"""Fixed-iteration trust-region window solvers (LM and Powell dogleg).

Replaces Ceres ``DENSE_SCHUR``+``DOGLEG`` with ≤8-iteration / 40 ms budget
(``estimator.cpp:3303-3318``) by a fixed-length trust-region loop: always
relinearize at the current accepted state, solve the dense normal equations
(one Cholesky of a ~300×300 system), accept/reject by cost, adapt the region.
Every iteration issues the same device operations, and accept/reject is a
``torch.where`` on tensors, so the loop never waits for the device. Two
strategies (``SolverConfig.method``):

- ``lm`` — Levenberg–Marquardt with multiplicative damping;
- ``dogleg`` — Powell's dogleg matching Ceres'
  ``trust_region_strategy_type = DOGLEG`` (``estimator.cpp:3306``): blend the
  Gauss–Newton step with the Cauchy (steepest-descent) point inside an
  adaptive radius, gain-ratio controlled.

A Cholesky factorization that fails (``info != 0``) yields a NaN step, which
makes the trial cost NaN and the step rejected — the same outcome as a
factorization that returns NaN.

Gauge handling matches ``double2vector`` (``estimator.cpp:2440-2569``): after
the solve, yaw and position of frame 0 are re-anchored to their pre-solve
values by a rigid yaw-rotation + translation of the whole window.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..geometry.so3 import mat_to_quat, mat_to_ypr, quat_mul, quat_normalize, quat_to_mat, yaw_to_mat
from .assembly import SolveInputs, assemble_residuals, assemble_rows, normal_equations
from .layout import StateLayout
from .lines import _solve_spd4
from .window import Tracks, WindowState, retract


class SolverParams(NamedTuple):
    sqrt_info_scale: Tensor   # FOCAL/1.5 (estimator.cpp:193-198)
    cauchy_delta: Tensor
    plane_sqrt_info: Tensor   # [3]
    lm_lambda0: Tensor
    lm_up: Tensor
    lm_down: Tensor


def _cost(r):
    # robust reweighting is already folded into r's rows
    return 0.5 * torch.sum(r * r)


def _cho_solve_or_nan(A: Tensor, b: Tensor) -> Tensor:
    """A⁻¹b through a Cholesky factorization; NaN where A is not positive
    definite (no exception, no host sync)."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _solve_delta(H, g, lam, free_mask):
    """(H + λ·diag(H) + εI) δ = -g, frozen columns pinned to zero."""
    damp = lam * torch.diagonal(H) + 1e-8
    # pin frozen vars with a unit diagonal so the system stays SPD
    damp = damp + (1.0 - free_mask)
    Hd = H + torch.diag(damp)
    return _cho_solve_or_nan(Hd, -g) * free_mask


def _solve_delta_schur(H, g, lam, free_mask, layout: StateLayout):
    """Same damped system solved via the Schur complement (ceres
    ``DENSE_SCHUR``): landmark inverse-depth columns are mutually-orthogonal
    scalar blocks and line blocks are independent 4×4s, so eliminating them
    costs two batched down-dates and shrinks the Cholesky from
    ``total×total`` to ``nx×nx``. The line blocks' solves are the unrolled,
    pivot-clamped 4×4 Cholesky of :func:`.lines._solve_spd4`, batched over
    lines and camera columns."""
    nx, ml, ll = layout.nx, layout.max_landmarks, layout.max_lines
    damp = lam * torch.diagonal(H) + 1e-8 + (1.0 - free_mask)
    Hd = H + torch.diag(damp)
    gn = -g * free_mask

    Hcc = Hd[:nx, :nx]
    bc = gn[:nx]

    # scalar depth blocks
    Hcd = Hd[:nx, nx : nx + ml]
    hdd = torch.diagonal(Hd)[nx : nx + ml]
    bd = gn[nx : nx + ml]
    wd = 1.0 / hdd                                   # damped ⇒ > 0
    Hcc = Hcc - (Hcd * wd[None, :]) @ Hcd.T
    bc = bc - Hcd @ (wd * bd)

    if ll:
        # 4×4 line blocks: the diagonal blocks of the trailing [4LL, 4LL]
        # corner, gathered as [LL, 4, 4] (the advanced index goes first)
        lines0 = nx + ml
        Hcl = Hd[:nx, lines0:].reshape(nx, ll, 4)
        ar = torch.arange(ll, device=H.device)
        Hll = Hd[lines0:, lines0:].reshape(ll, 4, ll, 4)[ar, :, ar, :]
        bl = gn[lines0:].reshape(ll, 4)
        sol_bl = _solve_spd4(Hll, bl)                               # Hll⁻¹ bl
        sol_Hcl = _solve_spd4(Hll[:, None], Hcl.transpose(0, 1))   # Hll⁻¹ Hclᵀ [LL,nx,4]
        Hcc = Hcc - torch.einsum("cla,lna->cn", Hcl, sol_Hcl)
        bc = bc - torch.einsum("cla,la->c", Hcl, sol_bl)

    dc = _cho_solve_or_nan(Hcc, bc)
    dd = wd * (bd - Hcd.T @ dc)
    parts = [dc, dd]
    if ll:
        rhs_l = bl - torch.einsum("cla,c->la", Hcl, dc)
        parts.append(_solve_spd4(Hll, rhs_l).reshape(-1))
    return torch.cat(parts) * free_mask


def _dogleg_step(H, g, free_mask, h_gn, radius):
    """Powell dogleg inside ``radius``: GN step if it fits, else the blend of
    the Cauchy point and GN on the trust boundary."""
    gm = g * free_mask
    gHg = gm @ (H @ gm)
    alpha = torch.where(gHg > 1e-12, (gm @ gm) / torch.clamp(gHg, min=1e-12),
                        torch.zeros_like(gHg))
    h_sd = -alpha * gm
    n_gn = torch.linalg.norm(h_gn)
    n_sd = torch.linalg.norm(h_sd)

    # boundary blend h_sd + beta (h_gn − h_sd) with |h| = radius
    d = h_gn - h_sd
    a = torch.clamp(d @ d, min=1e-18)
    b = h_sd @ d
    c = h_sd @ h_sd - radius * radius
    disc = torch.clamp(b * b - a * c, min=0.0)
    beta = (-b + torch.sqrt(disc)) / a
    h_blend = h_sd + torch.clamp(beta, 0.0, 1.0) * d

    h_sd_clip = h_sd * (radius / torch.clamp(n_sd, min=1e-12))
    h = torch.where(
        n_gn <= radius, h_gn,
        torch.where(n_sd >= radius, h_sd_clip, h_blend),
    )
    return h * free_mask


def _select(accept: Tensor, new, old):
    """Field-wise ``where(accept, new, old)`` over a NamedTuple of tensors."""
    return type(old)(*[torch.where(accept, b, a) for a, b in zip(old, new)])


def solve_window(
    state: WindowState,
    tracks: Tracks,
    inp: SolveInputs,
    layout: StateLayout,
    params: SolverParams,
    num_iters: int = 8,
    lines=None,
    method: str = "lm",
    linear_solver: str = "dense",
):
    """Run the trust-region loop for ``num_iters`` fixed iterations; returns
    (state', tracks', final_cost) — or (state', tracks', lines',
    final_cost) when ``lines`` is given. Landmark depths (and the line
    orthonormal blocks, when present) update jointly through the trailing
    columns.
    """
    nx = layout.nx
    ml = layout.max_landmarks
    dtype, dev = state.poses.dtype, state.poses.device
    with_lines = lines is not None

    def apply_delta(st: WindowState, tr: Tracks, ln, delta):
        st2 = retract(st, delta[:nx], layout)
        tr2 = tr._replace(inv_depth=tr.inv_depth + delta[nx : nx + ml])
        if with_lines:
            ln = ln._replace(orth=ln.orth + delta[nx + ml :].reshape(-1, 4))
        return st2, tr2, ln

    def inputs(ln):
        return inp._replace(lines=ln) if with_lines else inp

    def lin_cost(st, tr, ln):
        J, r = assemble_rows(
            st, tr, inputs(ln), layout, params.sqrt_info_scale, params.cauchy_delta,
            params.plane_sqrt_info,
        )
        return J, r, _cost(r)

    def cost_only(st, tr, ln):
        # residual-only probe (no Jacobian build) for accept/reject; frozen
        # columns never move, so free_mask does not change r
        return _cost(assemble_residuals(
            st, tr, inputs(ln), layout, params.sqrt_info_scale, params.cauchy_delta,
            params.plane_sqrt_info,
        ))

    if linear_solver == "schur":
        def lin_solve(H, g, lam):
            return _solve_delta_schur(H, g, lam, inp.free_mask, layout)
    else:
        def lin_solve(H, g, lam):
            return _solve_delta(H, g, lam, inp.free_mask)

    dogleg = method == "dogleg"
    reg = (torch.ones((), dtype=dtype, device=dev) if dogleg
           else params.lm_lambda0.to(dtype=dtype, device=dev))
    _, _, cost = lin_cost(state, tracks, lines)
    for _ in range(num_iters):
        J, r, c0 = lin_cost(state, tracks, lines)
        H, g = normal_equations(J, r)
        if dogleg:
            # Powell dogleg (ceres DOGLEG, estimator.cpp:3306): `reg` is the
            # trust radius, gain-ratio controlled. The GN step carries a tiny
            # RELATIVE Tikhonov floor: until the first marginalization prior
            # exists the window Hessian has a 4-dim gauge nullspace
            # (yaw+position are re-anchored only after the solve), and an
            # exactly undamped solve lets rounding-scale gradient components
            # explode along it; Ceres likewise regularizes its dogleg GN solve
            h_gn = lin_solve(H, g, 1e-6)
            delta = _dogleg_step(H, g, inp.free_mask, h_gn, reg)
        else:
            delta = lin_solve(H, g, reg)
        st_new, tr_new, ln_new = apply_delta(state, tracks, lines, delta)
        c1 = cost_only(st_new, tr_new, ln_new)
        accept = c1 < c0
        state = _select(accept, st_new, state)
        tracks = _select(accept, tr_new, tracks)
        if with_lines:
            lines = _select(accept, ln_new, lines)
        if dogleg:
            pred = -(g @ delta + 0.5 * delta @ (H @ delta))
            rho = (c0 - c1) / torch.clamp(pred, min=1e-18)
            step_norm = torch.linalg.norm(delta)
            reg = torch.where(
                accept & (rho > 0.75), torch.maximum(reg, 3.0 * step_norm),
                torch.where(accept & (rho >= 0.25), reg, reg * 0.5),
            )
            reg = torch.clamp(reg, 1e-8, 1e8)
        else:
            reg = torch.where(accept, reg * params.lm_down, reg * params.lm_up)
            reg = torch.clamp(reg, 1e-10, 1e6)
        cost = torch.where(accept, c1, c0)
    if with_lines:
        return state, tracks, lines, cost
    return state, tracks, cost


def gauge_transform(state_before: WindowState, state_after: WindowState):
    """The rigid yaw-gauge correction (R, t, q) with ``x' = R x + t`` that
    restores frame 0's pre-solve yaw and position (``double2vector``,
    ``estimator.cpp:2440-2569``)."""
    R0_before = quat_to_mat(state_before.poses[0, 3:7])
    R0_after = quat_to_mat(state_after.poses[0, 3:7])
    y_before = mat_to_ypr(R0_before)[0]
    y_after = mat_to_ypr(R0_after)[0]
    rot_diff = yaw_to_mat(y_before - y_after)
    q_diff = mat_to_quat(rot_diff)
    t = state_before.poses[0, 0:3] - rot_diff @ state_after.poses[0, 0:3]
    return rot_diff, t, q_diff


def reanchor_yaw(state_before: WindowState, state_after: WindowState) -> WindowState:
    """Undo the yaw/position gauge drift of the solve (``double2vector``,
    ``estimator.cpp:2440-2569``): rotate the optimized window about the origin
    so frame 0 recovers its pre-solve yaw and position."""
    rot_diff, t, q_diff = gauge_transform(state_before, state_after)
    new_p = state_after.poses[:, 0:3] @ rot_diff.T + t
    new_q = quat_normalize(quat_mul(q_diff, state_after.poses[:, 3:7]))
    new_v = state_after.sbs[:, 0:3] @ rot_diff.T
    sbs = torch.cat([new_v, state_after.sbs[:, 3:]], dim=-1)
    return state_after._replace(poses=torch.cat([new_p, new_q], dim=-1), sbs=sbs)
