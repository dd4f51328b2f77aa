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

**Landmark shards.** ``reduce`` (default None: one rank holds every
landmark) runs the same loop with the landmark and line slots split over
ranks (``parallel/sharded.py``). It is a callable that sums tensors over the
ranks in one packed reduction, with attributes ``rank`` and ``world``. Each
rank holds a view of the system: the camera block ``[:nx]`` of ``H`` and
``g`` summed over the ranks (the same on every rank), and the columns of its
own landmarks and lines, which no other rank's rows touch. The sums that
couple the shards go through ``reduce``: the camera block and the cost of
each linearization, the Schur down-dates, the trial cost, and the dogleg's
inner products (:func:`_products`); depth and line elimination and their
back-substitution stay on the rank. A dogleg iteration sums five times (the
linearization; the down-dates; ``|g|²`` with ``gᵀHg``; the five products of
the blend; the trial cost with the gain ratio's ``g·δ``, ``δᵀHδ`` and
``|δ|``), an LM iteration three. Every rank decides accept and reject on
the summed cost, so all ranks keep one state.
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


def _reduce_camera(H: Tensor, g: Tensor, cost: Tensor, nx: int, reduce):
    """Sum the camera block of this rank's normal equations, and its cost,
    over the ranks (one reduction); the landmark blocks stay the rank's."""
    Hcc, gc, cost = reduce(H[:nx, :nx], g[:nx], cost)
    H = torch.cat([torch.cat([Hcc, H[:nx, nx:]], dim=1), H[nx:]], dim=0)
    return H, torch.cat([gc, g[nx:]]), cost


def _products(terms, H: Tensor, nx: int, reduce=None) -> list:
    """Scalars over the whole tangent vector: ``("dot", a, b)`` is a·b,
    ``("norm", a)`` is |a|, ``("quad", a)`` is a·(H a) and ``("sum", s)``
    a scalar that the ranks sum. On one rank each is computed as it reads.
    With ``reduce`` the vectors are this rank's view (camera block
    replicated, the rest its shard): each product is its camera part plus
    the ranks' shard parts, all summed in one reduction; a quadratic form's
    shard part is ``2 a_cᵀ H_cd a_d + a_dᵀ H_dd a_d``."""
    if reduce is None:
        out = []
        for kind, a, *b in terms:
            out.append(a @ b[0] if kind == "dot" else torch.linalg.norm(a) if kind == "norm"
                       else a @ (H @ a) if kind == "quad" else a)
        return out
    cam, shard = [], []
    for kind, a, *b in terms:
        if kind == "sum":
            cam.append(torch.zeros_like(a))
            shard.append(a)
            continue
        ac, ad = a[:nx], a[nx:]
        if kind == "dot":
            cam.append(ac @ b[0][:nx])
            shard.append(ad @ b[0][nx:])
        elif kind == "norm":
            cam.append(ac @ ac)
            shard.append(ad @ ad)
        else:
            cam.append(ac @ (H[:nx, :nx] @ ac))
            shard.append(2.0 * (ac @ (H[:nx, nx:] @ ad)) + ad @ (H[nx:, nx:] @ ad))
    (summed,) = reduce(torch.stack(shard))
    total = torch.stack(cam) + summed
    return [torch.sqrt(v) if kind == "norm" else v for (kind, *_), v in zip(terms, total)]


def _solve_delta(H, g, lam, free_mask):
    """(H + λ·diag(H) + εI) δ = -g, frozen columns pinned to zero."""
    damp = lam * torch.diagonal(H) + 1e-8
    # pin frozen vars with a unit diagonal so the system stays SPD
    damp = damp + (1.0 - free_mask)
    Hd = H + torch.diag(damp)
    return _cho_solve_or_nan(Hd, -g) * free_mask


def _whole_columns(layout: StateLayout, rank: int, world: int, device) -> Tensor:
    """This rank's columns in the tangent vector of all ranks' slots: the
    camera block, then its depths and its lines among all ranks'."""
    nx, ml, ll = layout.nx, layout.max_landmarks, layout.max_lines
    ar = lambda n: torch.arange(n, device=device)
    return torch.cat([ar(nx), nx + rank * ml + ar(ml),
                      nx + world * ml + 4 * rank * ll + ar(4 * ll)])


def _solve_delta_whole(H, g, lam, free_mask, layout: StateLayout, reduce):
    """:func:`_solve_delta` over landmark shards: each rank writes its view
    into a zero-padded system of all ranks' columns (the camera block from
    rank 0 only), the ranks sum them (one reduction) and every rank solves
    the whole system, keeping its own columns of the step. Correct, not
    fast: the reduction carries the whole ``total × total`` matrix."""
    nx = layout.nx
    cols = _whole_columns(layout, reduce.rank, reduce.world, H.device)
    total = nx + reduce.world * (layout.max_landmarks + 4 * layout.max_lines)
    own = torch.ones(H.shape[0], dtype=H.dtype, device=H.device)
    if reduce.rank:
        own[:nx] = 0.0
    Hw = torch.zeros((total, total), dtype=H.dtype, device=H.device)
    Hw[cols[:, None], cols[None, :]] = H * torch.maximum(own[:, None], own[None, :])
    gw = torch.zeros(total, dtype=g.dtype, device=g.device).index_copy(0, cols, g * own)
    fw = torch.zeros(total, dtype=g.dtype, device=g.device).index_copy(0, cols, free_mask * own)
    Hw, gw, fw = reduce(Hw, gw, fw)
    return _solve_delta(Hw, gw, lam, fw)[cols]


def _solve_delta_schur(H, g, lam, free_mask, layout: StateLayout, reduce=None):
    """Same damped system solved via the Schur complement (ceres
    ``DENSE_SCHUR``): landmark inverse-depth columns are mutually-orthogonal
    scalar blocks and line blocks are independent 4×4s, so eliminating them
    costs two batched down-dates and shrinks the Cholesky from
    ``total×total`` to ``nx×nx``. The line blocks' solves are the unrolled,
    pivot-clamped 4×4 Cholesky of :func:`.lines._solve_spd4`, batched over
    lines and camera columns. Over landmark shards each rank eliminates its
    own depths and lines, the down-dates are summed (one reduction) and
    every rank solves the reduced camera system."""
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
    downs = [((Hcd * wd[None, :]) @ Hcd.T, Hcd @ (wd * bd))]

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
        downs.append((torch.einsum("cla,lna->cn", Hcl, sol_Hcl),
                      torch.einsum("cla,la->c", Hcl, sol_bl)))
    if reduce is not None:
        downs = [reduce(sum(d for d, _ in downs), sum(b for _, b in downs))]
    for down_H, down_b in downs:
        Hcc = Hcc - down_H
        bc = bc - down_b

    dc = _cho_solve_or_nan(Hcc, bc)
    dd = wd * (bd - Hcd.T @ dc)
    parts = [dc, dd]
    if ll:
        rhs_l = bl - torch.einsum("cla,c->la", Hcl, dc)
        parts.append(_solve_spd4(Hll, rhs_l).reshape(-1))
    return torch.cat(parts) * free_mask


def _dogleg_step(H, g, free_mask, h_gn, radius, nx: int = 0, reduce=None):
    """Powell dogleg inside ``radius``: GN step if it fits, else the blend of
    the Cauchy point and GN on the trust boundary. Its inner products run
    over the whole vector (:func:`_products`: two reductions over shards)."""
    gm = g * free_mask
    gHg, gg = _products([("quad", gm), ("dot", gm, gm)], H, nx, reduce)
    alpha = torch.where(gHg > 1e-12, gg / torch.clamp(gHg, min=1e-12),
                        torch.zeros_like(gHg))
    h_sd = -alpha * gm

    # boundary blend h_sd + beta (h_gn − h_sd) with |h| = radius
    d = h_gn - h_sd
    n_gn, n_sd, dd, b, ss = _products(
        [("norm", h_gn), ("norm", h_sd), ("dot", d, d), ("dot", h_sd, d), ("dot", h_sd, h_sd)],
        H, nx, reduce)
    a = torch.clamp(dd, min=1e-18)
    c = ss - radius * radius
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
    reduce=None,
):
    """Run the trust-region loop for ``num_iters`` fixed iterations; returns
    (state', tracks', final_cost) — or (state', tracks', lines',
    final_cost) when ``lines`` is given. Landmark depths (and the line
    orthonormal blocks, when present) update jointly through the trailing
    columns. With ``reduce`` the tracks and lines are this rank's shard
    (module docstring); the state and the cost are the same on every rank.
    """
    nx = layout.nx
    ml = layout.max_landmarks
    dtype, dev = state.poses.dtype, state.poses.device
    with_lines = lines is not None
    # the rows that touch the camera block alone are added on one rank
    replicated = reduce is None or reduce.rank == 0

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
            params.plane_sqrt_info, replicated,
        )
        H, g = normal_equations(J, r)
        if reduce is None:
            return H, g, _cost(r)
        return _reduce_camera(H, g, _cost(r), nx, reduce)

    def cost_only(st, tr, ln):
        # residual-only probe (no Jacobian build) for accept/reject; frozen
        # columns never move, so free_mask does not change r. Over shards
        # this is the rank's part of the cost
        return _cost(assemble_residuals(
            st, tr, inputs(ln), layout, params.sqrt_info_scale, params.cauchy_delta,
            params.plane_sqrt_info, replicated,
        ))

    if linear_solver == "schur":
        def lin_solve(H, g, lam):
            return _solve_delta_schur(H, g, lam, inp.free_mask, layout, reduce)
    elif reduce is None:
        def lin_solve(H, g, lam):
            return _solve_delta(H, g, lam, inp.free_mask)
    else:
        def lin_solve(H, g, lam):
            return _solve_delta_whole(H, g, lam, inp.free_mask, layout, reduce)

    dogleg = method == "dogleg"
    reg = (torch.ones((), dtype=dtype, device=dev) if dogleg
           else params.lm_lambda0.to(dtype=dtype, device=dev))
    _, _, cost = lin_cost(state, tracks, lines)
    for _ in range(num_iters):
        H, g, c0 = lin_cost(state, tracks, lines)
        if dogleg:
            # Powell dogleg (ceres DOGLEG, estimator.cpp:3306): `reg` is the
            # trust radius, gain-ratio controlled. The GN step carries a tiny
            # RELATIVE Tikhonov floor: until the first marginalization prior
            # exists the window Hessian has a 4-dim gauge nullspace
            # (yaw+position are re-anchored only after the solve), and an
            # exactly undamped solve lets rounding-scale gradient components
            # explode along it; Ceres likewise regularizes its dogleg GN solve
            h_gn = lin_solve(H, g, 1e-6)
            delta = _dogleg_step(H, g, inp.free_mask, h_gn, reg, nx, reduce)
        else:
            delta = lin_solve(H, g, reg)
        st_new, tr_new, ln_new = apply_delta(state, tracks, lines, delta)
        # the trial cost, with the dogleg's gain-ratio terms in the same sum
        gain_terms = [("dot", g, delta), ("quad", delta), ("norm", delta)] if dogleg else []
        c1, *gain = _products([("sum", cost_only(st_new, tr_new, ln_new))] + gain_terms,
                              H, nx, reduce)
        accept = c1 < c0
        state = _select(accept, st_new, state)
        tracks = _select(accept, tr_new, tracks)
        if with_lines:
            lines = _select(accept, ln_new, lines)
        if dogleg:
            g_delta, dHd, step_norm = gain
            pred = -(g_delta + 0.5 * dHd)
            rho = (c0 - c1) / torch.clamp(pred, min=1e-18)
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
