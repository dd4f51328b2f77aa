"""Schur marginalization → square-root prior, fully on-device.

The reference re-evaluates every factor touching frame 0, assembles a dense
normal-equation system with 4 pthreads, Schur-eliminates the dropped block via
an eigendecomposition with eigenvalue clipping, and stores a linearized
sqrt-prior (``marginalization_factor.cpp:119-308``). Here the same pipeline is
three matmuls, one small ``eigh`` and one Cholesky on static shapes:

1. the dropped-frame factor subset linearizes with the exact same batched
   kernels as the solver (:mod:`.assembly`) — no separate evaluation path;
2. anchored landmark depths are scalar blocks touching only camera columns,
   so their elimination is one batched rank-1 down-date, the analog of
   ``ThreadsConstructA``'s partial-H accumulation;
3. the 15-dim frame block is eliminated with a clipped-``eigh`` pseudo-inverse
   and the kept system re-factorized into a square root ``J0``, ``r0``
   (``marginalization_factor.cpp:278-302``).

The address-shift across the slide (``estimator.cpp:3500-3528``) becomes a
static column permutation into the post-slide layout.

With the landmark slots split over ranks (``reduce``, as in
:func:`.solver.solve_window`) each rank eliminates the depths and lines of
its own frame-0-anchored slots, rank 0 adds the rows that touch the camera
block alone, and the reduced systems ``Hred``, ``bred`` are summed (one
reduction). The frame-0 elimination and the square root then run on every
rank from the same sums; the all-reduce hands every rank the same bits, so
the ranks' factors are equal without a broadcast (two ranks on one H100,
``chip_smoke.py`` phase 12d).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .assembly import (
    MargPrior,
    SolveInputs,
    linearize_imu,
    linearize_plane,
    linearize_pose_anchor,
    linearize_prior,
    linearize_visual,
    linearize_wheel,
)
from .layout import PER_FRAME, StateLayout
from .window import Tracks, WindowState, boxminus, slide_new_state, slide_old_state


def _eigh_or_nan(A: Tensor, skip=None):
    """``torch.linalg.eigh(A)`` that never raises, batched over leading axes.

    ``torch.linalg.eigh`` raises ``LinAlgError`` where LAPACK (or cuSOLVER)
    does not converge, on a NaN input among others; ``jnp.linalg.eigh``
    returns NaN there. Here a non-finite matrix, and every matrix where
    ``skip`` is set (its result is selected away), is replaced by the
    identity before the call, which always converges; a non-finite matrix
    gets NaN eigenvalues (and the identity's eigenvectors). A float32 call
    that raises on a finite matrix is made again in float64 and rounded
    back (torch's float32 solver failed on a CPU on an H that
    ``jnp.linalg.eigh`` decomposes); if that raises too, the whole batch
    gets NaN eigenpairs. The call already waits for the solver's status,
    so the catch adds no host read. The eigenvectors keep the solver's
    memory layout, so every product with them rounds as before."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    bad = ~torch.all(torch.isfinite(A), dim=(-2, -1))
    away = bad if skip is None else bad | skip
    A_in = torch.where(away[..., None, None], eye, A)
    for dtype in dict.fromkeys((A.dtype, torch.float64)):
        try:
            s, V = (x.to(A.dtype) for x in torch.linalg.eigh(A_in.to(dtype)))
            return torch.where(bad[..., None], torch.full_like(s, float("nan")), s), V
        except torch.linalg.LinAlgError:
            pass
    return torch.full_like(A[..., 0], float("nan")), torch.full_like(A, float("nan"))


def _clipped_pinv(A: Tensor, eps: float = 1e-8):
    """Eigendecomposition pseudo-inverse with small-eigenvalue clipping
    (marginalization_factor.cpp:278-285 ``saes.eigenvalues().array() > eps``),
    batched over leading axes. A matrix whose ``eigh`` fails gives NaN, as
    ``jnp.linalg.eigh`` does, not a raise (:func:`_eigh_or_nan`)."""
    A = 0.5 * (A + A.mT)
    s, V = _eigh_or_nan(A)
    ok = s > eps
    s_inv = torch.where(ok, 1.0 / torch.where(ok, s, torch.ones_like(s)), torch.zeros_like(s))
    P = (V * s_inv[..., None, :]) @ V.mT
    return torch.where(torch.isnan(s[..., :1, None]), torch.full_like(P, float("nan")), P)


def _sqrt_factorize(H: Tensor, b: Tensor, eps: float = 1e-8):
    """H → (J0, r0) with J0ᵀJ0 = H, J0ᵀ r0 = b
    (marginalization_factor.cpp:294-302).

    The prior is consumed only through the quadratic form J0ᵀJ0 / J0ᵀr0, so
    ANY square root is equivalent. The fast path is a Cholesky of the
    ridge-stabilised system (J0 = Lᵀ, r0 = L⁻¹b); the reference's
    clipped-eigendecomposition factorization is the fallback taken only when
    rounding leaves H indefinite enough that the Cholesky fails. Both are
    computed and the status selects one on the device (the JAX package's
    ``lax.cond``): the choice needs no host read of the status, so a burst
    of steps and the fleet's ``vmap`` run it as they run the rest of the
    step (on CUDA the eigendecomposition still synchronizes the host, as
    every ``torch.linalg.eigh`` of the step does).

    Where the Cholesky succeeded, ``eigh`` is handed the identity
    (:func:`_eigh_or_nan` with ``skip``), so the Cholesky factor never
    depends on ``eigh`` converging (a float32 ``eigh`` of a finite H did not
    converge on a CPU and raised, ending the run, where the Cholesky had
    succeeded and where it had failed). Where the Cholesky fails, a float32
    ``eigh`` that raises is made again in float64. Where that fails too, the eigenvalues are NaN, as
    ``jnp.linalg.eigh`` gives them, the clip drops every direction and the
    prior is zero, as in the JAX package: the step keeps its solved state,
    the next window starts without the marginalized information, and the
    process goes on."""
    H = 0.5 * (H + H.mT)
    n = H.shape[-1]
    dtype = H.dtype
    # relative ridge: covers rank-deficiency + f32 rounding of the Schur
    # down-dates; ~1e-5 of the diagonal scale adds negligible information
    # next to sqrt_info-scaled factor blocks
    scale = torch.clamp(torch.max(torch.abs(torch.diagonal(H))), min=1.0)
    delta = (64.0 * torch.finfo(dtype).eps) * scale + eps
    L, info = torch.linalg.cholesky_ex(H + delta * torch.eye(n, dtype=dtype, device=H.device))
    chol_ok = (info == 0) & torch.all(torch.isfinite(L))
    L = torch.where(chol_ok, L, torch.eye(n, dtype=dtype, device=H.device))
    r_chol = torch.linalg.solve_triangular(L, b[:, None], upper=False)[:, 0]

    s, V = _eigh_or_nan(H, skip=chol_ok)
    ok = s > eps
    sqrt_s = torch.sqrt(torch.where(ok, s, torch.ones_like(s)))
    J_eig = torch.where(ok[:, None], sqrt_s[:, None] * V.T, torch.zeros_like(V))
    r_eig = torch.where(ok, (V.T @ b) / sqrt_s, torch.zeros_like(s))
    return torch.where(chol_ok, L.T, J_eig), torch.where(chol_ok, r_chol, r_eig)


def _schur_drop(H: Tensor, b: Tensor, drop: np.ndarray, keep: np.ndarray,
                eps: float = 1e-8):
    """Eliminate the static index set ``drop`` from (H, b)."""
    d = torch.as_tensor(drop, dtype=torch.int64, device=H.device)
    k = torch.as_tensor(keep, dtype=torch.int64, device=H.device)
    Amm_inv = _clipped_pinv(H.index_select(0, d).index_select(1, d), eps)
    Akm = H.index_select(0, k).index_select(1, d)
    Hk = H.index_select(0, k).index_select(1, k) - Akm @ Amm_inv @ Akm.T
    bk = b.index_select(0, k) - Akm @ (Amm_inv @ b.index_select(0, d))
    return Hk, bk


def _embed_prior(J_keep: Tensor, r_keep: Tensor, new_col: np.ndarray, nx: int):
    """Place the kept square root into the NX×NX prior at the post-slide
    columns. Additive: colliding columns (second-new map) sum."""
    nk = J_keep.shape[0]
    idx = torch.as_tensor(new_col, dtype=torch.int64, device=J_keep.device)
    kw = dict(dtype=J_keep.dtype, device=J_keep.device)
    J0 = torch.cat([torch.zeros((nk, nx), **kw).index_add(1, idx, J_keep),
                    torch.zeros((nx - nk, nx), **kw)])
    r0 = torch.cat([r_keep, torch.zeros(nx - nk, dtype=r_keep.dtype, device=r_keep.device)])
    return J0, r0


def marginalize_old(
    state: WindowState,
    tracks: Tracks,
    inp: SolveInputs,
    layout: StateLayout,
    sqrt_info_scale,
    cauchy_delta,
    plane_sqrt_info,
    lines=None,
    reduce=None,
) -> MargPrior:
    """Drop frame 0 (pose+speed-bias) and the depths of landmarks anchored
    there; return the prior already permuted into the POST-slide layout with
    the post-slide linearization point (``estimator.cpp:3334-3535``).

    When ``lines`` is given, the factors of lines anchored at frame 0 join
    the dropped subset with their 4-dim orthonormal blocks eliminated
    (``estimator.cpp:4680-4712``: drop set ``{2}``; the observation at the
    dropped frame itself is skipped)."""
    f = state.poses.shape[0]
    nx = layout.nx
    ml = layout.max_landmarks
    dev = state.poses.device

    ar = torch.arange(f, device=dev)
    only1 = ar == 1
    only0 = ar == 0
    replicated = reduce is None or reduce.rank == 0
    rows = []
    if replicated:
        rows.append(linearize_imu(state, inp.imu_pre, inp.imu_valid & only1, inp.g, layout))
        rows.append(linearize_wheel(state, inp.wheel_pre, inp.wheel_valid & only1, layout))
    anchored0 = tracks.active & (tracks.start_frame == 0)
    rows.append(linearize_visual(
        state, tracks, inp.td_obs, layout, sqrt_info_scale, cauchy_delta,
        lm_filter=anchored0,
    ))
    if replicated:
        rows.append(linearize_plane(state, inp.plane_valid & only0, plane_sqrt_info, layout))
        rows.append(linearize_prior(state, inp.prior, layout))
        # very first marginalization (no prior yet): seed with a pose0 anchor
        # at its current value instead of the prior factor
        # (estimator.cpp:3562-3570)
        rows.append(linearize_pose_anchor(state, state.poses[0], ~inp.prior.valid, layout))
    if replicated and inp.gnss_obs is not None:
        # GNSS factors of the dropped frame: slot-0 epochs + clock pair (0,1)
        # (estimator.cpp:3398-3434)
        from ..gnss.factors import linearize_clock_chain, linearize_gnss_psr_dopp

        rows.append(linearize_gnss_psr_dopp(
            state, inp.gnss_obs, inp.gnss_ready, layout, slot_filter=only0))
        rows.append(linearize_clock_chain(
            state, inp.frame_dts, inp.gnss_ready, inp.ddt_weight, layout,
            pair_filter=only1))
    if lines is not None:
        from .lines import linearize_lines

        line0 = lines.active & (lines.start_frame == 0)
        rows.append(linearize_lines(
            state, lines, layout, sqrt_info_scale * inp.line_weight,
            cauchy_delta, min_obs=inp.line_min_obs, lm_filter=line0,
            frame_filter=ar >= 1))
    J = torch.cat([a for a, _ in rows], dim=0) * inp.free_mask[None, :]
    r = torch.cat([b for _, b in rows], dim=0)

    Jc, Jl = J[:, :nx], J[:, nx : nx + ml]
    Hcc = Jc.T @ Jc
    bc = Jc.T @ r
    Hll = torch.sum(Jl * Jl, dim=0)                     # depth blocks are scalars
    Hcl = Jc.T @ Jl                                     # [NX, ML]
    bl = Jl.T @ r
    big = Hll > 1e-8
    w = torch.where(big, 1.0 / torch.where(big, Hll, torch.ones_like(Hll)),
                    torch.zeros_like(Hll))
    Hred = Hcc - (Hcl * w[None, :]) @ Hcl.T             # batched rank-1 down-dates
    bred = bc - Hcl @ (w * bl)

    if layout.max_lines > 0:
        # 4-dim line blocks: batched 4×4 block down-dates. No factor row
        # touches both a depth and a line column, so eliminating depths then
        # lines independently is exact.
        Jn = J[:, nx + ml :].reshape(J.shape[0], layout.max_lines, 4)
        Hnn = torch.einsum("rla,rlb->lab", Jn, Jn)      # [LL,4,4]
        Hcn = torch.einsum("rc,rla->lca", Jc, Jn)       # [LL,NX,4]
        bn = torch.einsum("rla,r->la", Jn, r)           # [LL,4]
        inv = _clipped_pinv(Hnn)
        Hred = Hred - torch.einsum("lca,lab,ldb->cd", Hcn, inv, Hcn)
        bred = bred - torch.einsum("lca,lab,lb->c", Hcn, inv, bn)
    if reduce is not None:
        Hred, bred = reduce(Hred, bred)

    # drop set: pose0+sb0 tangent (15) + frame-0 GNSS clock dt (4) and ddt (1)
    # (estimator.cpp:3351-3420 drop_set construction)
    drop = np.concatenate([
        np.arange(PER_FRAME),
        layout.gnss_dt + np.arange(4),
        np.array([layout.gnss_ddt]),
    ])
    keep = np.setdiff1d(np.arange(nx), drop)
    Hk, bk = _schur_drop(Hred, bred, drop, keep)
    J_keep, r_keep = _sqrt_factorize(Hk, bk)            # [nk, nk]

    # --- address shift into the post-slide layout (estimator.cpp:3500-3528):
    # frame cols shift down one slot; per-frame GNSS dt/ddt likewise; calib,
    # yaw_enu and anchor stay put ---
    new_col = keep.copy()
    frame_cols = keep < PER_FRAME * f
    new_col[frame_cols] -= PER_FRAME
    dt_cols = (keep >= layout.gnss_dt) & (keep < layout.gnss_dt + 4 * f)
    new_col[dt_cols] -= 4
    ddt_cols = (keep >= layout.gnss_ddt) & (keep < layout.gnss_ddt + f)
    new_col[ddt_cols] -= 1
    J0, r0 = _embed_prior(J_keep, r_keep, new_col, nx)
    return MargPrior(J0=J0, r0=r0, lin=slide_old_state(state),
                     valid=torch.ones((), dtype=torch.bool, device=dev))


def marginalize_second_new(
    state: WindowState, prior: MargPrior, layout: StateLayout
) -> MargPrior:
    """Drop only ``pose[F-2]`` from the existing prior (``estimator.cpp:
    3536-3631`` — drop set is exactly ``para_Pose[WINDOW_SIZE-1]``; the
    matching assert guarantees its speed-bias is never in the prior). When the
    prior has no columns there the Schur step is a no-op, reproducing the
    reference's skip branch without a branch. Returns the prior in the
    post-slide layout."""
    f = state.poses.shape[0]
    nx = layout.nx

    dx = boxminus(state, prior.lin, layout)
    r_cur = prior.r0 + prior.J0 @ dx
    H = prior.J0.T @ prior.J0
    b = prior.J0.T @ r_cur

    # drop set: pose(F-2) tangent only (estimator.cpp:3546-3552; slot F-2's
    # GNSS dt/ddt cols are provably zero and shift away with the same map)
    p = PER_FRAME * (f - 2)
    drop = np.arange(p, p + 6)
    keep = np.setdiff1d(np.arange(nx), drop)
    Hk, bk = _schur_drop(H, b, drop, keep)
    J_keep, r_keep = _sqrt_factorize(Hk, bk)

    # address map (estimator.cpp:3583-3618): i==F-2 skipped, i==F-1 →
    # slot F-2 for pose/sb and GNSS dt/ddt; all else identity. Old frame
    # F-1's sb cols land on slot F-2's kept (provably zero) sb cols — the
    # additive placement sums the collision
    new_col = keep.copy()
    old_f1 = PER_FRAME * (f - 1)
    mv = (keep >= old_f1) & (keep < old_f1 + PER_FRAME)
    new_col[mv] -= PER_FRAME
    dt_f1 = layout.gnss_dt + 4 * (f - 1)
    mv = (keep >= dt_f1) & (keep < dt_f1 + 4)
    new_col[mv] -= 4
    ddt_f1 = layout.gnss_ddt + (f - 1)
    mv = keep == ddt_f1
    new_col[mv] -= 1
    J0, r0 = _embed_prior(J_keep, r_keep, new_col, nx)
    # the reference re-linearizes the kept prior at the *current* values
    # (preMarginalize copies parameter_block_data from live state)
    lin_new = slide_new_state(state)
    # without a valid prior there is nothing to marginalize — pass through
    return MargPrior(
        J0=torch.where(prior.valid, J0, prior.J0),
        r0=torch.where(prior.valid, r0, prior.r0),
        lin=lin_new, valid=prior.valid,
    )
