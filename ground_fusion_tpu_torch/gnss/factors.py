"""Device-side GNSS factors: pseudorange/Doppler + receiver clock chain.

The tight GNSS coupling (``factor/gnss_psr_dopp_factor.cpp:51-106`` psr+dopp
residual with Sagnac, elevation weighting and state interpolation between
bracketing keyframes; ``gnss_dt_ddt_factor.cpp`` clock random-walk, coeff 50;
``gnss_ddt_smooth_factor.cpp`` drift smoothness, GNSS_DDT_WEIGHT): all epochs
of the window linearize as one ``torch.func.vmap`` of ``jacfwd`` over the
padded ``[F, S]`` observation table; satellite positions/clocks and
atmospheric delays are host-precomputed constants (ephemeris evaluation is
scalar/low-rate, SURVEY §7 stage 6), while everything touching optimized
state — anchor, yaw, clocks, poses, velocities — stays inside the
differentiated residual. The clock factors are linear, so their Jacobians are
written in closed form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor
from torch.func import vmap

from ..estimator.assembly import rows_to_dense
from ..estimator.factors import _jac_and_value
from ..estimator.layout import PER_FRAME, StateLayout
from ..estimator.window import WindowState
from .coords import WGS84_A, WGS84_E2

PSR_TO_DOPP_RATIO = 5.0
RELATIVE_SQRT_INFO = 10.0
DT_INFO_COEFF = 50.0
DT_ANCHOR_COEFF = 1000.0  # gnss_dt_anchor_factor.hpp:12


def dt_anchor_factor(rcv_dt, coeff: float = DT_ANCHOR_COEFF):
    """gnss_dt_anchor_factor.cpp:5-18: anchor a receiver clock bias to 0 —
    r = dt·coeff, J = coeff. (Shipped but unreferenced in the estimator
    build; provided for factor-library parity.)"""
    r = torch.atleast_1d(torch.as_tensor(rcv_dt) * coeff)
    return r, torch.full((1, 1), coeff, dtype=r.dtype, device=r.device)


class GnssObsWindow(NamedTuple):
    """Padded per-window satellite observations ([F, S] slots; slot (k, s)
    is an epoch bracketed by frames k and k+1 with interpolation ``ratio``
    and receiver clock dt[k]/ddt[k] — the reference's ``gnss_meas_buf[i]`` ↔
    ``para_rcv_dt + i·4`` pairing, estimator.cpp:3178-3207).

    REDUCED-OBSERVABLE form: the reference evaluates absolute ECEF
    pseudorange geometry in Ceres doubles; in float32 the ~2.4e7 m ranges
    quantize at ~2 m and the anchor at ~0.4 m. Here every observation is
    reduced at host ingest (float64, :func:`..gnss.ingest.reduce_obs`)
    against the alignment-time expansion anchor ``anc0``/its ENU rotation
    ``R0``, and the device residual touches only small well-conditioned
    quantities: the state's anchor column is the ENU delta from anc0, range
    enters as the stable quadratic correction
    ``Δrng = (|d|² − 2 d·rvec0)/(rng0 + rng)``, and both Sagnac terms enter
    through precomputed direction vectors."""

    rvec0: Tensor       # [F,S,3] R0ᵀ·(sat_pos − anc0)  (ENU, from anc0)
    rng0: Tensor        # [F,S] ‖sat_pos − anc0‖ (denominators/units only)
    psr_red: Tensor     # [F,S] psr − rng0 − sagnac0 + svdt·c − atm − tgd·c
    dopp_red: Tensor    # [F,S] dopp_wl − svddt·c + Ω/c·ẑ·(sv_vel × anc0)
    sv_vel: Tensor      # [F,S,3] R0ᵀ·sat velocity (ENU)
    sagnac_vec: Tensor  # [F,S,3] Ω/c·R0ᵀ·(ẑ_ecef × sat_pos)
    dsag_vec: Tensor    # [F,S,3] Ω/c·R0ᵀ·(ẑ_ecef × sv_vel)
    sys: Tensor         # [F,S] int64 constellation 0..3
    pr_weight: Tensor   # [F,S] sin(el)²/pr_uura · 10
    dp_weight: Tensor   # [F,S] sin(el)²/dp_uura · 10 · PSR_TO_DOPP_RATIO
    ratio: Tensor       # [F,S] interpolation toward frame k (reference
                        #       ts_ratio: epoch k sits between frames k, k+1)
    valid: Tensor       # [F,S] bool


# the per-slot float fields, in GnssObsWindow order (the host packs one
# epoch's slot as these fields side by side, see pipeline._write_gnss_slot)
SLOT_VECTORS = ("rvec0", "sv_vel", "sagnac_vec", "dsag_vec")
SLOT_SCALARS = ("rng0", "psr_red", "dopp_red", "pr_weight", "dp_weight", "ratio")


def empty_gnss_obs(num_frames: int, max_sats: int, dtype=torch.float32,
                   device=None) -> GnssObsWindow:
    f, s = num_frames, max_sats

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return GnssObsWindow(
        rvec0=z(f, s, 3), rng0=z(f, s), psr_red=z(f, s), dopp_red=z(f, s),
        sv_vel=z(f, s, 3), sagnac_vec=z(f, s, 3), dsag_vec=z(f, s, 3),
        sys=z(f, s, dt=torch.int64), pr_weight=z(f, s), dp_weight=z(f, s),
        ratio=z(f, s), valid=z(f, s, dt=torch.bool),
    )


def ecef2rotation_j(ref: Tensor) -> Tensor:
    """Differentiable ENU rotation at an ECEF point (torch twin of
    coords.ecef2rotation — for an anchor that is an optimized variable)."""
    x, y, z = ref[0], ref[1], ref[2]
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    lat = torch.atan2(z, p * (1.0 - WGS84_E2))
    for _ in range(5):
        sl = torch.sin(lat)
        n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * sl * sl)
        h = p / torch.cos(lat) - n
        lat = torch.atan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    sl, cl = torch.sin(lat), torch.cos(lat)
    so, co = torch.sin(lon), torch.cos(lon)
    return torch.stack([
        torch.stack([-so, -sl * co, cl * co]),
        torch.stack([co, -sl * so, cl * so]),
        torch.stack([torch.zeros_like(so), cl, sl]),
    ])


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def psr_dopp_residual_raw(Pi, Vi, Pj, Vj, rcv_dt, rcv_ddt, yaw_enu, danc_enu, o):
    """The 2-dim (psr, dopp) residual of gnss_psr_dopp_factor.cpp:51-106 in
    the REDUCED-OBSERVABLE form (see :class:`GnssObsWindow`), already
    multiplied by the elevation/URA weights. ``danc_enu`` is the anchor's
    ENU delta from the host-side expansion anchor anc0; every quantity here
    is O(km) or smaller, so the math is float32-stable. Broadcasts over
    leading axes (vectors carry a trailing axis of 3, the clocks, the yaw and
    ``o``'s scalars none).

    Range correction: with d = receiver ENU offset from anc0,
    ``rng² = rng0² − 2 d·rvec0 + |d|²``, so
    ``Δrng = rng − rng0 = q / (rng0 + rng)`` with ``q = |d|² − 2 d·rvec0``,
    evaluated by one fixed-point pass — catastrophic-cancellation-free.
    Sagnac terms use ``ẑ·(a × b)`` identities:
    ``ẑ·(sat × P) = ẑ·(sat × anc0) + (Ω/c·R0ᵀ(ẑ × sat))·d`` (constant part
    folded into psr_red at ingest; the direction vector is precomputed).

    Every scalar carries a trailing axis of 1 here: under ``jacfwd``, a
    0-dim tensor combined with a Python number yields a float64 tangent
    whatever the tensor's dtype."""
    def col(x):
        return x[..., None]

    ratio = col(o["ratio"])
    local_pos = ratio * Pi + (1.0 - ratio) * Pj
    local_vel = ratio * Vi + (1.0 - ratio) * Vj
    sy, cy = torch.sin(col(yaw_enu)), torch.cos(col(yaw_enu))

    def enu(v):                                     # R_z(yaw_enu) v
        x, y = v[..., 0:1], v[..., 1:2]
        return torch.cat([cy * x - sy * y, sy * x + cy * y, v[..., 2:3]], dim=-1)

    d = enu(local_pos) + danc_enu                   # receiver ENU offset
    V = enu(local_vel)                              # receiver ENU velocity

    rvec0, rng0 = o["rvec0"], col(o["rng0"])
    q = _dot(d, d) - 2.0 * _dot(d, rvec0)
    drng = q / (2.0 * rng0)
    drng = q / (2.0 * rng0 + drng)                  # q/(rng0+rng), one pass
    r0 = (drng + _dot(o["sagnac_vec"], d) + col(rcv_dt) - col(o["psr_red"])) \
        * col(o["pr_weight"])

    unit = (rvec0 - d) / torch.clamp(rng0 + drng, min=1e-6)
    dopp_est = (_dot(o["sv_vel"] - V, unit)
                + _dot(o["dsag_vec"], d) + _dot(o["sagnac_vec"], V)
                + col(rcv_ddt))
    r1 = (dopp_est + col(o["dopp_red"])) * col(o["dp_weight"])
    return torch.cat([r0, r1], dim=-1)


_OBS_KEYS = ("rvec0", "rng0", "psr_red", "dopp_red", "sv_vel", "sagnac_vec", "dsag_vec",
             "pr_weight", "dp_weight", "ratio")


def _flat_slots(state: WindowState, obs: GnssObsWindow, gnss_ready: Tensor,
                slot_filter: Optional[Tensor]):
    """The ``[F·S]`` factor batch: bracketing frame indices, the gathered
    state values each factor reads, its observation constants and validity.
    The receiver clock of a slot is gathered here, by the slot's frame and
    constellation (clamped to 0..3), outside any vmap."""
    f, s = obs.valid.shape
    dev = obs.valid.device
    ks = torch.arange(f, device=dev).repeat_interleave(s)   # slot k ↔ frames (k, k+1)
    kj = torch.clamp(ks + 1, max=f - 1)
    flat = GnssObsWindow(*[a.reshape((f * s,) + a.shape[2:]) for a in obs])
    sys = torch.clamp(flat.sys, 0, 3)
    valid = flat.valid & (ks <= f - 2) & gnss_ready
    if slot_filter is not None:
        valid = valid & slot_filter[ks]
    o = {k: getattr(flat, k) for k in _OBS_KEYS}
    vals = (state.poses[ks, 0:3], state.sbs[ks, 0:3], state.poses[kj, 0:3], state.sbs[kj, 0:3],
            state.rcv_dt[ks, sys], state.rcv_ddt[ks])
    return ks, kj, sys, valid, o, vals


def linearize_gnss_psr_dopp(state: WindowState, obs: GnssObsWindow,
                            gnss_ready: Tensor, layout: StateLayout,
                            slot_filter: Optional[Tensor] = None):
    """All psr/dopp factors of the window → dense rows.

    Tangent per factor: [δPi(3), δVi(3), δPj(3), δVj(3), δdt, δddt, δyaw,
    δanc(3)] = 18 columns (the position/velocity parts of the bracketing
    frames — the factor never touches rotations, matching the reference's
    <2,7,9,7,9,1,1,1,3> zero blocks)."""
    dtype, dev = state.poses.dtype, state.poses.device
    ks, kj, sys, valid, o, vals = _flat_slots(state, obs, gnss_ready, slot_filter)
    yaw, anc = state.yaw_enu, state.anc_ecef

    def one(Pi, Vi, Pj, Vj, dt, ddt, ob):
        def r_of(d):
            return psr_dopp_residual_raw(
                Pi + d[0:3], Vi + d[3:6], Pj + d[6:9], Vj + d[9:12],
                dt + d[12], ddt + d[13], yaw + d[14], anc + d[15:18], ob)

        return _jac_and_value(r_of, torch.zeros(18, dtype=dtype, device=dev))

    r, J = vmap(one)(*vals, o)                              # [B,2], [B,2,18]
    b = ks.shape[0]
    three = torch.arange(3, device=dev)
    col_idx = torch.cat(
        [
            (PER_FRAME * ks)[:, None] + three[None, :],             # Pi
            (PER_FRAME * ks + 6)[:, None] + three[None, :],         # Vi
            (PER_FRAME * kj)[:, None] + three[None, :],             # Pj
            (PER_FRAME * kj + 6)[:, None] + three[None, :],         # Vj
            (layout.gnss_dt + 4 * ks + sys)[:, None],               # dt
            (layout.gnss_ddt + ks)[:, None],                        # ddt
            torch.full((b, 1), layout.yaw_enu, dtype=torch.int64, device=dev),
            (layout.anc_ecef + three)[None, :].expand(b, 3),
        ],
        dim=1,
    )
    return rows_to_dense(J, col_idx, r, valid, layout.total)


def gnss_psr_dopp_residuals(state: WindowState, obs: GnssObsWindow, gnss_ready: Tensor,
                            slot_filter: Optional[Tensor] = None) -> Tensor:
    """Residual-only twin of :func:`linearize_gnss_psr_dopp` (the same rows'
    values, no Jacobians): the residual broadcasts over the slot axis."""
    _, _, _, valid, o, (Pi, Vi, Pj, Vj, dt, ddt) = _flat_slots(state, obs, gnss_ready,
                                                               slot_filter)
    r = psr_dopp_residual_raw(Pi, Vi, Pj, Vj, dt, ddt, state.yaw_enu, state.anc_ecef, o)
    return torch.where(valid[:, None], r, torch.zeros_like(r)).reshape(-1)


def _clock_chain_residuals(state: WindowState, frame_dts: Tensor, ddt_weight):
    """dt chain ``r = (dt_j − dt_i − ½(ddt_i + ddt_j)Δt)·50`` per pair and
    constellation ([F-1, 4], pair k = frames (k-1, k)), and ddt smoothness
    ``r = (ddt_i − ddt_j)·w`` per pair ([F-1])."""
    dt, ddt = state.rcv_dt, state.rcv_ddt
    r_dt = (dt[1:] - dt[:-1] - (0.5 * (ddt[:-1] + ddt[1:]) * frame_dts[1:])[:, None]) \
        * DT_INFO_COEFF
    r_sm = (ddt[:-1] - ddt[1:]) * ddt_weight
    return r_dt, r_sm


def _pair_ok(f: int, gnss_ready: Tensor, pair_filter: Optional[Tensor]) -> Tensor:
    ok = gnss_ready & torch.ones(f - 1, dtype=torch.bool, device=gnss_ready.device)
    if pair_filter is not None:
        ok = ok & pair_filter[1:]
    return ok


def linearize_clock_chain(state: WindowState, frame_dts: Tensor, gnss_ready: Tensor,
                          ddt_weight, layout: StateLayout,
                          pair_filter: Optional[Tensor] = None):
    """Receiver clock factors between adjacent frames: 4 constellations ×
    (dt random walk, coeff 50) + (ddt smoothness, GNSS_DDT_WEIGHT)
    (estimator.cpp:3209-3230). Both are linear in the state, so their
    Jacobians are constants: dt rows ``[−c, c, −½Δt·c, −½Δt·c]`` against
    ``[dt_i, dt_j, ddt_i, ddt_j]``, ddt rows ``[w, −w]``."""
    f = state.rcv_dt.shape[0]
    dtype, dev = state.poses.dtype, state.poses.device
    ks = torch.arange(1, f, device=dev)
    pair_ok = _pair_ok(f, gnss_ready, pair_filter)
    r_dt, r_sm = _clock_chain_residuals(state, frame_dts, ddt_weight)

    c = torch.full((f - 1,), DT_INFO_COEFF, dtype=dtype, device=dev)
    half = -(0.5 * frame_dts[1:]) * DT_INFO_COEFF
    J_dt = torch.stack([-c, c, half, half], dim=-1).repeat_interleave(4, dim=0)[:, None, :]
    pairs_k = ks.repeat_interleave(4)
    pairs_sys = torch.arange(4, device=dev).repeat(f - 1)
    cols_dt = torch.stack(
        [
            layout.gnss_dt + 4 * (pairs_k - 1) + pairs_sys,
            layout.gnss_dt + 4 * pairs_k + pairs_sys,
            layout.gnss_ddt + pairs_k - 1,
            layout.gnss_ddt + pairs_k,
        ],
        dim=1,
    )
    Jd1, rd1 = rows_to_dense(J_dt, cols_dt, r_dt.reshape(-1, 1),
                             pair_ok.repeat_interleave(4), layout.total)

    w = torch.as_tensor(ddt_weight, dtype=dtype, device=dev).expand(f - 1)
    J_sm = torch.stack([w, -w], dim=-1)[:, None, :]
    cols_sm = torch.stack([layout.gnss_ddt + ks - 1, layout.gnss_ddt + ks], dim=1)
    Jd2, rd2 = rows_to_dense(J_sm, cols_sm, r_sm[:, None], pair_ok, layout.total)
    return torch.cat([Jd1, Jd2]), torch.cat([rd1, rd2])


def clock_chain_residuals(state: WindowState, frame_dts: Tensor, gnss_ready: Tensor,
                          ddt_weight, pair_filter: Optional[Tensor] = None) -> Tensor:
    """Residual-only twin of :func:`linearize_clock_chain`."""
    f = state.rcv_dt.shape[0]
    pair_ok = _pair_ok(f, gnss_ready, pair_filter)
    r_dt, r_sm = _clock_chain_residuals(state, frame_dts, ddt_weight)
    zero = torch.zeros((), dtype=r_dt.dtype, device=r_dt.device)
    return torch.cat([torch.where(pair_ok[:, None], r_dt, zero).reshape(-1),
                      torch.where(pair_ok, r_sm, zero)])
