"""Padded raw-sample buffers for one window + batched preintegration.

The reference stores an ``IntegrationBase`` object per window slot and mutates
it sample-by-sample (``estimator.cpp:743-842`` processIMU/processWheel). Here
the raw samples live in fixed-capacity ``[F, K]`` tensors (slot k = interval
(k-1, k]); every solve re-preintegrates all intervals together, batched over
the F intervals, at the current linearization biases — repropagation
(``integration_base.h:47-61``) is free because preintegration is pure.

By default the window is preintegrated in the log-depth form
(:mod:`..preintegration.parallel`: a scan of ⌈log₂K⌉ rounds over the
samples), as the JAX package's window step does; ``parallel=False`` runs the
sequential loop over the K samples, which agrees with it to float rounding
and is the plain form the tests hold it against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..preintegration.imu import ImuPreint, preintegrate
from ..preintegration.parallel import preintegrate_parallel, preintegrate_wheel_parallel
from ..preintegration.wheel import WheelPreint, preintegrate_wheel


class ImuWindowBuffer(NamedTuple):
    dts: Tensor    # [F, K]
    acc: Tensor    # [F, K, 3]
    gyr: Tensor    # [F, K, 3]
    valid: Tensor  # [F, K] bool
    acc0: Tensor   # [F, 3] sample at interval start
    gyr0: Tensor   # [F, 3]


class WheelWindowBuffer(NamedTuple):
    dts: Tensor    # [F, K]
    vel: Tensor    # [F, K, 3]
    gyr: Tensor    # [F, K, 3]
    valid: Tensor  # [F, K] bool
    vel0: Tensor   # [F, 3]
    gyr0: Tensor   # [F, 3]
    # per-interval anomaly flag, set ONCE at the interval's first solve from
    # the wheel-vs-IMU dead-reckoning test (estimator.cpp:629-636) and slid
    # with the window: a slip-contaminated interval stays excluded for its
    # whole window lifetime (divergence from the reference, which re-admits
    # contaminated intervals once its newest-interval flag clears)
    bad: Tensor    # [F] bool


def empty_imu_buffer(num_frames: int, cap: int, dtype=torch.float32,
                     device=None) -> ImuWindowBuffer:
    f, k = num_frames, cap
    kw = dict(dtype=dtype, device=device)
    return ImuWindowBuffer(
        dts=torch.zeros((f, k), **kw), acc=torch.zeros((f, k, 3), **kw),
        gyr=torch.zeros((f, k, 3), **kw),
        valid=torch.zeros((f, k), dtype=torch.bool, device=device),
        acc0=torch.zeros((f, 3), **kw), gyr0=torch.zeros((f, 3), **kw),
    )


def empty_wheel_buffer(num_frames: int, cap: int, dtype=torch.float32,
                       device=None) -> WheelWindowBuffer:
    f, k = num_frames, cap
    kw = dict(dtype=dtype, device=device)
    return WheelWindowBuffer(
        bad=torch.zeros((f,), dtype=torch.bool, device=device),
        dts=torch.zeros((f, k), **kw), vel=torch.zeros((f, k, 3), **kw),
        gyr=torch.zeros((f, k, 3), **kw),
        valid=torch.zeros((f, k), dtype=torch.bool, device=device),
        vel0=torch.zeros((f, 3), **kw), gyr0=torch.zeros((f, 3), **kw),
    )


def preintegrate_imu_window(buf: ImuWindowBuffer, sbs: Tensor, noise18,
                            parallel: bool = True) -> ImuPreint:
    """Preintegrate every interval; slot k linearizes at the biases of frame
    k-1 (the interval's start), like ``IntegrationBase(acc_0, gyr_0, Bas[k-1],
    Bgs[k-1])``. Returns an ImuPreint with leading axis F. ``parallel``
    picks the log-depth form (default) or the sequential loop."""
    sb_prev = torch.roll(sbs, 1, dims=0)
    ba, bg = sb_prev[:, 3:6], sb_prev[:, 6:9]
    fn = preintegrate_parallel if parallel else preintegrate
    return fn(buf.dts, buf.acc, buf.gyr, buf.valid, buf.acc0, buf.gyr0, ba, bg, noise18)


def preintegrate_wheel_window(buf: WheelWindowBuffer, s_wheel: Tensor,
                              td_wheel: Tensor, noise12, parallel: bool = True) -> WheelPreint:
    sx, sy, sw = s_wheel[0], s_wheel[1], s_wheel[2]
    fn = preintegrate_wheel_parallel if parallel else preintegrate_wheel
    return fn(buf.dts, buf.vel, buf.gyr, buf.valid, buf.vel0, buf.gyr0,
              sx, sy, sw, td_wheel, noise12)


def _roll_clear(a: Tensor) -> Tensor:
    """Shift down one slot along axis 0 and clear the newest slot."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])], dim=0)


def _roll_wrap(a: Tensor) -> Tensor:
    return torch.roll(a, -1, dims=0)


def slide_old_imu_buffer(buf: ImuWindowBuffer) -> ImuWindowBuffer:
    """MARGIN_OLD: intervals shift down one slot; the newest slot is cleared
    for the incoming frame."""
    return ImuWindowBuffer(
        dts=_roll_clear(buf.dts), acc=_roll_wrap(buf.acc), gyr=_roll_wrap(buf.gyr),
        valid=_roll_clear(buf.valid), acc0=_roll_wrap(buf.acc0), gyr0=_roll_wrap(buf.gyr0),
    )


def slide_old_wheel_buffer(buf: WheelWindowBuffer) -> WheelWindowBuffer:
    return WheelWindowBuffer(
        dts=_roll_clear(buf.dts), vel=_roll_wrap(buf.vel), gyr=_roll_wrap(buf.gyr),
        valid=_roll_clear(buf.valid), vel0=_roll_wrap(buf.vel0), gyr0=_roll_wrap(buf.gyr0),
        bad=_roll_clear(buf.bad),
    )


def _merge_padded(dts_a, xa, ga, va, dts_b, xb, gb, vb):
    """Concatenate interval b after interval a within the same capacity K by
    compacting valid samples to the front (``Estimator::slideWindow`` new-frame
    merge, ``estimator.cpp:3712-3724`` push_back of the merged samples).

    If the combined interval overflows K samples, adjacent sample pairs are
    fused (dt summed, endpoint measurement kept) — a controlled decimation
    instead of the silent sample drop a fixed buffer would otherwise cause;
    repeated non-keyframe merges keep halving the rate, never losing time."""
    k = dts_a.shape[0]
    dts = torch.cat([dts_a, dts_b])
    x = torch.cat([xa, xb])
    g = torch.cat([ga, gb])
    v = torch.cat([va, vb])
    order = torch.argsort((~v).to(torch.int8), stable=True)   # valid first, stable
    dts, x, g, v = dts[order], x[order], g[order], v[order]
    n_valid = torch.sum(v)

    # decimated path: fuse pairs (2i, 2i+1) → K slots
    v1, v2 = v[0::2], v[1::2]
    dd = dts[0::2] * v1 + dts[1::2] * v2
    xd = torch.where(v2[:, None], x[1::2], x[0::2])
    gd = torch.where(v2[:, None], g[1::2], g[0::2])
    vd = v1 | v2
    overflow = n_valid > k
    # plain path: first K samples (correct when they fit)
    return (
        torch.where(overflow, dd, dts[:k]),
        torch.where(overflow, xd, x[:k]),
        torch.where(overflow, gd, g[:k]),
        torch.where(overflow, vd, v[:k]),
    )


def _set_two_newest(a: Tensor, second_last: Tensor, last: Tensor) -> Tensor:
    return torch.cat([a[:-2], second_last[None], last[None]], dim=0)


def slide_new_imu_buffer(buf: ImuWindowBuffer) -> ImuWindowBuffer:
    """MARGIN_SECOND_NEW: merge interval F-1 into F-2's successor — the new
    last interval covers (F-3, F-1]. Samples compact front-of-buffer; an
    interval that overflows capacity K is decimated (see ``_merge_padded``).
    """
    f = buf.dts.shape[0]
    d, a, g, v = _merge_padded(
        buf.dts[f - 2], buf.acc[f - 2], buf.gyr[f - 2], buf.valid[f - 2],
        buf.dts[f - 1], buf.acc[f - 1], buf.gyr[f - 1], buf.valid[f - 1],
    )
    return ImuWindowBuffer(
        dts=_set_two_newest(buf.dts, d, torch.zeros_like(d)),
        acc=_set_two_newest(buf.acc, a, buf.acc[f - 1]),
        gyr=_set_two_newest(buf.gyr, g, buf.gyr[f - 1]),
        valid=_set_two_newest(buf.valid, v, torch.zeros_like(v)),
        acc0=buf.acc0,
        gyr0=buf.gyr0,
    )


def slide_new_wheel_buffer(buf: WheelWindowBuffer) -> WheelWindowBuffer:
    f = buf.dts.shape[0]
    d, a, g, v = _merge_padded(
        buf.dts[f - 2], buf.vel[f - 2], buf.gyr[f - 2], buf.valid[f - 2],
        buf.dts[f - 1], buf.vel[f - 1], buf.gyr[f - 1], buf.valid[f - 1],
    )
    return WheelWindowBuffer(
        dts=_set_two_newest(buf.dts, d, torch.zeros_like(d)),
        vel=_set_two_newest(buf.vel, a, buf.vel[f - 1]),
        gyr=_set_two_newest(buf.gyr, g, buf.gyr[f - 1]),
        valid=_set_two_newest(buf.valid, v, torch.zeros_like(v)),
        vel0=buf.vel0,
        gyr0=buf.gyr0,
        # a merged interval is bad if either constituent was
        bad=_set_two_newest(buf.bad, buf.bad[f - 2] | buf.bad[f - 1],
                            torch.zeros_like(buf.bad[0])),
    )
