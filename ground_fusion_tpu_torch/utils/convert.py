"""Carry estimator and pose-graph state between the JAX package and this
port as numpy.

Both packages keep their state in NamedTuples with the same field names, so
a value is carried across by walking the names: a tuple of numpy arrays (or
any object with ``_fields``) goes in, the port's NamedTuple of tensors comes
out, and back. This module imports neither package's array library beyond
``torch``; the caller fetches the JAX arrays to the host first. Optional
tables (GNSS observations, line tracks) stay ``None`` when absent. The
estimator's GNSS host state (expansion anchor, track counts, epochs, gates)
is carried by :func:`gnss_host_state_from`. The dense map's state (voxel
hash, TSDF volume, occupancy grid) is carried into an existing map of the
port by :func:`map_state_from`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..estimator.assembly import MargPrior
from ..estimator.buffers import ImuWindowBuffer, WheelWindowBuffer
from ..estimator.lines import LineTracks
from ..estimator.step import EstimatorCore, StepFlags
from ..estimator.window import Tracks, WindowState
from ..global_layers.pose_graph import Keyframe
from ..gnss.factors import GnssObsWindow
from ..preintegration.imu import ImuPreint
from ..preintegration.wheel import WheelPreint


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _leaf(x, device, dtype):
    a = np.array(x)   # a writable host copy
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)


def _flat(cls, src, device, dtype):
    return cls(*[_leaf(_field(src, n), device, dtype) for n in cls._fields])


def state_from_numpy(src, device, dtype) -> WindowState:
    return _flat(WindowState, src, device, dtype)


def tracks_from_numpy(src, device, dtype) -> Tracks:
    return _flat(Tracks, src, device, dtype)


def imu_preint_from_numpy(src, device, dtype) -> ImuPreint:
    return _flat(ImuPreint, src, device, dtype)


def wheel_preint_from_numpy(src, device, dtype) -> WheelPreint:
    return _flat(WheelPreint, src, device, dtype)


def imu_buffer_from_numpy(src, device, dtype) -> ImuWindowBuffer:
    return _flat(ImuWindowBuffer, src, device, dtype)


def wheel_buffer_from_numpy(src, device, dtype) -> WheelWindowBuffer:
    return _flat(WheelWindowBuffer, src, device, dtype)


def prior_from_numpy(src, device, dtype) -> MargPrior:
    return MargPrior(
        J0=_leaf(_field(src, "J0"), device, dtype),
        r0=_leaf(_field(src, "r0"), device, dtype),
        lin=state_from_numpy(_field(src, "lin"), device, dtype),
        valid=_leaf(_field(src, "valid"), device, dtype),
    )


def core_from_numpy(core_np, device, dtype) -> EstimatorCore:
    """An ``EstimatorCore`` of numpy arrays (same field names) → the port's;
    a batched core (a leading axis B on every array, as the fleet's) stays
    batched."""
    return EstimatorCore(
        state=state_from_numpy(_field(core_np, "state"), device, dtype),
        tracks=tracks_from_numpy(_field(core_np, "tracks"), device, dtype),
        imu_buf=imu_buffer_from_numpy(_field(core_np, "imu_buf"), device, dtype),
        wheel_buf=wheel_buffer_from_numpy(_field(core_np, "wheel_buf"), device, dtype),
        prior=prior_from_numpy(_field(core_np, "prior"), device, dtype),
        gnss_obs=gnss_obs_from_numpy(_optional(core_np, "gnss_obs"), device, dtype),
        lines=line_tracks_from_numpy(_optional(core_np, "lines"), device, dtype),
    )


def _optional(src, name):
    if isinstance(src, dict):
        return src.get(name)
    return getattr(src, name, None)


def gnss_obs_from_numpy(src, device, dtype):
    """A GNSS observation table (same field names) → the port's, or None."""
    return None if src is None else _flat(GnssObsWindow, src, device, dtype)


def line_tracks_from_numpy(src, device, dtype):
    """A line-track table (same field names) → the port's, or None."""
    return None if src is None else _flat(LineTracks, src, device, dtype)


def flags_from_numpy(flags_np, device, dtype) -> StepFlags:
    """Step flags (same field names) → the port's. ``marg_old`` stays on the
    host: a bool for one step, a bool array for flags stacked over a burst's
    K steps (and a fleet's B sequences), whose tensors keep their leading
    axes."""
    opt = {n: _optional(flags_np, n) for n in
           ("propagate_newest", "gnss_ready", "frame_dts", "fix_yaw_enu", "first_gnss_opt")}
    marg = np.asarray(_field(flags_np, "marg_old"), bool)
    return StepFlags(
        marg_old=bool(marg) if marg.ndim == 0 else np.array(marg),
        stationary=_leaf(_field(flags_np, "stationary"), device, dtype),
        wheel_valid=_leaf(_field(flags_np, "wheel_valid"), device, dtype),
        imu_valid=_leaf(_field(flags_np, "imu_valid"), device, dtype),
        td_obs=_leaf(_field(flags_np, "td_obs"), device, dtype),
        **{n: None if v is None else _leaf(v, device, dtype) for n, v in opt.items()},
    )


def _copy_epoch(epoch: list) -> list:
    return [{k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in o.items()}
            for o in epoch]


def gnss_host_state_from(src, dst) -> None:
    """Carry an estimator's GNSS host state (either package's) into the
    port's ``dst`` in place: the float64 expansion anchor ``anc0``/``R0``,
    the per-satellite track counts, the filtered epochs, the alignment gate,
    the first-GNSS-solve flag and the raw pre-alignment epochs. The window
    tables themselves travel with the core (:func:`core_from_numpy`); the
    state's anchor column is read here too, for the host's copy of it."""
    sg, dg = src.gnss, dst.gnss
    dg.anc0 = None if sg.anc0 is None else np.array(sg.anc0, np.float64)
    dg.R0 = None if sg.R0 is None else np.array(sg.R0, np.float64)
    dg.track_count = dict(sg.track_count)
    dg.epochs = [_copy_epoch(e) for e in sg.epochs]
    dst.gnss_aligned = bool(src.gnss_aligned)
    dst._first_gnss_opt = bool(src._first_gnss_opt)
    dst._gnss_pre_epochs = [(t, _copy_epoch(e)) for t, e in src._gnss_pre_epochs]
    anc = src.core.state.anc_ecef
    dst._anc_delta = np.array(anc.cpu() if isinstance(anc, torch.Tensor) else anc, np.float64)


def to_numpy(x):
    """A tensor, or any nesting of NamedTuples/tuples/dicts of tensors, →
    the same nesting as dictionaries of numpy arrays (one host copy each)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_fields"):
        return {n: to_numpy(getattr(x, n)) for n in x._fields}
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [to_numpy(v) for v in x]
    return x


def core_to_numpy(core: EstimatorCore) -> dict:
    return to_numpy(core)


def stack_cores(cores) -> EstimatorCore:
    """B estimator cores (or any NamedTuples of tensors of one structure) →
    one with a leading batch axis B on every tensor; absent tables stay
    ``None``. The fleet step (:func:`..estimator.step.make_window_burst_batched`)
    takes and returns such a core."""
    return pytree.tree_map(
        lambda *ts: torch.stack(ts) if isinstance(ts[0], torch.Tensor) else ts[0], *cores)


def unstack_cores(core) -> list:
    """The inverse of :func:`stack_cores`: B cores (views of the batched
    tensors)."""
    n_b = core.state.poses.shape[0]
    return [pytree.tree_map_only(torch.Tensor, lambda t: t[b], core) for b in range(n_b)]


# pose-graph database tables: (device tables, host arrays, host integers)
_DB_TABLES = {
    "KeyframeDatabase": (("hists", "valid"), ("kf_idx", "doc_freq"), ("count", "capacity")),
    "SparseBowDatabase": (("db_words", "db_w", "valid"), ("kf_idx",), ("count", "capacity")),
}


def _keyframe_to_numpy(kf) -> dict:
    out = {}
    for n in Keyframe._fields:
        v = _field(kf, n)
        out[n] = v if n in ("index", "t") or v is None else np.array(v)
    return out


def pose_graph_to_numpy(pg) -> dict:
    """A pose graph (either package's, or such a dict) → a dictionary of
    host values: the keyframes, the database tables, the loop edges, the
    earliest looped keyframe and the drift."""
    db = _field(pg, "db")
    dev_names, host_names, int_names = _DB_TABLES[type(db).__name__]
    return {
        "kfs": [_keyframe_to_numpy(k) for k in _field(pg, "kfs")],
        "db": {**{n: np.array(to_numpy(_field(db, n))) for n in dev_names + host_names},
               **{n: int(_field(db, n)) for n in int_names}},
        "loop_edges": [tuple(np.array(v) if isinstance(v, np.ndarray) else v for v in e)
                       for e in _field(pg, "loop_edges")],
        "earliest_loop": _field(pg, "earliest_loop"),
        "r_drift": np.array(_field(pg, "r_drift"), np.float64),
        "t_drift": np.array(_field(pg, "t_drift"), np.float64),
    }


def pose_graph_from_numpy(src, pg) -> None:
    """Load ``src`` (a pose graph of either package, or the dictionary of
    :func:`pose_graph_to_numpy`) into the port's ``pg`` in place: keyframes,
    database tables (on ``pg``'s device), loop edges, earliest looped
    keyframe and drift. Both graphs must use the same kind of database."""
    state = pose_graph_to_numpy(src) if not isinstance(src, dict) else src
    pg.kfs = [Keyframe(**k) for k in state["kfs"]]
    db = pg.db
    dev_names, host_names, int_names = _DB_TABLES[type(db).__name__]
    for n in dev_names:
        setattr(db, n, torch.as_tensor(state["db"][n], dtype=getattr(db, n).dtype,
                                       device=getattr(db, n).device))
    for n in host_names:
        setattr(db, n, np.array(state["db"][n], dtype=getattr(db, n).dtype))
    for n in int_names:
        setattr(db, n, int(state["db"][n]))
    pg.loop_edges = list(state["loop_edges"])
    pg.earliest_loop = state["earliest_loop"]
    pg.r_drift = np.array(state["r_drift"], np.float64)
    pg.t_drift = np.array(state["t_drift"], np.float64)


_MAP_STATE = {
    "VoxelColorMap": ("counts", "color_sum", "pos_sum"),
    "TsdfVolume": ("tsdf", "weight", "color"),
    "OccupancyGrid2D": ("logodds",),
}


def map_state_from(src, dst) -> None:
    """Copy the state arrays of a dense-map object of either package (a
    ``VoxelColorMap``, ``TsdfVolume`` or ``OccupancyGrid2D``; the JAX
    package's arrays fetched to the host or not) into the port's ``dst`` of
    the same kind, in ``dst``'s dtypes and on its device. The geometry
    (voxel size, capacity, origin, resolution) must already agree."""
    names = _MAP_STATE[type(dst).__name__]
    for n in names:
        old = getattr(dst, n)
        a = np.array(getattr(src, n))
        if a.shape != tuple(old.shape):
            raise ValueError(f"{type(dst).__name__}.{n}: shape {a.shape} != {tuple(old.shape)}")
        setattr(dst, n, torch.as_tensor(a, device=old.device).to(old.dtype))
    if hasattr(dst, "origin"):
        dst.origin = np.array(src.origin, dtype=np.asarray(dst.origin).dtype)
