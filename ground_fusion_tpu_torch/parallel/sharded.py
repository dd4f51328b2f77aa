"""Sharded execution on ``torch.distributed``: the landmark-sharded window
step, the data-parallel fleet and the edge-sharded 4-DoF pose graph — the
JAX package's three scaling axes (``parallel/sharded.py`` there):

- **the landmarks** (the window step): each rank holds ``1/world`` of the
  landmark slots and of the line slots (:func:`shard_core`); the window
  state, the sensor buffers, the prior and the GNSS table are replicated.
  The step is the single-rank step (``estimator/step.py::_build_step``)
  with its cross-landmark sums routed through a reducer: each rank builds
  the rows of its own landmarks and lines, rank 0 adds the rows that touch
  the camera block alone, and the camera block of the normal equations, the
  Schur down-dates, the costs, the dogleg's inner products, the stationary
  vote and the frame-0 marginalization's reduced system are summed over the
  ranks. Depth and line elimination, back-substitution, triangulation, the
  culls and the slides stay on the rank. Every rank gets the same solved
  window (:func:`make_sharded_window_step`). In the JAX package GSPMD
  partitions the single-chip program; here the partition is explicit;
- **the fleet** (the sequence axis): B estimator cores, batched as
  ``make_window_burst_batched`` takes them, split over the ranks; each rank
  advances its B/world sequences with no communication, and one gather
  returns the whole fleet to every rank;
- **the pose graph** (the edge axis): each rank linearizes its share of the
  edges (``pose_graph.linearize_edges``, the code of the single-device
  solve) and the partial normal equations H = JᵀJ and g = Jᵀr are summed
  over the ranks once per Gauss-Newton iteration; the damped Cholesky solve
  runs replicated.

Every collective is a summing ``all_reduce``: a gather is a sum of
zero-padded buffers in which each rank fills its own rows. So the same code
runs on NCCL with a card per rank and on Gloo, which for CUDA tensors offers
only ``broadcast``, ``all_reduce`` and ``barrier`` (two ranks on one card,
or ranks on the CPU). Every function takes a process group (default: the
world). Nothing falls back to an unsharded run: a group that fails to form
raises, and so does a rank's collective after :data:`TIMEOUT`.

Usage (one process per rank)::

    dev = init_group(rank, world_size, "tcp://localhost:29500")
    group = make_lm_mesh(world_size)
    step, layout = make_sharded_window_step(cfg, dev, group)
    local, out = step(shard_core(core, group), flags)  # out: the same on every rank
    core = gather_core(local, group)                   # the whole core, every rank
    fleet = make_sharded_fleet(cfg, dev)
    cores, outs = fleet(cores, flags_batch)            # the whole fleet, every rank
    solve = make_sharded_pose_graph(n_nodes=24, iters=6)
    yaws, ts = solve(yaws, ts, node_valid, fixed, shard_edges(edges))
    close_group()
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor
from torch.utils import _pytree as pytree

from .. import resolve_device
from ..global_layers.pose_graph import GraphEdges, _cholesky_solve, linearize_edges


TIMEOUT = datetime.timedelta(seconds=300)    # joining the group, and each collective


def init_group(rank: int, world_size: int, address: str, backend: str | None = None,
               device=None) -> torch.device:
    """Join the default process group at ``address`` (``tcp://host:port``)
    as ``rank`` of ``world_size``; returns this rank's device. ``device=None``
    means the GPU, rank r on ``cuda:(r % device_count)`` (raises without
    one); ``device="cpu"`` keeps the rank on the CPU. ``backend`` defaults to
    ``nccl`` on the GPU and ``gloo`` on the CPU; pass ``gloo`` to put
    several ranks on one card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=address, world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    return dev


def close_group() -> None:
    """Leave and destroy the default process group."""
    dist.barrier()
    dist.destroy_process_group()


def _rank_world(group):
    return dist.get_rank(group), dist.get_world_size(group)


def _sum(t: Tensor, group) -> Tensor:
    """All-reduce (sum) of a tensor in place; boolean tensors as a count."""
    if t.dtype == torch.bool:
        u = t.to(torch.uint8)
        dist.all_reduce(u, op=dist.ReduceOp.SUM, group=group)
        return u > 0
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _rows(b: int, group, what: str = "fleet batch B"):
    """This rank's rows [lo, hi) of ``b`` rows (``what`` names them in the
    error); raises ``ValueError`` unless the world divides ``b``."""
    rank, world = _rank_world(group)
    if b % world:
        raise ValueError(f"{what}={b} not divisible by world size {world}")
    n = b // world
    return rank * n, rank * n + n


# ---------------------------------------------------------------------------
# the landmarks (window step)
# ---------------------------------------------------------------------------


def make_lm_mesh(n_devices: int, group=None):
    """The process group over the landmark axis: ``group`` (default: the
    world) when it has ``n_devices`` ranks, else a new group of its first
    ``n_devices`` ranks (``dist.new_group``, which every rank of ``group``
    must call; the other ranks take no part in the sharded step). Raises
    ``ValueError`` when ``group`` has fewer ranks."""
    world = dist.get_world_size(group)
    if world < n_devices:
        raise ValueError(f"a landmark mesh of {n_devices} ranks needs {n_devices} ranks; "
                         f"the group has {world}")
    if world == n_devices:
        return dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)[:n_devices]
    return dist.new_group(ranks=ranks, timeout=TIMEOUT)


def shard_tracks(tracks, group=None):
    """This rank's consecutive ``ML/world`` rows of every ``[ML, ...]`` leaf
    of a ``Tracks`` (or ``LineTracks``) table; raises ``ValueError`` unless
    the world divides ``ML``."""
    lo, hi = _rows(tracks.active.shape[0], group, "landmark slots ML")
    return type(tracks)(*[t[lo:hi].clone() for t in tracks])


def shard_core(core, group=None):
    """This rank's core: the landmark table and the line table (when there
    is one) cut to the rank's ``ML/world`` and ``LL/world`` slots;
    everything else (window state, sensor buffers, prior, GNSS table)
    unchanged. Raises ``ValueError`` unless the world divides ``ML``, and
    ``LL`` when there are lines."""
    if core.lines is None:
        return core._replace(tracks=shard_tracks(core.tracks, group))
    lo, hi = _rows(core.lines.active.shape[0], group, "line slots LL")
    tracks = shard_tracks(core.tracks, group)
    return core._replace(tracks=tracks, lines=type(core.lines)(*[t[lo:hi].clone()
                                                                 for t in core.lines]))


def gather_core(local, group=None):
    """The inverse of :func:`shard_core`: the whole core on every rank (a
    summing all-reduce of zero-padded tables, as :func:`gather_fleet`)."""
    world = _rank_world(group)[1]
    whole = lambda table: gather_fleet(table, world * table.active.shape[0], 0, group)
    lines = None if local.lines is None else whole(local.lines)
    return local._replace(tracks=whole(local.tracks), lines=lines)


class _Reducer:
    """The sharded step's ``reduce``: sums its tensors (one dtype) over the
    group in one all-reduce of their packed values; counts its calls."""

    def __init__(self, group):
        self.group = group
        self.rank, self.world = _rank_world(group)
        self.calls = 0

    def __call__(self, *tensors: Tensor) -> tuple:
        if len({t.dtype for t in tensors}) != 1:
            raise TypeError("reduce: the tensors of one reduction must share a dtype")
        flat = _sum(torch.cat([t.reshape(-1) for t in tensors]), self.group)
        self.calls += 1
        parts = torch.split(flat, [t.numel() for t in tensors])
        return tuple(p.reshape(t.shape) for p, t in zip(parts, tensors))


def make_sharded_window_step(cfg, device=None, group=None):
    """The per-frame window step with the landmark and line slots split over
    ``group`` (default: the world): ``step(local_core, flags) ->
    (local_core', out)``, ``local_core`` from :func:`shard_core`. ``out``
    (``pose``, ``sb``, ``cost``, ``poses``, ``failed``) and the replicated
    parts of the core are the same on every rank. Returns ``(step,
    layout)``, the layout of this rank's columns (``ML/world`` depths,
    ``LL/world`` lines). ``step.reductions`` is the number of reductions
    of its last call. ``device=None`` means the GPU (raises without one).
    Raises ``ValueError`` unless the world divides ``ML``, and ``LL`` with
    ``use_line``. Bursts and the fleet take no sharded core."""
    from ..estimator.step import _build_step

    dev = resolve_device(device)
    reducer = _Reducer(group)
    _rows(cfg.solver.max_landmarks, group, "landmark slots ML")
    if cfg.use_line:
        _rows(cfg.lines.max_lines, group, "line slots LL")
    body, layout = _build_step(cfg, dev, reducer)

    def step(local_core, flags):
        before = reducer.calls
        out = body(local_core, flags)
        step.reductions = reducer.calls - before
        return out

    step.reductions = 0
    return step, layout


# ---------------------------------------------------------------------------
# the fleet (sequence axis)
# ---------------------------------------------------------------------------


def shard_fleet(cores, flags_batch, group=None):
    """This rank's part of a fleet: ``cores`` with a leading axis B on every
    tensor, ``flags_batch`` with leading axes [K, B] (``marg_old`` a host
    bool array [K, B]). Each rank takes B/world consecutive sequences;
    raises ``ValueError`` when the world size does not divide B."""
    lo, hi = _rows(cores.state.poses.shape[0], group)
    local = pytree.tree_map_only(Tensor, lambda t: t[lo:hi], cores)
    flags = type(flags_batch)(*[
        np.asarray(v)[:, lo:hi] if name == "marg_old" else (None if v is None else v[:, lo:hi])
        for name, v in zip(flags_batch._fields, flags_batch)])
    return local, flags


def gather_fleet(local, b: int, axis: int = 0, group=None):
    """The inverse of the split: every tensor of ``local`` holds this rank's
    rows along ``axis``; returns the tree with all ``b`` rows, on every rank.
    One summing all-reduce per dtype family of zero-padded buffers (the sum
    of one value and zeros is that value, so the gather is exact)."""
    from ..estimator.step import make_packed_codec

    lo, hi = _rows(b, group)

    def padded(t: Tensor) -> Tensor:
        shape = list(t.shape)
        shape[axis] = b
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        full.narrow(axis, lo, hi - lo).copy_(t)
        return full

    full = pytree.tree_map_only(Tensor, padded, local)
    pack, unpack = make_packed_codec(full)
    return unpack([_sum(blob, group) for blob in pack(full)])


def make_sharded_fleet(cfg, device=None, group=None):
    """The fleet replay of ``make_window_burst_batched`` with the sequence
    axis split over the group: ``fleet(cores, flags_batch) -> (cores,
    outs)`` takes and returns the whole fleet (cores [B, ...], outputs
    [K, B, ...]) on every rank; each rank runs the batched burst on its
    B/world sequences."""
    from ..estimator.step import make_window_burst_batched

    burst, _ = make_window_burst_batched(cfg, device)

    def fleet(cores, flags_batch):
        b = cores.state.poses.shape[0]
        local_cores, local_flags = shard_fleet(cores, flags_batch, group)
        cb, ob = burst(local_cores, local_flags)
        return gather_fleet(cb, b, 0, group), gather_fleet(ob, b, 1, group)

    return fleet


# ---------------------------------------------------------------------------
# the pose graph (edge axis)
# ---------------------------------------------------------------------------


def shard_edges(edges: GraphEdges, group=None) -> GraphEdges:
    """Pad the edge table to a multiple of the world size (padding rows
    invalid) and return this rank's consecutive share of the rows."""
    rank, world = _rank_world(group)
    e = edges.i.shape[0]
    pad = (-e) % world

    def pad_leaf(t: Tensor) -> Tensor:
        return torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                                         device=t.device)])

    padded = GraphEdges(*[pad_leaf(t) for t in edges])     # valid pads with False
    n = (e + pad) // world
    return GraphEdges(*[t[rank * n : rank * n + n] for t in padded])


def make_sharded_pose_graph(n_nodes: int, iters: int = 5, group=None):
    """Edge-sharded 4-DoF pose-graph relaxation: ``solve(yaws [N], ts [N,3],
    node_valid, fixed, edges_local)`` with this rank's edges
    (:func:`shard_edges`) and every node replicated. Each Gauss-Newton
    iteration linearizes the local edges, sums H [4N,4N] and g [4N] over the
    group and solves the damped system on every rank — the iteration of
    ``pose_graph.optimize_4dof``, whose sums it splits."""

    def solve(yaws: Tensor, ts: Tensor, node_valid: Tensor, fixed: Tensor,
              edges_local: GraphEdges):
        free4 = (node_valid & ~fixed).to(ts.dtype).repeat_interleave(4)
        for _ in range(iters):
            Jd, r = linearize_edges(yaws, ts, edges_local, n_nodes)
            Jd = Jd * free4[None, :]
            H = _sum(Jd.T @ Jd, group)
            g = _sum(Jd.T @ r, group)
            damp = 1e-6 * torch.diagonal(H) + 1e-8 + (1.0 - free4)
            dx = (_cholesky_solve(H + torch.diag(damp), -g) * free4).reshape(n_nodes, 4)
            yaws, ts = yaws + dx[:, 0], ts + dx[:, 1:4]
        return yaws, ts

    return solve
