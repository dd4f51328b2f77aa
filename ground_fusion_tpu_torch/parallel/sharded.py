"""Sharded execution on ``torch.distributed``: the data-parallel fleet and
the edge-sharded 4-DoF pose graph.

Two of the JAX package's three scaling axes (``parallel/sharded.py`` there):

- **the fleet** (the sequence axis): B estimator cores, batched as
  ``make_window_burst_batched`` takes them, split over the ranks; each rank
  advances its B/world sequences with no communication, and one gather
  returns the whole fleet to every rank;
- **the pose graph** (the edge axis): each rank linearizes its share of the
  edges (``pose_graph.linearize_edges``, the code of the single-device
  solve) and the partial normal equations H = JᵀJ and g = Jᵀr are summed
  over the ranks once per Gauss-Newton iteration; the damped Cholesky solve
  runs replicated.

The third axis, the landmark-sharded window step, is not ported (it needs a
distributed Schur elimination through the solver, assembly and
marginalization).

Every collective is a summing ``all_reduce``: the gather is a sum of
zero-padded buffers in which each rank fills its own rows. So the same code
runs on NCCL with a card per rank and on Gloo, which for CUDA tensors offers
only ``broadcast``, ``all_reduce`` and ``barrier`` (two ranks on one card,
or ranks on the CPU). Every function takes a process group (default: the
world). Nothing falls back to an unsharded run: a group that fails to form
raises.

Usage (one process per rank)::

    dev = init_group(rank, world_size, "tcp://localhost:29500")
    fleet = make_sharded_fleet(cfg, dev)
    cores, outs = fleet(cores, flags_batch)        # the whole fleet, every rank
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


# ---------------------------------------------------------------------------
# the fleet (sequence axis)
# ---------------------------------------------------------------------------


def _rows(b: int, group):
    """This rank's rows [lo, hi) of a batch of ``b``; raises unless the
    world divides ``b``."""
    rank, world = _rank_world(group)
    if b % world:
        raise ValueError(f"fleet batch B={b} not divisible by world size {world}")
    n = b // world
    return rank * n, rank * n + n


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
