"""4-DoF pose-graph relaxation + host keyframe graph with drift broadcast.

Device side re-designs ``PoseGraph::optimize4DoF``
(``dense_map/src/pose_graph.cpp:529-705``: per-KF yaw + translation, Ceres
autodiff ``FourDOFError``/``FourDOFWeightError`` (pose_graph.h:199-288),
sequential edges to 4 predecessors, loop edges with yaw/10 weighting, first
looped keyframe held fixed): all edges linearize batched by forward-mode AD
(``torch.func.jacfwd`` under ``vmap``) into dense rows over the padded
[4·MAX_KF] state, and the graph relaxes with a fixed number of GN iterations
— one Cholesky each. The solvers run in float64 on the device.

Host side mirrors ``PoseGraph::addKeyFrame``/``detectLoop``/``findConnection``
(pose_graph.cpp:77-512, keyframe.cpp:194-352) using the device functions of
:mod:`.brief`, :mod:`.bow`, :mod:`.pnp`, plus the drift composition applied
to keyframes after the optimized span (pose_graph.cpp:674-696). Keyframes
keep host numpy copies (descriptors as uint32 words, as the JAX package
keeps them); each device call uploads what it needs and fetches its result
once."""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor
from torch.func import jacfwd, vmap

from .. import resolve_device
from ..geometry.so3 import (
    mat_to_quat,
    mat_to_ypr,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate_inv,
    quat_to_mat,
    ypr_to_mat,
)
from ..utils import np_quat
from .bow import KeyframeDatabase, bow_histogram, word_selector, words_of
from .brief import brief_describe, brief_pattern, fast_detect, match_brief
from .pnp import gumbel_noise, pnp_ransac


def _host(fn, *arrays) -> np.ndarray:
    """Apply a geometry function of the port to host arrays in float64."""
    return fn(*[torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]).numpy()


def _normalize_angle(a: Tensor) -> Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def _cholesky_solve(H: Tensor, g: Tensor) -> Tensor:
    """x = H⁻¹g by Cholesky; all NaN where H is not positive definite (as
    ``jnp.linalg.cholesky`` returns NaN where ``torch.linalg.cholesky``
    raises)."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(g[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, torch.nan))


class GraphEdges(NamedTuple):
    """Padded edge table for the 4-DoF graph."""

    i: Tensor        # [E] int64
    j: Tensor        # [E]
    t_ij: Tensor     # [E,3] relative translation in frame i (yaw-frame)
    yaw_ij: Tensor   # [E] relative yaw
    pitch_i: Tensor  # [E] fixed pitch of node i (from VIO)
    roll_i: Tensor   # [E]
    w_t: Tensor      # [E] translation weight
    w_yaw: Tensor    # [E] yaw weight (sequential 1, loop 1/10 — the
                     #     FourDOFWeightError /10 factor)
    valid: Tensor    # [E] bool


def edge_residual(yaw_i, t_i, yaw_j, t_j, e_tij, e_yaw, pitch_i, roll_i, w_t, w_yaw):
    """FourDOFError (pose_graph.h:199-241): translation expressed in node i's
    full (yaw,pitch,roll) frame, yaw difference normalized."""
    Ri = ypr_to_mat(torch.stack([yaw_i, pitch_i, roll_i]))
    r_t = (Ri.T @ (t_j - t_i) - e_tij) * w_t
    r_y = _normalize_angle(yaw_j - yaw_i - e_yaw) * w_yaw
    return torch.cat([r_t, r_y[None]])


def _edge_blocks(yaws: Tensor, ts: Tensor, edges: GraphEdges):
    """Per-edge forward-AD linearization: residuals [E,4] and the compact
    endpoint Jacobian blocks [E,4,8] (cols 0:4 = node i's (yaw,t), 4:8 =
    node j's). Invalid edges are zeroed. O(E) memory — the building block
    for both the dense-row solve and the matrix-free PCG solve."""
    dtype = ts.dtype

    def one(yi, ti, yj, tj, tij, yij, pi, ri, wt, wy, ok):
        def r_of(d):
            return edge_residual(yi + d[0], ti + d[1:4], yj + d[4], tj + d[5:8],
                                 tij, yij, pi, ri, wt, wy)

        z = torch.zeros(8, dtype=dtype, device=ts.device)
        w = ok.to(dtype)
        return r_of(z) * w, jacfwd(r_of)(z) * w

    return vmap(one)(yaws[edges.i], ts[edges.i], yaws[edges.j], ts[edges.j],
                     edges.t_ij, edges.yaw_ij, edges.pitch_i, edges.roll_i,
                     edges.w_t, edges.w_yaw, edges.valid)      # [E,4], [E,4,8]


def _dense_rows(J: Tensor, cols: Tensor, n_cols: int) -> Tensor:
    """Scatter per-edge blocks [E,R,C] into dense rows [E·R, n_cols] at the
    column indices ``cols`` [E,C]."""
    e, rows, _ = J.shape
    Jd = torch.zeros((e, rows, n_cols), dtype=J.dtype, device=J.device)
    ar_e = torch.arange(e, device=J.device)[:, None, None]
    ar_r = torch.arange(rows, device=J.device)[None, :, None]
    Jd[ar_e, ar_r, cols[:, None, :]] = J
    return Jd.reshape(e * rows, n_cols)


def linearize_edges(yaws: Tensor, ts: Tensor, edges: GraphEdges, n: int):
    """Batched forward-AD linearization of every 4-DoF edge into dense rows
    over the [4·N] state; invalid edges are zero rows."""
    r, J = _edge_blocks(yaws, ts, edges)
    ar3 = torch.arange(3, device=ts.device)[None, :]
    i4, j4 = (4 * edges.i)[:, None], (4 * edges.j)[:, None]
    cols = torch.cat([i4, i4 + 1 + ar3, j4, j4 + 1 + ar3], dim=1)   # [E,8]
    return _dense_rows(J, cols, 4 * n), r.reshape(-1)


def optimize_4dof(yaws: Tensor, ts: Tensor, node_valid: Tensor, fixed: Tensor,
                  edges: GraphEdges, iters: int = 5):
    """GN relaxation of the padded graph. yaws [N], ts [N,3]; ``fixed`` masks
    nodes held constant (the first looped keyframe, pose_graph.cpp:596-603).
    """
    n = yaws.shape[0]
    free4 = (node_valid & ~fixed).to(ts.dtype).repeat_interleave(4)
    for _ in range(iters):
        Jd, r = linearize_edges(yaws, ts, edges, n)
        Jd = Jd * free4[None, :]
        H = Jd.T @ Jd
        g = Jd.T @ r
        damp = 1e-6 * torch.diagonal(H) + 1e-8 + (1.0 - free4)
        dx = (_cholesky_solve(H + torch.diag(damp), -g) * free4).reshape(n, 4)
        yaws, ts = yaws + dx[:, 0], ts + dx[:, 1:4]
    return yaws, ts


def _pcg(Hv, Minv, g: Tensor, iters: int) -> Tensor:
    """Preconditioned conjugate gradients for H·x = −g with a fixed trip
    count. ``Hv`` and ``Minv`` are linear operators over ``g``'s shape;
    divisions are guarded so converged/degenerate iterations are no-ops."""
    def dot(a, b):
        return torch.sum(a * b)

    x = torch.zeros_like(g)
    r = -g
    z = Minv(r)
    p = z
    rz = dot(r, z)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Hp = Hv(p)
        pHp = dot(p, Hp)
        alpha = torch.where(pHp > 0, rz / torch.where(pHp > 0, pHp, torch.ones_like(pHp)), zero)
        x = x + alpha * p
        r = r - alpha * Hp
        z = Minv(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, torch.ones_like(rz)), zero)
        p = z + beta * p
        rz = rz_new
    return x


def _block_pcg_step(r: Tensor, J: Tensor, edges, free: Tensor, n: int, cg_iters: int) -> Tensor:
    """One matrix-free GN step from per-edge residuals [E,R] and endpoint
    blocks [E,R,2D]: the normal equations are never formed, each CG step is
    two batched einsums plus scatter-adds, preconditioned by the inverted
    D×D block diagonal. Returns dx [N,D] (zero on fixed nodes)."""
    dtype = J.dtype
    dof = J.shape[2] // 2
    colmask = torch.cat([free[edges.i][:, None].expand(-1, dof),
                         free[edges.j][:, None].expand(-1, dof)], dim=1)
    J = J * colmask[:, None, :]

    def scatter(blk_i, blk_j, shape):
        out = torch.zeros(shape, dtype=dtype, device=J.device)
        return out.index_add(0, edges.i, blk_i).index_add(0, edges.j, blk_j)

    ge = torch.einsum("eck,ec->ek", J, r)                   # [E,2D] = Jᵀr per edge
    g = scatter(ge[:, :dof], ge[:, dof:], (n, dof))
    Ji, Jj = J[:, :, :dof], J[:, :, dof:]
    Pblk = scatter(torch.einsum("eci,ecj->eij", Ji, Ji), torch.einsum("eci,ecj->eij", Jj, Jj),
                   (n, dof, dof))
    diag_h = torch.diagonal(Pblk, dim1=1, dim2=2)
    damp = 1e-6 * diag_h + 1e-8 + (1.0 - free)[:, None]    # [N,D]
    Pinv = torch.linalg.inv_ex(Pblk + torch.diag_embed(damp))[0]

    def Hv(v):
        ve = torch.cat([v[edges.i], v[edges.j]], dim=1)     # [E,2D]
        Jv = torch.einsum("eck,ek->ec", J, ve)
        JtJv = torch.einsum("eck,ec->ek", J, Jv)
        return scatter(JtJv[:, :dof], JtJv[:, dof:], (n, dof)) + damp * v

    return _pcg(Hv, lambda v: torch.einsum("nij,nj->ni", Pinv, v), g, cg_iters) * free[:, None]


def optimize_4dof_cg(yaws: Tensor, ts: Tensor, node_valid: Tensor, fixed: Tensor,
                     edges: GraphEdges, iters: int = 5, cg_iters: int = 256):
    """Matrix-free GN relaxation for LARGE graphs — the scale path past the
    dense-Cholesky bucket. Semantics match :func:`optimize_4dof` (same
    residuals, damping, fixed-node handling); H = JᵀJ is never materialized.
    ``cg_iters`` must cover the graph diameter (callers pick ~n/2 for a
    4-predecessor chain). The reference reaches the same scale through Ceres'
    SPARSE_NORMAL_CHOLESKY on an unbounded graph (pose_graph.cpp:529-705)."""
    n = yaws.shape[0]
    free = (node_valid & ~fixed).to(ts.dtype)
    for _ in range(iters):
        r, J = _edge_blocks(yaws, ts, edges)            # [E,4], [E,4,8]
        dx = _block_pcg_step(r, J, edges, free, n, cg_iters)
        yaws, ts = yaws + dx[:, 0], ts + dx[:, 1:4]
    return yaws, ts


class GraphEdges6(NamedTuple):
    """Padded edge table for the 6-DoF graph (``optimize6DoF``)."""

    i: Tensor        # [E] int64
    j: Tensor        # [E]
    t_ij: Tensor     # [E,3] relative translation in frame i
    q_ij: Tensor     # [E,4] relative rotation (wxyz), frame i → j
    w_t: Tensor      # [E] translation weight (1/t_var, reference 1/0.1)
    w_q: Tensor      # [E] rotation weight (1/q_var, reference 1/0.01)
    valid: Tensor    # [E] bool


def edge_residual_6dof(q_i, t_i, q_j, t_j, e_tij, e_qij, w_t, w_q):
    """RelativeRTError (global_fusion Factors.h:52 — the same autodiff cost
    ``optimize6DoF`` builds, pose_graph.cpp:785-795): translation expressed
    in node i's full rotation frame; rotation residual is the vector part of
    the error quaternion."""
    r_t = (quat_rotate_inv(q_i, t_j - t_i) - e_tij) * w_t
    q_rel = quat_mul(quat_conj(q_i), q_j)
    dq = quat_mul(quat_conj(e_qij), q_rel)
    r_q = 2.0 * dq[1:4] * torch.sign(dq[0]) * w_q
    return torch.cat([r_t, r_q])


def _quat_boxplus(q: Tensor, dth: Tensor) -> Tensor:
    one = torch.ones_like(dth[..., 0:1])
    return quat_normalize(quat_mul(q, torch.cat([one, 0.5 * dth], dim=-1)))


def _edge_blocks_6dof(quats: Tensor, ts: Tensor, edges: GraphEdges6):
    """6-DoF twin of :func:`_edge_blocks`: residuals [E,6] + endpoint tangent
    Jacobians [E,6,12] (δθ(3)+δt(3) per node)."""
    dtype = ts.dtype

    def one(qi, ti, qj, tj, tij, qij, wt, wq, ok):
        def r_of(d):
            return edge_residual_6dof(_quat_boxplus(qi, d[0:3]), ti + d[3:6],
                                      _quat_boxplus(qj, d[6:9]), tj + d[9:12],
                                      tij, qij, wt, wq)

        z = torch.zeros(12, dtype=dtype, device=ts.device)
        w = ok.to(dtype)
        return r_of(z) * w, jacfwd(r_of)(z) * w

    return vmap(one)(quats[edges.i], ts[edges.i], quats[edges.j], ts[edges.j],
                     edges.t_ij, edges.q_ij, edges.w_t, edges.w_q, edges.valid)


def linearize_edges_6dof(quats: Tensor, ts: Tensor, edges: GraphEdges6, n: int):
    """Batched forward-AD linearization of every 6-DoF edge into dense rows
    over the [6·N] tangent (δθ(3) + δt(3) per node)."""
    r, J = _edge_blocks_6dof(quats, ts, edges)
    ar6 = torch.arange(6, device=ts.device)[None, :]
    cols = torch.cat([(6 * edges.i)[:, None] + ar6, (6 * edges.j)[:, None] + ar6], dim=1)
    return _dense_rows(J, cols, 6 * n), r.reshape(-1)


def _retract_6dof(quats: Tensor, ts: Tensor, dx: Tensor):
    return _quat_boxplus(quats, dx[:, 0:3]), ts + dx[:, 3:6]


def optimize_6dof(quats: Tensor, ts: Tensor, node_valid: Tensor, fixed: Tensor,
                  edges: GraphEdges6, iters: int = 5):
    """Full-SE(3) graph relaxation (``PoseGraph::optimize6DoF``,
    pose_graph.cpp:707-860): per-KF quaternion + translation, sequential
    edges to 4 predecessors and loop edges as RelativeRTError, first looped
    keyframe fixed. quats [N,4] wxyz, ts [N,3]."""
    n = quats.shape[0]
    free6 = (node_valid & ~fixed).to(ts.dtype).repeat_interleave(6)
    for _ in range(iters):
        Jd, r = linearize_edges_6dof(quats, ts, edges, n)
        Jd = Jd * free6[None, :]
        H = Jd.T @ Jd
        g = Jd.T @ r
        damp = 1e-6 * torch.diagonal(H) + 1e-8 + (1.0 - free6)
        dx = (_cholesky_solve(H + torch.diag(damp), -g) * free6).reshape(n, 6)
        quats, ts = _retract_6dof(quats, ts, dx)
    return quats, ts


def optimize_6dof_cg(quats: Tensor, ts: Tensor, node_valid: Tensor, fixed: Tensor,
                     edges: GraphEdges6, iters: int = 5, cg_iters: int = 256):
    """Matrix-free PCG variant of :func:`optimize_6dof` for large graphs —
    the 6-DoF twin of :func:`optimize_4dof_cg` (block-Jacobi preconditioned,
    [E,6,12] einsum matvecs, fixed trip counts)."""
    n = quats.shape[0]
    free = (node_valid & ~fixed).to(ts.dtype)
    for _ in range(iters):
        r, J = _edge_blocks_6dof(quats, ts, edges)     # [E,6], [E,6,12]
        quats, ts = _retract_6dof(quats, ts, _block_pcg_step(r, J, edges, free, n, cg_iters))
    return quats, ts


def _pad_pow2(x: int, lo: int) -> int:
    """Next power-of-two ≥ max(x, lo) — the shape buckets over an unboundedly
    growing graph (they fix the padded shapes, and so the numbers the tests
    compare with the JAX package)."""
    n = lo
    while n < x:
        n *= 2
    return n


class Keyframe(NamedTuple):
    index: int
    t: float
    pose: np.ndarray          # [7] drift-corrected world_T_body (updatePose)
    kp: np.ndarray            # [K,2] pixel keypoints
    kp_norm: np.ndarray       # [K,2] normalized
    desc: np.ndarray          # [K,8] uint32 packed BRIEF
    kp_ok: np.ndarray         # [K]
    win_pts3d: np.ndarray     # [M,3] window landmarks (world)
    win_norm: np.ndarray      # [M,2] their normalized obs in this KF
    win_desc: np.ndarray      # [M,8] BRIEF at the VIO feature pixels
    win_ok: np.ndarray        # [M]
    vio_pose: Optional[np.ndarray] = None   # [7] raw VIO pose (getVioPose) —
                              # sequential edges and optimize() initial values
                              # are built from THIS, exactly like the
                              # reference (pose_graph.cpp:581-612), so
                              # repeated optimizes never compound


class PoseGraph:
    """Host keyframe graph: place recognition, geometric verification, 4-DoF
    relaxation in the background cadence, drift broadcast. ``device=None``
    means the GPU (raises without one)."""

    # dense-Cholesky bucket limit: graphs padded past this many nodes take
    # the matrix-free PCG path (optimize_4dof_cg) instead of dense rows
    DENSE_NODE_LIMIT = 256
    N_HYPOTHESES = 64          # pnp_ransac's fixed bank

    def __init__(self, cfg, max_kf: int = 512, cam_focal: float = 460.0, device=None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        # initial DB allocation only — the database and keyframe list are
        # unbounded (the DB doubles, optimize() pads to power-of-two buckets)
        self.max_kf = max_kf
        if cfg.loop.vocab_path:
            # trained DBoW2 vocabulary (brief_k10L6.bin import,
            # pose_graph_node.cpp:788-790): reference-comparable scores, so
            # the reference's own gates apply
            from .dbow_vocab import DBoW2Vocabulary, SparseBowDatabase

            self.vocab = DBoW2Vocabulary.load_binary(cfg.loop.vocab_path, device=self.device)
            self.db = SparseBowDatabase(
                self.vocab, capacity=max_kf, score_best=cfg.loop.dbow_score_best,
                score_min=cfg.loop.dbow_score_min, min_gap=cfg.loop.min_loop_gap)
        else:
            self.vocab = None
            self.db = KeyframeDatabase(
                capacity=max_kf, score_best=cfg.loop.bow_score_best,
                score_min=cfg.loop.bow_score_min, min_gap=cfg.loop.min_loop_gap,
                device=self.device)
        self.sel = torch.as_tensor(word_selector(), device=self.device)
        pa, pb = brief_pattern()
        self.pat_a = torch.as_tensor(pa, device=self.device)
        self.pat_b = torch.as_tensor(pb, device=self.device)
        self.kfs: list[Keyframe] = []
        self.loop_edges: list[tuple] = []
        self.r_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        self.earliest_loop = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.describes = collections.Counter()   # device type → describe() calls
        self.match_calls = 0                     # match_brief() calls

    def _upload_desc(self, desc: np.ndarray) -> Tensor:
        """Host uint32 words → the device's int32 bit patterns."""
        return torch.as_tensor(np.ascontiguousarray(desc, np.uint32).view(np.int32),
                               device=self.device)

    def _f64(self, a) -> Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    def draw_pnp_noise(self, n: int) -> Tensor:
        """The Gumbel draws that pick the RANSAC minimal sets, [64, n] f64."""
        return gumbel_noise(self.N_HYPOTHESES, n, self.generator, torch.float64, self.device)

    # ------------------------------------------------------------ keyframes

    def describe(self, img: np.ndarray, win_pts2d: Optional[np.ndarray] = None):
        """FAST + BRIEF for a keyframe image on the device; also describes
        the VIO window feature pixels (computeWindowBRIEFPoint,
        keyframe.cpp:148-158). One device→host fetch; returns numpy
        (pts, ok, desc uint32, win_desc uint32 or None)."""
        img_t = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        pts, ok = fast_detect(img_t, self.cfg.loop.fast_threshold, self.cfg.loop.max_keypoints)
        desc = brief_describe(img_t, pts, self.pat_a, self.pat_b)
        parts = [pts.contiguous().view(torch.int32).reshape(-1), ok.to(torch.int32),
                 desc.reshape(-1)]
        m = 0
        if win_pts2d is not None and len(win_pts2d):
            m = len(win_pts2d)
            win = torch.as_tensor(np.asarray(win_pts2d, np.float32), device=self.device)
            parts.append(brief_describe(img_t, win, self.pat_a, self.pat_b).reshape(-1))
        self.describes[desc.device.type] += 1
        flat = torch.cat(parts).cpu().numpy()
        k = pts.shape[0]
        pts_np = flat[: 2 * k].view(np.float32).reshape(k, 2)
        ok_np = flat[2 * k : 3 * k] != 0
        desc_np = flat[3 * k : 11 * k].view(np.uint32).reshape(k, 8)
        win_desc = flat[11 * k :].view(np.uint32).reshape(m, 8) if m else None
        return pts_np, ok_np, desc_np, win_desc

    def add_keyframe(self, kf: Keyframe, detect_loop: bool = True):
        """addKeyFrame (pose_graph.cpp:77-307): drift-correct the incoming
        pose, BoW-register, attempt loop detection + verification. The raw
        VIO pose is kept alongside (updateVioPose/getVioPose)."""
        vio_pose = np.array(kf.pose, np.float64)
        pose = vio_pose.copy()
        R = _host(quat_to_mat, pose[3:7])
        pose[0:3] = self.r_drift @ pose[0:3] + self.t_drift
        pose[3:7] = _host(mat_to_quat, self.r_drift @ R)
        kf = kf._replace(pose=pose, vio_pose=vio_pose)

        if self.vocab is not None:
            hist = self.db.bow_vector(kf.desc, kf.kp_ok)
        else:
            hist = bow_histogram(words_of(self._upload_desc(kf.desc),
                                          torch.as_tensor(kf.kp_ok, device=self.device),
                                          self.sel))
        # loop_idx is a KEYFRAME index (the DB maps slots → kf indices
        # internally); kf.index is the sequential insertion index, so it is
        # also the position in self.kfs
        loop_idx = self.db.query(hist, kf.index) if detect_loop else -1
        self.db.add(hist, kf_index=kf.index)
        self.kfs.append(kf)

        if 0 <= loop_idx < len(self.kfs) - 1:
            self._try_connect(kf, self.kfs[loop_idx])
        return loop_idx

    def _try_connect(self, cur: Keyframe, old: Keyframe):
        """findConnection (keyframe.cpp:332-430): window-BRIEF → old-KF
        matching, PnP-RANSAC, loop edge on success."""
        if cur.win_desc is None or not len(cur.win_desc):
            return False
        dev = self.device
        idx, matched = match_brief(
            self._upload_desc(cur.win_desc), torch.as_tensor(cur.win_ok, device=dev),
            self._upload_desc(old.desc), torch.as_tensor(old.kp_ok, device=dev),
            self.cfg.loop.hamming_thresh)
        self.match_calls += 1
        idx, matched = torch.stack([idx, matched.to(idx.dtype)]).cpu().numpy()
        matched = matched.astype(bool)
        if matched.sum() < self.cfg.loop.min_matches:
            return False
        obs_old = old.kp_norm[idx]                      # [M,2] matched obs in old
        # seed at old KF camera pose; solve old camera pose from cur 3-D pts
        pose_ref, _, ok = pnp_ransac(
            self._f64(old.pose), self._f64(cur.win_pts3d), self._f64(obs_old),
            torch.as_tensor(matched & cur.win_ok, device=dev),
            self.draw_pnp_noise(len(cur.win_pts3d)), min_inliers=self.cfg.loop.min_matches)
        out = torch.cat([pose_ref, ok.to(pose_ref.dtype)[None]]).cpu().numpy()
        if not out[7] > 0.5:
            return False
        # relative transform old_T_cur from PnP result. The window landmarks
        # are in the VIO frame, so the current keyframe enters with its VIO
        # pose, as findConnection takes origin_vio_T/R (keyframe.cpp); the
        # JAX package takes the drift-corrected pose, which is wrong by the
        # drift once a relaxation has run (ROADMAP queue 3)
        T_old = out[0:7]
        cur_pose = cur.vio_pose if cur.vio_pose is not None else cur.pose
        R_old = _host(quat_to_mat, T_old[3:7])
        R_cur = _host(quat_to_mat, cur_pose[3:7])
        t_rel = R_old.T @ (cur_pose[0:3] - T_old[0:3])
        R_rel = R_old.T @ R_cur
        yaw_rel = float(_host(mat_to_ypr, R_rel)[0])
        q_rel = _host(mat_to_quat, R_rel)
        self.loop_edges.append((old.index, cur.index, t_rel, yaw_rel, q_rel))
        if self.earliest_loop is None or old.index < self.earliest_loop:
            self.earliest_loop = old.index
        return True

    # ------------------------------------------------------------- optimize

    def _span(self):
        """(base, raw VIO poses [n,7]) of the keyframes from the first looped
        one on — the only ones that take part; both the initial values and
        the sequential-edge measurements come from RAW VIO poses, so repeated
        optimizes never compound (pose_graph.cpp:573-612)."""
        base = self.earliest_loop if self.earliest_loop is not None else 0
        poses = np.stack([k.vio_pose if k.vio_pose is not None else k.pose
                          for k in self.kfs[base:]])
        return base, poses

    def optimize(self, iters: int = 5):
        """optimize4DoF over all keyframes — or the full-SE(3) optimize6DoF
        variant (pose_graph.cpp:707-860) when ``loop.graph_6dof`` is set;
        updates the drift (pose_graph.cpp:529-705)."""
        if not self.loop_edges or len(self.kfs) < 2:
            return
        if self.cfg.loop.graph_6dof:
            return self._optimize_6dof(iters)
        base, poses = self._span()
        n = len(poses)
        Rs = _host(quat_to_mat, poses[:, 3:7])
        ypr = _host(mat_to_ypr, Rs)
        yaws = ypr[:, 0].copy()
        ts = poses[:, 0:3].copy()

        seq_edges = []
        for j in range(1, n):
            for back in range(1, 5):                      # 4 predecessors
                i = j - back
                if i < 0:
                    break
                t_ij = Rs[i].T @ (ts[j] - ts[i])
                seq_edges.append((i, j, t_ij, yaws[j] - yaws[i], ypr[i, 1], ypr[i, 2], 1.0, 1.0))
        for (gi, gj, t_rel, yaw_rel, *_rest) in self.loop_edges:
            i, j = gi - base, gj - base                   # local span indices
            seq_edges.append((i, j, t_rel, yaw_rel, ypr[i, 1], ypr[i, 2],
                              1.0, 0.1))                  # yaw/10 loop weight

        # pad nodes and edges to power-of-two buckets (the JAX package's
        # compile buckets; they fix the shapes and so the rounding)
        e = len(seq_edges)
        n_pad = _pad_pow2(n, 16)
        e_pad = _pad_pow2(e, 64)

        def col(k):
            a = np.zeros(e_pad)
            a[:e] = [s[k] for s in seq_edges]
            return a

        tij = np.zeros((e_pad, 3))
        tij[:e] = np.stack([s[2] for s in seq_edges])
        dev = self.device
        E = GraphEdges(
            i=torch.as_tensor(col(0).astype(np.int64), device=dev),
            j=torch.as_tensor(col(1).astype(np.int64), device=dev),
            t_ij=self._f64(tij), yaw_ij=self._f64(col(3)),
            pitch_i=self._f64(col(4)), roll_i=self._f64(col(5)),
            w_t=self._f64(col(6)), w_yaw=self._f64(col(7)),
            valid=torch.as_tensor(np.arange(e_pad) < e, device=dev),
        )
        node_valid = np.arange(n_pad) < n
        fixed = np.zeros(n_pad, bool)
        fixed[0] = True       # local 0 == first looped keyframe (span base)
        yaws_p = np.zeros(n_pad)
        yaws_p[:n] = yaws
        ts_p = np.zeros((n_pad, 3))
        ts_p[:n] = ts
        args = (self._f64(yaws_p), self._f64(ts_p), torch.as_tensor(node_valid, device=dev),
                torch.as_tensor(fixed, device=dev), E)
        if n_pad <= self.DENSE_NODE_LIMIT:
            new_yaws, new_ts = optimize_4dof(*args, iters=iters)
        else:
            new_yaws, new_ts = optimize_4dof_cg(*args, iters=iters, cg_iters=max(64, n_pad // 2))
        out = torch.cat([new_yaws[:n, None], new_ts[:n]], dim=1).cpu().numpy()
        new_yaws, new_ts = out[:, 0], out[:, 1:4]

        # write back optimized poses over the span (rotations = yaw
        # correction on the VIO rotation, q_z(dy) ⊗ q_vio); drift = newest
        # optimized vs its VIO pose (pose_graph.cpp:657-681: updatePose loop
        # then yaw_drift, r_drift = R(yaw_drift), t_drift = t_opt − r_drift · t_vio)
        for k in range(n):
            dy = new_yaws[k] - yaws[k]
            qz = np.array([np.cos(dy / 2), 0.0, 0.0, np.sin(dy / 2)])
            p = np.empty(7)
            p[0:3] = new_ts[k]
            p[3:7] = np_quat.quat_normalize(np_quat.quat_mul(qz, poses[k, 3:7]))
            self.kfs[base + k] = self.kfs[base + k]._replace(pose=p)
        dy = new_yaws[n - 1] - yaws[n - 1]
        self.r_drift = _host(ypr_to_mat, [dy, 0.0, 0.0])
        self.t_drift = new_ts[n - 1] - self.r_drift @ ts[n - 1]

    def _optimize_6dof(self, iters: int = 5):
        """optimize6DoF (pose_graph.cpp:707-860): every keyframe carries a
        full quaternion + translation; sequential edges to 4 predecessors and
        loop edges become RelativeRTError rows with the reference's 0.1/0.01
        variances; drift is the full rotation correction of the newest pose
        (pose_graph.cpp:849-853)."""
        base, poses = self._span()
        n = len(poses)
        quats = poses[:, 3:7].copy()
        ts = poses[:, 0:3].copy()
        Rs = _host(quat_to_mat, quats)

        W_T, W_Q = 1.0 / 0.1, 1.0 / 0.01    # RelativeRTError::Create(.., 0.1, 0.01)
        ij, t_list, R_list = [], [], []
        for j in range(1, n):
            for back in range(1, 5):
                i = j - back
                if i < 0:
                    break
                ij.append((i, j))
                t_list.append(Rs[i].T @ (ts[j] - ts[i]))
                R_list.append(Rs[i].T @ Rs[j])
        q_list = list(_host(mat_to_quat, np.stack(R_list))) if R_list else []
        for (gi, gj, t_rel, _yaw, *rest) in self.loop_edges:
            ij.append((gi - base, gj - base))
            t_list.append(t_rel)
            q_list.append(rest[0] if rest else np.array([1.0, 0, 0, 0]))

        e = len(ij)
        n_pad = _pad_pow2(n, 16)
        e_pad = _pad_pow2(e, 64)
        ij_p = np.zeros((e_pad, 2), np.int64)
        ij_p[:e] = ij
        tij = np.zeros((e_pad, 3))
        tij[:e] = np.stack(t_list)
        qij = np.zeros((e_pad, 4))
        qij[:, 0] = 1.0
        qij[:e] = np.stack(q_list)
        w = (np.arange(e_pad) < e).astype(np.float64)
        dev = self.device
        E6 = GraphEdges6(
            i=torch.as_tensor(ij_p[:, 0], device=dev), j=torch.as_tensor(ij_p[:, 1], device=dev),
            t_ij=self._f64(tij), q_ij=self._f64(qij), w_t=self._f64(w * W_T),
            w_q=self._f64(w * W_Q), valid=torch.as_tensor(w > 0, device=dev),
        )
        node_valid = np.arange(n_pad) < n
        fixed = np.zeros(n_pad, bool)
        fixed[0] = True       # local 0 == first looped keyframe (span base)
        quats_p = np.zeros((n_pad, 4))
        quats_p[:, 0] = 1.0
        quats_p[:n] = quats
        ts_p = np.zeros((n_pad, 3))
        ts_p[:n] = ts
        args = (self._f64(quats_p), self._f64(ts_p), torch.as_tensor(node_valid, device=dev),
                torch.as_tensor(fixed, device=dev), E6)
        if n_pad <= self.DENSE_NODE_LIMIT:
            new_q, new_t = optimize_6dof(*args, iters=iters)
        else:
            new_q, new_t = optimize_6dof_cg(*args, iters=iters, cg_iters=max(64, n_pad // 2))
        out = torch.cat([new_q[:n], new_t[:n]], dim=1).cpu().numpy()
        new_q, new_t = out[:, 0:4], out[:, 4:7]
        for k in range(n):
            p = np.empty(7)
            p[0:3] = new_t[k]
            p[3:7] = new_q[k]
            self.kfs[base + k] = self.kfs[base + k]._replace(pose=p)
        # full-rotation drift vs the VIO pose (pose_graph.cpp:849-853)
        R_new = _host(quat_to_mat, new_q[n - 1])
        self.r_drift = R_new @ Rs[n - 1].T
        self.t_drift = new_t[n - 1] - self.r_drift @ ts[n - 1]

    def write_tum(self, path: str) -> None:
        with open(path, "w") as fp:
            for k in self.kfs:
                p = k.pose
                fp.write(f"{k.t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                         f"{p[4]:.6f} {p[5]:.6f} {p[6]:.6f} {p[3]:.6f}\n")
