"""Global GPS/VIO fusion: 6-DoF pose graph with position priors.

Re-design of ``global_fusion`` (``globalOpt.{h,cpp}``: background thread
building a VIO-relative-pose chain + GPS position priors over all poses,
``Factors.h:26-50`` TError 3-dim position prior /σ, ``:52-135``
RelativeRTError 6-dim relative pose with t_var=0.1/q_var=0.01; GeographicLib
LocalCartesian geodetic↔ENU, ``globalOpt.cpp:31-41``; WGPS_T_WVIO alignment
update ``:216-226``): the whole graph linearizes batched (forward-mode AD per
edge, ``torch.func.jacfwd`` under ``vmap``) into dense rows over the [6·N]
tangent and relaxes with a fixed number of GN iterations — one Cholesky each,
in float64 on the device, as the loop graph's solvers. The host keeps the
odometry and the fixes as float64 numpy and composes each incoming pose with
the current alignment on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor
from torch.func import vmap

from .. import resolve_device
from ..estimator.factors import _jac_and_value
from ..geometry.se3 import pose_boxplus, pose_compose, pose_inverse
from ..geometry.so3 import quat_conj, quat_mul, quat_rotate_inv
from ..gnss.coords import ecef2rotation, geo2ecef
from .pose_graph import _cholesky_solve, _host


class GlobalEdges(NamedTuple):
    i: Tensor            # [E] int64 — VIO chain edges (i, i+1)
    j: Tensor
    rel: Tensor          # [E,7] measured relative pose (i frame)
    w_t: Tensor          # [E]
    w_q: Tensor          # [E]
    valid: Tensor        # [E]


class GlobalPriors(NamedTuple):
    k: Tensor            # [P] node index
    pos: Tensor          # [P,3] global position measurement
    w: Tensor            # [P,3] 1/σ per axis
    valid: Tensor        # [P]


def _rel_residual(pose_i, pose_j, rel, w_t, w_q):
    """RelativeRTError (Factors.h:52-135): translation of j in i's frame minus
    measured, quaternion difference vector, weighted."""
    q_i = pose_i[3:7]
    t_ij = quat_rotate_inv(q_i, pose_j[0:3] - pose_i[0:3])
    r_t = (t_ij - rel[0:3]) * w_t
    q_ij = quat_mul(quat_conj(q_i), pose_j[3:7])
    dq = quat_mul(quat_conj(rel[3:7]), q_ij)
    r_q = 2.0 * dq[1:4] * w_q
    return torch.cat([r_t, r_q])


def _dense(Jb: Tensor, cols: Tensor, rb: Tensor, n_cols: int):
    """Per-factor blocks ``[E, r, c]`` at global columns ``[E, c]`` → dense
    rows ``[E·r, n_cols]``."""
    e, rr, c = Jb.shape
    Jd = torch.zeros((e, rr, n_cols), dtype=Jb.dtype, device=Jb.device)
    Jd.scatter_(2, cols[:, None, :].expand(e, rr, c), Jb)
    return Jd.reshape(e * rr, n_cols), rb.reshape(-1)


def _linearize(poses: Tensor, edges: GlobalEdges, priors: GlobalPriors):
    n = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    six = torch.arange(6, device=dev)

    def edge_one(pi, pj, rel, wt, wq, ok):
        r, J = _jac_and_value(
            lambda d: _rel_residual(pose_boxplus(pi, d[0:6]), pose_boxplus(pj, d[6:12]),
                                    rel, wt, wq),
            torch.zeros(12, dtype=dtype, device=dev))
        return torch.where(ok, r, torch.zeros_like(r)), torch.where(ok, J, torch.zeros_like(J))

    r_e, J_e = vmap(edge_one)(poses[edges.i], poses[edges.j], edges.rel, edges.w_t,
                              edges.w_q, edges.valid)
    cols_e = torch.cat([(6 * edges.i)[:, None] + six[None, :],
                        (6 * edges.j)[:, None] + six[None, :]], dim=1)

    def prior_one(pk, pos, w, ok):
        r, J = _jac_and_value(lambda d: (pose_boxplus(pk, d)[0:3] - pos) * w,
                              torch.zeros(6, dtype=dtype, device=dev))
        return torch.where(ok, r, torch.zeros_like(r)), torch.where(ok, J, torch.zeros_like(J))

    r_p, J_p = vmap(prior_one)(poses[priors.k], priors.pos, priors.w, priors.valid)
    cols_p = (6 * priors.k)[:, None] + six[None, :]
    J1, r1 = _dense(J_e, cols_e, r_e, 6 * n)
    J2, r2 = _dense(J_p, cols_p, r_p, 6 * n)
    return torch.cat([J1, J2]), torch.cat([r1, r2])


def optimize_global(poses: Tensor, node_valid: Tensor, edges: GlobalEdges,
                    priors: GlobalPriors, iters: int = 5) -> Tensor:
    """GN over the [N,7] pose array; node 0 held only through the priors (as
    the reference: the first pose is constrained by its GPS prior). A
    factorization that fails gives an all-NaN step, as in the JAX package."""
    n = poses.shape[0]
    free = node_valid.to(poses.dtype).repeat_interleave(6)
    for _ in range(iters):
        J, r = _linearize(poses, edges, priors)
        J = J * free[None, :]
        H = J.T @ J
        g = J.T @ r
        damp = 1e-6 * torch.diagonal(H) + 1e-8 + (1.0 - free)
        dx = _cholesky_solve(H + torch.diag(damp), -g) * free
        poses = pose_boxplus(poses, dx.reshape(n, 6))
    return poses


class GlobalFusion:
    """Host wrapper: ingest VIO odometry + GPS fixes, optimize, maintain the
    WGPS_T_WVIO alignment (globalOpt.cpp:43-236). ``device=None`` means the
    GPU (raises without one); the solve runs there in float64."""

    def __init__(self, max_poses: int = 1024, t_var: float = 0.1, q_var: float = 0.01,
                 device=None):
        self.device = resolve_device(device)
        self.max_poses = max_poses
        self.w_t = 1.0 / t_var
        self.w_q = 1.0 / q_var
        self.vio_poses: list[np.ndarray] = []
        self.times: list[float] = []
        self.gps: dict[int, tuple[np.ndarray, float]] = {}   # idx -> (enu, acc)
        self.ref_lla: Optional[np.ndarray] = None
        self.wgps_T_wvio = np.concatenate([np.zeros(3), [1.0, 0.0, 0.0, 0.0]])
        self.global_poses: list[np.ndarray] = []

    def input_odom(self, t: float, pose7: np.ndarray):
        self.vio_poses.append(np.asarray(pose7, np.float64))
        self.times.append(t)
        self.global_poses.append(_host(pose_compose, self.wgps_T_wvio, pose7))
        if len(self.vio_poses) > self.max_poses:
            self.vio_poses.pop(0)
            self.times.pop(0)
            self.global_poses.pop(0)
            self.gps = {k - 1: v for k, v in self.gps.items() if k > 0}

    def input_gps(self, t: float, lat_deg: float, lon_deg: float, alt: float,
                  accuracy: float):
        """NavSatFix → local ENU via the first fix as datum
        (globalOpt.cpp:97-105 GPS2XYZ)."""
        lla = np.array([np.deg2rad(lat_deg), np.deg2rad(lon_deg), alt])
        if self.ref_lla is None:
            self.ref_lla = lla
            self.ref_ecef = geo2ecef(lla)
            self.ref_R = ecef2rotation(self.ref_ecef)
        enu = self.ref_R.T @ (geo2ecef(lla) - self.ref_ecef)
        # associate with the nearest odometry pose
        if not self.times:
            return
        k = int(np.argmin(np.abs(np.asarray(self.times) - t)))
        self.gps[k] = (enu, max(accuracy, 0.1))

    def optimize(self, iters: int = 5):
        n = len(self.vio_poses)
        if n < 2 or not self.gps:
            return
        vio = np.stack(self.vio_poses)
        rels = _host(pose_compose, _host(pose_inverse, vio[:-1]), vio[1:])
        kw = dict(dtype=torch.float64, device=self.device)
        idx = dict(dtype=torch.int64, device=self.device)
        edges = GlobalEdges(
            i=torch.arange(n - 1, **idx), j=torch.arange(1, n, **idx),
            rel=torch.as_tensor(rels, **kw),
            w_t=torch.full((n - 1,), self.w_t, **kw),
            w_q=torch.full((n - 1,), self.w_q, **kw),
            valid=torch.ones(n - 1, dtype=torch.bool, device=self.device),
        )
        ks = sorted(self.gps.keys())
        priors = GlobalPriors(
            k=torch.as_tensor(ks, **idx),
            pos=torch.as_tensor(np.stack([self.gps[k][0] for k in ks]), **kw),
            w=torch.as_tensor(np.stack([np.full(3, 1.0 / self.gps[k][1]) for k in ks]), **kw),
            valid=torch.ones(len(ks), dtype=torch.bool, device=self.device),
        )
        poses0 = torch.as_tensor(np.stack(self.global_poses), **kw)
        out = optimize_global(poses0, torch.ones(n, dtype=torch.bool, device=self.device),
                              edges, priors, iters).cpu().numpy()
        self.global_poses = [out[i] for i in range(n)]
        # update WGPS_T_WVIO from the newest pose (globalOpt.cpp:216-226)
        self.wgps_T_wvio = _host(pose_compose, out[n - 1], _host(pose_inverse, vio[n - 1]))

    def write_tum(self, path: str):
        with open(path, "w") as fp:
            for t, p in zip(self.times, self.global_poses):
                fp.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                         f"{p[4]:.6f} {p[5]:.6f} {p[6]:.6f} {p[3]:.6f}\n")
