"""TSDF fusion + surface extraction: the offline mesh path.

The reference reconstructs a colored surface mesh offline from the saved
dense cloud with PCL Poisson/MLS + k-NN vertex coloring
(``dense_map/src/pose_graph_node.cpp:133-318``, the 'd' command). Redesigned
for the array model: registered RGBD keyframes are fused into a dense
truncated-signed-distance volume on the device with one vectorized projective
update per frame (every voxel projects into the depth image: one
``[n³,3]×[3,3]`` product, then gathers and ``where``), and the isosurface is
extracted on the host with the surface-nets dual method (one vertex per
sign-changing cell, quads across sign-changing edges). Divergence note:
surface nets replaces Poisson reconstruction — same role (watertight-ish
colored mesh from registered RGBD), no PCL dependency.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device
from ..geometry.se3 import pose_inverse
from ..geometry.so3 import quat_to_mat


class TsdfVolume:
    """Dense TSDF + color volume over a fixed axis-aligned box, on the
    device. ``device=None`` means the GPU and raises without one."""

    def __init__(self, origin=(-4.0, -4.0, -1.0), size_m: float = 8.0,
                 resolution: int = 128, trunc_voxels: float = 3.0,
                 depth_max: float = 7.0, dtype=torch.float32, device=None):
        self.n = resolution
        self.voxel = size_m / resolution
        self.trunc = trunc_voxels * self.voxel
        self.depth_max = depth_max
        self.origin = np.asarray(origin, np.float32)
        self.device = resolve_device(device)
        kw = dict(dtype=dtype, device=self.device)
        self.tsdf = torch.ones((self.n,) * 3, **kw)
        self.weight = torch.zeros((self.n,) * 3, **kw)
        self.color = torch.zeros((self.n,) * 3 + (3,), **kw)
        self._coords = None          # voxel centers [n³,3], built at the first integrate

    def clear(self) -> None:
        """Reset the volume — used by the post-loop dense-map rebuild so the
        TSDF is re-rasterised at the relaxed poses instead of keeping
        pre-loop geometry (updatePath rebuild, pose_graph.cpp:875-930)."""
        self.tsdf.fill_(1.0)
        self.weight.zero_()
        self.color.zero_()

    def _voxel_centers(self) -> Tensor:
        if self._coords is None:
            kw = dict(dtype=self.tsdf.dtype, device=self.device)
            ax = torch.arange(self.n, **kw)
            grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
            origin = torch.as_tensor(self.origin, **kw)
            self._coords = (origin + (grid + 0.5) * torch.tensor(self.voxel, **kw)).reshape(-1, 3)
        return self._coords

    def integrate(self, depth_img, color_img, pose_wc, fx, fy, cx, cy) -> None:
        """Fuse one registered RGBD frame (depth [H,W], color [H,W,3], host
        arrays or tensors). ``pose_wc`` = [t(3), q_wxyz(4)] camera-to-world."""
        kw = dict(dtype=self.tsdf.dtype, device=self.device)
        depth_img = torch.as_tensor(depth_img, device=self.device).to(kw["dtype"])
        color_img = torch.as_tensor(color_img, device=self.device).to(kw["dtype"])
        pose_wc = torch.as_tensor(pose_wc, device=self.device).to(kw["dtype"])
        fx, fy, cx, cy = (torch.tensor(float(v), **kw) for v in (fx, fy, cx, cy))
        n = self.n
        h, w = depth_img.shape
        T_cw = pose_inverse(pose_wc)
        R_cw = quat_to_mat(T_cw[3:7])
        # one [n³, 3]×[3, 3] product takes every voxel into the camera frame
        pc = self._voxel_centers() @ R_cw.T + T_cw[0:3][None, :]
        z = pc[:, 2]
        z_safe = torch.where(z != 0, z, torch.ones_like(z))
        u = fx * pc[:, 0] / z_safe + cx
        v = fy * pc[:, 1] / z_safe + cy
        # clamp before the cast: an out-of-range float has no integer value
        ui = torch.clamp(torch.round(u), 0, w - 1).to(torch.int64)
        vi = torch.clamp(torch.round(v), 0, h - 1).to(torch.int64)
        d = depth_img[vi, ui]
        rgb = color_img[vi, ui]
        in_img = (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1) & (z > 0.05)
        d_ok = (d > 0.05) & (d < self.depth_max)
        sdf = d - z
        upd = in_img & d_ok & (sdf > -self.trunc)
        tsdf_new = torch.clamp(sdf / self.trunc, -1.0, 1.0).reshape(n, n, n)
        wf = upd.to(kw["dtype"]).reshape(n, n, n)
        rgb = rgb.reshape(n, n, n, 3)
        w_old = self.weight
        weight = w_old + wf
        denom = torch.where(weight > 0, weight, torch.ones_like(weight))
        self.tsdf = (self.tsdf * w_old + tsdf_new * wf) / denom
        self.color = (self.color * w_old[..., None] + rgb * wf[..., None]) / denom[..., None]
        self.weight = weight

    # -- host-side extraction ------------------------------------------------

    def extract_mesh(self, min_weight: float = 1.0, smooth_radius: float = 0.0):
        """Surface-nets isosurface of tsdf=0 → (verts [V,3], colors [V,3],
        tris [T,3] int). Host/offline, like the reference's 'd' command.
        ``smooth_radius`` > 0 applies the MLS vertex-smoothing stage
        (pose_graph_node.cpp:175-182) to the extracted vertices."""
        tsdf = self.tsdf.cpu().numpy()
        wgt = self.weight.cpu().numpy()
        col = self.color.cpu().numpy()
        valid = wgt >= min_weight
        verts, cols, tris = surface_nets(tsdf, valid, col, self.origin, self.voxel)
        if smooth_radius > 0.0 and len(verts):
            verts, _ = mls_smooth(verts, smooth_radius)
        return verts, cols, tris

    def save_mesh_ply(self, path: str, min_weight: float = 1.0,
                      smooth_radius: float = 0.0) -> None:
        verts, cols, tris = self.extract_mesh(min_weight, smooth_radius)
        write_mesh_ply(path, verts, cols, tris)


def surface_nets(tsdf: np.ndarray, valid: np.ndarray, color: np.ndarray,
                 origin, voxel: float):
    """Dual-contouring-lite: one vertex per cell whose 8 corners straddle the
    isosurface (placed at the mean of its edge zero-crossings); two triangles
    per sign-changing edge connecting the 4 cells around it."""
    n = tsdf.shape[0]
    f = np.where(valid, tsdf, np.nan)

    # cell corners f[i..i+1, j..j+1, k..k+1]
    c = np.empty((8,) + tuple(s - 1 for s in f.shape), f.dtype)
    corners = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
               (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    for ci, (dx, dy, dz) in enumerate(corners):
        c[ci] = f[dx:n - 1 + dx, dy:n - 1 + dy, dz:n - 1 + dz]
    finite = np.all(np.isfinite(c), axis=0)
    has_neg = np.any(c < 0, axis=0) & finite
    has_pos = np.any(c >= 0, axis=0) & finite
    active = has_neg & has_pos                       # [n-1]^3 cells with a vertex

    cell_idx = -np.ones(active.shape, np.int64)
    ii, jj, kk = np.nonzero(active)
    cell_idx[ii, jj, kk] = np.arange(len(ii))

    # vertex position: mean of edge crossings of the 12 cell edges
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    acc = np.zeros((len(ii), 3))
    cnt = np.zeros((len(ii),))
    corner_off = np.asarray(corners, np.float64)
    ca = c[:, ii, jj, kk]                            # [8, V]
    base = np.stack([ii, jj, kk], axis=-1).astype(np.float64)
    for a, b in edges:
        fa, fb = ca[a], ca[b]
        cross = (fa < 0) != (fb < 0)
        t = np.where(cross, fa / np.where(fa - fb == 0, 1.0, fa - fb), 0.0)
        p = corner_off[a][None, :] + t[:, None] * (corner_off[b] - corner_off[a])[None, :]
        acc += np.where(cross[:, None], p, 0.0)
        cnt += cross
    verts = base + acc / np.maximum(cnt, 1.0)[:, None]
    verts_w = np.asarray(origin)[None, :] + verts * voxel

    # faces: for each axis, an edge between grid point g and g+axis with a
    # sign change is shared by 4 cells; connect their vertices as a quad
    tris = []
    for axis in range(3):
        sl_a = [slice(1, n - 1)] * 3
        sl_b = [slice(1, n - 1)] * 3
        sl_b[axis] = slice(2, n)
        fa = f[tuple(sl_a)]
        fb = f[tuple(sl_b)]
        cross = np.isfinite(fa) & np.isfinite(fb) & ((fa < 0) != (fb < 0))
        flip = fa[cross] < 0
        gi, gj, gk = np.nonzero(cross)
        gi, gj, gk = gi + 1, gj + 1, gk + 1          # grid-point coords
        u, v = [x for x in range(3) if x != axis]

        def cell_at(di, dj, dk):
            return cell_idx[gi - di, gj - dj, gk - dk]

        offs = [(0, 0), (1, 0), (1, 1), (0, 1)]      # around the edge in (u,v)
        quad = []
        for ou, ov in offs:
            d = [0, 0, 0]
            d[u], d[v] = ou, ov
            quad.append(cell_at(*d))
        quad = np.stack(quad, axis=-1)               # [E, 4]
        ok = np.all(quad >= 0, axis=-1)
        quad = quad[ok]
        fl = flip[ok]
        q = np.where(fl[:, None], quad[:, ::-1], quad)
        tris.append(np.stack([q[:, 0], q[:, 1], q[:, 2]], axis=-1))
        tris.append(np.stack([q[:, 0], q[:, 2], q[:, 3]], axis=-1))
    tris = np.concatenate(tris, axis=0) if tris else np.zeros((0, 3), np.int64)

    # vertex colors: nearest-voxel lookup of the fused color volume (the
    # k-NN cloud-coloring analog, pose_graph_node.cpp:133-318)
    vi = np.clip(np.round(verts).astype(np.int64), 0, n - 1)
    cols = color[vi[:, 0], vi[:, 1], vi[:, 2]]
    return verts_w, cols, tris


# ---------------------------------------------------------------------------
# Cloud conditioning: the reference's offline mesh path runs PCL
# RadiusOutlierRemoval + MovingLeastSquares before Poisson
# (pose_graph_node.cpp:133-318, MLS at :175-182). Same role here, array-shaped:
# one grid-hash pass builds per-cell (count, Σp, Σppᵀ) tables and every point
# reads its 27-cell neighborhood with vectorized searchsorted lookups — no
# per-point KD-tree queries. Divergence: the neighborhood is the 27 cells of
# side ``radius`` around each point (superset of the exact radius ball, ⊂ ball
# of ~2.6·radius), which is the standard grid approximation.
# ---------------------------------------------------------------------------


def _cell_stats(points: np.ndarray, radius: float):
    """Grid-hash accumulation: per-cell count / sum / outer-product sums, plus
    each point's encoded cell key. Cells are cubes of side ``radius``."""
    keys = np.floor(points / radius).astype(np.int64)
    m = 1 << 21
    enc = ((keys[:, 0] + (m >> 1)) * m + (keys[:, 1] + (m >> 1))) * m \
        + (keys[:, 2] + (m >> 1))
    cells, inv = np.unique(enc, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(cells)).astype(np.float64)
    psum = np.zeros((len(cells), 3))
    osum = np.zeros((len(cells), 3, 3))
    np.add.at(psum, inv, points)
    outer = points[:, :, None] * points[:, None, :]
    np.add.at(osum, inv, outer)
    return cells, cnt, psum, osum, enc


def _gather_neighborhood(cells, cnt, psum, osum, enc_q: np.ndarray):
    """Sum the stats of the 27 cells around each query point's cell."""
    m = 1 << 21
    n_c = np.zeros(len(enc_q))
    n_p = np.zeros((len(enc_q), 3))
    n_o = np.zeros((len(enc_q), 3, 3))
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                q = enc_q + (dx * m + dy) * m + dz
                idx = np.searchsorted(cells, q)
                idx_c = np.clip(idx, 0, len(cells) - 1)
                hit = cells[idx_c] == q
                n_c += np.where(hit, cnt[idx_c], 0.0)
                n_p += np.where(hit[:, None], psum[idx_c], 0.0)
                n_o += np.where(hit[:, None, None], osum[idx_c], 0.0)
    return n_c, n_p, n_o


def radius_outlier_filter(points: np.ndarray, radius: float,
                          min_neighbors: int = 3) -> np.ndarray:
    """Keep-mask dropping points with fewer than ``min_neighbors`` other
    points in their 27-cell neighborhood (PCL RadiusOutlierRemoval role,
    pose_graph_node.cpp mesh path / pose_graph.cpp:228-239)."""
    if len(points) == 0:
        return np.zeros(0, bool)
    cells, cnt, psum, osum, enc = _cell_stats(np.asarray(points, np.float64),
                                              radius)
    n_c, _, _ = _gather_neighborhood(cells, cnt, psum, osum, enc)
    return (n_c - 1.0) >= min_neighbors


def mls_smooth(points: np.ndarray, radius: float, iters: int = 1,
               min_neighbors: int = 4):
    """Normal-aware moving-least-squares projection (degree-1 MLS, the
    ``pcl::MovingLeastSquares`` role at pose_graph_node.cpp:175-182).

    Each point is projected onto the total-least-squares plane of its
    neighborhood (mean μ, normal = smallest-eigenvalue eigenvector of the
    local covariance): ``p' = p − ((p−μ)·n̂)n̂``. Points with fewer than
    ``min_neighbors`` neighbors are left untouched. Returns (smoothed points,
    unit normals)."""
    pts = np.asarray(points, np.float64).copy()
    normals = np.zeros_like(pts)
    for _ in range(max(iters, 1)):
        cells, cnt, psum, osum, enc = _cell_stats(pts, radius)
        n_c, n_p, n_o = _gather_neighborhood(cells, cnt, psum, osum, enc)
        ok = n_c >= min_neighbors
        nc = np.maximum(n_c, 1.0)
        mu = n_p / nc[:, None]
        cov = n_o / nc[:, None, None] - mu[:, :, None] * mu[:, None, :]
        # eigh on [N,3,3] — smallest eigenvector is the local plane normal
        w, v = np.linalg.eigh(cov)
        nrm = v[..., 0]
        d = np.einsum("ij,ij->i", pts - mu, nrm)
        proj = pts - d[:, None] * nrm
        pts = np.where(ok[:, None], proj, pts)
        normals = np.where(ok[:, None], nrm, normals)
    return pts, normals


def write_mesh_ply(path: str, verts: np.ndarray, cols: np.ndarray,
                   tris: np.ndarray):
    """ASCII PLY with vertex colors + triangular faces."""
    with open(path, "w") as fp:
        fp.write("ply\nformat ascii 1.0\n")
        fp.write(f"element vertex {len(verts)}\n")
        fp.write("property float x\nproperty float y\nproperty float z\n")
        fp.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fp.write(f"element face {len(tris)}\n")
        fp.write("property list uchar int vertex_indices\n")
        fp.write("end_header\n")
        for p, c in zip(verts, cols):
            r, g, b = np.clip(c, 0, 255).astype(int)
            fp.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")
        for t in tris:
            fp.write(f"3 {t[0]} {t[1]} {t[2]}\n")
