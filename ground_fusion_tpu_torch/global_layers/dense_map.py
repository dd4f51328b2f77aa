"""Dense RGBD color mapping + 2-D occupancy grid, as device scatters.

Re-design of the dense_map node's mapping path (``pose_graph_node.cpp:598-624``
RGBD sampling with stride/margins/depth gates; ``pose_graph.cpp:191-244``
density-gated octree insertion + radius outlier removal; ``support_files/
grid_mapping/grid_mapper.cpp:12-57`` log-odds inverse sensor model): the octree
becomes a fixed-capacity voxel hash accumulated with one ``index_add_`` per
keyframe (counts + color sums + position sums), density/outlier gates become
count thresholds at export, and the occupancy grid is a batched ray-march
scatter. The state tensors live on the device; export and the PLY/PGM
writers run on the host.

The CUDA scatter-adds of floats run in no fixed order, so colour and position
sums may differ from the CPU's by float rounding; counts are integers and the
density gate reads only them, so the exported voxel set does not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device

_INT32_SPAN = 1 << 32


def _wrap_int32(x: Tensor) -> Tensor:
    """An int64 tensor reduced to the int32 value with the same low 32 bits
    (two's complement), kept in int64."""
    return torch.remainder(x + (1 << 31), _INT32_SPAN) - (1 << 31)


def hash_voxel_index(v: Tensor, capacity: int) -> Tensor:
    """Slot of each voxel triple ``v`` [N,3] (int32 values): the int32
    FNV-style hash exactly as int32 arithmetic gives it — products wrap,
    ``abs`` keeps INT32_MIN negative, and the modulo floors — computed in
    int64 so that no step relies on signed overflow."""
    v = v.to(torch.int64)
    h = (_wrap_int32(v[:, 0] * 73856093) ^ _wrap_int32(v[:, 1] * 19349663)
         ^ _wrap_int32(v[:, 2] * 83492791))
    return torch.remainder(_wrap_int32(torch.abs(h)), capacity)


def sample_rgbd(depth: Tensor, color: Tensor, stride: int = 4, boundary: int = 20,
                d_min: float = 0.1, d_max: float = 7.0):
    """Strided RGBD sampling (pose_graph_node.cpp:598-624): every ``stride``
    px inside the boundary margins, depth-gated, white-pixel culled. Returns
    (gx, gy, depth, rgb, valid) at fixed N = grid size, on the images'
    device; the caller lifts pixel + depth through its camera model."""
    h, w = depth.shape
    ys = torch.arange(boundary, h - boundary, stride, device=depth.device)
    xs = torch.arange(boundary, w - boundary, stride, device=depth.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gy, gx = gy.reshape(-1), gx.reshape(-1)
    d = depth[gy, gx]
    rgb = color[gy, gx]
    ok = (d > d_min) & (d < d_max) & ~torch.all(rgb > 250, dim=-1)
    return gx, gy, d, rgb, ok


class VoxelColorMap:
    """Fixed-capacity voxel-hash color accumulator on the device.

    Divergence note (as in the JAX package): the reference uses a PCL color
    octree with per-point density gating (``getVoxelDensityAtPoint < 3``); a
    modular hash with scatter-add accumulation is the branch-free analog —
    rare hash collisions blend colors of distinct voxels instead of erroring,
    and the density gate is applied at export as a minimum-count filter.
    ``device=None`` means the GPU and raises without one."""

    def __init__(self, voxel_size: float = 0.05, capacity: int = 1 << 20,
                 dtype=torch.float32, device=None):
        self.voxel_size = voxel_size
        self.capacity = capacity
        self.device = resolve_device(device)
        self.counts = torch.zeros((capacity,), dtype=torch.int32, device=self.device)
        self.color_sum = torch.zeros((capacity, 3), dtype=dtype, device=self.device)
        self.pos_sum = torch.zeros((capacity, 3), dtype=dtype, device=self.device)

    def insert(self, pts_w: Tensor, rgb: Tensor, valid: Tensor) -> None:
        """Accumulate points [N,3] with colours [N,3] where ``valid`` [N]."""
        dt = self.color_sum.dtype
        pts_w = torch.as_tensor(pts_w, device=self.device)
        idx = hash_voxel_index(torch.floor(pts_w / self.voxel_size).to(torch.int32),
                               self.capacity)
        valid = torch.as_tensor(valid, device=self.device)
        self.counts.index_add_(0, idx, valid.to(torch.int32))
        wf = valid.to(dt)[:, None]
        self.color_sum.index_add_(0, idx, torch.as_tensor(rgb, device=self.device).to(dt) * wf)
        self.pos_sum.index_add_(0, idx, pts_w.to(dt) * wf)

    def clear(self) -> None:
        """Drop all accumulated voxels — the rebuild-after-loop reset
        (``updatePath``'s ``octree->deleteTree(); cloud->clear()``,
        pose_graph.cpp:875-930)."""
        self.counts.zero_()
        self.color_sum.zero_()
        self.pos_sum.zero_()

    def export(self, min_count: int = 3):
        """Occupied voxels passing the density gate → (centers [M,3],
        colors [M,3]) as float64 numpy, in slot order — the radius-outlier
        analog (pose_graph.cpp:228-239). The gate runs on the device; only
        the kept slots are fetched."""
        keep = torch.nonzero(self.counts >= min_count)[:, 0]
        packed = torch.cat([self.counts[keep, None].to(self.pos_sum.dtype),
                            self.pos_sum[keep], self.color_sum[keep]], dim=1).cpu().numpy()
        c = packed[:, 0:1].astype(np.float64)
        return packed[:, 1:4] / c, packed[:, 4:7] / c

    def save_ply(self, path: str, min_count: int = 3) -> None:
        """ASCII PLY export (the 'd'-key PCD dump analog,
        pose_graph_node.cpp:733-743)."""
        pts, cols = self.export(min_count)
        write_cloud_ply(path, pts, cols)


def write_cloud_ply(path: str, pts: np.ndarray, cols: np.ndarray) -> None:
    with open(path, "w") as fp:
        fp.write("ply\nformat ascii 1.0\n")
        fp.write(f"element vertex {len(pts)}\n")
        fp.write("property float x\nproperty float y\nproperty float z\n")
        fp.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fp.write("end_header\n")
        for p, c in zip(pts, cols):
            r, g, b = np.clip(c, 0, 255).astype(int)
            fp.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")


class OccupancyGrid2D:
    """Log-odds 2-D occupancy grid (grid_mapper.cpp:12-57) on the device:
    each beam marches fixed steps from sensor to endpoint scattering
    ``l_free``, the endpoint cell gets ``l_occ``; clamped log-odds, float32.
    ``device=None`` means the GPU and raises without one."""

    def __init__(self, size_m: float = 50.0, resolution: float = 0.05,
                 l_occ: float = 0.85, l_free: float = -0.4,
                 l_min: float = -2.0, l_max: float = 3.5, device=None):
        self.res = resolution
        self.n = int(size_m / resolution)
        self.device = resolve_device(device)
        self.logodds = torch.zeros((self.n, self.n), dtype=torch.float32, device=self.device)
        self.l_occ, self.l_free = l_occ, l_free
        self.l_min, self.l_max = l_min, l_max
        self.origin = np.array([-size_m / 2, -size_m / 2])

    def update(self, sensor_xy, ends_xy, valid, steps: int = 128) -> None:
        """One scan: beams from ``sensor_xy`` [2] to ``ends_xy`` [B,2] where
        ``valid`` [B], in float32 as the JAX package computes them."""
        kw = dict(dtype=torch.float32, device=self.device)
        n = self.n
        origin = torch.as_tensor(self.origin, **kw)
        res = torch.tensor(self.res, **kw)
        sensor = torch.as_tensor(sensor_xy, **kw)
        ends = torch.as_tensor(ends_xy, **kw)
        valid = torch.as_tensor(valid, device=self.device)
        # free-space ray march: `steps` samples strictly inside each beam
        alphas = (torch.arange(1, steps + 1, **kw) / (steps + 1))[None, :, None]
        pts = sensor[None, None, :] + alphas * (ends[:, None, :] - sensor[None, None, :])
        cells = torch.floor((pts - origin[None, None, :]) / res).to(torch.int64)
        cx = torch.clamp(cells[..., 0], 0, n - 1).reshape(-1)
        cy = torch.clamp(cells[..., 1], 0, n - 1).reshape(-1)
        w = torch.repeat_interleave(valid, steps).to(torch.float32)
        # scatter-max-1 per beam-cell approximated by scatter-add of the
        # per-sample free update scaled down by samples-per-cell density
        flat = self.logodds.reshape(-1)
        flat.index_add_(0, cy * n + cx, self.l_free * w / 4.0)
        endc = torch.floor((ends - origin[None, :]) / res).to(torch.int64)
        ex = torch.clamp(endc[:, 0], 0, n - 1)
        ey = torch.clamp(endc[:, 1], 0, n - 1)
        flat.index_add_(0, ey * n + ex, self.l_occ * valid.to(torch.float32))
        self.logodds.clamp_(self.l_min, self.l_max)

    def probability(self) -> np.ndarray:
        lo = self.logodds.cpu().numpy()
        return 1.0 - 1.0 / (1.0 + np.exp(lo))

    def save_pgm(self, path: str) -> None:
        """Grid export loadable as a prior map (pose_graph_node.cpp:861-901
        loads such offline-built grids). The world scale is recorded in a
        PGM comment line (`# res <m/cell> origin <ox> <oy>`) — the PGM pixel
        format itself carries no resolution, so without this a non-default
        grid would silently reload at the wrong world scale."""
        p = self.probability()
        img = np.clip((1.0 - p) * 255, 0, 255).astype(np.uint8)
        with open(path, "wb") as fp:
            fp.write(f"P5\n# res {float(self.res)!r} origin "
                     f"{float(self.origin[0])!r} {float(self.origin[1])!r}\n"
                     f"{self.n} {self.n}\n255\n".encode())
            fp.write(img.tobytes())

    @classmethod
    def load_pgm(cls, path: str, resolution: Optional[float] = None, **kw):
        """Rebuild a grid from a saved PGM — the prior-occupancy-map load of
        the dense-map node (pose_graph_node.cpp:861-901). Probabilities are
        recovered from the 8-bit image and clamped to the log-odds bounds, so
        save→load round-trips to quantization.

        Resolution: an explicit ``resolution`` argument wins; otherwise the
        `# res … origin …` metadata comment written by :meth:`save_pgm` is
        used; otherwise the 0.05 m/cell default. ``device`` goes in ``kw``."""
        meta_res, meta_origin = None, None
        with open(path, "rb") as fp:
            assert fp.readline().strip() == b"P5", "not a binary PGM"
            dims = fp.readline().split()
            while dims and dims[0].startswith(b"#"):
                if len(dims) >= 3 and dims[1] == b"res":
                    meta_res = float(dims[2])
                    if len(dims) >= 6 and dims[3] == b"origin":
                        meta_origin = np.array([float(dims[4]), float(dims[5])])
                dims = fp.readline().split()
            w, h = int(dims[0]), int(dims[1])
            fp.readline()               # maxval
            img = np.frombuffer(fp.read(w * h), np.uint8).reshape(h, w)
        assert w == h, "occupancy grids are square"
        if resolution is None:
            resolution = meta_res if meta_res is not None else 0.05
        grid = cls(size_m=w * resolution, resolution=resolution, **kw)
        if meta_origin is not None:
            grid.origin = meta_origin
        p = np.clip(1.0 - img.astype(np.float64) / 255.0, 1e-4, 1 - 1e-4)
        lo = np.clip(np.log(p / (1.0 - p)), grid.l_min, grid.l_max)
        grid.logodds = torch.as_tensor(lo.astype(np.float32), device=grid.device)
        return grid
