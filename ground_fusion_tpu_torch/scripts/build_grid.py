"""Offline 2-D occupancy-grid builder from saved run artifacts — the
standalone ``support_files/grid_mapping`` tool (grid_mapper.cpp:12-57 log-odds
inverse sensor model + offline main) rebuilt over the checkpoint surface:

    python -m ground_fusion_tpu_torch.scripts.build_grid <run_dir> [grid.pgm]
        [--res 0.05] [--size 50] [--device cuda|cpu]

``run_dir`` holds a finished run's ``pose_graph.npz`` (``--save-state``) and
``map.ply`` (dense map export). Every map point becomes one beam from the
position of its nearest keyframe; the resulting PGM loads back as a prior map
(``--load-grid``, pose_graph_node.cpp:861-901). The grid is built on the GPU
unless ``--device cpu`` is given."""

from __future__ import annotations

import os
import sys

import numpy as np


def read_ply(path: str) -> np.ndarray:
    """Vertices of the ASCII PLY files the dense map writes."""
    with open(path) as fp:
        n = 0
        for line in fp:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        pts = np.loadtxt(fp, max_rows=n, ndmin=2)
    return pts[:, 0:3] if len(pts) else np.zeros((0, 3))


def build(run_dir: str, out_path: str, res: float = 0.05, size_m: float = 50.0,
          device=None) -> int:
    """Rasterize ``run_dir``'s map into ``out_path``; 0 on success, 1 when
    the map or the graph is empty."""
    from ..global_layers.dense_map import OccupancyGrid2D

    with np.load(os.path.join(run_dir, "pose_graph.npz"), allow_pickle=False) as graph:
        n_kf = int(graph["n_kf"])
        kf_xy = np.array([graph[f"kf{k}.pose"][0:2] for k in range(n_kf)]).reshape(n_kf, 2)
    pts = read_ply(os.path.join(run_dir, "map.ply"))
    if not len(pts) or not n_kf:
        print("nothing to rasterize (empty map or pose graph)")
        return 1

    grid = OccupancyGrid2D(size_m=size_m, resolution=res, device=device)
    # beam origin: the keyframe closest to each endpoint (the offline tool
    # walks the saved graph with each KF's cloud; the checkpoint keeps the
    # merged cloud, so nearest-KF is the origin recovery)
    d2 = ((pts[None, :, 0:2] - kf_xy[:, None, :]) ** 2).sum(-1)   # [K,N]
    owner = d2.argmin(axis=0)
    for k in range(n_kf):
        sel = owner == k
        if sel.any():
            ends = pts[sel, 0:2]
            grid.update(kf_xy[k], ends, np.ones(len(ends), bool))
    grid.save_pgm(out_path)
    print(f"wrote {out_path} ({grid.n}x{grid.n} @ {res} m)")
    return 0


def main(argv=None) -> int:
    from ..__main__ import _take_value

    argv = list(argv if argv is not None else sys.argv[1:])
    opts = {}
    for flag, key, conv in (("--res", "res", float), ("--size", "size_m", float),
                            ("--device", "device", str)):
        given, value = _take_value(argv, flag)
        if given:
            try:
                opts[key] = conv(value) if value is not None else None
            except ValueError:
                opts[key] = None
            if opts[key] is None:
                print(__doc__)
                return 2
    if not argv:
        print(__doc__)
        return 2
    run_dir = argv[0]
    out = argv[1] if len(argv) > 1 else os.path.join(run_dir, "grid.pgm")
    return build(run_dir, out, **opts)


if __name__ == "__main__":
    sys.exit(main())
