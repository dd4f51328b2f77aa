"""CLI entry: run the full system on a converted sequence directory.

    python -m ground_fusion_tpu_torch <config.yaml> <sequence_dir> [out_dir]
        [--burst K] [--device cuda|cpu] [--save-state] [--resume vio_state.npz]
        [--load-graph pose_graph.npz] [--load-grid grid.pgm]

The ``rosrun vins vins_node config.yaml`` + ``rosbag play`` analog
(README.md:146-161) for the file-driven dataset layout of
:mod:`ground_fusion_tpu_torch.io.dataset`. The system runs on the GPU unless
``--device cpu`` is given; without a GPU and without that flag it exits with
an error. ``--burst K`` stages K frames per flush (replay mode, see
``Config.burst_chunk``; ``--burst 1`` is live mode). GNSS epochs
(``gnss.csv``, with ``iono.csv``) feed the tight coupling when the config
enables it; GPS fixes (``gps.csv``) feed the global fusion.

Checkpointing: ``--save-state`` writes ``vio_state.npz`` and
``pose_graph.npz`` into the output directory at the end (the 's'-key save of
pose_graph.cpp:1062-1126); ``--resume`` restores a VIO snapshot and replays
the sequence from the first frame after the snapshot's newest window frame;
``--load-graph`` loads a prior pose graph for relocalization
(``load_previous_pose_graph``); ``--load-grid`` a prior occupancy PGM, which
the run republishes as ``prior_grid.pgm`` (pose_graph_node.cpp:861-901).
The files are those of the JAX package's CLI. A flag that needs a value and
has none, or a non-integer K, exits with code 2."""

from __future__ import annotations

import sys


def _take_value(argv, flag):
    """Remove ``flag VALUE`` from ``argv``; (present, value or None). A
    following ``--flag`` is not taken as the value."""
    if flag not in argv:
        return False, None
    i = argv.index(flag)
    value = argv[i + 1] if i + 1 < len(argv) and not argv[i + 1].startswith("--") else None
    del argv[i : i + (1 if value is None else 2)]
    return True, value


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    kw = {}
    for flag, key in (("--device", "device"), ("--resume", "resume"),
                      ("--load-graph", "load_graph"), ("--load-grid", "load_grid")):
        given, value = _take_value(argv, flag)
        if given:
            if value is None:
                print(__doc__)
                return 2
            kw[key] = value
    given, burst = _take_value(argv, "--burst")
    if given:
        try:
            kw["burst"] = int(burst)
        except (TypeError, ValueError):
            print(__doc__)
            return 2
    if "--save-state" in argv:
        argv.remove("--save-state")
        kw["save_state"] = True
    if len(argv) < 2:
        print(__doc__)
        return 2
    cfg_path, seq_dir = argv[0], argv[1]
    out_dir = argv[2] if len(argv) > 2 else "output"
    run(cfg_path, seq_dir, out_dir, **kw)
    return 0


def gnss_row_obs(r) -> dict:
    """One ``gnss.csv`` row → the observation dict of :mod:`.gnss.ingest`:
    t, sat, sys, psr, dopp×wavelength, psr_std, dopp_std, sat_pos[3],
    sat_vel[3], svdt, svddt, tgd[, ura[, tow]]."""
    o = dict(
        sat=int(r[1]), sys=int(r[2]), psr=r[3], dopp_wl=r[4],
        dopp=r[4],    # SPP/alignment key: doppler×wavelength
        psr_std=r[5], dopp_std=r[6], sat_pos=r[7:10].copy(),
        sat_vel=r[10:13].copy(), svdt=r[13], svddt=r[14], tgd=r[15],
    )
    if len(r) > 16:
        o["ura"] = r[16]
    if len(r) > 17:
        o["tow"] = r[17]
    return o


def run(cfg_path: str, seq_dir: str, out_dir: str = "output", device=None, burst: int = 0,
        save_state: bool = False, resume: str | None = None, load_graph: str | None = None,
        load_grid: str | None = None):
    """The CLI replay loop; returns the finished :class:`GroundFusionSystem`
    (tests and the smoke script assert on its internals afterwards).
    ``burst`` K > 0 replaces the config's ``burst_chunk``. With ``resume``
    the replay starts after the snapshot: every frame and every IMU, wheel,
    GNSS and GPS row at or before the snapshot's newest window time is
    skipped, since the restored window already holds them."""
    import dataclasses

    import numpy as np

    from .config import load_yaml
    from .io.dataset import Sequence, load_image
    from .system import GroundFusionSystem
    from .utils.evaluate import ate_rmse

    cfg = load_yaml(cfg_path)
    if burst:
        cfg = dataclasses.replace(cfg, burst_chunk=burst)
    seq = Sequence.load(seq_dir)
    sys_ = GroundFusionSystem(cfg, out_dir, device=device)
    if resume or load_graph or load_grid:
        sys_.load_checkpoint(graph_path=load_graph, state_path=resume, grid_path=load_grid)
    if seq.iono is not None and sys_.estimator.gnss is not None:
        # broadcast Klobuchar parameters (inputIonoParams,
        # rosNodeTest.cpp:203-210) — converted bags carry them in iono.csv
        sys_.estimator.gnss.iono_paras = list(seq.iono)

    imu_i = wheel_i = gnss_i = gps_i = 0
    t_resume = -np.inf
    if resume and sys_.estimator.ts:
        t_resume = sys_.estimator.ts[-1]
        after = lambda rows: 0 if rows is None else int(np.searchsorted(rows[:, 0], t_resume,
                                                                        side="right"))
        imu_i, wheel_i, gnss_i, gps_i = (after(r) for r in (seq.imu, seq.wheel, seq.gnss, seq.gps))
    for k, frame in enumerate(seq.frames):
        t, img_path, dep_path = frame[0], frame[1], frame[2]
        if t <= t_resume:
            continue
        right_path = frame[3] if len(frame) > 3 else None
        if seq.gps is not None:
            # NavSatFix fixes feed the loose global-fusion layer
            # (globalOptNode.cpp GPS subscription)
            while gps_i < len(seq.gps) and seq.gps[gps_i, 0] <= t:
                r = seq.gps[gps_i]
                sys_.input_gps_fix(r[0], r[1], r[2], r[3], r[4] if len(r) > 4 else 1.0)
                gps_i += 1
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= t:
            row = seq.imu[imu_i]
            sys_.input_imu(row[0], row[1:4], row[4:7])
            imu_i += 1
        if seq.wheel is not None:
            while wheel_i < len(seq.wheel) and seq.wheel[wheel_i, 0] <= t:
                row = seq.wheel[wheel_i]
                sys_.input_wheel(row[0], row[1:4], row[4:7])
                wheel_i += 1
        if seq.gnss is not None and cfg.gnss.enabled:
            # gnss.csv rows sharing a timestamp form one epoch (the GNSS
            # meas-msg grouping of rosNodeTest.cpp:678-711); feed each epoch
            # up to this frame through the tight-coupling path
            while gnss_i < len(seq.gnss) and seq.gnss[gnss_i, 0] <= t:
                t_ep = seq.gnss[gnss_i, 0]
                epoch = []
                while gnss_i < len(seq.gnss) and seq.gnss[gnss_i, 0] == t_ep:
                    epoch.append(gnss_row_obs(seq.gnss[gnss_i]))
                    gnss_i += 1
                sys_.input_gnss(t_ep, epoch)
        img = load_image(img_path)
        depth = load_image(dep_path) if dep_path else None
        right = load_image(right_path) if right_path else None
        pose = sys_.input_image(t, img, depth, img_right=right)
        if pose is not None and k % 10 == 0:
            print(f"frame {k}/{len(seq.frames)}  t={t:.2f}  "
                  f"p=[{pose[0]:.2f},{pose[1]:.2f},{pose[2]:.2f}]")
    out = sys_.finish(save_state=save_state)
    print(f"trajectory written to {out}")
    if seq.gt is not None:
        est = np.loadtxt(out, ndmin=2)
        if len(est):
            gt_interp = np.stack([
                np.interp(est[:, 0], seq.gt[:, 0], seq.gt[:, i]) for i in (1, 2, 3)
            ], -1)
            print(f"ATE RMSE vs gt: {ate_rmse(est[:, 1:4], gt_interp):.4f} m")
    return sys_


if __name__ == "__main__":
    raise SystemExit(main())
