"""The port's checkpoint and resume surface against the JAX package's, on the
CPU (``tests/test_checkpoint.py`` is the oracle):

- the ``save_core`` archive and ``Estimator.save_state`` snapshot cross-load
  both ways between the packages, bit for bit, on a core from the port's
  ``build_window_problem`` (no step run) with the GNSS table and
  the host bookkeeping (slots, timestamps, trajectory, GNSS anchor and track
  counts); ``save_state`` refuses unflushed burst frames and ``load_state``
  clears the port's host caches;
- ``pose_graph.npz`` cross-loads both ways: keyframes and database tables
  equal those of the writer's graph and of the other package's own load; a
  drifted revisit relocalizes against a loaded keyframe;
- the oracle's save-resume drive (22 + 12 frames, float64) through the port,
  post-resume ATE < 0.05 m;
- the two resume faults of the JAX package, repaired in the port: tracker
  ids after a state load lie above the restored ones, and ``run(resume=...)``
  feeds no frame or sensor row at or before the snapshot;
- the port's ``build_grid`` against ``scripts/build_grid.py``.

Under ``-m slow``: phase 4's rendered sequence saved after 20 frames and
resumed over 40 through the port's CLI on the CPU (``chip_smoke.py`` phase
12a).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

import chip_smoke
from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.global_layers.pose_graph import PoseGraph as JPoseGraph
from ground_fusion_tpu.pipeline import Estimator as JEstimator
from ground_fusion_tpu.utils import checkpoint as jckpt
from ground_fusion_tpu_torch import __main__ as cli
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.config import load_yaml
from ground_fusion_tpu_torch.global_layers.dense_map import OccupancyGrid2D, write_cloud_ply
from ground_fusion_tpu_torch.global_layers.pose_graph import PoseGraph as TPoseGraph
from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
from ground_fusion_tpu_torch.sim.synthetic import SimParams, build_window_problem
from ground_fusion_tpu_torch.scripts import build_grid as tbuild
from ground_fusion_tpu_torch.scripts.parity import feed_drive, simulator_drive
from ground_fusion_tpu_torch.system import GroundFusionSystem
from ground_fusion_tpu_torch.utils import checkpoint as tckpt
from ground_fusion_tpu_torch.utils.convert import core_from_numpy, pose_graph_to_numpy
from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DT = torch.float64


def _small(cls):
    """Window 4, 16 landmark slots, tight GNSS on (so the core has a GNSS
    table and no line table)."""
    cfg = cls()
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, window_size=4, max_landmarks=16),
        gnss=dataclasses.replace(cfg.gnss, enabled=True))


def _leaves(tree, prefix=""):
    """{dotted path: numpy array} of a core of either package."""
    out = {}
    if hasattr(tree, "_fields"):
        for n in tree._fields:
            out.update(_leaves(getattr(tree, n), f"{prefix}{n}."))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)
    return out


def _assert_cores_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].shape == lb[k].shape, k
        assert np.array_equal(la[k], lb[k].astype(la[k].dtype)), k


@pytest.fixture(scope="module")
def jax_estimator():
    """A JAX estimator holding a window from the port's
    ``build_window_problem`` (the JAX package's arrays at 1e-12,
    ``test_torch_stereo_sim.py``) and hand-set host bookkeeping, as after a
    solve with GNSS aligned."""
    cfg = _small(JConfig)
    prob = build_window_problem(_small(TConfig), SimParams(), dtype=DT, device=CPU)
    est = JEstimator(cfg, dtype=jnp.float64)

    def carried(jtable, ttable):
        return type(jtable)(*[jnp.asarray(t.numpy(), dtype=np.asarray(j).dtype)
                              for j, t in zip(jtable, ttable)])

    est.core = est.core._replace(**{name: carried(getattr(est.core, name), prob[name])
                                    for name in ("state", "tracks", "imu_buf", "wheel_buf")})
    rng = np.random.default_rng(0)
    ml = cfg.solver.max_landmarks
    slots = rng.permutation(ml)
    est.solver_flag = est.NON_LINEAR
    est.frame_count = cfg.num_frames
    est.ts = [float(t) for t in prob["ts"]]
    est.slot_of = {int(fid): int(s) for fid, s in zip(rng.choice(1000, 12, replace=False), slots)}
    est.free_slots = [int(s) for s in slots[12:]]
    est.trajectory = [(t, prob["state"].poses[k].numpy())
                      for k, t in enumerate(est.ts)]
    est.keyframe_flags = [True, False, True, True]
    est.gnss_aligned = True
    est.gnss.set_anchor(np.array([-2850000.123, 4650000.456, 3280000.789]))
    est.gnss.track_count = {3: 7, 18: 2, 40: 11}
    return est


def _port_estimator(src) -> TEstimator:
    """A port estimator carrying ``src``'s state through the test bridge."""
    est = TEstimator(_small(TConfig), dtype=DT, device=CPU)
    est.core = core_from_numpy(jax.tree_util.tree_map(np.asarray, src.core), CPU, DT)
    for name in ("solver_flag", "frame_count", "ts", "slot_of", "free_slots", "line_slot_of",
                 "free_line_slots", "trajectory", "keyframe_flags", "gnss_aligned"):
        setattr(est, name, getattr(src, name))
    est.gnss.set_anchor(src.gnss.anc0)
    est.gnss.track_count = dict(src.gnss.track_count)
    return est


def _assert_host_equal(a, b):
    for name in ("solver_flag", "frame_count", "ts", "slot_of", "free_slots", "line_slot_of",
                 "free_line_slots", "keyframe_flags", "gnss_aligned"):
        assert getattr(a, name) == getattr(b, name), name
    assert [t for t, _ in a.trajectory] == [t for t, _ in b.trajectory]
    assert all(np.array_equal(p, q) for (_, p), (_, q) in zip(a.trajectory, b.trajectory))
    assert np.array_equal(a.gnss.anc0, b.gnss.anc0) and np.array_equal(a.gnss.R0, b.gnss.R0)
    assert a.gnss.track_count == b.gnss.track_count


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_core_and_state_cross_load(direction, jax_estimator, tmp_path):
    """Both archives load bit for bit in the other package, with the
    template's dtypes and device; the absent line table stays ``None``."""
    jest = jax_estimator
    core_path, state_path = str(tmp_path / "core.npz"), str(tmp_path / "vio_state.npz")
    if direction == "jax_to_port":
        jckpt.save_core(core_path, jest.core)
        jest.save_state(state_path)
        test = TEstimator(_small(TConfig), dtype=DT, device=CPU)
        core = tckpt.load_core(core_path, test.core)
        assert core.lines is None and core.gnss_obs is not None
        assert core.tracks.start_frame.dtype == torch.int64 and core.tracks.obs_valid.dtype == torch.bool
        _assert_cores_equal(jest.core, core)
        test._burst_xs, test._mirror_synced, test._last_sb = [{}], True, np.zeros(9)
        test._prev_feats = {1: None}
        test.load_state(state_path)
        assert test._burst_xs == [] and not test._mirror_synced and test._last_sb is None
        assert test._prev_feats == {} and test._fp is None and test._fp_seed is None
        assert test.core.state.poses.device == CPU and test.core.state.poses.dtype == DT
        _assert_cores_equal(jest.core, test.core)
        _assert_host_equal(jest, test)
        assert np.array_equal(test._anc_delta, np.asarray(jest.core.state.anc_ecef))
    else:
        src = _port_estimator(jest)
        src._burst_xs = [{}]
        with pytest.raises(RuntimeError, match="flush"):
            src.save_state(state_path)
        src._burst_xs = []
        tckpt.save_core(core_path, src.core)
        src.save_state(state_path)
        fresh = JEstimator(_small(JConfig), dtype=jnp.float64)
        core = jckpt.load_core(core_path, fresh.core)
        assert core.lines is None
        _assert_cores_equal(src.core, core)
        fresh.load_state(state_path)
        _assert_cores_equal(src.core, fresh.core)
        _assert_host_equal(src, fresh)


def _jax_reloc_graph(path):
    """tests/test_checkpoint.py:51's ten keyframes through the JAX package."""
    from test_checkpoint import _loop_cfg, _textured_kf

    from ground_fusion_tpu.geometry.so3 import mat_to_quat, ypr_to_mat

    pg = JPoseGraph(_loop_cfg())
    yaws = np.linspace(0, 2 * np.pi, 11)[:10]
    for k in range(10):
        pt = np.array([3 * np.cos(yaws[k]), 3 * np.sin(yaws[k]), 0.0])
        R = np.asarray(ypr_to_mat(jnp.asarray([yaws[k], 0.0, 0.0], jnp.float64)))
        pg.add_keyframe(_textured_kf(pg, k, k, np.concatenate([pt, np.asarray(mat_to_quat(jnp.asarray(R)))])))
    jckpt.save_pose_graph(path, pg)
    return pg


def _assert_graph_states_equal(a, b):
    assert len(a["kfs"]) == len(b["kfs"])
    for ka, kb in zip(a["kfs"], b["kfs"]):
        assert ka.keys() == kb.keys()
        for n in ka:
            if n in ("index", "t"):
                assert type(ka[n]) is type(kb[n]) and ka[n] == kb[n], n
            else:
                assert ka[n].dtype == kb[n].dtype and np.array_equal(ka[n], kb[n]), n
    for n in a["db"]:
        assert np.array_equal(np.asarray(a["db"][n]), np.asarray(b["db"][n])), n
    assert a["earliest_loop"] == b["earliest_loop"] and len(a["loop_edges"]) == len(b["loop_edges"])
    assert np.array_equal(a["r_drift"], b["r_drift"]) and np.array_equal(a["t_drift"], b["t_drift"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pose_graph_cross_load(direction, tmp_path):
    """A saved graph loads in the other package with the keyframes and
    database tables that the writer's own load gives; in the port a
    drifted revisit of place 0 then closes a loop against a loaded
    keyframe (the oracle's relocalization)."""
    path = str(tmp_path / "pose_graph.npz")
    if direction == "jax_to_port":
        _jax_reloc_graph(path)
    else:
        chip_smoke.reloc_graph(np, CPU, path)
    from test_checkpoint import _loop_cfg

    jg = JPoseGraph(_loop_cfg())
    jckpt.load_pose_graph(path, jg)
    tg = TPoseGraph(chip_smoke.reloc_config(), device=CPU)
    tckpt.load_pose_graph(path, tg)
    assert len(tg.kfs) == 10 and tg.db.count == 10 and tg.db.hists.device == CPU
    with np.load(path) as saved:     # the arrays keep the writer's dtypes
        assert tg.kfs[3].desc.dtype == saved["kf3.desc"].dtype and tg.kfs[3].kp_ok.dtype == bool
    _assert_graph_states_equal(pose_graph_to_numpy(tg), pose_graph_to_numpy(jg))
    if direction == "jax_to_port":
        edges = chip_smoke.relocalize(np, tg)
        assert edges and edges[-1][0] < 10, "no relocalization against the loaded graph"


def test_resume_drive_holds_the_oracles_bound(tmp_path):
    """tests/test_checkpoint.py:88 in the port: 22 frames, a snapshot, a
    fresh estimator resumed from it for 12 more frames of the same drive;
    the resumed poses within the oracle's 0.05 m ATE."""
    cfg = dataclasses.replace(TConfig(), solver=dataclasses.replace(
        TConfig().solver, window_size=4, max_landmarks=32, max_iters=2))
    drive = simulator_drive(34, n_landmarks=60)
    est = TEstimator(cfg, dtype=DT, device=CPU)
    feed_drive(est, drive, range(22))
    assert est.solver_flag == est.NON_LINEAR
    path = str(tmp_path / "vio_state.npz")
    est.save_state(path)
    est2 = TEstimator(cfg, dtype=DT, device=CPU)
    est2.load_state(path)
    assert est2.solver_flag == est2.NON_LINEAR and est2.slot_of == est.slot_of and est2.ts == est.ts
    assert torch.equal(est2.core.state.poses, est.core.state.poses)
    feed_drive(est2, drive, range(22, 34))
    t_snap = drive[21]["t"]
    post = [(t, p) for t, p in est2.trajectory if t > t_snap]
    assert len(post) == 12 and est2.reboots == 0
    gt = {fr["t"]: fr["gt"] for fr in drive}
    ate = ate_rmse(np.stack([p[0:3] for _, p in post]), np.stack([gt[t][0:3] for t, _ in post]))
    assert ate < 0.05, f"post-resume ATE {ate:.4f} m"


def test_tracker_ids_continue_above_the_restored_ids(tmp_path):
    """After a state load the feature and line trackers hand out ids above
    every id of the restored slot maps (the JAX package restarts both at 0,
    so new features land in other landmarks' slots)."""
    cfg = dataclasses.replace(load_yaml(os.path.join(ROOT, "configs", "groundchallenge.yaml")),
                              use_line=True)
    saver = GroundFusionSystem(cfg, str(tmp_path / "a"), device=CPU)
    saver.estimator.slot_of = {3: 0, 977: 1}
    saver.estimator.line_slot_of = {41: 0}
    saver.save_checkpoint()
    system = GroundFusionSystem(cfg, str(tmp_path / "b"), device=CPU)
    system.load_checkpoint(state_path=str(tmp_path / "a" / "vio_state.npz"))
    assert system.tracker.next_id == 978 and system.line_tracker._next_id == 42
    img = chip_smoke.reloc_texture(np, 0)
    feats = system.tracker.track(0.0, np.kron(img, np.ones((4, 4)))[:480, :640])
    assert feats and min(feats) >= 978


def test_resume_feeds_nothing_at_or_before_the_snapshot(tmp_path, monkeypatch):
    """``run(resume=...)`` starts with the first frame and the first IMU,
    wheel, GNSS and GPS rows after the snapshot's newest window time (the
    JAX CLI replays the sequence from t = 0 into the restored window)."""
    seq = tmp_path / "seq"
    seq.mkdir()
    t = np.round(np.arange(0.0, 1.0, 0.01), 2)
    np.savetxt(seq / "imu.csv", np.c_[t, np.zeros((len(t), 6))], delimiter=",")
    np.savetxt(seq / "wheel.csv", np.c_[t[::2], np.zeros((len(t[::2]), 6))], delimiter=",")
    np.savetxt(seq / "gps.csv", np.c_[t[::10], np.zeros((10, 3)), np.ones(10)], delimiter=",")
    np.savetxt(seq / "gnss.csv", np.c_[np.repeat(t[::10], 2), np.tile([3, 5], 10),
                                       np.zeros((20, 14))], delimiter=",")
    np.save(seq / "img.npy", np.zeros((4, 4), np.float32))
    (seq / "frames.csv").write_text("".join(f"{k / 10:.1f},img.npy\n" for k in range(10)))
    t_snap = 0.4
    fed = {}

    def record(name):
        def fn(self, t, *a, **k):
            fed.setdefault(name, []).append(float(t))
        return fn

    for name in ("input_image", "input_imu", "input_wheel", "input_gnss", "input_gps_fix"):
        monkeypatch.setattr(GroundFusionSystem, name, record(name))
    monkeypatch.setattr(GroundFusionSystem, "load_checkpoint",
                        lambda self, **k: setattr(self.estimator, "ts", [0.2, 0.3, t_snap]))
    vio = tmp_path / "vio.txt"
    vio.write_text("")
    monkeypatch.setattr(GroundFusionSystem, "finish", lambda self, save_state=False: str(vio))
    cfg_path = os.path.join(ROOT, "configs", "m2dgrp.yaml")
    cli.run(cfg_path, str(seq), str(tmp_path / "out"), device="cpu", resume="vio_state.npz")
    assert fed["input_image"] == [0.5, 0.6, 0.7, 0.8, 0.9]
    # every row after the snapshot up to the last frame, and nothing else
    for name, times in (("input_imu", t), ("input_wheel", t[::2]), ("input_gnss", t[::10]),
                        ("input_gps_fix", t[::10])):
        assert fed[name] == [x for x in times if t_snap < x <= 0.9], name
    fed.clear()
    cli.run(cfg_path, str(seq), str(tmp_path / "out"), device="cpu")
    assert fed["input_image"][0] == 0.0 and fed["input_imu"] == [x for x in t if x <= 0.9]


def test_build_grid_matches_the_jax_script(tmp_path, capsys):
    """The port's builder and ``scripts/build_grid.py`` on the same
    ``pose_graph.npz`` and ``map.ply``: equal PGM headers, pixels equal (or
    one grey level apart where rounding flips one, counted), and the result
    loads back with its resolution and origin."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import build_grid as jbuild

    from ground_fusion_tpu.global_layers.pose_graph import Keyframe

    pg = JPoseGraph(JConfig())
    z8, z = np.zeros((4, 8), np.uint32), np.zeros((4, 2))
    for k in range(3):
        pose = np.array([1.0 * k, 0.5 * k, 0.0, 1.0, 0, 0, 0])
        pg.kfs.append(Keyframe(index=k, t=float(k), pose=pose, kp=z, kp_norm=z, desc=z8,
                               kp_ok=np.zeros(4, bool), win_pts3d=np.zeros((4, 3)), win_norm=z,
                               win_desc=z8, win_ok=np.zeros(4, bool), vio_pose=pose))
    jckpt.save_pose_graph(str(tmp_path / "pose_graph.npz"), pg)
    rng = np.random.default_rng(0)
    wall = np.stack([np.full(60, 4.0), np.linspace(-2, 2, 60), np.zeros(60)], -1)
    ring = np.c_[3.0 * np.cos(np.linspace(0, 6, 80)), 3.0 * np.sin(np.linspace(0, 6, 80)), np.zeros(80)]
    pts = np.concatenate([wall, ring]) + rng.normal(0, 0.01, (140, 3))
    write_cloud_ply(str(tmp_path / "map.ply"), pts, np.full((140, 3), 128.0))

    with jax.enable_x64(False):
        assert jbuild.build(str(tmp_path), str(tmp_path / "j.pgm"), res=0.1, size_m=20.0) == 0
    assert tbuild.main([str(tmp_path), str(tmp_path / "t.pgm"), "--res", "0.1", "--size", "20",
                        "--device", "cpu"]) == 0
    assert tbuild.main([str(tmp_path), "--res"]) == 2
    j, t = (open(tmp_path / f"{n}.pgm", "rb").read() for n in "jt")
    header = len(j) - 200 * 200
    assert j[:header] == t[:header]
    pj, pt = (np.frombuffer(b[header:], np.uint8).astype(int) for b in (j, t))
    flips = int((pj != pt).sum())
    assert np.abs(pj - pt).max() <= 1
    print(f"build_grid: {flips} of {pj.size} pixels one grey level apart")
    g = OccupancyGrid2D.load_pgm(str(tmp_path / "t.pgm"), device=CPU)
    assert g.n == 200 and g.res == 0.1 and np.allclose(g.origin, [-10.0, -10.0])
    prob = g.probability()
    assert prob[99:102, 139:142].max() > 0.6        # the wall (x = 4 m, y = 0) is occupied
    assert prob[99:102, 125:130].min() < 0.4        # free space carved on the way


@pytest.mark.slow
def test_cli_save_and_resume_on_the_rendered_sequence(tmp_path):
    """``chip_smoke.py`` phase 12a on the CPU: phase 4's sequence saved
    after ``chip_smoke.CKPT_FRAMES`` (15) frames through ``--save-state``,
    the grid built, then resumed over its first ``chip_smoke.CKPT_DRIVE``
    (26) frames with ``--resume``, ``--load-graph`` and ``--load-grid``
    (its checks: nothing fed again, post-snapshot ATE, ids, keyframe
    indices, the republished grid)."""
    seq = str(tmp_path / "seq")
    chip_smoke.render_smoke_sequence(seq)
    cfg_path = chip_smoke._loop_config(str(tmp_path))
    assert cli.main([cfg_path, seq, str(tmp_path / "out"), "--device", "cpu"]) == 0
    chip_smoke.phase_checkpoint_cli(torch, str(tmp_path), device="cpu")
