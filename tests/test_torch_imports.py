"""The port stands alone: importing every module of it pulls in neither JAX
nor the JAX package; its entry points refuse to run without a GPU unless the
CPU is asked for by name; on CPU tensors the kernel wrapper runs its plain
version and counts no launch."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ground_fusion_tpu_torch as gft
from ground_fusion_tpu_torch.config import Config, load_yaml, parse_simple_yaml
from ground_fusion_tpu_torch.ops.cuda import klt as cuda_klt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WALK = """
import importlib, pkgutil, sys
import ground_fusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "jaxlib" or m == "ground_fusion_tpu" or m.startswith("ground_fusion_tpu."))
from ground_fusion_tpu_torch.parallel import sharded
print("MODULES", len(names))
print("NAMES", " ".join(names))
print("SHARDED", " ".join(n for n in dir(sharded) if not n.startswith("_")))
print("BAD", bad)
"""


def test_no_module_of_the_port_imports_jax():
    r = subprocess.run([sys.executable, "-c", _WALK], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = dict(l.split(" ", 1) for l in r.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 30
    walked = set(lines["NAMES"].split())
    for name in ("estimator.sfm", "global_layers.dense_map", "global_layers.meshing",
                 "frontend.lines", "estimator.lines", "detector.model", "detector.train",
                 "cameras.calibration", "utils.wheel_odom", "native", "scripts.build_native",
                 "scripts.train_detector", "scripts.make_synth_seq", "scripts.profile_step",
                 "scripts.parity", "scripts.long_horizon", "scripts.bow_sweep",
                 "scripts.convert_bag"):
        assert f"ground_fusion_tpu_torch.{name}" in walked, name
    assert {"make_lm_mesh", "shard_core", "shard_tracks", "gather_core",
            "make_sharded_window_step", "shard_fleet", "make_sharded_pose_graph"} <= set(
        lines["SHARDED"].split())
    assert lines["BAD"] == "[]", lines["BAD"]


def test_no_estimator_module_imports_torch_distributed():
    """The estimator takes its cross-landmark sums through a ``reduce``
    callable: no module under ``estimator/`` imports ``torch.distributed``
    (only ``parallel/sharded.py`` does)."""
    import ast

    folder = os.path.join(ROOT, "ground_fusion_tpu_torch", "estimator")
    for name in sorted(os.listdir(folder)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            assert not any(m.startswith("torch.distributed") for m in mods), (name, mods)


def test_full_f32_arithmetic_is_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _no_gpu():
    return not torch.cuda.is_available()


@pytest.mark.parametrize("entry", ["resolve_device", "Estimator", "make_window_step",
                                   "FeatureTracker", "GroundFusionSystem", "PoseGraph",
                                   "KeyframeDatabase", "DBoW2Vocabulary", "load_binary",
                                   "GlobalFusion", "VoxelColorMap", "TsdfVolume",
                                   "OccupancyGrid2D", "LineTracker", "load_npz", "init_params",
                                   "calibrate", "make_sharded_window_step", "cli",
                                   "build_window_problem", "make_batch", "train",
                                   "profile_step", "run_pipeline", "bow_sweep"])
def test_entry_points_default_to_the_gpu_and_raise_without_one(entry, tmp_path):
    """No 'cuda if available else cpu': with no device argument every entry
    point resolves to the GPU, and raises on a machine that has none."""
    if not _no_gpu():
        pytest.skip("this machine has a GPU: the default device resolves")
    from ground_fusion_tpu_torch.cameras.calibration import calibrate
    from ground_fusion_tpu_torch.cameras.models import PinholeParams
    from ground_fusion_tpu_torch.detector.model import init_params, load_npz
    from ground_fusion_tpu_torch.detector.train import make_batch, train
    from ground_fusion_tpu_torch.estimator.step import make_window_step
    from ground_fusion_tpu_torch.frontend.lines import LineTracker
    from ground_fusion_tpu_torch.frontend.tracker import FeatureTracker
    from ground_fusion_tpu_torch.global_layers.bow import KeyframeDatabase
    from ground_fusion_tpu_torch.global_layers.dbow_vocab import DBoW2Vocabulary
    from ground_fusion_tpu_torch.global_layers.dense_map import OccupancyGrid2D, VoxelColorMap
    from ground_fusion_tpu_torch.global_layers.global_fusion import GlobalFusion
    from ground_fusion_tpu_torch.global_layers.meshing import TsdfVolume
    from ground_fusion_tpu_torch.global_layers.pose_graph import PoseGraph
    from ground_fusion_tpu_torch.parallel.sharded import make_sharded_window_step
    from ground_fusion_tpu_torch.pipeline import Estimator
    from ground_fusion_tpu_torch.scripts import bow_sweep, parity, profile_step
    from ground_fusion_tpu_torch.sim.synthetic import SimParams, build_window_problem
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = Config()
    board = np.stack(np.meshgrid(np.arange(4.0), np.arange(3.0)), -1).reshape(-1, 2)
    # a one-level vocabulary: the root and its two leaves
    tree = (2, 1, np.array([[1, 2], [-1, -1], [-1, -1]]), np.zeros((3, 8), np.uint32),
            np.array([-1, 0, 1]), np.ones(3))
    vocab_path = str(tmp_path / "vocab.bin")
    DBoW2Vocabulary.save_binary(vocab_path, *tree)
    calls = {
        "resolve_device": lambda: gft.resolve_device(None),
        "Estimator": lambda: Estimator(cfg),
        "make_window_step": lambda: make_window_step(cfg),
        "FeatureTracker": lambda: FeatureTracker(PinholeParams.make(300.0, 300.0, 160.0, 120.0)),
        "GroundFusionSystem": lambda: GroundFusionSystem(cfg, str(tmp_path)),
        "PoseGraph": lambda: PoseGraph(cfg),
        "KeyframeDatabase": lambda: KeyframeDatabase(capacity=4, n_words=16),
        "DBoW2Vocabulary": lambda: DBoW2Vocabulary(*tree, n_words=2),
        "load_binary": lambda: DBoW2Vocabulary.load_binary(vocab_path),
        "GlobalFusion": lambda: GlobalFusion(),
        "VoxelColorMap": lambda: VoxelColorMap(capacity=16),
        "TsdfVolume": lambda: TsdfVolume(resolution=4),
        "OccupancyGrid2D": lambda: OccupancyGrid2D(size_m=1.0, resolution=0.5),
        "LineTracker": lambda: LineTracker(300.0, 300.0, 160.0, 120.0),
        "load_npz": lambda: load_npz(os.path.join(ROOT, "ground_fusion_tpu_torch", "detector",
                                                  "weights.npz")),
        "init_params": lambda: init_params(),
        "calibrate": lambda: calibrate("pinhole", board, [board * 100.0] * 3),
        "make_sharded_window_step": lambda: make_sharded_window_step(cfg),
        "build_window_problem": lambda: build_window_problem(cfg, SimParams()),
        "make_batch": lambda: make_batch(np.random.default_rng(0), 1),
        "train": lambda: train(steps=1, batch=1),
        "profile_step": lambda: profile_step.profile(cfg, reps=1),
        "run_pipeline": lambda: parity.run_pipeline(n_frames=1),
        "bow_sweep": lambda: bow_sweep.scores(n_scenes=1),
    }
    if entry == "cli":
        r = subprocess.run(
            [sys.executable, "-m", "ground_fusion_tpu_torch",
             os.path.join(ROOT, "configs", "groundchallenge.yaml"), str(tmp_path), str(tmp_path)],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=ROOT))
        assert r.returncode != 0
        assert "trajectory written" not in r.stdout
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert gft.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_gpu():
    if not _no_gpu():
        pytest.skip("this machine has a GPU")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_lk_level_on_cpu_uses_the_plain_version_and_counts_no_launch():
    img = torch.rand((40, 48), generator=torch.Generator().manual_seed(0)) * 255.0
    pts = torch.tensor([[20.0, 20.0], [30.0, 15.0]])
    valid = torch.ones(2, dtype=torch.bool)
    launches, plain = cuda_klt.LAUNCHES, cuda_klt.REFERENCE_CALLS
    got = cuda_klt.lk_level(img, img, pts, pts, valid, half=5, iters=3)
    want = cuda_klt.lk_level_reference(img, img, pts, pts, valid, half=5, iters=3)
    assert cuda_klt.LAUNCHES == launches and cuda_klt.REFERENCE_CALLS == plain + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("switch", ["use_yolo", "burst_chunk"])
def test_yolo_and_burst_switches_build(switch, tmp_path):
    """``use_yolo`` builds the system with the detector and the shipped
    weights on the device it was given; ``burst_chunk`` puts its estimator in
    burst mode with that chunk."""
    import dataclasses

    from ground_fusion_tpu_torch.detector.model import load_npz
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = Config()
    if switch == "burst_chunk":
        cfg = dataclasses.replace(cfg, burst_chunk=8)
        system = GroundFusionSystem(cfg, str(tmp_path), device="cpu")
        assert system._burst and system.estimator._burst_chunk == 8
        return
    system = GroundFusionSystem(dataclasses.replace(cfg, use_yolo=True), str(tmp_path), device="cpu")
    shipped = load_npz(os.path.join(ROOT, "ground_fusion_tpu_torch", "detector", "weights.npz"),
                       device="cpu")
    assert len(system.detector_params.convs) == 5
    for got, want in zip(system.detector_params.convs[4] + (system.detector_params.head_w,),
                         shipped.convs[4] + (shipped.head_w,)):
        assert got.device.type == "cpu" and torch.equal(got, want)
    assert GroundFusionSystem(cfg, str(tmp_path), device="cpu").detector_params is None


def test_use_line_config_builds_with_lines(tmp_path):
    """``use_line`` no longer raises: on the CPU the system builds its line
    tracker and the estimator its line table and a layout with 4 columns
    per line slot; a frame with segment observations fills line slots."""
    import dataclasses

    from ground_fusion_tpu_torch.pipeline import FrameFeature
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = load_yaml(os.path.join(ROOT, "configs", "groundchallenge.yaml"))
    cfg = dataclasses.replace(cfg, use_line=True)
    system = GroundFusionSystem(cfg, str(tmp_path), device="cpu")
    est = system.estimator
    ll = cfg.lines.max_lines
    assert system.line_tracker is not None and system.line_tracker.device.type == "cpu"
    assert est.layout.max_lines == ll
    assert est.layout.total == est.layout.nx + cfg.solver.max_landmarks + 4 * ll
    assert tuple(est.core.lines.obs.shape) == (ll, cfg.num_frames, 4)
    est.input_frame(0.0, {0: FrameFeature(x=0.1, y=0.0)},
                    line_obs={7: np.array([0.1, -0.2, 0.1, 0.2]), 9: np.array([-0.3, 0.0, 0.2, 0.05])})
    assert sorted(est.line_slot_of) == [7, 9]
    assert int(est.core.lines.active.sum()) == 2 and int(est.core.lines.obs_valid[:, 0].sum()) == 2


@pytest.mark.parametrize("flag,kw", [
    (["--burst", "8"], {"burst": 8}), (["--save-state"], {"save_state": True}),
    (["--resume", "vio_state.npz"], {"resume": "vio_state.npz"}),
    (["--load-graph", "pose_graph.npz"], {"load_graph": "pose_graph.npz"}),
    (["--load-grid", "grid.pgm"], {"load_grid": "grid.pgm"})],
    ids=["burst", "save-state", "resume", "load-graph", "load-grid"])
def test_cli_flags_reach_run(flag, kw, monkeypatch):
    """The JAX package's CLI flags are all ported: each reaches ``run`` with
    its keyword, never read as the output directory; a flag that needs a
    value and has none (or a non-integer K) exits with 2 before anything
    runs."""
    from ground_fusion_tpu_torch import __main__ as cli

    ran = []
    monkeypatch.setattr(cli, "run", lambda *a, **k: ran.append((a, k)))
    assert cli.main(["cfg.yaml", "seq", "out", *flag, "--device", "cpu"]) == 0
    assert ran == [(("cfg.yaml", "seq", "out"), {"device": "cpu", **kw})]
    assert cli.main(["cfg.yaml", "seq", *flag]) == 0
    assert ran[-1] == (("cfg.yaml", "seq", "output"), kw)
    if len(flag) == 2:
        assert cli.main(["cfg.yaml", "seq", "out", flag[0]]) == 2
        assert cli.main(["cfg.yaml", "seq", "out", flag[0], "--device", "cpu"]) == 2
        if flag[0] == "--burst":
            assert cli.main(["cfg.yaml", "seq", "--burst", "x"]) == 2
        assert len(ran) == 2
    ran.clear()
    assert cli.main(["cfg.yaml", "seq", "out", "--device", "cpu"]) == 0
    assert ran == [(("cfg.yaml", "seq", "out"), {"device": "cpu"})]


@pytest.mark.parametrize("switch", ["map", "calibrate_extrinsic"])
def test_map_and_extrinsic_calibration_configs_build(switch, tmp_path):
    """``map`` (with its TSDF mesh) and ``solver.calibrate_extrinsic`` no
    longer raise: the system builds its voxel map and TSDF on the device it
    was given, and the estimator takes the hand-eye bootstrap."""
    import dataclasses

    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = Config()
    if switch == "map":
        cfg = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, enabled=True, mesh=True,
                                                                mesh_resolution=8))
    else:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                  calibrate_extrinsic=True))
    system = GroundFusionSystem(cfg, str(tmp_path), device="cpu")
    if switch == "map":
        assert system.voxel_map.counts.device.type == "cpu"
        assert tuple(system.tsdf.tsdf.shape) == (8, 8, 8)
    else:
        assert system.voxel_map is None and system.estimator.cfg.solver.calibrate_extrinsic


def test_m2dgrp_config_builds_with_gnss(tmp_path):
    """``configs/m2dgrp.yaml`` (tight GNSS) builds in the port: the estimator
    carries a GNSS table and ingest, the system waits for GPS fixes."""
    from ground_fusion_tpu_torch.pipeline import Estimator
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = load_yaml(os.path.join(ROOT, "configs", "m2dgrp.yaml"))
    assert cfg.gnss.enabled
    est = Estimator(cfg, device="cpu")
    assert est.gnss is not None and not est.gnss_aligned
    assert tuple(est.core.gnss_obs.valid.shape) == (cfg.num_frames, cfg.gnss.max_sats)
    system = GroundFusionSystem(cfg, str(tmp_path), device="cpu")
    assert system.global_fusion is None and system.estimator.gnss is not None


def test_every_camera_model_dispatches_and_unknown_raises():
    """Each of the five models of the JAX package dispatches (none raises
    ``NotImplementedError`` any more); an unknown name raises ``ValueError``."""
    from ground_fusion_tpu_torch.cameras.models import make_camera

    for model in ("pinhole", "pinhole_full", "mei", "equidistant", "scaramuzza"):
        cam = make_camera(model, 300.0, 300.0, 160.0, 120.0, device="cpu")
        assert cam.name == model
        uv = cam.space_to_plane(torch.tensor([[0.1, -0.05, 1.0]]))
        assert tuple(uv.shape) == (1, 2) and bool(torch.isfinite(uv).all())
    with pytest.raises(ValueError):
        make_camera("no_such_model", 300.0, 300.0, 160.0, 120.0)


@pytest.mark.parametrize("model", ["pinhole_full", "mei", "equidistant", "scaramuzza"])
def test_system_hooks_run_with_every_camera_model(model, tmp_path):
    """The system with each non-pinhole model (Mei and Scaramuzza lift to
    rays that are not z = 1 before scaling): the host copy of the camera that
    the prediction seeding and the keyframe hook use projects and lifts
    consistently, a keyframe maps into the voxel map and the TSDF, and the
    CLI runs a short sequence rendered through the model with ``use_yolo``."""
    import dataclasses

    from chip_smoke import camera_cases
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = Config()
    cam = dataclasses.replace(cfg.camera, model=model, width=64, height=48, fx=60.0, fy=60.0,
                              cx=32.0, cy=24.0, distortion=dict(camera_cases(np))[model])
    cfg = dataclasses.replace(cfg, camera=cam, map=dataclasses.replace(
        cfg.map, enabled=True, mesh=True, mesh_resolution=8, depth_stride=4))
    system = GroundFusionSystem(cfg, str(tmp_path), device="cpu")
    assert system.cam.name == model
    rays = torch.tensor([[0.1, -0.05, 1.0], [-0.2, 0.1, 1.0]])
    px = system.cam.project(system._cam_host, rays)
    back = system.cam.lift(system._cam_host, px)
    assert torch.allclose(back[:, 0:2] / back[:, 2:3], rays[:, 0:2], atol=1e-4)
    img = np.full((48, 64), 100.0, np.float32)
    depth = np.full((48, 64), 2.0, np.float32)
    system._map_keyframe(np.array([0.0, 0, 0, 1, 0, 0, 0]), img, depth)
    assert int(system.voxel_map.counts.gt(0).sum()) > 0
    assert bool(torch.isfinite(system.tsdf.tsdf).all())

    # the CLI on a short sequence rendered through that model, with use_yolo
    from ground_fusion_tpu_torch import __main__ as cli
    from ground_fusion_tpu_torch.cameras.models import make_camera
    from ground_fusion_tpu_torch.sim.render import render_sequence

    cam64 = make_camera(model, 60.0, 60.0, 32.0, 24.0, cam.distortion, dtype=torch.float64,
                        device="cpu")
    # 96x96: the detector needs its 16 candidate boxes (a 3x3 grid of 3 anchors)
    seq = render_sequence(str(tmp_path / "seq"), 3, 60.0, 60.0, 32.0, 24.0, 96, 96,
                          n_landmarks=300, camera=cam64)
    with open(os.path.join(ROOT, "configs", "groundchallenge.yaml")) as fp:
        text = fp.read()
    for old_line, new_line in (("model: pinhole", f"model: {model}"), ("width: 640", "width: 96"),
                               ("height: 480", "height: 96"), ("cx: 330.0", "cx: 32.0"),
                               ("cy: 248.0", "cy: 24.0"), ("fx: 611.4509887695312", "fx: 60.0"),
                               ("fy: 611.4857177734375", "fy: 60.0"),
                               ("distortion: [0.0, 0.0, 0.0, 0.0]",
                                f"distortion: {[float(v) for v in cam.distortion]}"),
                               ("use_yolo: false", "use_yolo: true")):
        text = text.replace(old_line, new_line)
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as fp:
        fp.write(text)
    out = str(tmp_path / "out")
    assert cli.main([cfg_path, seq, out, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(out, "vio.txt"))


@pytest.mark.parametrize("name", ["groundchallenge.yaml", "m2dgrp.yaml"])
def test_config_copy_and_yaml_subset_parser_match_the_jax_package(name):
    """The port's own copy of the config module loads the shipped files to
    the same values as the JAX package's, with PyYAML and without it."""
    import dataclasses

    import yaml

    from ground_fusion_tpu.config import load_yaml as jload

    path = os.path.join(ROOT, "configs", name)
    assert dataclasses.asdict(load_yaml(path)) == dataclasses.asdict(jload(path))
    with open(path) as fp:
        text = fp.read()
    assert parse_simple_yaml(text) == yaml.safe_load(text)
