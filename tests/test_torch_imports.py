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
print("MODULES", len(names))
print("BAD", bad)
"""


def test_no_module_of_the_port_imports_jax():
    r = subprocess.run([sys.executable, "-c", _WALK], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = dict(l.split(" ", 1) for l in r.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 30
    assert lines["BAD"] == "[]", lines["BAD"]


def test_full_f32_arithmetic_is_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _no_gpu():
    return not torch.cuda.is_available()


@pytest.mark.parametrize("entry", ["resolve_device", "Estimator", "make_window_step",
                                   "FeatureTracker", "GroundFusionSystem", "PoseGraph",
                                   "KeyframeDatabase", "DBoW2Vocabulary", "load_binary", "cli"])
def test_entry_points_default_to_the_gpu_and_raise_without_one(entry, tmp_path):
    """No 'cuda if available else cpu': with no device argument every entry
    point resolves to the GPU, and raises on a machine that has none."""
    if not _no_gpu():
        pytest.skip("this machine has a GPU: the default device resolves")
    from ground_fusion_tpu_torch.cameras.models import PinholeParams
    from ground_fusion_tpu_torch.estimator.step import make_window_step
    from ground_fusion_tpu_torch.frontend.tracker import FeatureTracker
    from ground_fusion_tpu_torch.global_layers.bow import KeyframeDatabase
    from ground_fusion_tpu_torch.global_layers.dbow_vocab import DBoW2Vocabulary
    from ground_fusion_tpu_torch.global_layers.pose_graph import PoseGraph
    from ground_fusion_tpu_torch.pipeline import Estimator
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = Config()
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


@pytest.mark.parametrize("switch", ["map", "gnss", "use_line", "use_yolo", "burst_chunk"])
def test_unported_switches_raise_by_name(switch, tmp_path):
    import dataclasses

    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = Config()
    if switch in ("map", "gnss"):
        cfg = dataclasses.replace(cfg, **{switch: dataclasses.replace(getattr(cfg, switch), enabled=True)})
    elif switch == "burst_chunk":
        cfg = dataclasses.replace(cfg, burst_chunk=8)
    else:
        cfg = dataclasses.replace(cfg, **{switch: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GroundFusionSystem(cfg, str(tmp_path), device="cpu")


def test_unported_camera_models_raise_by_name():
    from ground_fusion_tpu_torch.cameras.models import make_camera

    for model in ("pinhole_full", "mei", "equidistant", "scaramuzza"):
        with pytest.raises(NotImplementedError, match=model):
            make_camera(model, 300.0, 300.0, 160.0, 120.0)
    with pytest.raises(ValueError):
        make_camera("no_such_model", 300.0, 300.0, 160.0, 120.0)


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
