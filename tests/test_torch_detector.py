"""The port's detector against the JAX package's: weights carried both ways
(npz and ``params_from_jax``), the backbone at the training size and at an
odd size, ``detect`` on scenes of the training renderer, the cull, the
shipped weights' copy and recall, and the system's ``use_yolo`` hook.

The convolutions run in bfloat16 in both packages, and XLA and PyTorch round
at their own points, so features agree to a bfloat16 tolerance: 2e-2 of the
largest feature magnitude. Measured on the CPU: the port is at most 0.0156
from the JAX backbone run eagerly and 0.03125 from it jitted, features of
~2.6 (one and two roundings); the jitted and eager JAX backbones differ by
the same 0.03125. Detections are compared away from the thresholds."""

import dataclasses
import hashlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ground_fusion_tpu.detector import model as jd  # noqa: E402
from ground_fusion_tpu.detector.train import render_scene as jax_render_scene  # noqa: E402
from ground_fusion_tpu_torch.detector import model as td  # noqa: E402
from ground_fusion_tpu_torch.detector.train import render_scene  # noqa: E402

JAX_WEIGHTS = os.path.join(ROOT, "ground_fusion_tpu", "detector", "weights.npz")
PORT_WEIGHTS = os.path.join(ROOT, "ground_fusion_tpu_torch", "detector", "weights.npz")


def _leaves(params):
    """(HWIO kernels and vectors as numpy) of either package's params."""
    out = []
    for blk in params.convs:
        for k, v in zip(("w", "b", "g", "be", "m", "v"), blk):
            a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            out.append(a.transpose(2, 3, 1, 0) if isinstance(v, torch.Tensor) and k == "w" else a)
    for v, is_w in ((params.head_w, True), (params.head_b, False)):
        a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        out.append(a.transpose(2, 3, 1, 0) if isinstance(v, torch.Tensor) and is_w else a)
    return out


def test_npz_both_ways_between_the_packages(tmp_path):
    """A file either package writes loads in the other to the same arrays,
    bit for bit (the JAX key scheme, kernels HWIO on disk)."""
    jp = jd.init_params(jax.random.PRNGKey(3))
    jd.save_npz(str(tmp_path / "jax.npz"), jp)
    tp = td.load_npz(str(tmp_path / "jax.npz"), device="cpu")
    for a, b in zip(_leaves(tp), _leaves(jp)):
        np.testing.assert_array_equal(a, b)
    assert tuple(tp.convs[1][0].shape) == (32, 16, 3, 3)        # OIHW in memory
    mine = td.init_params(torch.Generator().manual_seed(5), device="cpu")
    td.save_npz(str(tmp_path / "port.npz"), mine)
    back = jd.load_npz(str(tmp_path / "port.npz"))
    for a, b in zip(_leaves(back), _leaves(mine)):
        np.testing.assert_array_equal(a, b)
    with np.load(str(tmp_path / "port.npz")) as z, np.load(JAX_WEIGHTS) as ref:
        assert sorted(z.files) == sorted(ref.files)
        assert all(z[k].dtype == ref[k].dtype and z[k].shape == ref[k].shape for k in ref.files)


def test_params_from_jax_carries_the_shipped_weights():
    """``params_from_jax`` of the JAX package's loaded weights (as arrays)
    equals the port's own load of its copy, and the ``Detector`` module holds
    the same tensors and detects as ``detect`` does."""
    jp = jd.load_npz(JAX_WEIGHTS)
    tp = td.params_from_jax([[np.asarray(v) for v in blk] for blk in jp.convs],
                            np.asarray(jp.head_w), np.asarray(jp.head_b), device="cpu")
    mine = td.load_npz(PORT_WEIGHTS, device="cpu")
    for a, b in zip(_leaves(tp), _leaves(mine)):
        np.testing.assert_array_equal(a, b)
    module = td.Detector(tp)
    assert len(list(module.buffers())) == 6 * 5 + 2
    img = torch.as_tensor(render_scene(np.random.default_rng(1))[0])
    for a, b in zip(module(img), td.detect(mine, img)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(96, 96), (80, 112)], ids=["96x96", "odd-80x112"])
def test_backbone_matches_jax(shape):
    """The backbone on the same seeded images: at 96x96 (the training size)
    and at 80x112, whose fifth pool sees an odd 5x7 grid (the JAX "SAME"
    window pads its high side; the port's ``ceil_mode``)."""
    jp = jd.load_npz(JAX_WEIGHTS)
    tp = td.load_npz(PORT_WEIGHTS, device="cpu")
    img = np.random.default_rng(2).uniform(0, 1, (2,) + shape + (3,)).astype(np.float32)
    fj = np.asarray(jax.jit(jd.backbone)(jp, jnp.asarray(img)))
    ft = td.backbone(tp, torch.as_tensor(img)).numpy()
    assert ft.shape == fj.shape == (2, -(-shape[0] // 32), -(-shape[1] // 32), 256)
    gap = np.abs(ft - fj).max() / np.abs(fj).max()
    assert gap <= chip_smoke.DET_FEAT_TOL, gap


def test_detect_matches_jax_on_training_scenes():
    """``detect`` on ten scenes of the training renderer (seed 99): boxes,
    classes, scores and ``valid`` agree with the JAX package's away from the
    confidence and IoU thresholds; the scenes are the JAX renderer's."""
    jp = jd.load_npz(JAX_WEIGHTS)
    tp = td.load_npz(PORT_WEIGHTS, device="cpu")
    rng, jrng = np.random.default_rng(99), np.random.default_rng(99)
    n_valid = 0
    for _ in range(10):
        img, boxes, n = render_scene(rng)
        img_j, boxes_j, n_j = jax_render_scene(jrng)
        assert np.array_equal(img, img_j) and np.array_equal(boxes, boxes_j) and n == n_j
        j = [np.asarray(x) for x in jd.detect(jp, jnp.asarray(img), conf_thresh=0.3)]
        t = [x.numpy() for x in td.detect(tp, torch.as_tensor(img), conf_thresh=0.3)]
        assert t[0].shape == (16, 4) and t[2].dtype == np.int64 and t[3].dtype == bool
        ok, box_px, score = chip_smoke.detections_agree(np, t, j)
        assert ok, (box_px, score)
        n_valid += int(t[3].sum())
    assert n_valid >= 10


def test_cull_features_in_boxes_exact():
    """The cull against the JAX package's on random points, boxes, classes
    and validity, with points on box edges (inclusive bounds)."""
    rng = np.random.default_rng(4)
    boxes = np.sort(rng.uniform(0, 100, (16, 2, 2)), axis=1).transpose(0, 2, 1).reshape(16, 4)
    boxes = boxes[:, [0, 2, 1, 3]].astype(np.float32)
    pts = rng.uniform(0, 100, (200, 2)).astype(np.float32)
    pts[:16] = boxes[:, 0:2]
    pts[16:32] = boxes[:, 2:4]
    classes = rng.integers(0, 8, 16)
    valid = rng.uniform(size=16) > 0.3
    want = np.asarray(jd.cull_features_in_boxes(jnp.asarray(pts), jnp.asarray(boxes),
                                                jnp.asarray(classes), jnp.asarray(valid)))
    got = td.cull_features_in_boxes(torch.as_tensor(pts), torch.as_tensor(boxes),
                                    torch.as_tensor(classes), torch.as_tensor(valid)).numpy()
    assert np.array_equal(got, want) and 0 < got.sum() < len(got)


def test_shipped_weights_are_the_jax_file_and_recall():
    """The port's weights file is the JAX package's, byte for byte, and the
    port's detector recalls ≥ 0.7 of the rendered objects at IoU 0.3
    (tests/test_detector.py:74-96)."""
    def sha(path):
        with open(path, "rb") as fp:
            return hashlib.sha256(fp.read()).hexdigest()

    assert sha(PORT_WEIGHTS) == sha(JAX_WEIGHTS)
    tp = td.load_npz(PORT_WEIGHTS, device="cpu")
    rng = np.random.default_rng(99)
    scenes = [render_scene(rng) for _ in range(10)]
    results = [[x.numpy() for x in td.detect(tp, torch.as_tensor(s[0]), conf_thresh=0.3)]
               for s in scenes]
    hits, total = chip_smoke.detector_recall(np, results, [(s[1], s[2]) for s in scenes])
    assert hits >= 0.7 * total, f"detector recall {hits}/{total}"


def _yolo_cfg():
    from ground_fusion_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(
        cfg, use_yolo=True,
        camera=dataclasses.replace(cfg.camera, width=96, height=96, fx=110.0, fy=110.0,
                                   cx=48.0, cy=48.0),
        tracker=dataclasses.replace(cfg.tracker, max_features=48, min_dist_px=4.0, border=3,
                                    fb_thresh_px=1.0))


def test_system_with_use_yolo_loads_weights_and_culls(tmp_path):
    """``use_yolo``: ``<out_dir>/detector.npz`` wins over the shipped file;
    without it the shipped weights load. On a rendered scene the tracker
    returns features on the object, and every feature that does not reach
    the estimator lies in a valid dynamic-class box, as the cull says."""
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    run_dir = tmp_path / "run"
    run_dir.mkdir()
    mine = td.init_params(torch.Generator().manual_seed(7), device="cpu")
    td.save_npz(str(run_dir / "detector.npz"), mine)
    sys_run = GroundFusionSystem(_yolo_cfg(), str(run_dir), device="cpu")
    assert torch.equal(sys_run.detector_params.head_w, mine.head_w)

    system = GroundFusionSystem(_yolo_cfg(), str(tmp_path / "shipped"), device="cpu")
    shipped = td.load_npz(PORT_WEIGHTS, device="cpu")
    assert torch.equal(system.detector_params.head_w, shipped.head_w)
    assert system.detector_params.head_w.device.type == "cpu"

    img, boxes, _ = render_scene(np.random.default_rng(7))
    seen = {}
    inner = system.estimator.input_frame

    def recording(t, feats, **kw):
        seen.update(feats)
        return inner(t, feats, **kw)

    system.estimator.input_frame = recording
    system.input_image(0.0, img, np.ones(img.shape[:2], np.float32))
    pts, ids = system.tracker.prev_pts, system.tracker.ids
    gt = boxes[0]
    on_obj = (pts[:, 0] >= gt[0]) & (pts[:, 0] <= gt[2]) & (pts[:, 1] >= gt[1]) & (pts[:, 1] <= gt[3])
    dropped = np.array([int(i) not in seen for i in ids])
    assert on_obj.any() and dropped[on_obj].any(), "no feature on the object was culled"
    b, _, c, v = td.detect(shipped, torch.as_tensor(img))
    keep = td.cull_features_in_boxes(torch.as_tensor(pts), b, c, v).numpy()
    assert np.array_equal(~keep, dropped)
    assert system.stats.counts["detect"] == 1


@pytest.mark.slow
def test_use_yolo_replay_through_both_systems(tmp_path):
    """tests/test_detector_e2e.py's replay through the port's system: the
    object's features reach the tracker and the detector keeps (nearly) all
    of them out of the estimator, and the culled replay stays within the
    oracle's ATE bound, as the JAX system's does on the same scene."""
    import test_detector_e2e as e2e

    ate_j, cnt_j = e2e._replay(tmp_path / "jax", use_yolo=True)
    ate_off, cnt_off = e2e._replay(tmp_path / "jax_off", use_yolo=False)

    import ground_fusion_tpu.system as jsys
    import ground_fusion_tpu_torch.system as tsys

    orig = jsys.GroundFusionSystem
    jsys.GroundFusionSystem = lambda cfg, out: tsys.GroundFusionSystem(
        _port_cfg(cfg), out, device="cpu")
    try:
        ate_t, cnt_t = e2e._replay(tmp_path / "port", use_yolo=True)
    finally:
        jsys.GroundFusionSystem = orig
    assert max(cnt_off) >= 5
    assert sum(cnt_t) <= 0.2 * sum(cnt_off), (cnt_t, cnt_off)
    assert sum(cnt_j) <= 0.2 * sum(cnt_off), (cnt_j, cnt_off)
    assert ate_t < 0.15 and ate_j < 0.15, (ate_t, ate_j)


def _port_cfg(jcfg):
    """The JAX package's Config carried into the port's (the same fields)."""
    from ground_fusion_tpu_torch import config as tc

    def conv(obj, cls):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            kw[f.name] = conv(v, getattr(tc, type(v).__name__)) if dataclasses.is_dataclass(v) else v
        return cls(**kw)

    return conv(jcfg, tc.Config)
