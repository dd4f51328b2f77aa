"""PyTorch port vs JAX package: the LK level's plain version, the plain
chain behind ``lk_track``, the pyramid, bidirectional tracking, corner
refill, depth sampling and the feature tracker, on the same numpy-seeded
images. On the CPU the port's wrappers run the plain versions; the CUDA
kernel itself is held against them on the GPU by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.cameras.models import PinholeParams as JPinhole
from ground_fusion_tpu.frontend import klt as jklt
from ground_fusion_tpu.frontend.tracker import FeatureTracker as JTracker
from ground_fusion_tpu.ops.pallas.klt import lk_level_pallas
from ground_fusion_tpu_torch.cameras.models import PinholeParams as TPinhole
from ground_fusion_tpu_torch.frontend import klt as tklt
from ground_fusion_tpu_torch.frontend.tracker import FeatureTracker as TTracker
from ground_fusion_tpu_torch.ops.cuda import klt as cuda_klt
from ground_fusion_tpu_torch.sim.render import render_frame


def _textured(h, w, seed=0):
    """Band-limited random texture (the case of tests/test_pallas_klt.py)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (h, w))
    k = np.ones(5) / 5.0
    for axis in (0, 1):
        base = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, base)
    return base * 400 + 128


def _level_case(h=120, w=160, n=40, seed=1):
    """Texture and its rolled copy; points inside, near every border, and
    invalid ones; seeds offset from the previous points."""
    tex = _textured(h, w)
    cur = np.roll(tex, (2, -1), (0, 1))
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(30, w - 30, n), rng.uniform(30, h - 30, n)], -1)
    pts[0:4] = [[3.5, 50.2], [w - 4.2, 60.0], [70.3, 2.1], [80.0, h - 3.3]]   # borders
    pts[4] = [-6.0, -4.0]                                                     # outside
    seed_pts = pts + rng.normal(0, 0.7, pts.shape)
    valid = np.ones(n, bool)
    valid[5:8] = False
    return tex, cur, pts, seed_pts, valid


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-3)])
def test_lk_level_reference_matches_jax(dtype, tol):
    tex, cur, pts, seed_pts, valid = _level_case()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_pts, want_ok = jklt._lk_level(
        jnp.asarray(tex, jd), jnp.asarray(cur, jd), jnp.asarray(pts, jd),
        jnp.asarray(seed_pts, jd), jnp.asarray(valid), 10, 10)
    got_pts, got_ok = cuda_klt.lk_level_reference(
        torch.as_tensor(tex, dtype=td), torch.as_tensor(cur, dtype=td),
        torch.as_tensor(pts, dtype=td), torch.as_tensor(seed_pts, dtype=td),
        torch.as_tensor(valid), 10, 10)
    want_ok = np.asarray(want_ok)
    assert np.array_equal(want_ok, got_ok.numpy())
    assert want_ok.sum() >= 20 and not want_ok[5:8].any()
    err = np.abs(np.asarray(want_pts) - got_pts.numpy()).max()
    assert err <= tol, err                       # px
    # features that are not ok keep their seed bit for bit
    assert np.array_equal(got_pts.numpy()[~want_ok], seed_pts.astype(dtype)[~want_ok])


def test_lk_level_reference_vs_pallas_interpret():
    """The textured-roll case of tests/test_pallas_klt.py: interior features
    agree with the TPU kernel (interpret mode) to 1e-2 px; flat is rejected."""
    h, w = 200, 280
    tex = _textured(h, w)
    cur = np.roll(tex, (3, -2), (0, 1))
    rng = np.random.default_rng(1)
    n = 24
    pts = np.stack([rng.uniform(40, w - 40, n), rng.uniform(40, h - 40, n)], -1).astype(np.float32)
    pal_pts, pal_ok = lk_level_pallas(jnp.asarray(tex, jnp.float32), jnp.asarray(cur, jnp.float32),
                                      jnp.asarray(pts), jnp.asarray(pts), jnp.ones(n, bool),
                                      half=10, iters=10)
    got_pts, got_ok = cuda_klt.lk_level(
        torch.as_tensor(tex, dtype=torch.float32), torch.as_tensor(cur, dtype=torch.float32),
        torch.as_tensor(pts), torch.as_tensor(pts), torch.ones(n, dtype=torch.bool), 10, 10)
    both = np.asarray(pal_ok) & got_ok.numpy()
    assert both.sum() >= n // 2
    d = np.linalg.norm(np.asarray(pal_pts) - got_pts.numpy(), axis=1)
    assert d[both].max() < 1e-2, d[both].max()
    shift_err = np.linalg.norm(got_pts.numpy()[both] - (pts[both] + np.array([-2.0, 3.0])), axis=1)
    assert np.median(shift_err) < 0.1

    flat = torch.full((128, 160), 100.0)
    p2 = torch.tensor([[80.0, 64.0], [40.0, 40.0]])
    out, ok = cuda_klt.lk_level(flat, flat, p2, p2, torch.ones(2, dtype=torch.bool))
    assert not bool(ok.any()) and torch.equal(out, p2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The argument checks of the CUDA path are plain Python and testable
    without a card: a 'meta' tensor is neither CPU nor CUDA."""
    img = torch.zeros((8, 8), device="meta")
    pts = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_klt.lk_level(img, img, pts, pts, torch.ones(2, dtype=torch.bool, device="meta"))


def _track_case(h=60, w=80, n=16, seed=3):
    """A texture and its copy shifted by (+2 rows, -1 column); points inside,
    near every border (so the ``inb`` masks bite) and invalid ones; seeds
    offset from the previous points."""
    tex = _textured(h, w, seed=seed)
    cur = np.roll(tex, (2, -1), (0, 1))
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(12, w - 12, n), rng.uniform(12, h - 12, n)], -1)
    pts[0:3] = [[1.5, 30.0], [w - 2.5, 25.0], [40.0, h - 1.2]]
    seed_pts = pts + rng.normal(0, 0.5, pts.shape)
    valid = np.ones(n, bool)
    valid[3:5] = False
    return tex, cur, pts, seed_pts, valid


def test_lk_track_reference_matches_jax_track_bidirectional():
    """The plain chain behind ``lk_track`` (3 levels, both directions, masks,
    round-trip gate) against the JAX package's ``track_bidirectional``, f64."""
    tex, cur, pts, seed_pts, valid = _track_case()
    jp0 = tuple(jklt.build_pyramid(jnp.asarray(tex, jnp.float64), 3))
    jp1 = tuple(jklt.build_pyramid(jnp.asarray(cur, jnp.float64), 3))
    want_pts, want_ok = jklt.track_bidirectional(
        jp0, jp1, jnp.asarray(pts), jnp.asarray(seed_pts), jnp.asarray(valid), 3, 10, 10, 0.5)
    got_pts, got_ok = cuda_klt.lk_track_reference(
        tklt.build_pyramid(torch.as_tensor(tex), 3), tklt.build_pyramid(torch.as_tensor(cur), 3),
        torch.as_tensor(pts), torch.as_tensor(seed_pts), torch.as_tensor(valid), 3, 10, 10, 0.5)
    want_ok = np.asarray(want_ok)
    assert np.array_equal(want_ok, got_ok.numpy())
    assert 6 <= want_ok.sum() < len(pts) - 2 and not want_ok[3:5].any()
    assert np.abs(np.asarray(want_pts) - got_pts.numpy()).max() <= 1e-6        # px


def test_lk_track_on_cpu_runs_the_plain_chain_and_counts_no_launch():
    tex, cur, pts, seed_pts, valid = _track_case()
    args = (tklt.build_pyramid(torch.as_tensor(tex, dtype=torch.float32), 3),
            tklt.build_pyramid(torch.as_tensor(cur, dtype=torch.float32), 3),
            torch.as_tensor(pts, dtype=torch.float32), torch.as_tensor(seed_pts, dtype=torch.float32),
            torch.as_tensor(valid), 3, 10, 10, 0.5)
    counts = (cuda_klt.TRACK_LAUNCHES, cuda_klt.TRACK_REFERENCE_CALLS, cuda_klt.LAUNCHES,
              cuda_klt.REFERENCE_CALLS)
    got = cuda_klt.lk_track(*args)
    assert (cuda_klt.TRACK_LAUNCHES, cuda_klt.TRACK_REFERENCE_CALLS, cuda_klt.LAUNCHES,
            cuda_klt.REFERENCE_CALLS) == (counts[0], counts[1] + 1, counts[2], counts[3])
    want = cuda_klt.lk_track_reference(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tracking_and_stereo_depths_go_through_lk_track(monkeypatch):
    """``track_bidirectional`` is one ``lk_track`` call, and the tracker's
    frame and stereo paths both reach it through ``track_bidirectional``."""
    calls = []

    def counting(*args):
        calls.append(args[5])                       # levels
        return cuda_klt.lk_track(*args)

    monkeypatch.setattr(tklt, "lk_track", counting)
    img0, _ = _blob_frame(20)
    img1, _ = _blob_frame(21, shift=(1.0, -1.0))
    tt = TTracker(TPinhole.make(300.0, 300.0, 160.0, 120.0), max_cnt=24, min_dist=20, device="cpu")
    tt.baseline = 0.1
    tt.track(0.0, img0)
    assert calls == []                              # nothing to track in the first frame
    tt.track(0.1, img1, img_right=np.roll(img1, -3, axis=1))
    assert calls == [3, 3]                          # the frame's features, then stereo depths


def _lk_meta_args():
    """Arguments of ``lk_track`` on 'meta' tensors (neither CPU nor CUDA),
    which the checks of the CUDA path see without a card."""
    def pyr():
        return [torch.empty((60 >> k, 80 >> k), device="meta") for k in range(3)]
    return [pyr(), pyr(), torch.empty((16, 2), device="meta"), torch.empty((16, 2), device="meta"),
            torch.empty(16, dtype=torch.bool, device="meta"), 3]


@pytest.mark.parametrize("case,error,match", [
    ("image_dtype", TypeError, "float32"),
    ("image_shape", ValueError, "expected"),
    ("image_device", ValueError, "is on cpu"),
    ("points_shape", ValueError, r"must be \[16, 2\]"),
    ("points_dtype", TypeError, "float32"),
    ("valid", ValueError, "bool or uint8"),
    ("levels_over_the_kernel", ValueError, "levels do not fit"),
    ("levels_over_the_pyramid", ValueError, "levels do not fit"),
    ("half_over_the_kernel", ValueError, "half-size"),
    ("too_many_rows", ValueError, "features do not fit"),
    ("meta", ValueError, "unsupported device"),
])
def test_lk_track_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    args, kw = _lk_meta_args(), {}
    if case == "image_dtype":
        args[1][1] = torch.empty((30, 40), dtype=torch.float64, device="meta")
    elif case == "image_shape":
        args[1][2] = torch.empty((16, 20), device="meta")
    elif case == "image_device":
        args[1][0] = torch.empty((60, 80))
    elif case == "points_shape":
        args[3] = torch.empty((16, 3), device="meta")
    elif case == "points_dtype":
        args[2] = torch.empty((16, 2), dtype=torch.float64, device="meta")
    elif case == "valid":
        args[4] = torch.empty(16, dtype=torch.int32, device="meta")
    elif case == "levels_over_the_kernel":
        args[5] = cuda_klt.MAX_LEVELS + 1
    elif case == "levels_over_the_pyramid":
        args[5] = 4
    elif case == "half_over_the_kernel":
        kw["half"] = cuda_klt.MAX_HALF + 1
    elif case == "too_many_rows":
        args[2] = args[3] = torch.empty((2**31, 2), device="meta")
        args[4] = torch.empty(2**31, dtype=torch.bool, device="meta")
    launches = cuda_klt.TRACK_LAUNCHES
    with pytest.raises(error, match=match):
        cuda_klt.lk_track(*args, **kw)
    assert cuda_klt.TRACK_LAUNCHES == launches


def test_pyramid_and_bidirectional_match_jax():
    tex = _textured(120, 160, seed=4)
    cur = np.roll(tex, (3, -2), (0, 1))
    jp0 = tuple(jklt.build_pyramid(jnp.asarray(tex, jnp.float64), 3))
    jp1 = tuple(jklt.build_pyramid(jnp.asarray(cur, jnp.float64), 3))
    tp0 = tklt.build_pyramid(torch.as_tensor(tex), 3)
    tp1 = tklt.build_pyramid(torch.as_tensor(cur), 3)
    for a, b in zip(jp0, tp0):
        assert a.shape == tuple(b.shape)
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-12

    rng = np.random.default_rng(2)
    n = 32
    pts = np.stack([rng.uniform(5, 155, n), rng.uniform(5, 115, n)], -1)
    valid = np.ones(n, bool)
    valid[-3:] = False
    want_pts, want_ok = jklt.track_bidirectional(
        jp0, jp1, jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid), 3, 10, 10, 0.5)
    got_pts, got_ok = tklt.track_bidirectional(
        tp0, tp1, torch.as_tensor(pts), torch.as_tensor(pts), torch.as_tensor(valid),
        3, 10, 10, 0.5)
    want_ok = np.asarray(want_ok)
    assert np.array_equal(want_ok, got_ok.numpy())
    assert want_ok.sum() >= 12
    assert np.abs(np.asarray(want_pts) - got_pts.numpy()).max() <= 1e-8   # px, f64


def _blob_frame(seed, w=320, h=240, n=90, shift=(0.0, 0.0)):
    rng = np.random.default_rng(7)
    uv = np.stack([rng.uniform(10, w - 10, n), rng.uniform(10, h - 10, n)], -1) + shift
    z = rng.uniform(1.0, 4.0, n)
    return render_frame(uv, z, np.ones(n, bool), np.random.default_rng(seed), w, h)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_refill_corners_same_picks_same_order(dtype):
    img, _ = _blob_frame(0)
    rng = np.random.default_rng(5)
    existing = np.stack([rng.uniform(0, 320, 12), rng.uniform(0, 240, 12)], -1)
    existing[0] = [2.0, 3.0]                     # box clipped by the image corner
    ev = np.ones(12, bool)
    ev[-2:] = False
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_pts, want_ok = jklt.refill_corners(
        jnp.asarray(img, jd), jnp.asarray(existing, jd), jnp.asarray(ev), 64, 25, 5)
    got_pts, got_ok = tklt.refill_corners(
        torch.as_tensor(img, dtype=td), torch.as_tensor(existing, dtype=td),
        torch.as_tensor(ev), 64, 25, 5)
    want_ok = np.asarray(want_ok)
    assert np.array_equal(want_ok, got_ok.numpy())
    assert 10 <= want_ok.sum() < 64              # both real picks and padding
    # same pixels in the same order (exact: integer pixel coordinates)
    assert np.array_equal(np.asarray(want_pts)[want_ok], got_pts.numpy()[want_ok])


def test_shi_tomasi_and_sample_depth_match_jax():
    img, depth = _blob_frame(1)
    want = np.asarray(jklt.shi_tomasi_response(jnp.asarray(img, jnp.float64)))
    got = tklt.shi_tomasi_response(torch.as_tensor(img, dtype=torch.float64)).numpy()
    assert np.abs(want - got).max() <= 1e-9 * max(1.0, np.abs(want).max())
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-5, 325, 50), rng.uniform(-5, 245, 50)], -1)
    pts[0] = [10.5, 20.5]                        # ties round to even in both
    want = np.asarray(jklt.sample_depth(jnp.asarray(depth, jnp.float64), jnp.asarray(pts)))
    got = tklt.sample_depth(torch.as_tensor(depth, dtype=torch.float64), torch.as_tensor(pts))
    assert np.array_equal(want, got.numpy())


def test_feature_tracker_three_frames_match_jax():
    """FeatureTracker.track over three rendered frames: same ids, pixels and
    normalized points within 1e-2 px, same depths."""
    fx = fy = 300.0
    cx, cy = 160.0, 120.0
    jt = JTracker(JPinhole.make(fx, fy, cx, cy), max_cnt=64, min_dist=20)
    tt = TTracker(TPinhole.make(fx, fy, cx, cy), max_cnt=64, min_dist=20, device="cpu")
    before = cuda_klt.LAUNCHES
    for k in range(3):
        img, depth = _blob_frame(10 + k, shift=(1.5 * k, -1.0 * k))
        fj = jt.track(0.1 * k, img, depth)
        ft = tt.track(0.1 * k, img, depth)
        assert list(fj.keys()) == list(ft.keys())
        assert len(fj) >= 30
        assert np.array_equal(jt.ids, tt.ids)
        assert np.abs(jt.prev_pts - tt.prev_pts).max() <= 1e-2          # px
        for fid in fj:
            a, b = fj[fid], ft[fid]
            assert abs(a.x - b.x) <= 1e-2 / fx and abs(a.y - b.y) <= 1e-2 / fy
            assert abs(a.vx - b.vx) <= 1e-3 and abs(a.vy - b.vy) <= 1e-3
            assert a.depth == b.depth
    assert (jt.track_len >= 2).sum() >= 20       # features really were tracked
    assert cuda_klt.LAUNCHES == before           # CPU tensors launch no kernel
