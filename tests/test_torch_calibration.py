"""The port's intrinsic calibration against the JAX package's: the ChESS
response and corner detector on a rendered board, the NumPy helpers (grid
order, DLT, Zhang, pose from homography, the ψ→θ basis), ``calibrate`` for
the pinhole model against the JAX ``calibrate`` in float64, and the other
four models against the oracles' truths (tests/test_calibration.py) on the
port. Board views are generated through the port's projections in float64;
the JAX oracles run with x64 on (tests/conftest.py)."""

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
from ground_fusion_tpu.cameras import calibration as jc  # noqa: E402
from ground_fusion_tpu_torch.cameras import calibration as tc  # noqa: E402

HELPER_TOL = 1e-9


def _board_image(rows=4, cols=5, sq=40):
    """tests/test_calibration.py:46-55's rendered chessboard."""
    h, w = (rows + 1) * sq + 80, (cols + 1) * sq + 80
    img = np.full((h, w), 200.0)
    for r in range(rows + 1):
        for c in range(cols + 1):
            if (r + c) % 2 == 0:
                y0, x0 = 40 + r * sq, 40 + c * sq
                img[y0:y0 + sq, x0:x0 + sq] = 30.0
    return img


def test_chess_response_and_detect_corners_match_jax():
    """The ring response equals the JAX package's on the rendered board, and
    the detected corners and their scores are the same, in the same order."""
    img = _board_image()
    img[::7, ::5] += 3.0           # break the board's symmetries a little
    np.testing.assert_allclose(tc.chess_response(torch.as_tensor(img)).numpy(),
                               np.asarray(jc.chess_response(jnp.asarray(img))), rtol=0, atol=1e-9)
    pts_j, val_j = jc.detect_corners(jnp.asarray(img), max_corners=20, nms=8)
    pts_t, val_t = tc.detect_corners(torch.as_tensor(img), max_corners=20, nms=8)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=0, atol=1e-9)
    grid = tc.order_grid(pts_t.numpy(), 4, 5)
    np.testing.assert_array_equal(grid, jc.order_grid(np.asarray(pts_j), 4, 5))


def test_numpy_helpers_match_jax():
    """order_grid, homography_dlt, zhang_intrinsics, pose_from_homography and
    the ψ→θ matrix on the pinhole oracle's views, within 1e-9."""
    name, gt, project, view_kw, _ = chip_smoke.calibration_cases()[0]
    world, img_pts = chip_smoke.calibration_views(project, gt, **view_kw)
    hs_t = [tc.homography_dlt(world, p) for p in img_pts]
    hs_j = [jc.homography_dlt(world, p) for p in img_pts]
    np.testing.assert_allclose(np.stack(hs_t), np.stack(hs_j), rtol=HELPER_TOL, atol=HELPER_TOL)
    k_t, k_j = tc.zhang_intrinsics(hs_t), jc.zhang_intrinsics(hs_j)
    np.testing.assert_allclose(k_t, k_j, rtol=HELPER_TOL)
    K = np.array([[k_t[0], 0, k_t[2]], [0, k_t[1], k_t[3]], [0, 0, 1.0]])
    for h in hs_t:
        np.testing.assert_allclose(tc.pose_from_homography(h, K), jc.pose_from_homography(h, K),
                                   rtol=HELPER_TOL, atol=HELPER_TOL)
    pts = np.random.default_rng(0).permutation(img_pts[0])
    np.testing.assert_array_equal(tc.order_grid(pts, 6, 8), jc.order_grid(pts, 6, 8))
    assert tc.order_grid(pts[:10], 6, 8) is None
    np.testing.assert_array_equal(tc._PSI2THETA, jc._PSI2THETA)


def test_calibrate_pinhole_matches_jax():
    """``calibrate("pinhole")`` and ``calibrate_pinhole`` on the pinhole
    oracle's eight views: the intrinsics, poses and RMS of the JAX
    ``calibrate`` in float64 (LM steps accepted on the device), and the
    oracle's recovery bounds. Near the minimum an LM step's accept/reject
    test compares two almost equal costs, so rounding (thread counts, XLA's
    reduction order) can flip one decision and end the 25 steps elsewhere in
    the flat bottom: measured 1e-12 to 8.1e-7 px apart on fx (one and six
    workers), hence 1e-6 relative on the intrinsics and 1e-7 on the poses;
    the RMS at the bottom agrees to 1e-9 px."""
    name, gt, project, view_kw, iters = chip_smoke.calibration_cases()[0]
    world, img_pts = chip_smoke.calibration_views(project, gt, **view_kw)
    res = tc.calibrate(name, world, img_pts, iters=iters, device="cpu")
    ref = jc.calibrate(name, world, img_pts, iters=iters)
    assert res.params[0].dtype == torch.float64 and res.params[0].device.type == "cpu"
    np.testing.assert_allclose([float(v) for v in res.params], [float(v) for v in ref.params],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res.poses, ref.poses, rtol=0, atol=1e-7)
    assert abs(res.rms_px - ref.rms_px) < 1e-9
    assert not chip_smoke.calibration_errors(name, gt, project, res)
    short = tc.calibrate_pinhole(world, img_pts, iters=2, device="cpu")
    assert short.rms_px > res.rms_px
    with pytest.raises(ValueError):
        tc.calibrate("no_such_model", world, img_pts, device="cpu")


@pytest.mark.parametrize("name", ["equidistant", "mei", "pinhole_full", "scaramuzza"])
def test_calibrate_recovers_the_oracles_truth(name):
    """Each of the other four models on its oracle's views and iterations,
    within the oracle's bounds (tests/test_calibration.py:98-249): RMS,
    reprojection parity over the working field up to the planar gauge,
    Scaramuzza's canonical sign and fitted cam2world round trip."""
    case = {c[0]: c for c in chip_smoke.calibration_cases()}[name]
    _, gt, project, view_kw, iters = case
    world, img_pts = chip_smoke.calibration_views(project, gt, **view_kw)
    res = tc.calibrate(name, world, img_pts, iters=iters, device="cpu")
    assert type(res.params).__name__ == type(gt).__name__
    bad = chip_smoke.calibration_errors(name, gt, project, res)
    assert not bad, bad


def test_jacobian_on_the_optical_axis_stays_finite():
    """A board point on the optical axis: the JAX package's projection
    Jacobians are NaN there for the equidistant and Scaramuzza models (the
    derivative of ``linalg.norm`` at 0), so an LM step that saw such a point
    would never be accepted; the port's ``torch.linalg.norm`` has a zero
    derivative at 0 and its Jacobians stay finite. Off the axis they agree."""
    from ground_fusion_tpu.cameras import models as jm
    from ground_fusion_tpu_torch.cameras import models as tm

    pts = np.array([[0.0, 0.0, 1.0], [0.1, -0.05, 1.2]])
    cases = [
        (jm.EquidistantParams.make(300.0, 300.0, 320.0, 240.0, -0.01, 0.004, dtype=jnp.float64),
         tm.EquidistantParams.make(300.0, 300.0, 320.0, 240.0, -0.01, 0.004, dtype=torch.float64),
         jm.equidistant_space_to_plane, tm.equidistant_space_to_plane, True),
        (jm.MeiParams.make(0.9, 600.0, 600.0, 320.0, 240.0, dtype=jnp.float64),
         tm.MeiParams.make(0.9, 600.0, 600.0, 320.0, 240.0, dtype=torch.float64),
         jm.mei_space_to_plane, tm.mei_space_to_plane, False),
        (jm.ScaramuzzaParams.make([0.0] * 5, [471.0, -300.0, 0.0], dtype=jnp.float64),
         tm.ScaramuzzaParams.make([0.0] * 5, [471.0, -300.0, 0.0], dtype=torch.float64),
         jm.scaramuzza_space_to_plane_zfwd, tm.scaramuzza_space_to_plane_zfwd, True),
    ]
    for jp, tp, jf, tf, nan_in_jax in cases:
        Jj = np.asarray(jax.jacfwd(lambda x: jf(jp, x))(jnp.asarray(pts)))
        Jt = torch.func.jacfwd(lambda x: tf(tp, x))(torch.as_tensor(pts)).numpy()
        assert np.isfinite(Jt).all()
        assert bool(np.isnan(Jj[0]).any()) == nan_in_jax
        np.testing.assert_allclose(Jt[1], Jj[1], rtol=1e-12, atol=1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["equidistant", "mei", "pinhole_full", "scaramuzza"])
def test_calibrate_matches_jax(name):
    """The other four models against the JAX ``calibrate`` on the same views
    (float64): the RMS to 1e-9 px, the intrinsics to 1e-5 relative (the
    degenerate coefficient directions of a finite field move by more than
    the pinhole's), the same fitted Scaramuzza model to 1e-3 px over the field."""
    case = {c[0]: c for c in chip_smoke.calibration_cases()}[name]
    _, gt, project, view_kw, iters = case
    world, img_pts = chip_smoke.calibration_views(project, gt, **view_kw)
    res = tc.calibrate(name, world, img_pts, iters=iters, device="cpu")
    ref = jc.calibrate(name, world, img_pts, iters=iters)
    assert abs(res.rms_px - ref.rms_px) < 1e-9
    if name != "scaramuzza":
        np.testing.assert_allclose([float(v) for v in res.params], [float(v) for v in ref.params],
                                   rtol=1e-5, atol=1e-5)
        return
    from ground_fusion_tpu.cameras import models as jm
    from ground_fusion_tpu_torch.cameras import models as tm

    rays = np.concatenate([np.random.default_rng(6).uniform(-0.3, 0.3, (200, 2)),
                           np.ones((200, 1))], 1)
    uv_t = tm.scaramuzza_space_to_plane_zfwd(res.params, torch.as_tensor(rays)).numpy()
    uv_j = np.asarray(jm.scaramuzza_space_to_plane_zfwd(ref.params, jnp.asarray(rays)))
    assert np.abs(uv_t - uv_j).max() < 1e-3
