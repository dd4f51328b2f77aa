"""PyTorch port vs JAX package: structural lines. The cases of
``tests/test_lines.py`` and the tier-1 cases of ``tests/test_lines_ba.py``,
each replayed through both packages on the same numpy-seeded inputs in
float64 (the line tracker in float32, as the JAX package runs it): the
Plücker/orthonormal maps and factors (1e-10), the segment detector, the
descriptor and the matcher (the same picks in the same order, endpoints and
descriptors within 1e-6), a 10-frame ``LineTracker`` run (the same ids), and
the estimator's line blocks — triangulation, ``onlyLineOpt``, the cull, the
slides, the rows with both filters, the Schur line tail, the solve and the
frame-0 marginalization (1e-8). The window step with lines is held in
``test_torch_step.py``. Under ``-m slow``: the stand-alone solve and
frame-0 marginalization with lines (each a JAX compile; the step holds
both), and the per-frame replay of points and segments through both
estimators with ``use_line``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.estimator import assembly as jasm
from ground_fusion_tpu.estimator import lines as jlines
from ground_fusion_tpu.estimator import marginalization as jmarg
from ground_fusion_tpu.estimator import solver as jsolver
from ground_fusion_tpu.estimator.layout import StateLayout as JLayout
from ground_fusion_tpu.estimator.window import Tracks as JTracks
from ground_fusion_tpu.estimator.window import WindowState as JState
from ground_fusion_tpu.frontend import lines as jfl
from ground_fusion_tpu.preintegration.imu import ImuPreint as JImuPreint
from ground_fusion_tpu.preintegration.wheel import WheelPreint as JWheelPreint
from ground_fusion_tpu_torch.estimator import assembly as tasm
from ground_fusion_tpu_torch.estimator import lines as tlines
from ground_fusion_tpu_torch.estimator import marginalization as tmarg
from ground_fusion_tpu_torch.estimator import solver as tsolver
from ground_fusion_tpu_torch.estimator.buffers import (
    empty_imu_buffer,
    empty_wheel_buffer,
    preintegrate_imu_window,
    preintegrate_wheel_window,
)
from ground_fusion_tpu_torch.estimator.layout import StateLayout as TLayout
from ground_fusion_tpu_torch.estimator.window import empty_state, empty_tracks
from ground_fusion_tpu_torch.frontend import lines as tfl
from ground_fusion_tpu_torch.geometry.se3 import pose_boxplus, pose_compose
from ground_fusion_tpu_torch.geometry.so3 import mat_to_quat, quat_to_mat, ypr_to_mat
from ground_fusion_tpu_torch.preintegration.imu import noise_cov
from ground_fusion_tpu_torch.preintegration.wheel import wheel_noise_cov
from ground_fusion_tpu_torch.utils import convert

JD, TD = jnp.float64, torch.float64
F = 6          # frames
LL = 4         # line slots
SCALE = 460.0 / 1.5


def _np(x):
    return np.array(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(a, b, tol, rel=False):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, np.abs(a).max()) if rel else 1.0
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol * scale:.3e}"


def _line_through(p0, d):
    d = d / np.linalg.norm(d)
    return np.concatenate([np.cross(p0, d), d])


# ---------------------------------------------------------------------------
# frontend/lines.py: geometry and the factor (tests/test_lines.py)
# ---------------------------------------------------------------------------


def test_orth_plk_maps_match_jax():
    """Ten random lines: Plücker → orthonormal → Plücker, both packages, 1e-10;
    the round trip returns the line up to scale and sign."""
    rng = np.random.default_rng(0)
    plk = np.stack([_line_through(rng.normal(0, 2, 3), rng.normal(0, 1, 3)) for _ in range(10)])
    jo = jfl.plk_to_orth(jnp.asarray(plk, JD))
    to = tfl.plk_to_orth(torch.as_tensor(plk))
    _close(jo, to, 1e-10)
    jp, tp = jfl.orth_to_plk(jo), tfl.orth_to_plk(to)
    _close(jp, tp, 1e-10)
    s = np.linalg.norm(plk, axis=1) / np.linalg.norm(_np(tp), axis=1)
    back = _np(tp) * s[:, None]
    assert np.all(np.minimum(np.abs(back - plk).max(1), np.abs(back + plk).max(1)) < 1e-9)
    q = mat_to_quat(ypr_to_mat(torch.tensor([0.3, -0.1, 0.2], dtype=TD)))
    t = torch.tensor([0.4, -0.2, 1.1], dtype=TD)
    _close(jfl.plk_transform(jnp.asarray(plk), jnp.asarray(_np(q)), jnp.asarray(_np(t))),
           tfl.plk_transform(torch.as_tensor(plk), q, t), 1e-10)


def test_line_residual_and_factor_match_jax():
    """``line_residual_raw`` on and off the line and ``line_factor``'s
    residual and 2×16 Jacobian: 1e-10 (the Jacobian relative to its
    largest entry)."""
    p0, d = np.array([1.0, 0.5, 4.0]), np.array([0.6, -0.2, 0.1])
    orth = tfl.plk_to_orth(torch.as_tensor(_line_through(p0, d)))
    R = ypr_to_mat(torch.tensor([0.2, 0.05, -0.1], dtype=TD))
    t = np.array([0.3, -0.1, 0.2])
    pose_i = torch.cat([torch.as_tensor(t), mat_to_quat(R)])
    ex = torch.tensor([0.05, -0.02, 0.1, 0.99, 0.05, -0.07, 0.02], dtype=TD)
    ex = torch.cat([ex[:3], ex[3:] / torch.linalg.norm(ex[3:])])
    obs = []
    for a in (0.0, 1.0):
        pc = R.numpy().T @ (p0 + a * d / np.linalg.norm(d) - t)
        obs.extend([pc[0] / pc[2], pc[1] / pc[2]])
    obs = torch.tensor(obs, dtype=TD)
    J = {k: jnp.asarray(_np(v)) for k, v in dict(p=pose_i, ex=ex, o=orth, ob=obs).items()}
    for d_orth in (0.0, 0.01):
        dj = jnp.asarray([d_orth, 0.0, 0.0, 0.0])
        _close(jfl.line_residual_raw(J["p"], J["ex"], J["o"] + dj, J["ob"]),
               tfl.line_residual_raw(pose_i, ex, orth + torch.as_tensor(_np(dj)), obs), 1e-10)
    assert float(tfl.line_residual_raw(pose_i, torch.tensor([0, 0, 0, 1.0, 0, 0, 0], dtype=TD),
                                       orth, obs).abs().max()) < 1e-9
    rj, Jj = jax.jit(jfl.line_factor)(J["p"], J["ex"], J["o"], J["ob"], jnp.asarray(SCALE))
    rt, Jt = tfl.line_factor(pose_i, ex, orth, obs, torch.tensor(SCALE, dtype=TD))
    assert tuple(Jt.shape) == (2, 16)
    _close(rj, rt, 1e-10, rel=True)
    _close(Jj, Jt, 1e-10, rel=True)


def test_two_view_triangulation_matches_jax():
    """``triangulate_line`` on the scene of ``tests/test_lines.py``: 1e-10,
    and the line recovered up to scale and sign."""
    p0, d = np.array([0.5, -0.3, 5.0]), np.array([1.0, 0.4, 0.0])
    cam_i = torch.tensor([0, 0, 0, 1.0, 0, 0, 0], dtype=TD)
    R = ypr_to_mat(torch.tensor([0.15, 0.0, 0.0], dtype=TD))
    cam_j = torch.cat([torch.tensor([1.0, 0.2, 0.0], dtype=TD), mat_to_quat(R)])

    def obs_of(cam):
        Rm, t = quat_to_mat(cam[3:7]).numpy(), cam[0:3].numpy()
        o = []
        for a in (0.0, 2.0):
            pc = Rm.T @ (p0 + a * d / np.linalg.norm(d) - t)
            o.extend([pc[0] / pc[2], pc[1] / pc[2]])
        return torch.tensor(o, dtype=TD)

    args = (obs_of(cam_i), obs_of(cam_j), cam_i, cam_j)
    want = jfl.triangulate_line(*[jnp.asarray(_np(a)) for a in args])
    got = tfl.triangulate_line(*args)
    _close(want, got, 1e-10)
    plk_gt = _line_through(p0, d)
    s = np.linalg.norm(plk_gt) / np.linalg.norm(_np(got))
    assert min(np.abs(_np(got) * s - plk_gt).max(), np.abs(_np(got) * s + plk_gt).max()) < 1e-6


# ---------------------------------------------------------------------------
# detection, description, matching, tracking
# ---------------------------------------------------------------------------


def _edge_image():
    """The image of ``tests/test_lines.py``: a vertical edge at x=60 and a
    horizontal one at y=40 — most tiles have strength 0, and the tiles along
    each edge have exactly equal strengths."""
    img = np.full((128, 160), 10.0)
    img[:, 60:] += 100.0
    img[40:, :] += 60.0
    return img


def _rendered_image():
    """640x480 rendered frame with blobs and drawn segments (the port's
    renderer), at the smoke sequence's intrinsics."""
    from ground_fusion_tpu_torch.sim.render import render_frame

    rng = np.random.default_rng(3)
    uv = np.stack([rng.uniform(10, 630, 300), rng.uniform(10, 470, 300)], -1)
    segs = np.array([[100.0, 50.0, 110.0, 400.0], [200.0, 300.0, 520.0, 350.0],
                     [400.0, 60.0, 420.0, 250.0], [560.0, 80.0, 600.0, 440.0]])
    img, _ = render_frame(uv, np.ones(300), np.ones(300, bool), rng, 640, 480,
                          segments_px=segs)
    return img.astype(np.float64)


@pytest.mark.parametrize("which", ["edges", "rendered"])
def test_detect_and_describe_match_jax(which):
    """The same segments in the same order (ties in tile order), endpoints
    and strengths within 1e-6, descriptors within 1e-6; the edge image's
    near-vertical segment at x=60 is found."""
    img = _edge_image() if which == "edges" else _rendered_image()
    max_lines = 32 if which == "edges" else 64
    js, jst, jok = jfl.detect_segments(jnp.asarray(img), tile=16, max_lines=max_lines)
    ts, tst, tok = tfl.detect_segments(torch.as_tensor(img), tile=16, max_lines=max_lines)
    assert np.array_equal(_np(jok), _np(tok))
    assert int(_np(tok).sum()) >= 6
    if which == "edges":
        # many tiles tie at strength 0, and the edge tiles tie among themselves
        assert (_np(tst) == 0).sum() > 0 and len(np.unique(_np(tst)[_np(tok)])) < _np(tok).sum()
        kept = _np(ts)[_np(tok)]
        ang = np.arctan2(kept[:, 3] - kept[:, 1], kept[:, 2] - kept[:, 0])
        assert np.any((np.abs(np.abs(ang) - np.pi / 2) < 0.2)
                      & (np.abs(0.5 * (kept[:, 0] + kept[:, 2]) - 60) < 8))
    _close(jst, tst, 1e-6, rel=True)
    _close(js, ts, 1e-6)
    _close(jfl.lbd_describe(jnp.asarray(img), js), tfl.lbd_describe(torch.as_tensor(img), ts),
           1e-6)


def test_detect_segments_breaks_ties_in_tile_order():
    """Every tile of a flat image has strength 0: the picks are tiles 0..k-1
    in order, as ``lax.top_k`` gives them."""
    img = np.full((64, 96), 7.0)
    js, _, _ = jfl.detect_segments(jnp.asarray(img), tile=16, max_lines=10)
    ts, tst, tok = tfl.detect_segments(torch.as_tensor(img), tile=16, max_lines=10)
    assert not bool(tok.any()) and float(tst.abs().max()) == 0.0
    _close(js, ts, 1e-12)
    cx = 0.5 * (_np(ts)[:, 0] + _np(ts)[:, 2])
    assert np.allclose(cx, np.arange(10) % 6 * 16.0)   # tile columns 0..5, then row 1


def test_match_lines_matches_jax():
    """The shifted edge image of ``tests/test_lines.py``: the same indices and
    flags; most segments match themselves."""
    img = _edge_image()
    segs, _, ok = jfl.detect_segments(jnp.asarray(img), tile=16, max_lines=32)
    img2 = np.roll(img, 3, axis=1)
    segs2 = segs + jnp.asarray([3.0, 0, 3.0, 0])
    jd, jd2 = jfl.lbd_describe(jnp.asarray(img), segs), jfl.lbd_describe(jnp.asarray(img2), segs2)
    ji, jm = jfl.match_lines(jd, segs, ok, jd2, segs2, ok, max_midpoint_dist=12.0)
    T = lambda a: torch.as_tensor(_np(a))
    ti, tm = tfl.match_lines(T(jd), T(segs), T(ok), T(jd2), T(segs2), T(ok), max_midpoint_dist=12.0)
    assert np.array_equal(_np(ji), _np(ti)) and np.array_equal(_np(jm), _np(tm))
    okn = _np(ok)
    assert ((_np(ti)[okn] == np.arange(32)[okn]) & _np(tm)[okn]).mean() > 0.6


def test_line_tracker_ten_frames_same_ids():
    """Ten frames of a moving edge image through both trackers (float32, as
    the JAX package runs its detector): the same ids every frame, endpoints
    within 1e-5, and ids persist across frames."""
    jt = jfl.LineTracker(fx=100.0, fy=100.0, cx=80.0, cy=64.0, max_lines=32, min_len_px=8.0)
    tt = tfl.LineTracker(fx=100.0, fy=100.0, cx=80.0, cy=64.0, max_lines=32, min_len_px=8.0,
                         device="cpu")
    base = _edge_image().astype(np.float32)
    base[90:94, 20:140] += 80.0                  # a bar: two more edges
    shared = 0
    prev = None
    for k in range(10):
        img = np.roll(base, (k // 3, 2 * k), axis=(0, 1))
        oj, ot = jt.track(img), tt.track(img)
        assert sorted(oj) == sorted(ot), f"frame {k}"
        for lid in oj:
            _close(oj[lid], ot[lid], 1e-5)
        if prev is not None:
            shared += len(set(prev) & set(ot))
        prev = ot
    assert shared >= 20


# ---------------------------------------------------------------------------
# estimator/lines.py (tests/test_lines_ba.py)
# ---------------------------------------------------------------------------


def _scene(seed, noise=0.0):
    """Poses along +x with a small attitude wiggle, generic 3-D segments in
    front (z in [2, 4]), their endpoints projected into each camera's
    normalized plane (ex_cam = identity), and the ground-truth lines in the
    frame-0 camera — the scene of ``tests/test_lines_ba.py``, in float64."""
    rng = np.random.default_rng(seed)
    state = empty_state(F, TD)
    poses = torch.stack([pose_boxplus(
        torch.tensor([0, 0, 0, 1.0, 0, 0, 0], dtype=TD),
        torch.tensor(np.concatenate([[0.3 * k, 0.02 * k, 0.01 * k],
                                     rng.normal(scale=0.02, size=3)]), dtype=TD))
        for k in range(F)])
    state = state._replace(poses=poses)
    a = rng.uniform(-1.5, 1.5, (LL, 3))
    a[:, 2] = rng.uniform(2.0, 4.0, LL)
    d = rng.normal(size=(LL, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = a + 1.5 * d
    cams = pose_compose(poses, state.ex_cam).numpy()
    obs = np.zeros((LL, F, 4))
    for k in range(F):
        R, t = quat_to_mat(torch.as_tensor(cams[k, 3:7])).numpy(), cams[k, 0:3]
        pa, pb = (a - t) @ R, (b - t) @ R
        obs[:, k] = np.stack([pa[:, 0] / pa[:, 2], pa[:, 1] / pa[:, 2],
                              pb[:, 0] / pb[:, 2], pb[:, 1] / pb[:, 2]], -1)
    obs += noise * rng.normal(size=obs.shape)
    plk_w = torch.as_tensor(np.concatenate([np.cross(a, b), b - a], -1))
    cam0 = torch.as_tensor(cams[0])
    orth_gt = tfl.plk_to_orth(tfl.plk_transform(plk_w, cam0[3:7], cam0[0:3]))
    lines = tlines.empty_line_tracks(LL, F, TD)._replace(
        active=torch.ones(LL, dtype=torch.bool), obs=torch.as_tensor(obs),
        obs_valid=torch.ones((LL, F), dtype=torch.bool))
    return state, lines, orth_gt, rng


def _to_jax(x):
    """A port NamedTuple of tensors → the JAX package's of the same name."""
    cls = {"WindowState": JState, "LineTracks": jlines.LineTracks}[type(x).__name__]
    return cls(**{k: jnp.asarray(v) for k, v in convert.to_numpy(x).items()})


def _lines_equal(jl, tl, tol):
    for name in tl._fields:
        a, b = _np(getattr(jl, name)), _np(getattr(tl, name))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b), name
        else:
            _close(a, b, tol)


def test_gt_lines_have_zero_residual_and_residuals_match_jax():
    state, lines, orth_gt, _ = _scene(0, noise=1e-3)
    lines = lines._replace(orth=orth_gt, solve_ok=torch.ones(LL, dtype=torch.bool))
    r = tlines.line_residuals(state, lines, 1.0, 1.0, min_obs=3)
    want = jax.jit(lambda s, l: jlines.line_residuals(s, l, 1.0, 1.0, min_obs=3))(
        _to_jax(state), _to_jax(lines))
    _close(want, r, 1e-10)
    exact = tlines.line_residuals(state, _scene(0)[1]._replace(
        orth=orth_gt, solve_ok=torch.ones(LL, dtype=torch.bool)), 1.0, 1.0)
    assert float(exact.abs().max()) < 1e-10


@pytest.mark.parametrize("filters", ["none", "lm_and_frame"])
def test_linearize_lines_matches_jax(filters):
    """Rows of every (line, frame) observation — J, r — against the JAX
    package, 1e-8 relative; the anchor observation's pose columns sum
    (additive scatter); with ``lm_filter``/``frame_filter`` as the frame-0
    marginalization passes them. Also the residual probe."""
    state, lines, orth_gt, rng = _scene(1, noise=1e-3)
    lines = lines._replace(orth=orth_gt + 0.01 * torch.as_tensor(rng.normal(size=(LL, 4))),
                           solve_ok=torch.ones(LL, dtype=torch.bool),
                           start_frame=torch.tensor([0, 1, 0, 2]))
    layout_t, layout_j = TLayout(F, 8, LL), JLayout(F, 8, LL)
    kw = {}
    if filters != "none":
        kw = dict(lm_filter=torch.tensor([True, False, True, True]),
                  frame_filter=torch.arange(F) >= 1)
    jkw = {k: jnp.asarray(_np(v)) for k, v in kw.items()}
    Jj, rj = jax.jit(lambda s, l: jlines.linearize_lines(
        s, l, layout_j, SCALE, 1.0, min_obs=3, **jkw))(_to_jax(state), _to_jax(lines))
    Jt, rt = tlines.linearize_lines(state, lines, layout_t, SCALE, 1.0, min_obs=3, **kw)
    assert np.count_nonzero(_np(Jt)) > 100
    _close(Jj, Jt, 1e-8, rel=True)
    _close(rj, rt, 1e-8, rel=True)
    # the anchor observation of line 0 (frame 0): its pose-0 block is the sum
    # of the pose_i and pose_j columns, which cancel
    if filters == "none":
        assert float(Jt[0:2, 0:6].abs().max()) < 1e-6 * float(Jt.abs().max())
        _close(tlines.line_residuals(state, lines, SCALE, 1.0, min_obs=3), rt, 1e-12, rel=True)


def test_triangulate_lines_matches_jax():
    """Untriangulated slots triangulate to the JAX package's lines (1e-8),
    with the same ``solve_ok``; disabled (``enabled=False``) nothing moves;
    the triangulated lines reproject onto the observations."""
    state, lines, _, _ = _scene(2)
    lines = lines._replace(start_frame=torch.tensor([0, 1, 0, 3]))
    jtri = jax.jit(lambda s, l, e: jlines.triangulate_lines(s, l, min_obs=3, min_cos_theta=0.9999,
                                                            enabled=e))
    for enabled in (True, False):
        j = jtri(_to_jax(state), _to_jax(lines), jnp.asarray(enabled))
        t = tlines.triangulate_lines(state, lines, min_obs=3, min_cos_theta=0.9999,
                                     enabled=torch.tensor(enabled))
        _lines_equal(j, t, 1e-8)
        assert bool(t.solve_ok[:3].all()) == enabled and not bool(t.solve_ok[3])
    r = tlines.line_residuals(state, t, 1.0, 1.0, min_obs=3)
    assert float(r.abs().max()) < 5e-3


def test_only_line_opt_matches_jax():
    """Eight steps of the batched line-only Gauss-Newton from perturbed
    lines: 1e-8 against the JAX package, and the cost falls 20-fold."""
    state, lines, orth_gt, rng = _scene(3, noise=1e-4)
    lines = lines._replace(orth=orth_gt + 0.02 * torch.as_tensor(rng.normal(size=(LL, 4))),
                           solve_ok=torch.tensor([True, True, True, False]))
    j = jax.jit(lambda s, l: jlines.only_line_opt(s, l, 1.0, min_obs=3, iters=8))(
        _to_jax(state), _to_jax(lines))
    t = tlines.only_line_opt(state, lines, 1.0, min_obs=3, iters=8)
    _lines_equal(j, t, 1e-8)
    c0 = float(torch.sum(tlines.line_residuals(state, lines, 1.0, 1.0, min_obs=3) ** 2))
    c1 = float(torch.sum(tlines.line_residuals(state, t, 1.0, 1.0, min_obs=3) ** 2))
    assert c1 < 0.05 * c0
    assert torch.equal(t.orth[3], lines.orth[3])          # unsolved: untouched


def test_solve_spd4_clamps_its_pivots():
    """The unrolled 4×4 Cholesky against the JAX package's on SPD, singular
    and zero blocks: equal to 1e-12, finite everywhere (pivots clamped at
    1e-12), and an exact solve on the SPD block."""
    rng = np.random.default_rng(9)
    A = rng.normal(size=(4, 4))
    blocks = [A @ A.T + np.eye(4), np.outer(A[0], A[0]), np.zeros((4, 4))]
    g = rng.normal(size=4)
    for H in blocks:
        want = _np(jlines._solve_spd4(jnp.asarray(H), jnp.asarray(g)))
        got = tlines._solve_spd4(torch.as_tensor(H), torch.as_tensor(g))
        assert np.all(np.isfinite(_np(got)))
        _close(want, got, 1e-12, rel=True)
    _close(np.linalg.solve(blocks[0], g), tlines._solve_spd4(torch.as_tensor(blocks[0]),
                                                             torch.as_tensor(g)), 1e-12)
    batched = tlines._solve_spd4(torch.as_tensor(np.stack(blocks))[:, None],
                                 torch.as_tensor(np.stack([g, -g]))[None])
    assert tuple(batched.shape) == (3, 2, 4)
    _close(batched[0, 1], tlines._solve_spd4(torch.as_tensor(blocks[0]), torch.as_tensor(-g)), 0)


def test_remove_line_outliers_matches_jax():
    state, lines, orth_gt, _ = _scene(4)
    bad = orth_gt.clone()
    bad[0] += torch.tensor([0.5, -0.4, 0.3, 0.2], dtype=TD)
    lines = lines._replace(orth=bad, solve_ok=torch.ones(LL, dtype=torch.bool))
    j = jax.jit(lambda s, l: jlines.remove_line_outliers(s, l, min_obs=3, max_reproj=3.0 / 460.0))(
        _to_jax(state), _to_jax(lines))
    t = tlines.remove_line_outliers(state, lines, min_obs=3, max_reproj=3.0 / 460.0)
    _lines_equal(j, t, 0.0)
    assert not bool(t.solve_ok[0]) and not bool(t.active[0]) and bool(t.solve_ok[1:].all())


def test_slides_match_jax():
    """Both slides on slots anchored at frames 0, 1, 0, 2 (one with no
    frame-0 observation) and on a table seen only at frame 0: 1e-10; a
    frame-0 line re-expressed in frame 1's camera still reprojects."""
    state, lines, orth_gt, _ = _scene(5)
    ov = lines.obs_valid.clone()
    ov[1, 0] = False
    lines = lines._replace(orth=orth_gt, solve_ok=torch.ones(LL, dtype=torch.bool),
                           start_frame=torch.tensor([0, 1, 0, 2]), obs_valid=ov)
    lonely = lines._replace(obs_valid=torch.zeros((LL, F), dtype=torch.bool).index_fill(1, torch.tensor([0]), True))
    for ln in (lines, lonely, lines._replace(start_frame=torch.zeros(LL, dtype=torch.int64))):
        _lines_equal(jlines.slide_old_lines(_to_jax(state), _to_jax(ln)),
                     tlines.slide_old_lines(state, ln), 1e-10)
        _lines_equal(jlines.slide_new_lines(_to_jax(ln)), tlines.slide_new_lines(ln), 0.0)
    assert not bool(tlines.slide_old_lines(state, lonely).active[0])
    old00 = tlines.slide_old_lines(state, lines._replace(start_frame=torch.zeros(LL, dtype=torch.int64)))
    st1 = state._replace(poses=torch.cat([state.poses[1:], state.poses[-1:]]))
    assert float(tlines.line_residuals(st1, old00, 1.0, 1.0, min_obs=3).abs().max()) < 1e-8


# ---------------------------------------------------------------------------
# the solve and the marginalization with lines
# ---------------------------------------------------------------------------


def _solve_problem(seed):
    """The joint-solve scene of ``tests/test_lines_ba.py``: triangulated lines,
    poses 1..F-1 perturbed, no IMU/wheel/visual rows, extrinsics fixed —
    as (port inputs, JAX inputs)."""
    state_gt, lines, _, rng = _scene(seed, noise=1e-4)
    lines = tlines.triangulate_lines(state_gt, lines, min_obs=3, min_cos_theta=0.9999)
    layout = TLayout(F, 8, LL)
    poses = state_gt.poses.clone()
    for k in range(1, F):
        poses[k] = pose_boxplus(poses[k], torch.as_tensor(rng.normal(scale=0.01, size=6)))
    state0 = state_gt._replace(poses=poses)
    free = np.ones(layout.total)
    free[layout.ex_cam: layout.ex_cam + 6] = 0.0
    free[layout.td] = 0.0
    free[layout.ex_wheel: layout.nx] = 0.0
    tinp = tasm.SolveInputs(
        imu_pre=preintegrate_imu_window(empty_imu_buffer(F, 4, TD), state0.sbs,
                                        noise_cov(0.1, 0.01, 1e-3, 1e-4, dtype=TD)),
        imu_valid=torch.zeros(F, dtype=torch.bool),
        wheel_pre=preintegrate_wheel_window(empty_wheel_buffer(F, 4, TD), state0.s_wheel,
                                            state0.td_wheel, wheel_noise_cov(0.1, 0.02, dtype=TD)),
        wheel_valid=torch.zeros(F, dtype=torch.bool), plane_valid=torch.zeros(F, dtype=torch.bool),
        td_obs=torch.zeros(F, dtype=TD), prior=tasm.empty_prior(layout, F, TD),
        g=torch.tensor([0, 0, 9.805], dtype=TD), free_mask=torch.as_tensor(free),
        lines=lines, line_min_obs=3)
    tracks = empty_tracks(8, F, TD)
    n = convert.to_numpy
    jinp = jasm.SolveInputs(
        imu_pre=JImuPreint(**{k: jnp.asarray(v) for k, v in n(tinp.imu_pre).items()}),
        imu_valid=jnp.zeros(F, bool),
        wheel_pre=JWheelPreint(**{k: jnp.asarray(v) for k, v in n(tinp.wheel_pre).items()}),
        wheel_valid=jnp.zeros(F, bool), plane_valid=jnp.zeros(F, bool), td_obs=jnp.zeros(F, JD),
        prior=jasm.empty_prior(JLayout(F, 8, LL), F, JD), g=jnp.asarray([0, 0, 9.805], JD),
        free_mask=jnp.asarray(free), lines=_to_jax(lines), line_min_obs=3)
    jtracks = JTracks(**{k: jnp.asarray(v) for k, v in n(tracks).items()})
    return state_gt, state0, tracks, lines, tinp, layout, jtracks, jinp


def _solver_params(mod, conv):
    return mod.SolverParams(
        sqrt_info_scale=conv(SCALE), cauchy_delta=conv(1.0),
        plane_sqrt_info=conv([100.0, 100.0, 100.0]), lm_lambda0=conv(1e-4),
        lm_up=conv(3.0), lm_down=conv(1.0 / 3.0))


@pytest.fixture(scope="module")
def solve_problem():
    return _solve_problem(6)


def test_schur_line_tail_matches_jax_and_the_dense_solve(solve_problem):
    """``_solve_delta_schur`` with 4×4 line blocks on the scene's normal
    equations: equal to the JAX package's Schur solve and to the port's own
    dense solve over all ``total`` columns, 1e-8 relative; the diagonal
    blocks are gathered as [LL, 4, 4]."""
    _, state0, tracks, lines, tinp, layout, _, _ = solve_problem
    J, r = tasm.assemble_rows(state0, tracks, tinp, layout, torch.tensor(SCALE, dtype=TD),
                              torch.tensor(1.0, dtype=TD), torch.tensor([100.0] * 3, dtype=TD))
    H, g = tasm.normal_equations(J, r)
    lines0 = layout.nx + layout.max_landmarks
    ar = torch.arange(LL)
    blocks = H[lines0:, lines0:].reshape(LL, 4, LL, 4)[ar, :, ar, :]
    assert tuple(blocks.shape) == (LL, 4, 4)
    assert torch.equal(blocks[1], H[lines0 + 4: lines0 + 8, lines0 + 4: lines0 + 8])
    for lam in (1e-6, 1e-2):
        schur = tsolver._solve_delta_schur(H, g, lam, tinp.free_mask, layout)
        dense = tsolver._solve_delta(H, g, lam, tinp.free_mask)
        want = jsolver._solve_delta_schur(jnp.asarray(_np(H)), jnp.asarray(_np(g)),
                                          jnp.asarray(lam), jnp.asarray(_np(tinp.free_mask)),
                                          JLayout(F, 8, LL))
        assert float(schur[lines0:].abs().max()) > 0
        _close(want, schur, 1e-8, rel=True)
        _close(dense, schur, 1e-8, rel=True)


@pytest.mark.slow
def test_solve_window_with_lines_matches_jax(solve_problem):
    """Eight dogleg iterations over the Schur path (the config's default)
    with line rows only: poses, lines and cost within 1e-8 of the JAX
    package; the line cost falls 20-fold. (The dense path over all
    ``total`` columns is held to the Schur path by the test above.) Under
    ``slow`` for its JAX compile: ``test_torch_step.py`` holds the solve
    with lines inside the window step."""
    linear = "schur"
    state_gt, state0, tracks, lines, tinp, layout, jtracks, jinp = solve_problem
    jl = JLayout(F, 8, LL)
    js, _, jln, jc = jax.jit(lambda s, t, i, l: jsolver.solve_window(
        s, t, i, jl, _solver_params(jsolver, lambda v: jnp.asarray(v, JD)), num_iters=8,
        lines=l, method="dogleg", linear_solver=linear))(_to_jax(state0), jtracks, jinp, jinp.lines)
    ts, _, tln, tc = tsolver.solve_window(
        state0, tracks, tinp, layout, _solver_params(tsolver, lambda v: torch.tensor(v, dtype=TD)),
        num_iters=8, lines=lines, method="dogleg", linear_solver=linear)
    _close(js.poses, ts.poses, 1e-8)
    _close(jln.orth, tln.orth, 1e-8)
    assert abs(float(jc) - float(tc)) <= 1e-8 * max(1.0, float(jc))
    c0 = float(torch.sum(tlines.line_residuals(state0, lines, SCALE, 1.0, min_obs=3) ** 2))
    c1 = float(torch.sum(tlines.line_residuals(ts, tln, SCALE, 1.0, min_obs=3) ** 2))
    assert c1 < 0.05 * c0


@pytest.mark.slow
def test_marginalize_old_with_lines_matches_jax():
    """Frame-0 line factors (the frame-0 observation skipped) fold into the
    prior: ``J0ᵀJ0`` and ``J0ᵀr0`` within 1e-8 of the JAX package's, PSD,
    over the camera block only. Under ``slow`` for its JAX compile:
    ``test_torch_step.py`` holds the prior of a step that marginalizes
    frame-0 lines."""
    state, lines, orth_gt, _ = _scene(7, noise=1e-4)
    lines = lines._replace(orth=orth_gt, solve_ok=torch.ones(LL, dtype=torch.bool),
                           start_frame=torch.tensor([0, 0, 1, 0]))
    layout = TLayout(F, 8, LL)
    ib = empty_imu_buffer(F, 4, TD)
    ib = ib._replace(dts=torch.full_like(ib.dts, 0.01),
                     acc=torch.cat([ib.acc[..., :2], torch.full_like(ib.acc[..., 2:], 9.805)], -1),
                     valid=torch.ones_like(ib.valid))
    ipre = preintegrate_imu_window(ib, state.sbs, noise_cov(0.1, 0.01, 1e-3, 1e-4, dtype=TD))
    wpre = preintegrate_wheel_window(empty_wheel_buffer(F, 4, TD), state.s_wheel, state.td_wheel,
                                     wheel_noise_cov(0.1, 0.02, dtype=TD))
    tinp = tasm.SolveInputs(
        imu_pre=ipre, imu_valid=torch.ones(F, dtype=torch.bool), wheel_pre=wpre,
        wheel_valid=torch.zeros(F, dtype=torch.bool), plane_valid=torch.zeros(F, dtype=torch.bool),
        td_obs=torch.zeros(F, dtype=TD), prior=tasm.empty_prior(layout, F, TD),
        g=torch.tensor([0, 0, 9.805], dtype=TD), free_mask=torch.ones(layout.total, dtype=TD),
        line_min_obs=3)
    n = convert.to_numpy
    jl = JLayout(F, 8, LL)
    jinp = jasm.SolveInputs(
        imu_pre=JImuPreint(**{k: jnp.asarray(v) for k, v in n(ipre).items()}),
        imu_valid=jnp.ones(F, bool),
        wheel_pre=JWheelPreint(**{k: jnp.asarray(v) for k, v in n(wpre).items()}),
        wheel_valid=jnp.zeros(F, bool), plane_valid=jnp.zeros(F, bool), td_obs=jnp.zeros(F, JD),
        prior=jasm.empty_prior(jl, F, JD), g=jnp.asarray([0, 0, 9.805], JD),
        free_mask=jnp.ones(jl.total, JD), line_min_obs=3)
    tracks = empty_tracks(8, F, TD)
    jtracks = JTracks(**{k: jnp.asarray(v) for k, v in n(tracks).items()})
    plane = [100.0, 100.0, 100.0]
    jp = jax.jit(lambda s, t, i, l: jmarg.marginalize_old(
        s, t, i, jl, SCALE, 1.0, jnp.asarray(plane, JD), lines=l))(
        _to_jax(state), jtracks, jinp, _to_jax(lines))
    tp = tmarg.marginalize_old(state, tracks, tinp, layout, SCALE, 1.0,
                               torch.tensor(plane, dtype=TD), lines=lines)
    J0, r0, T0, t0 = _np(jp.J0), _np(jp.r0), _np(tp.J0), _np(tp.r0)
    assert T0.shape == (layout.nx, layout.nx) and np.all(np.isfinite(T0))
    Hj, Ht = J0.T @ J0, T0.T @ T0
    assert np.abs(Hj).max() > 1.0
    assert np.abs(Hj - Ht).max() <= 1e-8 * np.abs(Hj).max()
    assert np.abs(J0.T @ r0 - T0.T @ t0).max() <= 1e-8 * max(1.0, np.abs(J0.T @ r0).max())
    ev = np.linalg.eigvalsh(0.5 * (Ht + Ht.T))
    assert ev.min() > -1e-9 * ev.max()
    # without the line factors the prior differs: they really joined
    tp0 = tmarg.marginalize_old(state, tracks, tinp, layout, SCALE, 1.0,
                                torch.tensor(plane, dtype=TD))
    assert np.abs(_np(tp0.J0).T @ _np(tp0.J0) - Ht).max() > 1e-3 * np.abs(Ht).max()


# ---------------------------------------------------------------------------
# the slice as a whole: points and segments through both estimators
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_line_replay_matches_jax_per_frame(monkeypatch):
    """The replay of ``tests/test_lines_ba.py::test_e2e_pipeline_with_lines``
    (200 landmarks, 12 segments, 30 frames, ``use_line`` with 16 slots at
    ``min_obs`` 4, the rig's ``body_T_cam`` in the config) through both
    ``Estimator``s in float64: per frame a pose from both or neither within
    1e-6, the same line slots, ``active`` and ``solve_ok``; at the end line
    slots are active and solved, and the ATE is below the oracle's 0.02 m.
    Compiles a full-size JAX window program."""
    from ground_fusion_tpu import pipeline as jpipeline
    from ground_fusion_tpu.config import Config as JConfig
    from ground_fusion_tpu.sim import synthetic as jsim
    from ground_fusion_tpu_torch.config import Config as TConfig
    from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
    from ground_fusion_tpu_torch.pipeline import FrameFeature as TFeature
    from ground_fusion_tpu_torch.sim import synthetic as tsim
    from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

    # the JAX estimator's window preintegration, jitted (eager it dispatches
    # for minutes a replay); the same function, compiled
    monkeypatch.setattr(jpipeline, "preintegrate_imu_window",
                        jax.jit(jpipeline.preintegrate_imu_window))
    monkeypatch.setattr(jpipeline, "preintegrate_wheel_window",
                        jax.jit(jpipeline.preintegrate_wheel_window))
    exn = np.asarray(jsim.body_T_cam(JD))

    def cfg_of(cls):
        cfg = cls(use_line=True)
        return dataclasses.replace(
            cfg, lines=dataclasses.replace(cfg.lines, max_lines=16, min_obs=4),
            camera=dataclasses.replace(cfg.camera, t_ic=tuple(exn[0:3]), q_ic=tuple(exn[3:7])))

    sp = jsim.SimParams()
    je = jpipeline.Estimator(cfg_of(JConfig), dtype=JD)
    je.native = None
    te = TEstimator(cfg_of(TConfig), dtype=TD, device="cpu")
    ex = jsim.body_T_cam(JD)
    pts_w = jnp.asarray(jsim.make_landmarks(200, sp, seed=1), JD)
    segs_np = jsim.make_segments(12, sp, seed=2)
    assert np.array_equal(segs_np, tsim.make_segments(12, tsim.SimParams(), seed=2))
    segs_w = jnp.asarray(segs_np, JD)
    frame_dt, imu_dt, wheel_dt = 1.0 / sp.frame_rate, 1.0 / sp.imu_rate, 1.0 / sp.wheel_rate

    def feed(kind, t):
        sample = jsim.imu_sample if kind == "imu" else jsim.wheel_sample
        a, g = np.asarray(sample(t, sp), dtype=np.float64)
        for e in (je, te):
            (e.input_imu if kind == "imu" else e.input_wheel)(float(t), a, g)

    feed("imu", 0.0)
    feed("wheel", 0.0)
    est, gt = [], []
    for k in range(30):
        t = k * frame_dt
        if k > 0:
            for ti in np.arange(t - frame_dt + imu_dt, t + 0.5 * imu_dt, imu_dt):
                feed("imu", ti)
            for ti in np.arange(t - frame_dt + wheel_dt, t + 0.5 * wheel_dt, wheel_dt):
                feed("wheel", ti)
        pose_gt = jsim.gt_pose7(t, sp)
        uv, z, vis = (np.asarray(x) for x in jsim.project_landmarks(pose_gt, ex, pts_w))
        obs4, lvis = (np.asarray(x) for x in jsim.project_segments(pose_gt, ex, segs_w))
        tobs4, tlvis = tsim.project_segments(torch.as_tensor(np.array(pose_gt)),
                                             torch.as_tensor(exn), torch.as_tensor(segs_np))
        assert np.array_equal(lvis, tlvis.numpy())
        assert not lvis.any() or np.abs(obs4 - tobs4.numpy())[lvis].max() < 1e-12
        ids = np.nonzero(vis)[0]
        line_obs = {int(i): obs4[i] for i in np.nonzero(lvis)[0]}
        pj = je.input_frame(t, {int(i): jpipeline.FrameFeature(
            x=float(uv[i, 0]), y=float(uv[i, 1]), depth=float(z[i])) for i in ids},
            line_obs=line_obs)
        pt = te.input_frame(t, {int(i): TFeature(
            x=float(uv[i, 0]), y=float(uv[i, 1]), depth=float(z[i])) for i in ids},
            line_obs=line_obs)
        assert (pj is None) == (pt is None), f"frame {k}"
        if pj is not None:
            assert np.abs(np.asarray(pj) - np.asarray(pt)).max() <= 1e-6, f"frame {k}"
            est.append(np.asarray(pt))
            gt.append(np.asarray(pose_gt))
        assert je.line_slot_of == te.line_slot_of, f"frame {k}"
        jl, tl = je.core.lines, te.core.lines
        for name in ("active", "solve_ok", "start_frame", "obs_valid"):
            assert np.array_equal(np.asarray(getattr(jl, name)), getattr(tl, name).numpy()), \
                f"frame {k}: {name}"
        assert np.abs(np.asarray(jl.orth) - tl.orth.numpy()).max() <= 1e-6, f"frame {k}"
    assert len(est) >= 15
    act, ok = te.core.lines.active.numpy(), te.core.lines.solve_ok.numpy()
    assert act.sum() >= 2 and (act & ok).sum() >= 1
    ate = ate_rmse(np.stack([p[0:3] for p in est]), np.stack([g[0:3] for g in gt]))
    print(f"line replay: {len(est)} poses, ATE {ate:.6f} m, {int(act.sum())} active line "
          f"slots, {int((act & ok).sum())} solved")
    assert ate < 0.02, f"ATE {ate:.4f} m with lines enabled"


def test_line_slots_fill_and_slide_like_jax():
    """The estimator's line bookkeeping during the window fill (no solve, so
    no JAX window program): ids appear, persist and vanish over four frames;
    a slot whose line died is recycled; ``_slide_fill_window`` slides the
    line table. The same slot map and tables as the JAX package's
    ``Estimator`` after every frame."""
    from ground_fusion_tpu import pipeline as jpipeline
    from ground_fusion_tpu.config import Config as JConfig
    from ground_fusion_tpu_torch.config import Config as TConfig
    from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
    from ground_fusion_tpu_torch.pipeline import FrameFeature as TFeature

    def small(cls):
        cfg = cls(use_line=True)
        # no wheel: the fill's wheel-predicted poses would run the JAX
        # package's eager wheel preintegration, tens of seconds a frame
        return dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, window_size=4, max_landmarks=16),
            lines=dataclasses.replace(cfg.lines, max_lines=4),
            wheel=dataclasses.replace(cfg.wheel, enabled=False))

    je = jpipeline.Estimator(small(JConfig), dtype=JD)
    je.native = None
    te = TEstimator(small(TConfig), dtype=TD, device="cpu")
    rng = np.random.default_rng(11)
    frames = [{1: 0, 2: 0, 3: 0}, {2: 0, 3: 0, 5: 0}, {3: 0, 5: 0, 6: 0, 7: 0, 8: 0}, {5: 0, 9: 0}]

    def same():
        assert je.line_slot_of == te.line_slot_of and je.free_line_slots == te.free_line_slots
        jl, tl = je.core.lines, te.core.lines
        for name in tl._fields:
            a, b = np.asarray(getattr(jl, name)), getattr(tl, name).numpy()
            assert np.array_equal(a, b) if a.dtype == bool or a.dtype.kind in "iu" \
                else np.abs(a - b).max() <= 1e-15, name

    for k, ids in enumerate(frames):
        if k == 2:
            # line 1's slot dies on the device (as a cull would): recycled
            slot = te.line_slot_of[1]
            je.core = je.core._replace(lines=je.core.lines._replace(
                active=je.core.lines.active.at[slot].set(False)))
            act = te.core.lines.active.clone()
            act[slot] = False
            te.core = te.core._replace(lines=te.core.lines._replace(active=act))
        obs = {i: rng.normal(0, 0.3, 4) for i in ids}
        feats = {0: (0.1, 0.0)}
        je.input_frame(0.1 * k, {i: jpipeline.FrameFeature(x=x, y=y) for i, (x, y) in feats.items()},
                       line_obs=obs)
        te.input_frame(0.1 * k, {i: TFeature(x=x, y=y) for i, (x, y) in feats.items()},
                       line_obs=obs)
        same()
    assert 1 not in te.line_slot_of and int(te.core.lines.active.sum()) == 4
    je._slide_fill_window()
    te._slide_fill_window()
    same()
