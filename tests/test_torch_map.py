"""PyTorch port vs JAX package: the dense map — RGB-D sampling, the voxel
colour hash, the occupancy grid, the TSDF volume and its mesh extraction —
and the system's map hooks (insertion at drift-corrected keyframe poses, the
rebuild after a loop relaxation, the world-z gate, the files ``finish``
writes), on the CPU.

The map objects of both packages start from the same state where a test
needs it (``utils/convert.py::map_state_from``); float64 where the compared
tolerance asks for it, float32 where the JAX package computes in float32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.global_layers import dense_map as jdm
from ground_fusion_tpu.global_layers import meshing as jmesh
from ground_fusion_tpu.global_layers.pose_graph import Keyframe as JKeyframe
from ground_fusion_tpu.system import GroundFusionSystem as JSystem
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.global_layers import dense_map as tdm
from ground_fusion_tpu_torch.global_layers import meshing as tmesh
from ground_fusion_tpu_torch.global_layers.pose_graph import Keyframe as TKeyframe
from ground_fusion_tpu_torch.system import GroundFusionSystem as TSystem
from ground_fusion_tpu_torch.utils import convert

CPU = "cpu"


# ---------------------------------------------------------------- sampling


def test_sample_rgbd_matches_jax():
    """Stride, margins, depth gates and the white-pixel cull: every output
    exactly (``tests/test_mapping.py::test_sample_rgbd_gates``' image, with
    random depths, holes and white pixels)."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.0, 8.0, (120, 160)).astype(np.float32)
    depth[rng.random((120, 160)) < 0.2] = 0.0
    color = rng.uniform(0, 255, (120, 160, 3)).astype(np.float32)
    color[rng.random((120, 160)) < 0.1] = 255.0
    want = jdm.sample_rgbd(jnp.asarray(depth), jnp.asarray(color), stride=4, boundary=20)
    got = tdm.sample_rgbd(torch.as_tensor(depth), torch.as_tensor(color), stride=4, boundary=20)
    for name, w, g in zip(("gx", "gy", "d", "rgb", "ok"), want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name
    assert 0 < int(got[4].sum()) < len(got[4])


# ---------------------------------------------------------------- voxel hash


def _jax_slots(v, capacity):
    """The JAX package's voxel hash (``dense_map.py:66-68``) in int32."""
    v = jnp.asarray(v, jnp.int32)
    h = (v[:, 0] * 73856093) ^ (v[:, 1] * 19349663) ^ (v[:, 2] * 83492791)
    return np.asarray(jnp.abs(h) % capacity)


def test_voxel_hash_wraps_like_int32():
    """Products wrap, ``abs(INT32_MIN)`` stays negative, the modulo floors:
    the port's slots equal the JAX package's int32 ones for random voxel
    triples over the whole int32 range and for the triple whose hash is
    INT32_MIN."""
    rng = np.random.default_rng(1)
    v = rng.integers(-2**31, 2**31, (4096, 3)).astype(np.int32)
    v[0] = (-2**31, 0, 0)           # 73856093 · -2^31 wraps to INT32_MIN
    for capacity in (1 << 12, 1 << 20, 1000):
        want = _jax_slots(v, capacity)
        got = tdm.hash_voxel_index(torch.as_tensor(v), capacity).numpy()
        assert np.array_equal(want, got)
        assert (got >= 0).all() and (got < capacity).all()
    assert int(jnp.abs(jnp.asarray([-2**31], jnp.int32))[0]) == -2**31


def _collision(capacity):
    """Two distinct voxels that share a slot at ``capacity``."""
    g = np.stack(np.meshgrid(*[np.arange(-6, 7)] * 3, indexing="ij"), -1).reshape(-1, 3)
    slots = tdm.hash_voxel_index(torch.as_tensor(g, dtype=torch.int32), capacity).numpy()
    order = np.argsort(slots, kind="stable")
    dup = np.nonzero(np.diff(slots[order]) == 0)[0][0]
    return g[order[dup]], g[order[dup + 1]]


def _voxel_inserts(voxel):
    """Three inserts: clusters in two colliding voxels (negative
    coordinates), a scatter over [-3, 3]³, masked points."""
    rng = np.random.default_rng(2)
    va, vb = _collision(1 << 12)
    out = []
    for k in range(3):
        ca = (va + 0.5) * voxel + rng.normal(0, 0.01, (40, 3))
        cb = (vb + 0.5) * voxel + rng.normal(0, 0.01, (25, 3))
        spread = rng.uniform(-3.0, 3.0, (300, 3))
        pts = np.concatenate([ca, cb, spread])
        rgb = rng.uniform(0, 255, (len(pts), 3))
        valid = rng.random(len(pts)) > 0.15 * k
        out.append((pts, rgb, valid))
    return out, (va, vb)


def test_voxel_map_matches_jax(tmp_path):
    """Three inserts at capacity 2¹² in float64, carried over after the
    first: counts exact, sums within 1e-12, ``export`` and the PLY text
    identical; the two colliding voxels share one slot in both."""
    voxel, cap = 0.1, 1 << 12
    inserts, (va, vb) = _voxel_inserts(voxel)
    jm = jdm.VoxelColorMap(voxel_size=voxel, capacity=cap, dtype=jnp.float64)
    tm = tdm.VoxelColorMap(voxel_size=voxel, capacity=cap, dtype=torch.float64, device=CPU)
    for k, (pts, rgb, valid) in enumerate(inserts):
        jm.insert(pts, rgb, valid)
        if k == 0:
            convert.map_state_from(jax.device_get(jm), tm)
        else:
            tm.insert(torch.as_tensor(pts), torch.as_tensor(rgb), torch.as_tensor(valid))
    assert np.array_equal(np.asarray(jm.counts), tm.counts.numpy())
    for name in ("color_sum", "pos_sum"):
        assert np.abs(np.asarray(getattr(jm, name)) - getattr(tm, name).numpy()).max() <= 1e-12
    slot = _jax_slots(np.stack([va, vb]), cap)
    assert slot[0] == slot[1] and int(tm.counts[slot[0]]) > 60
    for min_count in (1, 3):
        for w, g in zip(jm.export(min_count), tm.export(min_count)):
            assert w.shape == g.shape and np.abs(w - g).max() <= 1e-12
    jm.save_ply(str(tmp_path / "j.ply"))
    tm.save_ply(str(tmp_path / "t.ply"))
    assert (tmp_path / "j.ply").read_text() == (tmp_path / "t.ply").read_text()
    tm.clear()
    assert int(tm.counts.sum()) == 0 and len(tm.export(1)[0]) == 0


# ---------------------------------------------------------------- occupancy


def test_occupancy_grid_matches_jax(tmp_path):
    """Five scans of 32 beams (``tests/test_mapping.py::test_occupancy_grid_rays``)
    plus a partly masked scan from another sensor position, float32 as the
    JAX package computes it without x64: log-odds within 1e-6; ``save_pgm``
    byte for byte; ``load_pgm`` of that file equal in both."""
    jg = jdm.OccupancyGrid2D(size_m=20.0, resolution=0.1)
    tg = tdm.OccupancyGrid2D(size_m=20.0, resolution=0.1, device=CPU)
    angles = np.linspace(-0.5, 0.5, 32)
    ends = np.stack([3.0 * np.cos(angles), 3.0 * np.sin(angles)], -1)
    scans = [(np.zeros(2), ends, np.ones(32, bool))] * 5
    valid = np.ones(32, bool)
    valid[::3] = False
    scans.append((np.array([0.7, -0.4]), ends * 1.7 + [0.2, 0.1], valid))
    with jax.enable_x64(False):
        for sensor, e, v in scans:
            jg.update(sensor, e, v)
    for sensor, e, v in scans:
        tg.update(sensor, e, v)
    assert np.abs(np.asarray(jg.logodds) - tg.logodds.numpy()).max() <= 1e-6
    jg.save_pgm(str(tmp_path / "j.pgm"))
    tg.save_pgm(str(tmp_path / "t.pgm"))
    assert (tmp_path / "j.pgm").read_bytes() == (tmp_path / "t.pgm").read_bytes()
    jl = jdm.OccupancyGrid2D.load_pgm(str(tmp_path / "j.pgm"))
    tl = tdm.OccupancyGrid2D.load_pgm(str(tmp_path / "j.pgm"), device=CPU)
    assert tl.res == jl.res and tl.n == jl.n and np.array_equal(tl.origin, jl.origin)
    assert np.array_equal(np.asarray(jl.logodds), tl.logodds.numpy())
    # round trip to 8-bit quantization
    assert np.abs(tl.probability() - tg.probability()).max() <= 1.0 / 255 + 1e-6
    carried = tdm.OccupancyGrid2D(size_m=20.0, resolution=0.1, device=CPU)
    convert.map_state_from(jax.device_get(jg), carried)
    assert np.array_equal(carried.logodds.numpy(), np.asarray(jg.logodds))


# ---------------------------------------------------------------- TSDF


def _sphere_views(w=120, h=120, fx=100.0, cx=60.0, radius=0.5):
    """The four views of the sphere of ``tests/test_meshing.py:21``
    (camera on a circle of radius 2, looking at the origin)."""
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    views = []
    for ang in np.linspace(0, 2 * np.pi, 4, endpoint=False):
        cam_pos = 2.0 * np.array([np.cos(ang), np.sin(ang), 0.0])
        z_axis = -cam_pos / np.linalg.norm(cam_pos)
        x_axis = np.cross(np.array([0.0, 0.0, 1.0]), z_axis)
        x_axis /= np.linalg.norm(x_axis)
        R_wc = np.stack([x_axis, np.cross(z_axis, x_axis), z_axis], axis=1)
        qw = np.sqrt(max(np.trace(R_wc) + 1.0, 1e-12)) / 2
        q = [qw, (R_wc[2, 1] - R_wc[1, 2]) / (4 * qw), (R_wc[0, 2] - R_wc[2, 0]) / (4 * qw),
             (R_wc[1, 0] - R_wc[0, 1]) / (4 * qw)]
        center_c = R_wc.T @ -cam_pos
        dirs = np.stack([(u - cx) / fx, (v - cx) / fx, np.ones_like(u, float)], -1)
        b = -2 * dirs @ center_c
        a = np.sum(dirs * dirs, axis=-1)
        disc = b * b - 4 * a * (center_c @ center_c - radius ** 2)
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), 0.0)
        depth = np.where((disc > 0) & (t > 0.1), t, 0.0)
        color = np.stack([np.full((h, w), 200.0), 120.0 + 50.0 * np.sin(u / 9.0),
                          80.0 + 40.0 * np.cos(v / 7.0)], -1)
        views.append((depth, color, np.concatenate([cam_pos, q])))
    return views, (fx, fx, cx, cx)


@pytest.fixture(scope="module")
def tsdf_pair():
    """The sphere fused into a 24³ float64 volume by both packages: two
    views each, the JAX package's state carried into the port's, two more
    views each."""
    views, intr = _sphere_views()
    kw = dict(origin=(-1.0, -1.0, -1.0), size_m=2.0, resolution=24, depth_max=5.0)
    jv = jmesh.TsdfVolume(dtype=jnp.float64, **kw)
    tv = tmesh.TsdfVolume(dtype=torch.float64, device=CPU, **kw)
    for k, (depth, color, pose) in enumerate(views):
        jv.integrate(depth, color, pose, *intr)
        if k == 1:
            convert.map_state_from(jax.device_get(jv), tv)
        elif k > 1:
            tv.integrate(depth, color, pose, *intr)
    return jv, tv


def test_tsdf_integrate_matches_jax(tsdf_pair):
    """One projective update of all n³ voxels per view: TSDF, weight and
    colour within 1e-10 (float64); a cleared volume is the initial one."""
    jv, tv = tsdf_pair
    for name in ("tsdf", "weight", "color"):
        assert np.abs(np.asarray(getattr(jv, name)) - getattr(tv, name).numpy()).max() <= 1e-10
    assert int((tv.weight > 0).sum()) > 1000
    fresh = tmesh.TsdfVolume(origin=(-1.0, -1.0, -1.0), size_m=2.0, resolution=24,
                             dtype=torch.float64, device=CPU)
    fresh.integrate(*_sphere_views()[0][0], *_sphere_views()[1])
    fresh.clear()
    assert bool((fresh.tsdf == 1).all()) and not fresh.weight.any() and not fresh.color.any()


def test_mesh_extraction_matches_jax(tsdf_pair, tmp_path):
    """``surface_nets``, ``radius_outlier_filter``, ``mls_smooth`` and
    ``write_mesh_ply`` of the port's own copies: identical to the JAX
    package's on the same volume; the port's ``extract_mesh`` of its own
    volume within 1e-9 of the JAX package's, faces identical."""
    jv, tv = tsdf_pair
    tsdf, wgt, col = (np.asarray(getattr(jv, n)) for n in ("tsdf", "weight", "color"))
    want = jmesh.surface_nets(tsdf, wgt >= 1.0, col, jv.origin, jv.voxel)
    got = tmesh.surface_nets(tsdf, wgt >= 1.0, col, jv.origin, jv.voxel)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    verts = want[0]
    assert len(verts) > 100 and len(want[2]) > 100
    for radius in (0.05, 0.12):
        for k in (1, 3, 6):
            assert np.array_equal(jmesh.radius_outlier_filter(verts, radius, k),
                                  tmesh.radius_outlier_filter(verts, radius, k))
        for w, g in zip(jmesh.mls_smooth(verts, radius, iters=2), tmesh.mls_smooth(verts, radius, iters=2)):
            assert np.array_equal(w, g)
    jmesh.write_mesh_ply(str(tmp_path / "j.ply"), *want)
    tmesh.write_mesh_ply(str(tmp_path / "t.ply"), *got)
    assert (tmp_path / "j.ply").read_text() == (tmp_path / "t.ply").read_text()
    for smooth in (0.0, 0.1):
        w = jv.extract_mesh(smooth_radius=smooth)
        g = tv.extract_mesh(smooth_radius=smooth)
        assert np.array_equal(w[2], g[2])
        assert np.abs(w[0] - g[0]).max() <= 1e-9 and np.abs(w[1] - g[1]).max() <= 1e-9


# ---------------------------------------------------------------- system hooks


def _map_cfg(cls):
    """``tests/test_mapping.py::_mapping_system``'s config, with the TSDF on
    at 24³ over the 3 m box that holds the scene's surface, so that the hooks
    also integrate and re-rasterise it."""
    cfg = cls()
    return dataclasses.replace(
        cfg,
        map=dataclasses.replace(cfg.map, enabled=True, voxel_size=0.05, depth_stride=16,
                                mesh=True, mesh_resolution=24, mesh_size_m=3.0,
                                mesh_origin=(-1.0, -1.5, 0.0), outlier_min_neighbors=2),
        loop=dataclasses.replace(cfg.loop, enabled=True),
    )


def _graph_kf(cls, idx, pose):
    z8 = np.zeros((4, 8), np.uint32)
    z = np.zeros((4, 2))
    return cls(index=idx, t=float(idx), pose=np.asarray(pose, float), kp=z, kp_norm=z, desc=z8,
               kp_ok=np.zeros(4, bool), win_pts3d=np.zeros((4, 3)), win_norm=z, win_desc=z8,
               win_ok=np.zeros(4, bool), vio_pose=np.asarray(pose, float))


def _wavy_depth(h=480, w=640):
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    return (0.9 + 0.25 * np.sin(u / 37.0) * np.cos(v / 23.0) + 0.4 * u / w).astype(np.float32)


def _gt_cloud(sys_, depth, pose):
    """Ground-truth world points of a frame: the JAX package's sampling and
    lift chain at the true pose (``tests/test_mapping.py::_gt_cloud``)."""
    from ground_fusion_tpu.geometry.se3 import pose_apply, pose_compose

    color = np.full(depth.shape + (3,), 128.0, np.float32)
    gx, gy, d, rgb, ok = jdm.sample_rgbd(jnp.asarray(depth), jnp.asarray(color),
                                         stride=sys_.cfg.map.depth_stride,
                                         boundary=sys_.cfg.map.depth_boundary)
    rays = sys_.cam.lift_projective(jnp.stack([gx, gy], -1).astype(jnp.float32))
    rays = rays / jnp.maximum(jnp.abs(rays[:, 2:3]), 1e-9)
    cam_pose = pose_compose(jnp.asarray(pose, jnp.float32), sys_.estimator.core.state.ex_cam)
    return np.asarray(pose_apply(cam_pose, rays * d[:, None]))[np.asarray(ok)]


def _nn_err(a, b):
    """Mean distance from each point of ``a`` to its nearest in ``b``."""
    from scipy.spatial import cKDTree

    return float(cKDTree(b).query(a)[0].mean())


def _same_map(jm, tm, tol):
    """Counts exact (so the same voxels pass every gate), float32 sums and
    the exported centres within ``tol``."""
    assert np.array_equal(np.asarray(jm.counts), tm.counts.numpy())
    for name in ("color_sum", "pos_sum"):
        w, g = np.asarray(getattr(jm, name)), getattr(tm, name).numpy()
        assert np.abs(w - g).max() <= tol * max(1.0, np.abs(w).max()), name
    (wc, wcol), (gc, gcol) = jm.export(1), tm.export(1)
    assert wc.shape == gc.shape and np.abs(wc - gc).max() <= tol
    return gc


@pytest.fixture(scope="module")
def jitted_jax_sampling():
    """The JAX package's RGB-D sampling, jitted while this file runs (eager,
    each 480x640 keyframe dispatches for ~0.3 s); the same function,
    compiled."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jdm, "sample_rgbd", jax.jit(jdm.sample_rgbd, static_argnames=("stride", "boundary")))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def rebuild_run(tmp_path_factory, jitted_jax_sampling):
    """``tests/test_mapping.py::test_map_reanchors_after_loop`` through both
    systems: four keyframes mapped at drifting poses, then the graph's
    poses set to the truth and the map rebuilt."""
    out = tmp_path_factory.mktemp("rebuild")
    js = JSystem(_map_cfg(JConfig), str(out / "jax"))
    ts = TSystem(_map_cfg(TConfig), str(out / "torch"), device=CPU)
    depth = _wavy_depth()
    img = np.full((480, 640), 128.0, np.float32)
    gt = [np.array([0.25 * k, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]) for k in range(4)]
    drift = [g + np.r_[np.array([0.3, -0.25, 0.1]) * k, np.zeros(4)] for k, g in enumerate(gt)]
    for s, kf in ((js, JKeyframe), (ts, TKeyframe)):
        for k in range(4):
            s.pose_graph.kfs.append(_graph_kf(kf, k, drift[k]))
            s._map_keyframe(drift[k], img, depth, register=k)
    before = (np.array(js.voxel_map.counts), ts.voxel_map.counts.clone(), ts.voxel_map.export(1)[0],
              np.array(js.tsdf.tsdf), ts.tsdf.tsdf.clone())
    for s in (js, ts):
        for k in range(4):
            s.pose_graph.kfs[k] = s.pose_graph.kfs[k]._replace(pose=gt[k])
        s._rebuild_map()
    gt_cloud = np.concatenate([_gt_cloud(js, depth, p) for p in gt])
    return js, ts, before, gt_cloud


def test_map_hooks_insert_and_rebuild_like_jax(rebuild_run):
    """Insertion at the drifted keyframe poses and the rebuild at the
    corrected ones: the same voxels with the same counts in both systems
    (sums within float32 rounding), the TSDF within 1e-5 (its rebuild
    re-rasterises the float16/uint8 copies in both); and the port meets the
    oracle's own bounds: err0 > 0.08 m, err1 < 0.05 m and < 0.3·err0."""
    js, ts, before, gt_cloud = rebuild_run
    jcounts0, tcounts0, tc0, jtsdf0, ttsdf0 = before
    assert np.array_equal(jcounts0, tcounts0.numpy())
    assert np.abs(jtsdf0 - ttsdf0.numpy()).max() <= 1e-5
    assert set(ts._kf_clouds) == set(js._kf_clouds) == {0, 1, 2, 3}
    centers1 = _same_map(js.voxel_map, ts.voxel_map, 1e-5)
    assert np.abs(np.asarray(js.tsdf.tsdf) - ts.tsdf.tsdf.numpy()).max() <= 1e-5
    assert np.abs(np.asarray(js.tsdf.weight) - ts.tsdf.weight.numpy()).max() == 0
    err0, err1 = _nn_err(tc0, gt_cloud), _nn_err(centers1, gt_cloud)
    assert err0 > 0.08, f"drift too small for a meaningful test ({err0:.3f})"
    assert err1 < 0.3 * err0 and err1 < 0.05, f"rebuild did not re-anchor: {err0:.3f}->{err1:.3f}"


def test_finish_writes_the_same_map_and_mesh(rebuild_run):
    """``finish``: ``map.ply`` after the radius-outlier stage and
    ``mesh.ply`` of the TSDF, the same vertices and faces in both systems."""
    js, ts, _, _ = rebuild_run
    js.finish()
    ts.finish()

    def table(path):
        """Header lines, vertex rows (x y z r g b), face rows (3 i j k)."""
        with open(path) as fp:
            lines = fp.read().splitlines()
        end = lines.index("end_header")
        rows = [[float(x) for x in l.split()] for l in lines[end + 1:]]
        return (lines[: end + 1], np.array([r for r in rows if len(r) == 6]),
                np.array([r for r in rows if len(r) == 4]))

    for name in ("map.ply", "mesh.ply"):
        jh, jverts, jfaces = table(os.path.join(js.out_dir, name))
        th, tverts, tfaces = table(os.path.join(ts.out_dir, name))
        assert jh == th and len(jverts) > 20, name
        # printed with 4 decimals: a float32 rounding may move the last one
        assert np.abs(jverts - tverts).max() <= 1.01e-4, name
        assert np.array_equal(jfaces, tfaces), name
    assert len(tfaces) > 20


def test_map_insertion_z_gate_like_jax(tmp_path, jitted_jax_sampling):
    """``tests/test_mapping.py::test_map_insertion_z_gate``: points above
    z_max never enter the map, points inside it do — the same voxels in both
    systems."""
    systems = (JSystem(_map_cfg(JConfig), str(tmp_path / "jax")),
               TSystem(_map_cfg(TConfig), str(tmp_path / "torch"), device=CPU))
    depth = np.full((480, 640), 2.6, np.float32)   # z_cam = 2.6 > z_max = 2
    img = np.full((480, 640), 128.0, np.float32)
    pose = np.array([0.0, 0, 0, 1, 0, 0, 0])
    for s in systems:
        s._map_keyframe(pose, img, depth)
        assert len(s.voxel_map.export(min_count=1)[0]) == 0, "z-gated points leaked into the map"
    depth[:] = 1.5
    for s in systems:
        s._map_keyframe(pose, img, depth)
    centers = _same_map(systems[0].voxel_map, systems[1].voxel_map, 1e-5)
    assert len(centers) > 0 and centers[:, 2].max() <= systems[1].cfg.map.z_max + 0.05


def test_map_delta_topic_and_unregistered_keyframes(tmp_path):
    """A keyframe too thin for the pose graph is still mapped, at the
    drift-corrected pose (``_loop_and_map``), and ``map_delta`` publishes
    the inserted cloud; without a pose graph every solved frame maps at its
    VIO pose."""
    cfg = _map_cfg(TConfig)
    ts = TSystem(cfg, str(tmp_path / "loop"), device=CPU)
    ts.pose_graph.r_drift = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    ts.pose_graph.t_drift = np.array([1.0, 2.0, 0.0])
    deltas = []
    ts.subscribe("map_delta", lambda **kw: deltas.append(kw))
    depth = np.full((480, 640), 1.5, np.float32)
    img = np.full((480, 640), 90.0, np.float32)
    pose = np.array([0.5, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    ts._loop_and_map(0.0, img, depth, pose, is_keyframe=True)   # < 8 window landmarks
    assert len(ts.pose_graph.kfs) == 0 and not ts._kf_clouds
    assert len(deltas) == 1 and len(deltas[0]["points"]) > 0
    corrected = ts._drift_corrected(pose)
    assert np.allclose(corrected[0:3], [1.0, 2.5, 0.0])
    assert np.allclose(np.abs(corrected[3:7]), [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)])
    ref = TSystem(cfg, str(tmp_path / "ref"), device=CPU)
    ref._map_keyframe(corrected, img, depth)
    assert torch.equal(ts.voxel_map.counts, ref.voxel_map.counts)
    assert int(ts.voxel_map.counts.sum()) == len(deltas[0]["points"])
    ts._loop_and_map(0.1, img, depth, pose, is_keyframe=False)  # not a keyframe: nothing
    assert len(deltas) == 1

    no_loop = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=False))
    ts2 = TSystem(no_loop, str(tmp_path / "vio"), device=CPU)
    ts2._loop_and_map(0.0, img, depth, pose, is_keyframe=False)
    assert len(ts2.voxel_map.export(1)[0]) > 0 and float(ts2.tsdf.weight.sum()) > 0
