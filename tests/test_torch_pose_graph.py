"""PyTorch port vs JAX package: the 4-DoF and 6-DoF pose-graph solvers
(dense and matrix-free), the host ``PoseGraph`` on the 11-keyframe loop of
``tests/test_pose_graph_e2e.py``, and pose-graph state carried from the JAX
package into the port. Float64 on the CPU in both packages."""

import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.global_layers import pose_graph as jpg
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.config import load_yaml
from ground_fusion_tpu_torch.geometry.so3 import mat_to_quat as t_mat_to_quat
from ground_fusion_tpu_torch.geometry.so3 import ypr_to_mat as t_ypr_to_mat
from ground_fusion_tpu_torch.global_layers import brief as tbrief
from ground_fusion_tpu_torch.global_layers import pose_graph as tpg
from ground_fusion_tpu_torch.ops.cuda import hamming
from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
from ground_fusion_tpu_torch.system import GroundFusionSystem as TSystem
from ground_fusion_tpu_torch.utils.convert import pose_graph_from_numpy, pose_graph_to_numpy
from test_pose_graph_e2e import _place_texture

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N, N_PAD, E_PAD = 20, 32, 128


def _ypr_mat(ypr):
    """Rotation(s) from yaw-pitch-roll, in float64 (test inputs only)."""
    return t_ypr_to_mat(torch.as_tensor(np.asarray(ypr, np.float64))).numpy()


def _quat(R):
    return t_mat_to_quat(torch.as_tensor(np.asarray(R, np.float64))).numpy()


def _graph():
    """A drifted chain of N nodes with 4-predecessor edges, pitch and roll,
    one loop edge back to node 0 (yaw weight 1/10); padded to N_PAD nodes and
    E_PAD edges as PoseGraph pads them. Returns (yaws, ts, quats, node
    arrays..., 4-DoF columns, 6-DoF columns) as numpy."""
    rng = np.random.default_rng(11)
    gt_ypr = np.cumsum(rng.normal(0, [0.15, 0.02, 0.02], (N, 3)), axis=0)
    gt_t = np.cumsum(rng.normal(0, 0.5, (N, 3)), axis=0)
    gt_R = _ypr_mat(gt_ypr)
    ypr0 = gt_ypr + rng.normal(0, 0.04, (N, 3)) * np.arange(N)[:, None] / N
    t0 = gt_t + rng.normal(0, 0.1, (N, 3)) * np.arange(N)[:, None] / N
    ypr0[0], t0[0] = gt_ypr[0], gt_t[0]
    R0 = _ypr_mat(ypr0)
    e4, e6 = [], []
    pairs = [(j - b, j) for j in range(1, N) for b in range(1, 5) if j - b >= 0] + [(0, N - 1)]
    for k, (i, j) in enumerate(pairs):
        loop = k == len(pairs) - 1
        t_ij = gt_R[i].T @ (gt_t[j] - gt_t[i]) + (0 if loop else rng.normal(0, 0.01, 3))
        e4.append((i, j, t_ij, gt_ypr[j, 0] - gt_ypr[i, 0], ypr0[i, 1], ypr0[i, 2],
                   1.0, 0.1 if loop else 1.0))
        e6.append((i, j, t_ij, _quat(gt_R[i].T @ gt_R[j])))
    quats0 = _quat(R0)
    return ypr0[:, 0], t0, quats0, e4, e6


def _pad(a, n, fill=0.0):
    out = np.full((n,) + a.shape[1:], fill, np.float64)
    out[: len(a)] = a
    return out


@pytest.fixture(scope="module")
def graph():
    yaws, ts, quats, e4, e6 = _graph()
    e = len(e4)
    valid = np.arange(E_PAD) < e
    ij = np.zeros((E_PAD, 2), np.int64)
    ij[:e] = [(s[0], s[1]) for s in e4]
    cols4 = {k: _pad(np.array([s[c] for s in e4], np.float64), E_PAD)
             for k, c in [("t_ij", 2), ("yaw_ij", 3), ("pitch_i", 4), ("roll_i", 5),
                          ("w_t", 6), ("w_yaw", 7)]}
    q_ij = _pad(np.stack([s[3] for s in e6]), E_PAD)
    q_ij[e:, 0] = 1.0
    w = valid.astype(np.float64)
    quats_p = _pad(quats, N_PAD)
    quats_p[N:, 0] = 1.0
    fixed = np.zeros(N_PAD, bool)
    fixed[0] = True
    nodes = dict(yaws=_pad(yaws, N_PAD), ts=_pad(ts, N_PAD), quats=quats_p,
                 node_valid=np.arange(N_PAD) < N, fixed=fixed)
    j4 = jpg.GraphEdges(i=jnp.asarray(ij[:, 0], jnp.int32), j=jnp.asarray(ij[:, 1], jnp.int32),
                        valid=jnp.asarray(valid), **{k: jnp.asarray(v) for k, v in cols4.items()})
    t4 = tpg.GraphEdges(i=torch.as_tensor(ij[:, 0]), j=torch.as_tensor(ij[:, 1]),
                        valid=torch.as_tensor(valid), **{k: torch.as_tensor(v) for k, v in cols4.items()})
    cols6 = dict(t_ij=cols4["t_ij"], q_ij=q_ij, w_t=10.0 * w, w_q=100.0 * w)
    j6 = jpg.GraphEdges6(i=j4.i, j=j4.j, valid=j4.valid, **{k: jnp.asarray(v) for k, v in cols6.items()})
    t6 = tpg.GraphEdges6(i=t4.i, j=t4.j, valid=t4.valid,
                         **{k: torch.as_tensor(v) for k, v in cols6.items()})
    return nodes, (j4, t4), (j6, t6)


def test_linearize_edges_4dof_and_6dof(graph):
    nodes, (j4, t4), (j6, t6) = graph
    lin4 = jax.jit(jpg.linearize_edges, static_argnames="n")
    lin6 = jax.jit(jpg.linearize_edges_6dof, static_argnames="n")
    Jj, rj = lin4(jnp.asarray(nodes["yaws"]), jnp.asarray(nodes["ts"]), j4, n=N_PAD)
    Jt, rt = tpg.linearize_edges(torch.as_tensor(nodes["yaws"]), torch.as_tensor(nodes["ts"]), t4, N_PAD)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-8, rtol=0)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-8, rtol=0)
    Jj, rj = lin6(jnp.asarray(nodes["quats"]), jnp.asarray(nodes["ts"]), j6, n=N_PAD)
    Jt, rt = tpg.linearize_edges_6dof(torch.as_tensor(nodes["quats"]), torch.as_tensor(nodes["ts"]),
                                      t6, N_PAD)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-8, rtol=0)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-8, rtol=0)
    assert np.abs(rt.numpy()).max() > 1e-3          # the graph is really off its optimum


@pytest.mark.parametrize("solver", ["optimize_4dof", "optimize_4dof_cg",
                                    "optimize_6dof", "optimize_6dof_cg"])
def test_optimizers_match_jax(graph, solver):
    nodes, edges4, edges6 = graph
    six = "6dof" in solver
    first = "quats" if six else "yaws"
    (je, te) = edges6 if six else edges4
    kw = dict(iters=4, **({"cg_iters": 48} if solver.endswith("cg") else {}))
    names = (first, "ts", "node_valid", "fixed")
    want = getattr(jpg, solver)(*[jnp.asarray(nodes[k]) for k in names], je, **kw)
    got = getattr(tpg, solver)(*[torch.as_tensor(nodes[k]) for k in names], te, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-8, rtol=0)
    moved = np.abs(got[1].numpy()[:N] - nodes["ts"][:N]).max()
    assert moved > 1e-2                              # the solve did something
    assert np.array_equal(got[1].numpy()[0], nodes["ts"][0])   # the fixed node stays


# ----------------------------------------------------------------- e2e loop


class JaxNoise:
    """The JAX package's RANSAC draws, for the port's PoseGraph: split the
    graph's key as ``PoseGraph._try_connect`` does, then draw 64 Gumbel rows
    as ``pnp_ransac`` does inside."""

    def __init__(self, key):
        self.key = key

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, 64)
        g = jax.vmap(lambda k: jax.random.gumbel(k, (n,), jnp.float64))(keys)
        return torch.as_tensor(np.asarray(g))


def _loop_cfgs():
    def cfg(cls):
        c = cls()
        return dataclasses.replace(c, loop=dataclasses.replace(c.loop, min_loop_gap=5, min_matches=12))
    return cfg(JConfig), cfg(TConfig)


def _keyframe_inputs(n=11):
    """The 11 keyframes of tests/test_pose_graph_e2e.py (drifted loop,
    place-dependent imagery, landmarks published in the drifted frame), on
    integer-valued images; past 11, keyframe k revisits place k - 10."""
    out = []
    landmarks = {}
    true_yaw = np.linspace(0, 2 * np.pi, 11)
    for k in range(n):
        place = k % 10
        yaw_t = true_yaw[k] if k < 10 else true_yaw[k - 10]
        pt_true = np.array([3 * np.cos(yaw_t), 3 * np.sin(yaw_t), 0.0])
        yaw_est = yaw_t + 0.015 * k
        pt_est = pt_true + np.array([0.02 * k, -0.015 * k, 0.0])
        R_est = _ypr_mat([yaw_est, 0.0, 0.0])
        pose = np.concatenate([pt_est, _quat(R_est)])
        if place not in landmarks:
            r2 = np.random.default_rng(500 + place)
            landmarks[place] = np.stack(
                [r2.uniform(-1, 1, 40), r2.uniform(-0.8, 0.8, 40), r2.uniform(2, 5, 40)], -1)
        pc = landmarks[place]
        win_norm = pc[:, 0:2] / pc[:, 2:3]
        out.append(dict(k=k, pose=pose, img=np.round(_place_texture(place)), pc=pc,
                        pts_w=pc @ R_est.T + pt_est, win_norm=win_norm,
                        win_px=win_norm * 100 + np.array([80, 60])))
    return out


def _keyframe(module, inp, described):
    pts, ok, desc, win_desc = described
    kp_norm = (pts - np.array([80, 60])) / 100.0
    return module.Keyframe(
        index=inp["k"], t=float(inp["k"]), pose=inp["pose"],
        kp=np.concatenate([pts, inp["win_px"]]),
        kp_norm=np.concatenate([kp_norm, inp["win_norm"]]),
        desc=np.concatenate([desc, win_desc]).astype(np.uint32),
        kp_ok=np.concatenate([np.asarray(ok), np.ones(len(win_desc), bool)]),
        win_pts3d=inp["pts_w"], win_norm=inp["win_norm"], win_desc=win_desc.astype(np.uint32),
        win_ok=np.ones(len(inp["pts_w"]), bool))


@pytest.fixture(scope="module")
def loop_run():
    """Both packages over the 11 keyframes, fed the same keyframes (the JAX
    package's FAST/BRIEF output; the port's own is compared on the way) and
    the same RANSAC draws; plus a port graph that takes over the JAX graph
    after 10 keyframes and adds the 11th."""
    jcfg, tcfg = _loop_cfgs()
    jg = jpg.PoseGraph(jcfg)
    tg = tpg.PoseGraph(tcfg, device="cpu")
    tg.draw_pnp_noise = JaxNoise(jg._key)
    ported_describe = []
    carried = None
    for inp in _keyframe_inputs():
        jd = jg.describe(inp["img"], inp["win_px"])
        ported_describe.append((jd, tg.describe(inp["img"], inp["win_px"])))
        if inp["k"] == 10:
            carried = (copy.deepcopy(jg), pose_graph_to_numpy(jg), jg._key)
        jg.add_keyframe(_keyframe(jpg, inp, jd))
        tg.add_keyframe(_keyframe(tpg, inp, jd))
    jg_before, state10, key10 = carried
    tc = tpg.PoseGraph(tcfg, device="cpu")
    pose_graph_from_numpy(state10, tc)
    tc.draw_pnp_noise = JaxNoise(key10)
    plain = hamming.MATCH_REFERENCE_CALLS        # match_brief's wrapper on CPU tensors
    tc.add_keyframe(_keyframe(tpg, inp, jd))
    return dict(jg=jg, tg=tg, tc=tc, jg_before=jg_before, describe=ported_describe,
                carried_match_calls=hamming.MATCH_REFERENCE_CALLS - plain)


def test_port_describe_matches_on_the_loop_images(loop_run):
    """FAST points and their order exactly; BRIEF words except bits whose
    two blurred samples are equal in the port (a tie that XLA's other
    summation order of the blur breaks by an ulp)."""
    pa, pb = (torch.as_tensor(p) for p in tbrief.brief_pattern())
    n_diff = n_bits = 0
    for inp, ((jp, jo, jdesc, jwin), (tp, to, tdesc, twin)) in zip(_keyframe_inputs(),
                                                                   loop_run["describe"]):
        assert np.array_equal(np.asarray(jp), tp) and np.array_equal(np.asarray(jo), to)
        assert tdesc.dtype == twin.dtype == np.uint32
        img = torch.as_tensor(inp["img"], dtype=torch.float32)
        pts = torch.cat([torch.as_tensor(tp), torch.as_tensor(inp["win_px"], dtype=torch.float32)])
        ia, ib = (s.numpy() for s in tbrief.brief_samples(img, pts, pa, pb))
        want = np.concatenate([jdesc, jwin]).astype(np.uint32)
        diff = np.unpackbits((want ^ np.concatenate([tdesc, twin])).view(np.uint8),
                             bitorder="little").reshape(len(pts), 256).astype(bool)
        assert not np.any(diff & (np.abs(ia - ib) > 1e-9 * np.abs(ia)))
        n_diff, n_bits = n_diff + int(diff.sum()), n_bits + diff.size
    assert n_diff <= 1e-3 * n_bits


def _assert_graphs_agree(tg, jg, tol=1e-6):
    assert len(tg.loop_edges) == len(jg.loop_edges) >= 1
    for a, b in zip(tg.loop_edges, jg.loop_edges):
        assert a[0:2] == b[0:2]
        np.testing.assert_allclose(a[2], b[2], atol=tol, rtol=0)
        assert abs(a[3] - b[3]) <= tol
        np.testing.assert_allclose(a[4], b[4], atol=tol, rtol=0)
    assert tg.earliest_loop == jg.earliest_loop
    for a, b in zip(tg.kfs, jg.kfs):
        np.testing.assert_allclose(a.pose, b.pose, atol=tol, rtol=0)
        np.testing.assert_allclose(a.vio_pose, b.vio_pose, atol=tol, rtol=0)
    np.testing.assert_allclose(tg.r_drift, jg.r_drift, atol=tol, rtol=0)
    np.testing.assert_allclose(tg.t_drift, jg.t_drift, atol=tol, rtol=0)


@pytest.mark.parametrize("graph_6dof", [False, True])
def test_loop_closure_end_to_end_matches_jax(loop_run, graph_6dof):
    """The same loop edges; after the relaxation the same poses and drift
    (1e-6). The end error falls, below 0.6x for the 4-DoF graph as in the
    JAX package's own test (the 6-DoF graph takes it from 0.25 m to 0.19 m
    on this short loop, in both packages)."""
    jg, tg = copy.deepcopy(loop_run["jg"]), copy.deepcopy(loop_run["tg"])
    _assert_graphs_agree(tg, jg)
    end_before = tg.kfs[-1].pose[0:3].copy()
    if graph_6dof:
        jg._optimize_6dof()
        tg._optimize_6dof()
    else:
        jg.optimize()
        tg.optimize()
    _assert_graphs_agree(tg, jg)
    true_end = np.array([3.0, 0.0, 0.0])
    err_b = np.linalg.norm(end_before - true_end)
    err_a = np.linalg.norm(tg.kfs[-1].pose[0:3] - true_end)
    assert err_a < (0.8 if graph_6dof else 0.6) * err_b
    assert tg.describes["cpu"] == 11 and tg.match_calls >= 1


@pytest.mark.parametrize("graph_6dof", [False, True])
def test_optimize_past_the_dense_limit_matches_jax_and_the_dense_solve(loop_run, graph_6dof):
    """``optimize`` with the dense limit set below the loop's 16 padded
    nodes, so that both packages' graphs take the matrix-free PCG solvers:
    the port's result is the JAX package's (1e-6) and the port's own dense
    solve's (1e-9)."""
    jg, tg, dense = (copy.deepcopy(loop_run[k]) for k in ("jg", "tg", "tg"))
    jg.DENSE_NODE_LIMIT = tg.DENSE_NODE_LIMIT = 8
    for g in (jg, tg, dense):
        g._optimize_6dof() if graph_6dof else g.optimize()
    _assert_graphs_agree(tg, jg)
    _assert_graphs_agree(tg, dense, tol=1e-9)


def test_state_carried_from_the_jax_graph(loop_run):
    """The JAX graph after 10 keyframes, carried into the port, then the
    11th keyframe added: the same result as the JAX graph's own run."""
    tc, jg, before = loop_run["tc"], loop_run["jg"], loop_run["jg_before"]
    assert loop_run["carried_match_calls"] == 1
    _assert_graphs_agree(tc, jg)
    tc.optimize()
    jg = copy.deepcopy(jg)
    jg.optimize()
    _assert_graphs_agree(tc, jg)
    # the carried tables themselves, and back out again
    assert np.array_equal(tc.db.kf_idx, np.asarray(jg.db.kf_idx))
    np.testing.assert_array_equal(tc.db.hists.numpy(), np.asarray(jg.db.hists))
    back = pose_graph_to_numpy(tc)
    ref = pose_graph_to_numpy(before)
    assert back["db"]["count"] == ref["db"]["count"] + 1
    np.testing.assert_array_equal(back["db"]["hists"][:10], ref["db"]["hists"][:10])


def test_loop_closes_through_the_system_keyframe_hook(tmp_path):
    """The 11 keyframes and a 12th back at place 1 through
    ``GroundFusionSystem``'s keyframe hook on the CPU (float64 window, the
    ground-challenge camera mount), each seated in the window as the step
    leaves it (``chip_smoke.seat_keyframe``: observed in slot F-2, anchored
    in slot 0). The hook's world landmarks are the keyframe's to 1e-9 m, its
    observations to 1e-12, its window pixels to 1e-4 px (float32 camera).
    The loop at keyframe 10 closes through the hook, which publishes
    ``loop_closure`` and ``path_update``; after its relaxation the graph is
    the JAX package's graph fed the hook's keyframes (1e-6). Keyframe 11
    closes a second loop after that relaxation, and its edge is the one a
    graph that never relaxed builds from the same keyframes (1e-6): the
    port takes the current keyframe's VIO pose where the JAX package takes
    its drift-corrected one."""
    jcfg, tcfg = _loop_cfgs()
    mount = load_yaml(chip_smoke.CONFIG_PATH).camera
    tcfg = dataclasses.replace(
        tcfg, loop=dataclasses.replace(tcfg.loop, enabled=True),
        camera=dataclasses.replace(tcfg.camera, width=160, height=120, fx=100.0, fy=100.0,
                                   cx=80.0, cy=60.0, t_ic=mount.t_ic, q_ic=mount.q_ic))
    ts = TSystem(tcfg, str(tmp_path), device="cpu")
    ts.estimator = TEstimator(tcfg, dtype=torch.float64, device="cpu")
    key0 = jpg.PoseGraph(jcfg)._key
    ts.pose_graph.draw_pnp_noise = JaxNoise(key0)
    events = []
    for topic in ("loop_closure", "path_update"):
        ts.subscribe(topic, lambda topic=topic, **_: events.append(topic))
    after_first = None
    for inp in _keyframe_inputs(12):
        body = chip_smoke.seat_keyframe(np, torch, ts, inp["pose"], inp["pc"])
        ts._add_loop_keyframe(float(inp["k"]), inp["img"], body)
        kf = ts.pose_graph.kfs[-1]
        assert kf.index == inp["k"]
        np.testing.assert_allclose(kf.win_pts3d, inp["pts_w"], atol=1e-9, rtol=0)
        np.testing.assert_allclose(kf.win_norm, inp["win_norm"], atol=1e-12, rtol=0)
        np.testing.assert_allclose(kf.kp[-len(inp["pc"]):], inp["win_px"], atol=1e-4, rtol=0)
        if inp["k"] == 10:
            after_first = copy.deepcopy(ts.pose_graph)
    pg = ts.pose_graph
    assert [e[0:2] for e in pg.loop_edges] == [(0, 10), (1, 11)]
    assert events == ["loop_closure", "path_update"] * 2
    # the keyframes as the hook handed them to the graph
    handed = [kf._replace(pose=kf.vio_pose, vio_pose=None) for kf in pg.kfs]
    jg = jpg.PoseGraph(jcfg)
    for kf in handed[:11]:
        jg.add_keyframe(jpg.Keyframe(**kf._asdict()))
    jg.optimize()
    _assert_graphs_agree(after_first, jg)
    unrelaxed = tpg.PoseGraph(tcfg, device="cpu")
    unrelaxed.draw_pnp_noise = JaxNoise(key0)
    for kf in handed:
        unrelaxed.add_keyframe(kf)
    a, b = pg.loop_edges[1], unrelaxed.loop_edges[1]
    assert a[0:2] == b[0:2]
    np.testing.assert_allclose(a[2], b[2], atol=1e-6, rtol=0)
    assert abs(a[3] - b[3]) <= 1e-6
    np.testing.assert_allclose(a[4], b[4], atol=1e-6, rtol=0)
