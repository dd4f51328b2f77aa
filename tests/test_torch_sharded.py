"""``ground_fusion_tpu_torch/parallel/sharded.py`` on two Gloo ranks on the
CPU, against the JAX package (``tests/test_parallel.py`` is the oracle).

One pair of worker processes (``chip_smoke.shard_worker``, which imports no
JAX) carries every distributed check of the file; the JAX references are
computed here and compared with what the ranks wrote:

- the edge-sharded 4-DoF graph of ``test_parallel.py`` (24 nodes, 6
  iterations, float64) within 1e-8 of the JAX package's ``optimize_4dof``
  and of its ``make_sharded_pose_graph`` on the 8-device CPU mesh;
- ``shard_edges`` pads the table with invalid rows and gives each rank its
  consecutive share;
- a fleet whose batch the world does not divide raises ``ValueError``.

Every collective of the module is an ``all_reduce``, ``broadcast`` or
``barrier`` (what Gloo offers for CUDA tensors). Under ``-m slow``: the
sharded fleet (4 filled cores, 2 a rank, ``max_landmarks`` 32, ``max_iters``
4, K = 2) against the unsharded fleet at ``tests/test_burst.py``'s
tolerances.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ground_fusion_tpu.global_layers.pose_graph import GraphEdges, optimize_4dof
from ground_fusion_tpu.parallel.sharded import make_sharded_pose_graph, shard_edges
from ground_fusion_tpu_torch.parallel import sharded

TOL = 1e-8


@pytest.fixture(scope="module")
def jax_graph():
    """The JAX package's single-device and 8-device solutions."""
    p = chip_smoke.sharded_graph_problem(np)
    edges = GraphEdges(i=jnp.asarray(p["i"], jnp.int32), j=jnp.asarray(p["j"], jnp.int32),
                       t_ij=jnp.asarray(p["t_ij"]), yaw_ij=jnp.asarray(p["yaw_ij"]),
                       pitch_i=jnp.asarray(p["pitch_i"]), roll_i=jnp.asarray(p["roll_i"]),
                       w_t=jnp.asarray(p["w_t"]), w_yaw=jnp.asarray(p["w_yaw"]),
                       valid=jnp.asarray(p["valid"]))
    n = p["n"]
    args = (jnp.asarray(p["yaws0"]), jnp.asarray(p["ts0"]), jnp.ones(n, bool),
            jnp.zeros(n, bool).at[0].set(True))
    single = optimize_4dof(*args, edges, iters=p["iters"])
    mesh = jax.make_mesh((8,), ("lm",))
    mesh8 = make_sharded_pose_graph(mesh, n_nodes=n, iters=p["iters"])(*args, shard_edges(edges, mesh))
    return p, {"single": [np.asarray(x) for x in single], "mesh8": [np.asarray(x) for x in mesh8]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results from one spawned Gloo pair (300 s timeout)."""
    return chip_smoke.run_shard_pair(str(tmp_path_factory.mktemp("shard")), "cpu", fleet="")


@pytest.mark.parametrize("reference", ["single", "mesh8"])
def test_sharded_graph_matches_jax(reference, jax_graph, ranks):
    """Each rank's solution equals the JAX package's single-device solve and
    its 8-device edge-sharded solve to 1e-8, and the port's single-device
    solve on the same rank; it recovers the truth."""
    p, ref = jax_graph
    y_ref, t_ref = ref[reference]
    for res in ranks:
        np.testing.assert_allclose(res["y_sharded"], y_ref, atol=TOL)
        np.testing.assert_allclose(res["t_sharded"], t_ref, atol=TOL)
        np.testing.assert_allclose(res["t_sharded"], res["t_single"], atol=TOL)
    np.testing.assert_allclose(ranks[0]["t_sharded"], p["gt_t"], atol=1e-5)


def test_shard_edges_pads_with_invalid_rows(ranks):
    """45 edges over 2 ranks: padded to 46, 23 consecutive rows a rank, the
    padding row invalid."""
    p = chip_smoke.sharded_graph_problem(np)
    e = len(p["i"])
    n = (e + 1) // 2
    got_i = np.concatenate([r["local_i"] for r in ranks])
    got_valid = np.concatenate([r["local_valid"] for r in ranks])
    assert all(len(r["local_i"]) == n for r in ranks)
    np.testing.assert_array_equal(got_i[:e], p["i"])
    assert got_valid[:e].all() and not got_valid[e:].any() and len(got_valid) == 2 * n


def test_fleet_batch_not_divisible_raises(ranks):
    for res in ranks:
        assert str(res["divisible_error"]) == "fleet batch B=3 not divisible by world size 2"


def test_every_collective_is_all_reduce_broadcast_or_barrier():
    """Gloo offers only these three for CUDA tensors; the module calls no
    other ``torch.distributed`` operation that moves data, in any of its
    functions, the landmark-sharded step's included (its reducer and its
    gather); the landmark axis's group is the world or a new group."""
    tree = ast.parse(open(sharded.__file__).read())
    calls = {node.func.attr for node in ast.walk(tree)
             if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
             and isinstance(node.func.value, ast.Name) and node.func.value.id == "dist"}
    setup = {"init_process_group", "destroy_process_group", "get_rank", "get_world_size",
             "new_group", "get_process_group_ranks"}
    assert calls - setup <= {"all_reduce", "broadcast", "barrier"} and "all_reduce" in calls
    defined = {node.name for node in ast.walk(tree)
               if isinstance(node, (ast.FunctionDef, ast.ClassDef))}
    assert {"make_lm_mesh", "shard_core", "shard_tracks", "gather_core",
            "make_sharded_window_step", "_Reducer"} <= defined


@pytest.mark.slow
def test_sharded_fleet_matches_the_unsharded_fleet(tmp_path):
    """Two ranks advance two filled cores each through 2 steps of the
    fleet; the gathered fleet is within ``tests/test_burst.py``'s
    tolerances of the unsharded fleet (step poses 1e-2, end poses 1e-3,
    inverse depths 2e-3, ``wheel_buf.bad`` equal)."""
    r0 = chip_smoke.run_shard_pair(str(tmp_path), "cpu", fleet="small")[0]
    for name in chip_smoke.FLEET_TOL:
        assert bool(r0[f"fleet_{name}_ok"]), (name, float(r0[f"fleet_{name}"]))
    assert bool(r0["fleet_bad_equal"])
