"""The landmark-sharded window step (``parallel/sharded.py``:
``make_sharded_window_step``, ``shard_core``, ``gather_core``) on two Gloo
ranks on the CPU, float64, against the JAX package's ``make_window_step``
and the port's own unsharded step (``tests/test_parallel.py`` is the
oracle).

One pair of worker processes (``chip_smoke.shard_worker`` in its step mode,
which imports no JAX) runs every case of ``chip_smoke.shard_step_cases
("small")`` — window 4, 16 landmarks, plane on, 2 dogleg iterations, the
core filled as the JAX driver's dryrun fills its core
(``chip_smoke.dryrun_core``); the ranks write npz results. Each case runs
``chip_smoke.SHARD_CHAIN``: both branches from the core, then both from the
keyframe step's core (a valid prior: prior rows, line triangulation). The
dryrun's whole factor set (``full``: 2 line slots, GNSS with 4 satellites)
and its ``linear_solver: dense`` and ``method: lm`` variants are held to the
port's unsharded step. The ``jax`` case (no lines, no GNSS: a JAX program
with them takes ~50 s to compile on a CPU) is held to the JAX package under
``-m slow``: its ~35 s JAX compile, run beside ``tests/test_burst.py`` in
the tier-1 run, lengthened that critical path by ~100 s (four cold runs on
one 8-core host).

Poses, slid inverse depths and line coordinates within 1e-8; the prior
through its quadratic form, J0ᵀJ0 and J0ᵀr0, within 1e-5 or 1e-8 of its
scale where that is larger (``chip_smoke.prior_gap``): the dryrun window's
information reaches 2.8e6, where summing the same rows in two orders alone
moves J0ᵀJ0 by 2e-4, and ``tests/test_torch_step.py`` holds the port's
prior to JAX at 1e-8 of its scale. Under ``-m slow`` the oracle's own
problem runs on 2 and 4 ranks at its own 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import chip_smoke
from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.estimator.assembly import empty_prior as jempty_prior
from ground_fusion_tpu.estimator.step import EstimatorCore as JCore
from ground_fusion_tpu.estimator.step import StepFlags as JFlags
from ground_fusion_tpu.estimator.step import make_window_step as jmake
from ground_fusion_tpu.sim.synthetic import SimParams, build_window_problem
from ground_fusion_tpu.utils import checkpoint as jckpt
from ground_fusion_tpu_torch.utils import checkpoint as tckpt

TOL = 1e-8


def jax_config(cfg):
    """The JAX package's ``Config`` with the values of the port's ``cfg``."""
    def conv(jobj, tobj):
        kw = {}
        for field in dataclasses.fields(tobj):
            v = getattr(tobj, field.name)
            kw[field.name] = conv(getattr(jobj, field.name), v) if dataclasses.is_dataclass(v) else v
        return dataclasses.replace(jobj, **kw)

    return conv(JConfig(), cfg)


def jax_chain(tmp_path):
    """The ``jax`` case's chain through the JAX package's step."""
    cfg = chip_smoke.shard_step_cases("small")["jax"]
    jcfg = jax_config(cfg)
    jstep, _ = jmake(jcfg)
    core, flags = chip_smoke.dryrun_core(cfg, torch.float64, torch.device("cpu"))
    path = str(tmp_path / "core0.npz")
    tckpt.save_core(path, core)
    core0 = jckpt.load_core(path, __graft_entry__._example_core_and_flags(jcfg, jnp.float64)[0])
    f = cfg.num_frames

    def jflags(marg_old):
        return JFlags(marg_old=jnp.asarray(marg_old), stationary=jnp.asarray(False),
                      wheel_valid=jnp.asarray(flags.wheel_valid.numpy()),
                      imu_valid=jnp.asarray(flags.imu_valid.numpy()),
                      td_obs=jnp.zeros(f, jnp.float64), propagate_newest=jnp.asarray(True))

    done = []
    for marg_old, start in chip_smoke.SHARD_CHAIN:
        core1, out = jstep(core0 if start is None else done[start][0], jflags(marg_old))
        done.append((core1, out))
    return [jax.device_get(x) for x in done]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (300 s timeout)."""
    return chip_smoke.run_shard_pair(str(tmp_path_factory.mktemp("shard_step")), "cpu",
                                     step="small")


def steps_of(res, case):
    return sorted({int(k.split(".")[1]) for k in res if k.startswith(case + ".")})


def singles(ranks):
    """The unsharded steps' results, from whichever rank ran them."""
    out = {}
    for res in ranks:
        out.update({k: v for k, v in res.items() if ".single." in k or k.endswith("single_ms")})
    return out


@pytest.mark.slow
def test_sharded_step_matches_jax(ranks, tmp_path):
    """The ``jax`` case's four steps on 2 ranks: the solved poses, the
    whole slid inverse-depth table and the prior equal the JAX package's
    ``make_window_step`` on the same core."""
    r0, ref = ranks[0], jax_chain(tmp_path)
    assert steps_of(r0, "jax") == [0, 1, 2, 3]
    for k, (jcore, jout) in enumerate(ref):
        p = f"jax.{k}."
        np.testing.assert_allclose(r0[p + "out.poses"], np.asarray(jout["poses"]), atol=TOL, rtol=0)
        np.testing.assert_allclose(r0[p + "whole.tracks.inv_depth"],
                                   np.asarray(jcore.tracks.inv_depth), atol=TOL, rtol=0)
        np.testing.assert_array_equal(r0[p + "whole.tracks.active"], np.asarray(jcore.tracks.active))
        assert chip_smoke.prior_gap(r0[p + "rep.prior.J0"], r0[p + "rep.prior.r0"],
                                    np.asarray(jcore.prior.J0), np.asarray(jcore.prior.r0)) <= 1.0, p
        assert bool(r0[p + "rep.prior.valid"]) == bool(jcore.prior.valid)


def compare_with_unsharded(ranks, case):
    gap = chip_smoke.shard_step_gaps(ranks, case)
    for name in ("poses", "depth", "orth"):
        assert gap[name] <= TOL, (name, gap[name])
    assert gap["prior"] <= 1.0 and gap["masks"] and gap["ranks"], gap
    r0, single = ranks[0], singles(ranks)
    for k in steps_of(r0, case):
        p = f"{case}.{k}."
        assert abs(float(r0[p + "out.cost"]) - float(single[p + "single.out.cost"])) <= \
            TOL * max(1.0, float(single[p + "single.out.cost"]))


def test_full_factor_sharded_step_matches_unsharded(ranks):
    """The dryrun's factor set (IMU, wheel, visual, plane, GNSS and the
    clock chain, the pose anchor, lines, the prior): the four steps on 2
    ranks against the port's unsharded step; the lines triangulate in the
    steps with a valid prior and take part in the solve."""
    compare_with_unsharded(ranks, "full")
    r0 = ranks[0]
    assert r0["full.0.whole.lines.solve_ok"].tolist() == [True, False]
    assert r0["full.2.whole.lines.solve_ok"].all()          # triangulated under the prior


@pytest.mark.parametrize("case", ["dense", "lm"])
def test_dense_and_lm_variants_match_unsharded(case, ranks):
    """``linear_solver: dense`` (the whole system summed from zero-padded
    views) and ``method: lm`` sharded against unsharded, both branches."""
    assert steps_of(ranks[0], case) == [0, 1]
    compare_with_unsharded(ranks, case)


def test_float32_keyframe_step_keeps_its_cholesky_prior(ranks):
    """The ``lm`` case in float32 on 2 ranks, keyframe branch, first step:
    the step whose frame-0 marginalization raised "linalg.eigh: The
    algorithm failed to converge" on a CPU when ``_sqrt_factorize`` called
    ``eigh`` on an H whose Cholesky had succeeded. It runs on both ranks and
    on the unsharded step; the poses and the prior are finite, the prior is
    valid and not zero (a failed square root leaves a zero prior), and the
    sharded pose is within 1e-2 of the unsharded one (float32 on an
    ill-conditioned window, as phase 12d finds on the card)."""
    r0, single = ranks[0], singles(ranks)
    assert steps_of(r0, "lm_f32") == [0]
    for res in ranks:
        assert res["lm_f32.0.out.pose"].dtype == np.float32
        assert np.isfinite(res["lm_f32.0.out.poses"]).all()
        assert np.isfinite(res["lm_f32.0.rep.prior.J0"]).all()
        assert bool(res["lm_f32.0.rep.prior.valid"])
    assert np.isfinite(single["lm_f32.0.single.out.poses"]).all()
    J0 = r0["lm_f32.0.rep.prior.J0"]
    assert np.abs(J0).max() > 0.0
    assert np.abs(single["lm_f32.0.single.out.pose"] - r0["lm_f32.0.out.pose"]).max() <= 1e-2


def test_ranks_are_bitwise_equal(ranks):
    """Every rank's output and replicated core (state, buffers, prior, GNSS
    table) are bitwise equal, in every step of every case."""
    r0, r1 = ranks
    keys = [k for k in r0 if (".out." in k or ".rep." in k) and ".single." not in k]
    assert len(keys) > 100
    for k in keys:
        assert np.array_equal(r0[k], r1[k]), k


def test_reductions_per_step(ranks):
    """The packed reductions of a step: the first linearization, five per
    dogleg iteration (three per LM iteration), the stationary vote and,
    with ``marg_old``, the frame-0 marginalization."""
    r0 = ranks[0]
    iters = chip_smoke.shard_step_cases("small")["full"].solver.max_iters
    for case, per_iter in (("full", 5), ("dense", 5), ("lm", 3)):
        assert int(r0[f"{case}.0.reductions"]) == 1 + per_iter * iters + 2
        assert int(r0[f"{case}.1.reductions"]) == 1 + per_iter * iters + 1


def test_gather_core_undoes_shard_core(ranks):
    """``gather_core(shard_core(core))`` is the core, every tensor equal."""
    for res in ranks:
        assert bool(res["roundtrip_equal"])


def test_indivisible_slots_raise(ranks):
    """On 2 ranks a core with 3 landmark slots, or with 3 line slots, is
    refused with both numbers named; so is a landmark mesh of 3 ranks."""
    for res in ranks:
        assert str(res["error_ml"]) == "landmark slots ML=3 not divisible by world size 2"
        assert str(res["error_ll"]) == "line slots LL=3 not divisible by world size 2"
        assert str(res["error_mesh"]) == "a landmark mesh of 3 ranks needs 3 ranks; the group has 2"


@pytest.mark.slow
@pytest.mark.parametrize("world", [2, 4])
def test_oracle_problem_on_cpu_ranks(world, tmp_path):
    """``tests/test_parallel.py``'s problem (``Config()``,
    ``build_window_problem``, rng 3) on ``world`` CPU ranks against the JAX
    package's single-device step, both branches, at the oracle's
    tolerances: poses and slid depths 1e-8, the prior's J0ᵀJ0 and J0ᵀr0
    1e-5."""
    DT = jnp.float64
    cfg = JConfig()
    step, layout = jmake(cfg)
    prob = build_window_problem(cfg, SimParams(), dtype=DT)
    f = cfg.num_frames
    rng = np.random.default_rng(3)
    state0 = prob["state"]._replace(poses=prob["state"].poses.at[2:, 0:3].add(
        jnp.asarray(rng.normal(0, 0.01, (f - 2, 3)), DT)))
    tracks0 = prob["tracks"]._replace(inv_depth=prob["tracks"].inv_depth * (
        1.0 + 0.05 * jnp.asarray(rng.normal(0, 1, cfg.solver.max_landmarks))))
    core = JCore(state=state0, tracks=tracks0, imu_buf=prob["imu_buf"],
                 wheel_buf=prob["wheel_buf"], prior=jempty_prior(layout, f, DT))
    jckpt.save_core(str(tmp_path / "jcore.npz"), core)
    with np.load(str(tmp_path / "jcore.npz")) as z:
        arrays = {"core." + k: z[k] for k in z.files}
    arrays["flags.wheel_valid"] = arrays["flags.imu_valid"] = np.asarray(prob["interval_valid"])
    core_path = str(tmp_path / "oracle.npz")
    np.savez(core_path, **arrays)
    ranks = chip_smoke.run_shard_pair(str(tmp_path), "cpu", step=core_path, world=world,
                                      timeout_s=1200)
    for k, marg_old in enumerate((True, False)):
        flags = JFlags(marg_old=jnp.asarray(marg_old), stationary=jnp.asarray(False),
                       wheel_valid=prob["interval_valid"], imu_valid=prob["interval_valid"],
                       td_obs=jnp.zeros(f, DT), propagate_newest=jnp.asarray(False))
        core1, out1 = jax.device_get(step(core, flags))
        p = f"oracle.{k}."
        for res in ranks:
            np.testing.assert_allclose(res[p + "out.poses"], np.asarray(out1["poses"]), atol=1e-8)
            np.testing.assert_allclose(res[p + "whole.tracks.inv_depth"],
                                       np.asarray(core1.tracks.inv_depth), atol=1e-8)
            J, r = res[p + "rep.prior.J0"], res[p + "rep.prior.r0"]
            J1, r1 = np.asarray(core1.prior.J0), np.asarray(core1.prior.r0)
            np.testing.assert_allclose(J.T @ J, J1.T @ J1, atol=1e-5)
            np.testing.assert_allclose(J.T @ r, J1.T @ r1, atol=1e-5)
        for key in ranks[0]:
            if key.startswith(p) and (".out." in key or ".rep." in key):
                assert all(np.array_equal(ranks[0][key], res[key]) for res in ranks[1:]), key
