"""PyTorch port vs JAX package: window solve, triangulation, the moving
consistency check and both marginalizations, on the synthetic window problem
at ``window_size=4``, ``max_landmarks=48`` (about ten live landmarks) in float64. Priors are compared
through ``J0ᵀJ0`` and ``J0ᵀr0`` (any square root is a valid prior)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.estimator import gates as jgates
from ground_fusion_tpu.estimator import marginalization as jmarg
from ground_fusion_tpu.estimator import solver as jsolver
from ground_fusion_tpu.estimator import triangulation as jtri
from ground_fusion_tpu_torch.estimator import assembly as tasm
from ground_fusion_tpu_torch.estimator import gates as tgates
from ground_fusion_tpu_torch.estimator import marginalization as tmarg
from ground_fusion_tpu_torch.estimator import solver as tsolver
from ground_fusion_tpu_torch.estimator import triangulation as ttri
from ground_fusion_tpu_torch.utils import convert
from test_torch_assembly import JD, TD, Problem


@pytest.fixture(scope="module")
def prob():
    return Problem(max_landmarks=48, pix_noise=1e-3, perturb_seed=1)


def _params(mod, conv):
    return mod.SolverParams(
        sqrt_info_scale=conv(460.0 / 1.5), cauchy_delta=conv(1.0),
        plane_sqrt_info=conv([100.0, 100.0, 20.0]), lm_lambda0=conv(1e-4),
        lm_up=conv(3.0), lm_down=conv(1.0 / 3.0))


def _jp():
    return _params(jsolver, lambda v: jnp.asarray(v, JD))


def _tp():
    return _params(tsolver, lambda v: torch.tensor(v, dtype=TD))


@pytest.mark.parametrize("method,linear", [("dogleg", "schur"), ("lm", "dense")])
def test_solve_window_matches_jax(prob, method, linear):
    """Four trust-region iterations from the same perturbed window: poses,
    speed-bias and depths within 1e-8, cost within 1e-8 relative."""
    solve = jax.jit(lambda s, t, i: jsolver.solve_window(
        s, t, i, prob.jlayout, _jp(), num_iters=4, method=method, linear_solver=linear))
    js, jt, jc = solve(prob.jstate, prob.jtracks, prob.jinp)
    ts, tt, tc = tsolver.solve_window(prob.tstate, prob.ttracks, prob.tinp, prob.tlayout, _tp(),
                                      num_iters=4, method=method, linear_solver=linear)
    r0 = tasm.assemble_residuals(prob.tstate, prob.ttracks, prob.tinp, *prob.torch_args())
    assert float(tc) < 0.5 * float(0.5 * torch.sum(r0 * r0))     # the solve really moved
    assert np.abs(np.asarray(js.poses) - ts.poses.numpy()).max() <= 1e-8
    assert np.abs(np.asarray(js.sbs) - ts.sbs.numpy()).max() <= 1e-8
    assert np.abs(np.asarray(jt.inv_depth) - tt.inv_depth.numpy()).max() <= 1e-8
    assert abs(float(jc) - float(tc)) <= 1e-8 * max(1.0, float(jc))


def test_schur_step_equals_dense_step(prob):
    """Block elimination is algebraically exact (bar of tests/test_solver.py)."""
    J, r = tasm.assemble_rows(prob.tstate, prob.ttracks, prob.tinp, *prob.torch_args())
    H, g = J.T @ J, J.T @ r
    lam = torch.tensor(1e-4, dtype=TD)
    d_dense = tsolver._solve_delta(H, g, lam, prob.tinp.free_mask)
    d_schur = tsolver._solve_delta_schur(H, g, lam, prob.tinp.free_mask, prob.tlayout)
    np.testing.assert_allclose(d_schur.numpy(), d_dense.numpy(), rtol=1e-6, atol=1e-9)


def test_failed_cholesky_rejects_the_step(prob):
    """A normal matrix that is not positive definite gives a NaN step, which
    the accept test rejects: the state comes back unchanged, as in the JAX
    package where the factorization returns NaN."""
    n = prob.tlayout.total
    H = -torch.eye(n, dtype=TD)
    g = torch.ones(n, dtype=TD)
    free = torch.ones(n, dtype=TD)
    for solve in (lambda: tsolver._solve_delta(H, g, 0.0, free),
                  lambda: tsolver._solve_delta_schur(H, g, 0.0, free, prob.tlayout)):
        assert bool(torch.isnan(solve()).all())
    want = np.asarray(jsolver._solve_delta(-jnp.eye(n, dtype=JD), jnp.ones(n, JD),
                                           jnp.asarray(0.0, JD), jnp.ones(n, JD)))
    assert np.isnan(want).all()

    # the loop's reject branch: a NaN mask makes every step and trial cost NaN
    bad = prob.tinp._replace(free_mask=torch.full((n,), float("nan"), dtype=TD))
    st, tr, cost = tsolver.solve_window(prob.tstate, prob.ttracks, bad, prob.tlayout, _tp(),
                                        num_iters=2, method="dogleg", linear_solver="schur")
    assert torch.equal(st.poses, prob.tstate.poses)
    assert torch.equal(tr.inv_depth, prob.ttracks.inv_depth)


def test_triangulate_all_matches_jax(prob):
    """Fresh landmarks (solve_ok cleared), half with usable depth: same
    solve_ok / depth_fixed, inverse depths within 1e-9 where triangulated."""
    jt = prob.jtracks
    ml = jt.active.shape[0]
    keep_depth = np.arange(ml) % 2 == 0
    obs = np.array(jt.obs)
    obs[~keep_depth, :, 4] = 0.0
    jt = jt._replace(solve_ok=jnp.zeros(ml, bool), obs=jnp.asarray(obs),
                     inv_depth=jnp.full((ml,), 0.2, JD))
    tt = convert.tracks_from_numpy(jax.device_get(jt), "cpu", TD)
    want = jax.jit(lambda s, t: jtri.triangulate_all(s, t, depth_max=7.0))(prob.jstate, jt)
    got = ttri.triangulate_all(prob.tstate, tt, depth_max=7.0)
    need = np.asarray(jt.active) & (np.asarray(jt.obs_valid).sum(1) >= 4)
    assert need.sum() >= 4
    assert np.array_equal(np.asarray(want.solve_ok), got.solve_ok.numpy())
    assert np.array_equal(np.asarray(want.depth_fixed), got.depth_fixed.numpy())
    assert np.asarray(want.depth_fixed).any() and (~np.asarray(want.depth_fixed)[need]).any()
    d = np.abs(np.asarray(want.inv_depth) - got.inv_depth.numpy())
    assert d[need].max() <= 1e-9
    # slots outside `need` are never written
    assert np.array_equal(got.inv_depth.numpy()[~need], np.full((~need).sum(), 0.2))


def test_moving_consistency_check_matches_jax(prob):
    """Two landmarks moved off their rays: flagged by both, nothing else."""
    inv = np.array(prob.jtracks.inv_depth)
    act = np.nonzero(np.asarray(prob.jtracks.active))[0]
    inv[act[0]] *= 6.0
    inv[act[1]] *= 0.1
    jt = prob.jtracks._replace(inv_depth=jnp.asarray(inv))
    tt = prob.ttracks._replace(inv_depth=torch.as_tensor(inv))
    want = np.asarray(jgates.moving_consistency_check(prob.jstate, jt, focal=460.0))
    got = tgates.moving_consistency_check(prob.tstate, tt, focal=460.0).numpy()
    assert np.array_equal(want, got)
    assert want[act[0]] and want[act[1]] and want.sum() < len(act)
    kept = tgates.remove_outliers(tt, torch.as_tensor(got))
    assert not bool(kept.active[act[0]]) and bool(kept.active[act[2]])


def _quad(prior):
    J0, r0 = np.asarray(prior.J0), np.asarray(prior.r0)
    return J0.T @ J0, J0.T @ r0


def _tquad(prior):
    return (prior.J0.T @ prior.J0).numpy(), (prior.J0.T @ prior.r0).numpy()


@pytest.fixture(scope="module")
def priors(prob):
    """marginalize_old from no prior, in both packages."""
    args = (jnp.asarray(460.0 / 1.5, JD), jnp.asarray(1.0, JD), jnp.asarray([100.0, 100.0, 20.0], JD))
    jprior = jax.jit(lambda s, t, i: jmarg.marginalize_old(s, t, i, prob.jlayout, *args))(
        prob.jstate, prob.jtracks, prob.jinp)
    targs = (torch.tensor(460.0 / 1.5, dtype=TD), torch.tensor(1.0, dtype=TD),
             torch.tensor([100.0, 100.0, 20.0], dtype=TD))
    tprior = tmarg.marginalize_old(prob.tstate, prob.ttracks, prob.tinp, prob.tlayout, *targs)
    return jprior, tprior


def test_marginalize_old_matches_jax(priors):
    """Prior quadratic form within 1e-8 of its scale; linearization point and
    validity equal."""
    jprior, tprior = priors
    Hj, bj = _quad(jprior)
    Ht, bt = _tquad(tprior)
    assert np.abs(Hj).max() > 1.0
    assert np.abs(Hj - Ht).max() <= 1e-8 * np.abs(Hj).max()
    assert np.abs(bj - bt).max() <= 1e-8 * max(1.0, np.abs(bj).max())
    assert bool(tprior.valid) and bool(jprior.valid)
    assert np.abs(np.asarray(jprior.lin.poses) - tprior.lin.poses.numpy()).max() <= 1e-12


def test_marginalize_second_new_matches_jax(prob, priors):
    """Dropping pose F-2 from the prior just built: same quadratic form; with
    an invalid prior it passes through untouched."""
    jprior, tprior = priors
    want = jax.jit(lambda s, p: jmarg.marginalize_second_new(s, p, prob.jlayout))(prob.jstate, jprior)
    tin = convert.prior_from_numpy(jax.device_get(jprior), "cpu", TD)
    got = tmarg.marginalize_second_new(prob.tstate, tin, prob.tlayout)
    Hj, bj = _quad(want)
    Ht, bt = _tquad(got)
    assert np.abs(Hj - Ht).max() <= 1e-8 * np.abs(Hj).max()
    assert np.abs(bj - bt).max() <= 1e-8 * max(1.0, np.abs(bj).max())

    empty = prob.tinp.prior
    out = tmarg.marginalize_second_new(prob.tstate, empty, prob.tlayout)
    assert not bool(out.valid) and float(out.J0.abs().max()) == 0.0


def test_sqrt_factorize_takes_eigh_path_when_not_positive_definite():
    """An indefinite H fails the Cholesky; the clipped-eigendecomposition
    path must return the square root of H's positive part, as the JAX
    package does through its NaN check."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    s = np.array([5.0, 3.0, 1.0, 0.5, -2.0, -4.0])
    H = (Q * s) @ Q.T
    b = rng.normal(size=6)
    J0, r0 = tmarg._sqrt_factorize(torch.as_tensor(H), torch.as_tensor(b))
    Hpos = (Q * np.clip(s, 0, None)) @ Q.T
    assert np.abs((J0.T @ J0).numpy() - Hpos).max() <= 1e-10
    wj, wr = jmarg._sqrt_factorize(jnp.asarray(H), jnp.asarray(b))
    assert np.abs(np.asarray(wj.T @ wj) - (J0.T @ J0).numpy()).max() <= 1e-10
    assert np.abs(np.asarray(wj.T @ wr) - (J0.T @ r0).numpy()).max() <= 1e-10
    # and a positive definite H takes the Cholesky path: J0 upper triangular
    Hpd = (Q * np.abs(s)) @ Q.T
    J0, _ = tmarg._sqrt_factorize(torch.as_tensor(Hpd), torch.as_tensor(b))
    assert float(torch.tril(J0, -1).abs().max()) == 0.0
