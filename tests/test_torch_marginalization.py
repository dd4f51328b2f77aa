"""The prior's square root (``estimator/marginalization.py``:
``_sqrt_factorize``, ``_clipped_pinv``) when ``torch.linalg.eigh`` fails.

``torch.linalg.eigh`` raises where the eigensolver does not converge (a NaN
input among others) and ``jnp.linalg.eigh`` returns NaN. A float32
keyframe step raised so on a CPU although its H had a Cholesky factor: the
port handed every H to ``eigh`` and selected the Cholesky result after it.
Here ``eigh`` is patched to raise: the Cholesky path must still return its
factor, bitwise; where both fail the prior is the JAX package's (zero), and a
NaN block gives NaN, not a raise. The float32 keyframe step on the JAX
dryrun's core raised so on a CPU (``dense`` case, one thread, PyTorch's CPU
build) and must now run; the 2-rank step of the ``lm`` case is
``test_torch_sharded_step.py::test_float32_keyframe_step_keeps_its_cholesky_prior``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

import chip_smoke

from ground_fusion_tpu.estimator import marginalization as jmarg
from ground_fusion_tpu_torch.estimator import marginalization as tmarg
from ground_fusion_tpu_torch.estimator.step import make_window_step


def _raising_eigh(*args, **kwargs):
    raise torch.linalg.LinAlgError("linalg.eigh: The algorithm failed to converge")


def _spd(rng, n, dtype):
    A = rng.normal(size=(n, 2 * n))
    return torch.as_tensor(A @ A.T, dtype=dtype), torch.as_tensor(rng.normal(size=n), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cholesky_path_never_needs_eigh(dtype, monkeypatch):
    """A positive definite H (105×105, the failing step's size): with
    ``eigh`` raising on every call, the factor and r0 are bitwise those of
    an ``eigh`` that works, alone and under the fleet's ``vmap``."""
    H, b = _spd(np.random.default_rng(0), 105, dtype)
    J_ok, r_ok = tmarg._sqrt_factorize(H, b)
    Hs, bs = torch.stack([H, 2.0 * H]), torch.stack([b, b])
    Jv_ok, rv_ok = torch.func.vmap(tmarg._sqrt_factorize)(Hs, bs)
    monkeypatch.setattr(torch.linalg, "eigh", _raising_eigh)
    J, r = tmarg._sqrt_factorize(H, b)
    assert torch.equal(J, J_ok) and torch.equal(r, r_ok)
    assert float(torch.tril(J, -1).abs().max()) == 0.0     # the Cholesky factor Lᵀ
    Jv, rv = torch.func.vmap(tmarg._sqrt_factorize)(Hs, bs)
    assert torch.equal(Jv, Jv_ok) and torch.equal(rv, rv_ok)


def test_both_failing_give_the_jax_packages_zero_prior(monkeypatch):
    """A NaN H fails both the Cholesky and ``eigh``: no raise, and the
    prior is zero, as ``jmarg._sqrt_factorize`` gives it (its ``eigh``
    returns NaN and the clip drops every direction). An indefinite H whose
    ``eigh`` raises gives the same zero prior."""
    rng = np.random.default_rng(1)
    H = np.full((6, 6), np.nan)
    b = rng.normal(size=6)
    J, r = tmarg._sqrt_factorize(torch.as_tensor(H), torch.as_tensor(b))
    wj, wr = jmarg._sqrt_factorize(jnp.asarray(H), jnp.asarray(b))
    np.testing.assert_array_equal(J.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(r.numpy(), np.asarray(wr))
    assert not J.any() and not r.any()
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    Hind = torch.as_tensor((Q * np.array([5.0, 3.0, 1.0, 0.5, -2.0, -4.0])) @ Q.T)
    monkeypatch.setattr(torch.linalg, "eigh", _raising_eigh)
    J, r = tmarg._sqrt_factorize(Hind, torch.as_tensor(b))
    assert not J.any() and not r.any()


def test_clipped_pinv_of_a_nan_block_is_nan_not_a_raise():
    """The batched 15×15 frame-block pseudo-inverse: a NaN block gives NaN
    (``jmarg._clipped_pinv`` gives NaN too) and leaves the other blocks
    bitwise what they are alone; ``eigh`` of a NaN 15×15 raises in torch."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(15, 30))
    good = torch.as_tensor(A @ A.T)
    nan = torch.full((15, 15), float("nan"), dtype=torch.float64)
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.eigh(nan)
    got = tmarg._clipped_pinv(torch.stack([good, nan]))
    assert torch.equal(got[0], tmarg._clipped_pinv(good))
    assert bool(torch.isnan(got[1]).all())
    assert np.isnan(np.asarray(jmarg._clipped_pinv(jnp.asarray(nan.numpy())))).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jmarg._clipped_pinv(jnp.asarray(good.numpy()))),
                               rtol=0, atol=1e-8 * float(np.abs(np.linalg.pinv(good.numpy())).max()))


@pytest.fixture
def one_thread():
    """One CPU thread for the test, whatever the worker's count (the raise
    below was met with one); the count before it is restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_float32_keyframe_step_on_the_dryrun_core_runs(one_thread):
    """``make_window_step`` in float32 on ``chip_smoke.dryrun_core`` of the
    ``dense`` case of ``chip_smoke.shard_step_cases("small")``, keyframe
    branch, first step: before the repair its frame-0 marginalization raised
    "linalg.eigh: The algorithm failed to converge (error code: 8349)" on a
    finite H whose Cholesky had failed, and which float64 and
    ``jnp.linalg.eigh`` decompose (every run, one thread, on the CPU build
    of PyTorch 2.13). The step runs, its pose is finite and its prior is
    valid, finite and not zero: the float64 retry's square root."""
    cfg = chip_smoke.shard_step_cases("small")["dense"]
    cpu = torch.device("cpu")
    core0, flags_of = chip_smoke.shard_case("dense", cfg, torch.float32, cpu)
    core, out = make_window_step(cfg, cpu)[0](core0, flags_of(True))
    assert out["pose"].dtype == torch.float32 and bool(torch.isfinite(out["poses"]).all())
    assert bool(core.prior.valid) and bool(torch.isfinite(core.prior.J0).all())
    assert float(core.prior.J0.abs().max()) > 0.0
