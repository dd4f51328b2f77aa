"""PyTorch port vs JAX package: the Hamming distance of packed BRIEF
descriptors. The port's plain versions (SWAR popcount and bit planes) are
held exactly to the JAX package's SWAR version and its bit-plane version at
every shape, and to its Pallas kernel (interpret mode on the CPU, one
compile) at 37x211. On the CPU the port's wrapper runs the plain version;
the CUDA kernel itself is held against the plain version on the GPU by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.global_layers.brief import hamming_matrix as j_swar
from ground_fusion_tpu.ops.pallas.hamming import hamming_matrix_mxu as j_mxu
from ground_fusion_tpu.ops.pallas.hamming import hamming_matrix_pallas as j_pallas
from ground_fusion_tpu_torch.global_layers import brief as tbrief
from ground_fusion_tpu_torch.ops.cuda import hamming


def _rand_desc(rng, k):
    return rng.integers(0, 2**32, (k, 8), dtype=np.uint32)


def _t(d: np.ndarray) -> torch.Tensor:
    """Host uint32 words → the port's int32 bit patterns."""
    return torch.as_tensor(d.view(np.int32))


@pytest.mark.parametrize("ka,kb", [(37, 211), (130, 65), (1, 1)])
def test_plain_versions_equal_the_jax_package_and_its_pallas_kernel(ka, kb):
    rng = np.random.default_rng(ka * 1000 + kb)
    da, db = _rand_desc(rng, ka), _rand_desc(rng, kb)
    want = np.asarray(j_swar(jnp.asarray(da), jnp.asarray(db)))
    assert np.array_equal(np.asarray(j_mxu(jnp.asarray(da), jnp.asarray(db))), want)
    if ka == 37:     # the Pallas kernel in interpret mode, at the shape of test_pallas_ops.py
        assert np.array_equal(np.asarray(j_pallas(jnp.asarray(da), jnp.asarray(db))), want)
    for fn in (hamming.hamming_matrix_reference, hamming.hamming_matrix_mxu):
        got = fn(_t(da), _t(db))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), fn.__name__


def test_identity_and_complement():
    rng = np.random.default_rng(5)
    d = _rand_desc(rng, 16)
    comp = d ^ np.uint32(0xFFFFFFFF)
    assert np.all(np.diag(np.asarray(j_swar(jnp.asarray(d), jnp.asarray(comp)))) == 256)
    for fn in (hamming.hamming_matrix_reference, hamming.hamming_matrix_mxu):
        assert np.all(np.diag(fn(_t(d), _t(d)).numpy()) == 0)
        flip = fn(_t(d), torch.bitwise_not(_t(d))).numpy()
        assert np.array_equal(flip, fn(_t(d), _t(comp)).numpy())
        assert np.all(np.diag(flip) == 256)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    """``brief.hamming_matrix`` is the wrapper itself, so neither name can go
    round the kernel on the card."""
    assert tbrief.hamming_matrix is hamming.hamming_matrix
    rng = np.random.default_rng(6)
    da, db = _t(_rand_desc(rng, 9)), _t(_rand_desc(rng, 33))
    launches, plain = hamming.LAUNCHES, hamming.REFERENCE_CALLS
    got = hamming.hamming_matrix(da, db)
    assert hamming.LAUNCHES == launches and hamming.REFERENCE_CALLS == plain + 1
    assert torch.equal(got, hamming.hamming_matrix_reference(da, db))


def test_match_brief_goes_through_the_wrapper():
    rng = np.random.default_rng(7)
    da, db = _t(_rand_desc(rng, 5)), _t(_rand_desc(rng, 12))
    plain = hamming.REFERENCE_CALLS
    tbrief.match_brief(da, torch.ones(5, dtype=torch.bool), db, torch.ones(12, dtype=torch.bool))
    assert hamming.REFERENCE_CALLS == plain + 1


def test_wrapper_refuses_other_devices():
    d = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hamming.hamming_matrix(d, d)


def test_packing_wraps_to_the_int32_bit_pattern():
    """Bit 31 set gives a negative int32 whose uint32 view is the packed
    word; the words come back exactly through the plain popcount."""
    bits = torch.zeros((3, 256), dtype=torch.bool)
    bits[0, 31] = True                       # word 0 = 0x80000000
    bits[1, :] = True                        # every word 0xFFFFFFFF
    bits[2, 32:64:2] = True                  # word 1 = 0x55555555
    words = tbrief.pack_bits(bits)
    assert words.dtype == torch.int32
    u = words.numpy().view(np.uint32)
    assert u[0, 0] == 0x80000000 and np.all(u[1] == 0xFFFFFFFF) and u[2, 1] == 0x55555555
    d = hamming.hamming_matrix_reference(words, torch.zeros((1, 8), dtype=torch.int32))
    assert d[:, 0].tolist() == [1, 256, 16]
