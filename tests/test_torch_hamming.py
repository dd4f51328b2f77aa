"""PyTorch port vs JAX package: the Hamming distance of packed BRIEF
descriptors. The port's plain versions (SWAR popcount and bit planes) are
held exactly to the JAX package's SWAR version and its bit-plane version at
every shape, and to its Pallas kernel (interpret mode on the CPU, one
compile) at 37x211; the plain version of the fused match is held exactly to
the JAX package's ``match_brief`` (ties, masks, an all-masked old set). On
the CPU the port's wrappers run the plain versions; the CUDA kernels
themselves are held against them on the GPU by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.global_layers.brief import hamming_matrix as j_swar
from ground_fusion_tpu.global_layers.brief import match_brief as j_match
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


def test_match_brief_goes_through_the_wrapper(monkeypatch):
    """``match_brief`` is one call of the fused wrapper ``hamming_match``,
    which on CPU tensors runs the plain version and launches nothing."""
    rng = np.random.default_rng(7)
    da, db = _t(_rand_desc(rng, 5)), _t(_rand_desc(rng, 12))
    ok_a, ok_b = torch.ones(5, dtype=torch.bool), torch.ones(12, dtype=torch.bool)
    calls = []

    def counting(*args):
        calls.append(args)
        return hamming.hamming_match(*args)

    monkeypatch.setattr(tbrief, "hamming_match", counting)
    launches, plain = hamming.MATCH_LAUNCHES, hamming.MATCH_REFERENCE_CALLS
    got = tbrief.match_brief(da, ok_a, db, ok_b)
    assert len(calls) == 1
    assert hamming.MATCH_LAUNCHES == launches and hamming.MATCH_REFERENCE_CALLS == plain + 1
    want = hamming.match_brief_reference(da, ok_a, db, ok_b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrapper_refuses_other_devices():
    d = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hamming.hamming_matrix(d, d)


def _match_case(case: str):
    """(desc_cur, ok_cur, desc_old, ok_old) as numpy: current rows are old
    rows with 0-120 bits flipped, so some fall under the gate of 80 and some
    do not; ``ties`` repeats 8 old descriptors 5 times each (equal distances
    at several indices), ``mask`` masks every third old row and the rows some
    current ones copy, ``all_masked`` masks every old row."""
    if case == "1x1":
        rng = np.random.default_rng(11)
        return _rand_desc(rng, 1), np.ones(1, bool), _rand_desc(rng, 1), np.ones(1, bool)
    rng = np.random.default_rng({"random": 12, "ties": 13, "mask": 14, "all_masked": 15}[case])
    kc, kb = 12, 40
    old = _rand_desc(rng, kb)
    if case == "ties":
        old = np.repeat(_rand_desc(rng, 8), 5, axis=0)[rng.permutation(kb)]
    src = rng.integers(0, kb, kc)
    bits = np.unpackbits(old[src].view(np.uint8), axis=1)
    for r, k in enumerate(rng.integers(0, 121, kc)):
        bits[r, rng.choice(256, k, replace=False)] ^= 1
    cur = np.packbits(bits, axis=1).view(np.uint32)
    ok_cur = rng.random(kc) > 0.2
    ok_old = np.ones(kb, bool)
    if case == "mask":
        ok_old[::3] = False
        ok_old[src[:4]] = False
    if case == "all_masked":
        ok_old[:] = False
    return cur, ok_cur, old, ok_old


@pytest.mark.parametrize("case", ["random", "ties", "mask", "all_masked", "1x1"])
def test_match_brief_reference_equals_the_jax_package(case):
    cur, ok_cur, old, ok_old = _match_case(case)
    want_idx, want_m = j_match(jnp.asarray(cur), jnp.asarray(ok_cur), jnp.asarray(old),
                               jnp.asarray(ok_old), 80)
    got_idx, got_m = hamming.match_brief_reference(_t(cur), torch.as_tensor(ok_cur), _t(old),
                                                   torch.as_tensor(ok_old), 80)
    assert got_idx.dtype == torch.int64 and got_m.dtype == torch.bool
    assert np.array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))
    if case == "all_masked":
        assert not got_m.any() and not got_idx.any()
    if case in ("random", "ties"):
        assert 0 < int(got_m.sum()) < len(cur)       # both sides of the gate
    if case == "ties":                                # the first of equal old rows wins
        d = hamming.hamming_matrix_reference(_t(cur), _t(old))
        for r, i in enumerate(got_idx.tolist()):
            assert i == int(torch.nonzero(d[r] == d[r].min())[0])


def test_hamming_match_on_cpu_runs_the_plain_version_and_counts_no_launch():
    cur, ok_cur, old, ok_old = _match_case("mask")
    args = (_t(cur), torch.as_tensor(ok_cur), _t(old), torch.as_tensor(ok_old), 80)
    launches, plain = hamming.MATCH_LAUNCHES, hamming.MATCH_REFERENCE_CALLS
    matrix_launches = hamming.LAUNCHES
    got = hamming.hamming_match(*args)
    assert hamming.MATCH_LAUNCHES == launches and hamming.LAUNCHES == matrix_launches
    assert hamming.MATCH_REFERENCE_CALLS == plain + 1
    want = hamming.match_brief_reference(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _meta(shape, dtype=torch.int32, device="meta"):
    return torch.empty(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "int32 words"),
    ("shape", ValueError, r"expected \[K, 8\]"),
    ("device", ValueError, "is on cpu"),
    ("mask_dtype", ValueError, "contiguous bool"),
    ("mask_length", ValueError, "contiguous bool"),
    ("no_old", ValueError, "no old descriptor"),
    ("too_many_rows", ValueError, "exceed"),
    ("meta", ValueError, "unsupported device"),
])
def test_hamming_match_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    """The checks of the CUDA path are plain Python, testable without a card
    on 'meta' tensors (neither CPU nor CUDA); every case is refused before
    anything is launched."""
    args = [_meta((10, 8)), _meta((10,), torch.bool), _meta((30, 8)), _meta((30,), torch.bool)]
    if case == "dtype":
        args[2] = _meta((30, 8), torch.int64)
    elif case == "shape":
        args[0] = _meta((10, 4))
    elif case == "device":
        args[2] = _meta((30, 8), device="cpu")
    elif case == "mask_dtype":
        args[3] = _meta((30,), torch.uint8)
    elif case == "mask_length":
        args[1] = _meta((9,), torch.bool)
    elif case == "no_old":
        args[2], args[3] = _meta((0, 8)), _meta((0,), torch.bool)
    elif case == "too_many_rows":
        args[0], args[1] = _meta((2**31, 8)), _meta((2**31,), torch.bool)
    launches = hamming.MATCH_LAUNCHES
    with pytest.raises(error, match=match):
        hamming.hamming_match(*args)
    assert hamming.MATCH_LAUNCHES == launches


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "int32 words"),
    ("device", ValueError, "is on cpu"),
    ("too_many_rows", ValueError, "exceed the kernel's grid"),
])
def test_hamming_matrix_wrapper_refuses_what_the_kernel_does_not_take(case, error, match):
    da, db = _meta((10, 8)), _meta((30, 8))
    if case == "dtype":
        da = _meta((10, 8), torch.float32)
    elif case == "device":
        db = _meta((30, 8), device="cpu")
    elif case == "too_many_rows":
        da = _meta((65535 * 32 + 1, 8))
    with pytest.raises(error, match=match):
        hamming.hamming_matrix(da, db)


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
