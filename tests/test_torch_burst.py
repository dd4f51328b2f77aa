"""The port's execution modes at the step level, against its own window
step (which ``test_torch_step.py`` holds to the JAX package), on the cases
of ``tests/test_burst.py``, in float64 on the CPU at ``window_size=4``,
``max_landmarks=32`` and 2 dogleg iterations:

- the packed codec round-trips a core bit for bit and refuses a dtype family
  that mixes dtypes; the packed step equals the step;
- ``make_window_burst`` equals the loop of steps bit for bit (K = 5, both
  slide branches);
- the fleet (``make_window_burst_batched``: the step under ``vmap``, split
  by the keyframe decisions) matches each sequence at the oracle's
  tolerances (B = 3, K = 2, both branches in every step);
- ``utils/convert.py`` carries a batched JAX core and stacked flags.

Under ``-m slow``: the JAX package's fleet and the port's from the same
filled cores. The pipeline-level modes are in ``test_torch_burst_replay.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

import chip_smoke
from ground_fusion_tpu_torch.config import Config
from ground_fusion_tpu_torch.estimator.step import (
    make_packed_codec,
    make_window_burst,
    make_window_burst_batched,
    make_window_step,
    make_window_step_packed,
)
from ground_fusion_tpu_torch.utils.convert import stack_cores, unstack_cores

DT = torch.float64


def _small(**kw):
    cfg = Config(**kw)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, window_size=4, max_landmarks=32, max_iters=2))


def _tensors(x):
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _equal(a, b):
    la, lb = _tensors(a), _tensors(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------- step level


def test_packed_codec_round_trip_is_exact_and_the_packed_step_equals_the_step():
    cfg = _small()
    core, flags = chip_smoke.filled_core(cfg, DT, "cpu")
    step, _ = make_window_step(cfg, "cpu")
    pstep, pack, unpack, _ = make_window_step_packed(cfg, core, "cpu")
    blobs = pack(core)
    assert len(blobs) == 3 and [b.dtype for b in blobs] == [torch.bool, DT, torch.int64]
    assert _equal(unpack(blobs), core)
    c1, o1 = step(core, flags)
    pb, o2 = pstep(blobs, flags)
    assert torch.equal(o1["pose"], o2["pose"])
    assert _equal(unpack(pb), c1)


def test_packed_codec_rejects_mixed_dtype_family():
    with pytest.raises(TypeError, match="mixes"):
        make_packed_codec({"a": torch.zeros(3, dtype=torch.float64),
                           "b": torch.zeros(3, dtype=torch.float32)})


def test_burst_equals_the_loop_of_steps():
    """K = 5 steps with marg_old [T, F, T, T, F]: the burst's core and every
    step's outputs equal the loop's bit for bit (the same eager steps)."""
    cfg = _small()
    step, _ = make_window_step(cfg, "cpu")
    burst, _ = make_window_burst(cfg, "cpu")
    core, flags = chip_smoke.filled_core(cfg, DT, "cpu")
    margs = [True, False, True, True, False]
    c_seq, outs = core, []
    for m in margs:
        c_seq, out = step(c_seq, flags._replace(marg_old=m))
        outs.append(out)
    c_b, outs_b = burst(core, chip_smoke.flags_batch(flags, margs))
    assert _equal(c_b, c_seq)
    for k, out in enumerate(outs):
        for name, v in out.items():
            assert torch.equal(outs_b[name][k], v), (k, name)


def test_fleet_matches_each_sequence():
    """B = 3 cores (depths scaled by 1 + 0.1·b), K = 2 steps with marg_old
    = (k + b) % 2 == 0, so every step splits the batch: each sequence within
    the oracle's tolerances of its own burst (per-step poses 1e-2, end poses
    1e-3, inverse depths 2e-3, ``wheel_buf.bad`` equal)."""
    cfg = _small()
    fleet, _ = make_window_burst_batched(cfg, "cpu")
    single, _ = make_window_burst(cfg, "cpu")
    B, K = 3, 2
    cores, margs = [], np.array([[(k + b) % 2 == 0 for b in range(B)] for k in range(K)])
    for b in range(B):
        core, flags = chip_smoke.filled_core(cfg, DT, "cpu", b)
        cores.append(core)
    cb, ob = fleet(stack_cores(cores), chip_smoke.flags_batch(flags, margs))
    ends = unstack_cores(cb)
    assert len(ends) == B and tuple(ob["pose"].shape) == (K, B, 7)
    for b in range(B):
        cs, os_ = single(cores[b], chip_smoke.flags_batch(flags, margs[:, b]))
        assert torch.allclose(ob["pose"][:, b], os_["pose"], rtol=1e-2, atol=1e-2)
        assert torch.allclose(ends[b].state.poses, cs.state.poses, rtol=1e-3, atol=1e-3)
        assert torch.allclose(ends[b].tracks.inv_depth, cs.tracks.inv_depth, rtol=1e-3, atol=2e-3)
        assert torch.equal(ends[b].wheel_buf.bad, cs.wheel_buf.bad)


def test_fleet_with_one_branch_for_the_whole_batch():
    """A step where every sequence takes the same branch runs unsplit; stack
    and unstack are inverse."""
    cfg = _small()
    fleet, _ = make_window_burst_batched(cfg, "cpu")
    step, _ = make_window_step(cfg, "cpu")
    cores = [chip_smoke.filled_core(cfg, DT, "cpu", b)[0] for b in range(2)]
    _, flags = chip_smoke.filled_core(cfg, DT, "cpu")
    assert all(_equal(a, b) for a, b in zip(unstack_cores(stack_cores(cores)), cores))
    cb, ob = fleet(stack_cores(cores), chip_smoke.flags_batch(flags, [[False, False]]))
    for b, core in enumerate(cores):
        cs, os_ = step(core, flags._replace(marg_old=False))
        assert torch.allclose(ob["pose"][0, b], os_["pose"], atol=1e-10)
        assert torch.allclose(unstack_cores(cb)[b].state.poses, cs.state.poses, atol=1e-10)


def test_batched_jax_core_and_stacked_flags_convert():
    """``core_from_numpy`` carries a batched core of the JAX package (every
    leaf with a leading axis B) and ``flags_from_numpy`` flags stacked [K]
    and [K, B]: the same tensors as converting each core alone and stacking
    them, ``marg_old`` a host bool array."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from ground_fusion_tpu.config import Config as JConfig
    from ground_fusion_tpu_torch.utils import convert

    jcfg = JConfig()
    jcfg = dataclasses.replace(jcfg, solver=dataclasses.replace(
        jcfg.solver, window_size=4, max_landmarks=32))
    cores, flags = [], None
    for b in range(2):
        core, flags = __graft_entry__._example_core_and_flags(jcfg, jnp.float64)
        cores.append(core._replace(tracks=core.tracks._replace(
            inv_depth=core.tracks.inv_depth * (1.0 + 0.1 * b))))
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cores)
    got = convert.core_from_numpy(jax.device_get(batched), "cpu", DT)
    want = stack_cores([convert.core_from_numpy(jax.device_get(c), "cpu", DT) for c in cores])
    assert tuple(got.tracks.inv_depth.shape) == (2, 32) and _equal(got, want)
    margs = np.array([[True, False], [False, True], [True, True]])
    fb = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (3, 2) + jnp.shape(a)), flags)
    fl = convert.flags_from_numpy(jax.device_get(fb._replace(marg_old=jnp.asarray(margs))),
                                  "cpu", DT)
    assert isinstance(fl.marg_old, np.ndarray) and np.array_equal(fl.marg_old, margs)
    assert tuple(fl.wheel_valid.shape) == (3, 2, 5) and fl.wheel_valid.dtype == torch.bool
    one = convert.flags_from_numpy(jax.device_get(flags), "cpu", DT)
    assert one.marg_old is True


# ------------------------------------------------------------------- slow


@pytest.mark.slow
def test_fleet_matches_the_jax_packages_fleet_from_the_same_cores():
    """``tests/test_burst.py``'s filled cores (B = 3, window 4, 32
    landmarks, 4 dogleg iterations), built by the JAX package, cast to
    float64, stacked and carried into the port by ``utils/convert.py``; K = 3 steps with marg_old
    = (k + b) % 2 == 0 through both packages' fleets: per-step poses, end
    poses and inverse depths within 1e-6, ``wheel_buf.bad`` equal."""
    import jax
    import jax.numpy as jnp

    from ground_fusion_tpu.config import Config as JConfig
    from ground_fusion_tpu.estimator.step import make_window_burst_batched as j_fleet
    from ground_fusion_tpu_torch.utils import convert
    from tests import test_burst as oracle

    kw = dict(window_size=4, max_landmarks=32, max_iters=4)
    jcfg = JConfig()
    jcfg = dataclasses.replace(jcfg, solver=dataclasses.replace(jcfg.solver, **kw))
    B, K = 3, 3
    f64 = lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a
    cores = []
    for b in range(B):
        core, flags = jax.tree_util.tree_map(f64, oracle._filled_core(jcfg))
        cores.append(core._replace(tracks=core.tracks._replace(
            inv_depth=core.tracks.inv_depth * (1.0 + 0.1 * b))))
    margs = np.array([[(k + b) % 2 == 0 for b in range(B)] for k in range(K)])
    cores_b = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cores)
    fb = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (K, B) + jnp.shape(a)), flags)
    fb = fb._replace(marg_old=jnp.asarray(margs))
    burst, _ = j_fleet(jcfg)
    j_end, j_out = jax.device_get(burst(cores_b, fb))

    cfg = _small()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, **kw))
    fleet, _ = make_window_burst_batched(cfg, "cpu")
    t_end, t_out = fleet(convert.core_from_numpy(jax.device_get(cores_b), "cpu", DT),
                         convert.flags_from_numpy(jax.device_get(fb), "cpu", DT))
    assert np.abs(np.asarray(j_out["pose"]) - t_out["pose"].numpy()).max() <= 1e-6
    assert np.abs(np.asarray(j_end.state.poses) - t_end.state.poses.numpy()).max() <= 1e-6
    assert np.abs(np.asarray(j_end.tracks.inv_depth) - t_end.tracks.inv_depth.numpy()).max() <= 1e-6
    assert np.array_equal(np.asarray(j_end.wheel_buf.bad), t_end.wheel_buf.bad.numpy())
