"""PyTorch port vs JAX package: detector training (``detector/train.py``:
``make_batch``, ``_targets``, ``loss_fn``, ``train``) and
``scripts/train_detector.py``'s port.

The loss runs the backbone's convolutions in bfloat16 in both packages (XLA
there, ``conv2d`` here), so the gradients of one batch differ by bfloat16
rounding: each package's gradient lies 1-17 % (Frobenius, per leaf) from the
gradient of a float64 backbone, and the two lie within 2e-2 of each other on
every leaf but the conv biases, whose gradient is a bfloat16 sum over every
pixel of the batch; there the port's gradient must be no farther from the
JAX package's than the JAX package's is from the float64 one."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from ground_fusion_tpu.detector import model as jmodel
from ground_fusion_tpu.detector import train as jtrain
from ground_fusion_tpu_torch.detector import model as tmodel
from ground_fusion_tpu_torch.detector import train as ttrain
from ground_fusion_tpu_torch.scripts import train_detector

CPU = torch.device("cpu")
LEAF_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two CPU threads for this file's training steps; the worker's count
    before them is restored after them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_params():
    """The JAX package's ``init_params(PRNGKey(0))`` in float32 (under x64
    its kernels come out float64: ``np.sqrt`` promotes them)."""
    p = jmodel.init_params(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), p)


def _port_params(jp):
    tp = tmodel.params_from_jax([[np.asarray(v) for v in blk] for blk in jp.convs],
                                jp.head_w, jp.head_b, device=CPU)
    return ttrain.with_leaves(tp, [t.clone().requires_grad_(True) for t in ttrain.leaves(tp)])


def _jax_leaves(tree):
    """The JAX gradient's leaves in the port's order and layout (kernels
    HWIO → OIHW)."""
    out = [np.asarray(x) for blk in tree.convs for x in blk] + [np.asarray(tree.head_w),
                                                                np.asarray(tree.head_b)]
    return [x.transpose(3, 2, 0, 1) if x.ndim == 4 else x for x in out]


def test_make_batch_and_targets_match_jax():
    """The same rng gives the same batch (bit for bit), and the anchor-grid
    targets agree: objectness and classes equal, boxes within 1e-6 (float32
    logs of the box sizes). The batch holds images with one, two and three
    boxes; a case with two boxes on one cell and anchor keeps the max
    objectness and the last box, as the scan does."""
    want = jtrain.make_batch(np.random.default_rng(5), 12)
    got = ttrain.make_batch(np.random.default_rng(5), 12, device=CPU)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy()) and g.dtype == torch.from_numpy(
            np.asarray(w)).dtype
    boxes = np.asarray(want[1]).copy()
    ns = np.asarray(want[2]).copy()
    boxes[0, 1] = boxes[0, 0] + np.float32(2.0)       # same centre cell and anchor
    ns[0] = max(ns[0], 2)
    for gy, gx, stride in ((3, 3, 32.0), (6, 4, 24.0)):
        w = jax.vmap(lambda b, n: jtrain._targets(b, n, gy, gx, stride, 8))(jnp.asarray(boxes),
                                                                            jnp.asarray(ns))
        g = ttrain._targets(torch.as_tensor(boxes), torch.as_tensor(ns), gy, gx, stride)
        assert np.array_equal(g[0].numpy(), np.asarray(w[0], np.float32))
        np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]), rtol=0, atol=1e-6)
        assert np.array_equal(g[2].numpy(), np.asarray(w[2]))
        assert float(g[0].sum()) >= 1.0


def _f64_grads(tp, batch):
    """The port's loss gradient with the backbone in float64 (no bfloat16
    cast): the exact gradient both packages round."""
    def f64_backbone(params, x):
        x = x.double()
        for w, b, gamma, beta, mean, var in params.convs:
            x = F.conv2d(x, w.double(), padding=1) + b.double()[:, None, None]
            x = (gamma.double()[:, None, None] * (x - mean.double()[:, None, None])
                 / torch.sqrt(var.double()[:, None, None] + 1e-5) + beta.double()[:, None, None])
            x = torch.where(x > 0, x, 0.1 * x)
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return x.float()

    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "_backbone_nchw", f64_backbone)
    try:
        tp = ttrain.with_leaves(tp, [t.detach().clone().requires_grad_(True)
                                     for t in ttrain.leaves(tp)])
        ttrain.loss_fn(tp, *batch).backward()
        return [t.grad.numpy() for t in ttrain.leaves(tp)]
    finally:
        mp.undo()


def test_loss_and_gradient_match_jax_value_and_grad():
    """``loss_fn`` and its gradient in every leaf (kernels, biases,
    batch-norm scales, shifts and statistics, the head) against
    ``jax.value_and_grad(loss_fn)`` on the same float32 parameters and an
    8-image batch: the loss within 1e-4 relative, every leaf within
    :data:`LEAF_TOL` (Frobenius, relative), the conv biases no farther
    from JAX than JAX is from the float64 gradient (module docstring)."""
    jp = _jax_params()
    batch_np = jtrain.make_batch(np.random.default_rng(3), 8)
    loss_j, grad_j = jax.jit(jax.value_and_grad(jtrain.loss_fn))(jp, *batch_np)
    tp = _port_params(jp)
    batch = tuple(torch.as_tensor(np.asarray(a)) for a in batch_np)
    loss_t = ttrain.loss_fn(tp, *batch)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    exact = _f64_grads(tp, batch)
    for k, (t, w, e) in enumerate(zip(ttrain.leaves(tp), _jax_leaves(grad_j), exact)):
        g = t.grad.numpy()
        assert g.shape == w.shape, k
        gap = np.linalg.norm(g - w) / np.linalg.norm(w)
        if k % 6 == 1 and k < 30:                    # a conv bias
            assert gap <= np.linalg.norm(w - e) / np.linalg.norm(e), (k, gap)
        else:
            assert gap <= LEAF_TOL, (k, gap)


def test_adam_matches_optax():
    """Two steps of :func:`ttrain.adam` against ``optax.adam(1e-3)`` from
    the same parameters on the same gradients (JAX's gradient of two
    batches): every leaf within 1e-6 (float32, the same formula rounded in
    another order)."""
    jp = _jax_params()
    opt = optax.adam(1e-3)
    state = opt.init(jp)
    tp = _port_params(jp)
    topt = ttrain.adam(tp, 1e-3)
    rng = np.random.default_rng(4)
    grad_fn = jax.jit(jax.grad(jtrain.loss_fn))
    for _ in range(2):
        grads = grad_fn(jp, *jtrain.make_batch(rng, 4))
        updates, state = opt.update(grads, state)
        jp = optax.apply_updates(jp, updates)
        for t, g in zip(ttrain.leaves(tp), _jax_leaves(grads)):
            t.grad = torch.as_tensor(np.ascontiguousarray(g))
        topt.step()
    for t, w in zip(ttrain.leaves(tp), _jax_leaves(jp)):
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=0, atol=1e-6)


def test_a_short_cpu_run_lowers_the_loss(tmp_path):
    """``train`` for 12 steps of 8 images on the CPU from ``init_params``
    (generator seed 0): the mean loss of the last four steps is below the
    first step's; the script writes the trained weights in the JAX
    package's key scheme, which both packages load."""
    losses = []
    params = ttrain.train(steps=12, batch=8, seed=0, log_every=0, device=CPU, losses=losses)
    assert len(losses) == 12 and np.mean(losses[-4:]) < losses[0]
    assert all(not t.requires_grad for t in ttrain.leaves(params))
    out = str(tmp_path / "detector.npz")
    assert train_detector.main(["2", out, "--device", "cpu", "--batch", "4"]) == 0
    with np.load(out) as got, np.load(os.path.join(os.path.dirname(tmodel.__file__),
                                                   "weights.npz")) as shipped:
        assert sorted(got.files) == sorted(shipped.files)
        assert all(got[k].shape == shipped[k].shape for k in got.files)
    jmodel.load_npz(out)
    tmodel.load_npz(out, device=CPU)


@pytest.mark.slow
def test_400_steps_on_the_cpu_reach_the_recall_bound():
    """The JAX package's schedule (400 steps, batch 16, seed 0) on the CPU:
    recall ≥ 0.7 at IoU 0.3 on the 10 scenes of ``tests/test_detector.py``
    (rng 99, ``conf_thresh=0.3``); 19/20 with PyTorch 2.13's CPU build."""
    params = ttrain.train(steps=400, batch=16, seed=0, log_every=0, device=CPU)
    rng = np.random.default_rng(99)
    results, gts = [], []
    for _ in range(10):
        img, boxes, n = ttrain.render_scene(rng)
        results.append([x.numpy() for x in tmodel.detect(params, torch.as_tensor(img),
                                                         conf_thresh=0.3)])
        gts.append((boxes, n))
    hits, total = chip_smoke.detector_recall(np, results, gts)
    assert hits >= 0.7 * total, (hits, total)
