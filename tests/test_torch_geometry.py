"""PyTorch port vs JAX package: SO(3)/SE(3) primitives on the same
numpy-seeded inputs, float64, agreement to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.geometry import se3 as jse3
from ground_fusion_tpu.geometry import so3 as jso3
from ground_fusion_tpu_torch.geometry import se3 as tse3
from ground_fusion_tpu_torch.geometry import so3 as tso3

TOL = 1e-12
RNG = np.random.default_rng(0)
N = 16
_q = RNG.normal(size=(N, 4))
QUATS = _q / np.linalg.norm(_q, axis=-1, keepdims=True)
QUATS2 = np.roll(QUATS, 3, axis=0)
VECS = RNG.normal(size=(N, 3))
PHIS = np.concatenate([RNG.normal(size=(N - 2, 3)), np.zeros((1, 3)), 1e-9 * np.ones((1, 3))])
POSES = np.concatenate([RNG.normal(size=(N, 3)), QUATS], axis=-1)
POSES2 = np.concatenate([RNG.normal(size=(N, 3)), QUATS2], axis=-1)
DELTAS = 0.1 * RNG.normal(size=(N, 6))


def _cmp(jfn, tfn, *args):
    want = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    got = tfn(*[torch.as_tensor(a) for a in args]).numpy()
    assert want.shape == got.shape
    assert np.abs(want - got).max() <= TOL, np.abs(want - got).max()


SO3_CASES = [
    ("quat_normalize", (2.0 * QUATS,)),
    ("quat_conj", (QUATS,)),
    ("quat_mul", (QUATS, QUATS2)),
    ("quat_rotate", (QUATS, VECS)),
    ("quat_rotate_inv", (QUATS, VECS)),
    ("quat_to_mat", (QUATS,)),
    ("skew", (VECS,)),
    ("quat_exp", (PHIS,)),
    ("quat_log", (QUATS,)),
    ("delta_q", (PHIS,)),
    ("so3_exp_mat", (PHIS,)),
    ("right_jacobian_so3", (PHIS,)),
    ("left_quat_prod_mat", (QUATS,)),
    ("right_quat_prod_mat", (QUATS,)),
    ("ypr_to_mat", (VECS,)),
    ("g2r", (VECS,)),
    ("yaw_to_mat", (VECS[:, 0],)),
]


@pytest.mark.parametrize("name,args", SO3_CASES, ids=[c[0] for c in SO3_CASES])
def test_so3_matches_jax(name, args):
    _cmp(getattr(jso3, name), getattr(tso3, name), *args)


def test_mat_to_quat_and_logs_match_jax():
    mats = np.asarray(jso3.quat_to_mat(jnp.asarray(QUATS)))
    # include rotations near 180° about each axis so every Shepperd branch runs
    extra = np.asarray(jso3.so3_exp_mat(jnp.asarray(
        [[3.1, 0.0, 0.0], [0.0, 3.1, 0.0], [0.0, 0.0, 3.1], [0.0, 0.0, 0.0]])))
    mats = np.concatenate([mats, extra])
    _cmp(jso3.mat_to_quat, tso3.mat_to_quat, mats)
    _cmp(jso3.so3_log_mat, tso3.so3_log_mat, mats)
    _cmp(jso3.mat_to_ypr, tso3.mat_to_ypr, mats)


SE3_CASES = [
    ("pose_boxplus", (POSES, DELTAS)),
    ("pose_compose", (POSES, POSES2)),
    ("pose_inverse", (POSES,)),
    ("pose_apply", (POSES, VECS)),
    ("pose_apply_inv", (POSES, VECS)),
]


@pytest.mark.parametrize("name,args", SE3_CASES, ids=[c[0] for c in SE3_CASES])
def test_se3_matches_jax(name, args):
    _cmp(getattr(jse3, name), getattr(tse3, name), *args)
