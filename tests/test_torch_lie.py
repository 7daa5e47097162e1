"""cofusion_tpu_torch/ops/lie.py against cofusion_tpu/ops/lie.py on the CPU.

Tolerance atol=1e-6: both are float32 Rodrigues/Shepperd formulas with the
same branch-free guards; they differ only in transcendental implementations
(XLA's vs PyTorch's sin/cos/acos/sqrt, ~1 ulp) and in 3x3/4x4 product
summation order, which stay well below 1e-6 on unit-scale inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.ops import lie as jlie
from cofusion_tpu_torch.ops import lie as tlie

torch.set_num_threads(1)
ATOL = 1e-6


def _rot_vecs(rng, n, scale):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    return (w / np.linalg.norm(w, axis=1, keepdims=True) * rng.uniform(0, scale, (n, 1))).astype(np.float32)


def _poses(rng, n):
    R = np.array(jlie.so3_exp(jnp.asarray(_rot_vecs(rng, n, 3.0))))
    t = rng.normal(size=(n, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 3.0])
def test_so3_exp_matches(scale):
    w = _rot_vecs(np.random.default_rng(1), 64, scale)
    ref = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    out = tlie.so3_exp(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("scale", [1e-8, 1e-3, 0.5, 3.0])
def test_so3_log_matches(scale):
    w = _rot_vecs(np.random.default_rng(2), 64, scale)
    R = np.array(jlie.so3_exp(jnp.asarray(w)))
    ref = np.asarray(jlie.so3_log(jnp.asarray(R)))
    out = tlie.so3_log(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_se3_exp_invert_compose_match():
    rng = np.random.default_rng(3)
    xi = np.concatenate([rng.normal(size=(32, 3)), _rot_vecs(rng, 32, 1.0)], axis=1).astype(np.float32)
    np.testing.assert_allclose(
        tlie.se3_exp_rt(torch.from_numpy(xi)).numpy(),
        np.asarray(jlie.se3_exp_rt(jnp.asarray(xi))), atol=ATOL,
    )
    T = _poses(rng, 32)
    U = _poses(rng, 32)
    np.testing.assert_allclose(
        tlie.invert_rt(torch.from_numpy(T)).numpy(),
        np.asarray(jlie.invert_rt(jnp.asarray(T))), atol=ATOL,
    )
    np.testing.assert_allclose(
        tlie.compose(torch.from_numpy(T), torch.from_numpy(U)).numpy(),
        np.asarray(jlie.compose(jnp.asarray(T), jnp.asarray(U))), atol=ATOL,
    )


def test_transform_and_rotate_points_match():
    rng = np.random.default_rng(4)
    T = _poses(rng, 1)[0]
    p = rng.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlie.transform_points(torch.from_numpy(T), torch.from_numpy(p)).numpy(),
        np.asarray(jlie.transform_points(jnp.asarray(T), jnp.asarray(p))), atol=ATOL,
    )
    np.testing.assert_allclose(
        tlie.rotate_vectors(torch.from_numpy(T), torch.from_numpy(p)).numpy(),
        np.asarray(jlie.rotate_vectors(jnp.asarray(T), jnp.asarray(p))), atol=ATOL,
    )


def test_quaternion_round_trip_matches():
    rng = np.random.default_rng(5)
    R = _poses(rng, 200)[:, :3, :3]
    q_ref = np.array(jlie.rotmat_to_quat(jnp.asarray(R)))
    q = tlie.rotmat_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(q, q_ref, atol=ATOL)
    np.testing.assert_allclose(
        tlie.quat_to_rotmat(torch.from_numpy(q_ref)).numpy(),
        np.asarray(jlie.quat_to_rotmat(jnp.asarray(q_ref))), atol=ATOL,
    )


def test_hat_matches():
    w = np.random.default_rng(6).normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tlie.hat(torch.from_numpy(w)).numpy(), np.asarray(jlie.hat(jnp.asarray(w)))
    )
