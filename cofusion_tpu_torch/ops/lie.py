"""SO(3)/SE(3) Lie-group helpers — PyTorch counterpart of cofusion_tpu/ops/lie.py.

Same conventions as the JAX module:
  * poses are 4x4 row-major camera-to-world matrices;
  * `se3_exp_rt(xi)` with xi = (t(3), w(3)) builds [[exp(w), t], [0, 1]] (the
    reference's computeUpdateSE3: translation is not coupled through V).

Branch-free (Taylor-guarded small-angle paths), batched over leading dims,
float32.  Matrix products run in full float32: `device.resolve_device` turns
TF32 off on the card.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye3(ref: torch.Tensor, batch_shape) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(*batch_shape, 3, 3)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, numerically safe at theta -> 0.

    R = I + sin(t)/t [w]_x + (1-cos(t))/t^2 [w]_x^2
    """
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    safe_theta = torch.where(small, 1.0, theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_theta) / safe_theta)
    b = torch.where(
        small,
        0.5 - theta2 / 24.0,
        (1.0 - torch.cos(safe_theta)) / torch.where(small, 1.0, theta2),
    )
    W = hat(w)
    # [w]_x^2 == w w^T - (w^T w) I
    wwT = w[..., :, None] * w[..., None, :]
    eye = _eye3(w, W.shape[:-2])
    W2 = wwT - theta2[..., None, None] * eye
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of a rotation matrix -> axis-angle vector (safe near identity)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    vee = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    small = theta < 1e-6
    safe_sin = torch.where(small, 1.0, torch.sin(theta))
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * safe_sin))
    return scale[..., None] * vee


def _bottom_row(ref: torch.Tensor, batch_shape) -> torch.Tensor:
    # [0, 0, 0, 1] built on the device: assigning a Python scalar into a CUDA
    # tensor is a host-to-device copy that synchronises the stream
    row = torch.eye(4, dtype=ref.dtype, device=ref.device)[3]
    return row.expand(*batch_shape, 1, 4)


def make_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(R, R.shape[:-2])], dim=-2)


def se3_exp_rt(xi: torch.Tensor) -> torch.Tensor:
    """Reference-style SE3 update: xi=(t, w) -> [[exp(w), t],[0,1]]."""
    t, w = xi[..., :3], xi[..., 3:6]
    return make_rt(so3_exp(w), t)


def invert_rt(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (R, t) -> (R^T, -R^T t)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_rt(Rt, -torch.matmul(Rt, t[..., None])[..., 0])


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to points of shape (..., 3)."""
    return torch.matmul(p, T[:3, :3].T) + T[:3, 3]


def rotate_vectors(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(v, T[:3, :3].T)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Matrix product of two 4x4 transforms at full float32 precision."""
    return torch.matmul(A, B)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory-export order.

    Branch-free Shepperd-style: all four candidate constructions, then the
    best-conditioned one is picked."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _case(tq, a, b, c, d):
        s = torch.sqrt(torch.clamp(tq, min=1e-12)) * 2.0
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1)

    q0 = _case(1.0 + tr, m21 - m12, m02 - m20, m10 - m01, 1.0 + tr)
    q1 = _case(1.0 + m00 - m11 - m22, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12)
    q2 = _case(1.0 - m00 + m11 - m22, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20)
    q3 = _case(1.0 - m00 - m11 + m22, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )
