"""SE(3) Lie-group operations on float32 torch tensors.

Counterpart of ``rgbid_tpu/core/se3.py``. A pose is a (4, 4) matrix, a
twist a (6,) vector ``[v, w]`` (translation first). Small-angle Taylor
branches are selected with ``torch.where`` so no function here reads a
device value back to the host.
"""

from __future__ import annotations

import torch

_EPS2 = 1e-8  # theta^2 below which the Taylor expansions are used


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (3,) -> (3, 3) skew-symmetric matrix."""
    z = torch.zeros_like(w[0])
    return torch.stack(
        [
            torch.stack([z, -w[2], w[1]]),
            torch.stack([w[2], z, -w[0]]),
            torch.stack([-w[1], w[0], z]),
        ]
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[2, 1], W[0, 2], W[1, 0]])


def _sinc_coeffs(theta2: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) with Taylor fallbacks."""
    small = theta2 < _EPS2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (t2 * theta)
    )
    return a, b, c


def _compose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(4, 4) transform from R (3, 3) and t (3,). Built from an identity
    with device-to-device block copies: writing a Python number into one
    element of a CUDA tensor copies a host scalar, which synchronizes."""
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def exp(delta: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: twist [v, w] -> (4, 4) transform."""
    v, w = delta[:3], delta[3:]
    W = hat(w)
    W2 = W @ W
    theta2 = torch.dot(w, w)
    a, b, c = _sinc_coeffs(theta2)
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return _compose(R, V @ v)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (4, 4) transform -> twist [v, w]."""
    R = T[:3, :3]
    t = T[:3, 3]
    cos_theta = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    theta2 = theta * theta
    small = theta2 < _EPS2
    sin_theta = torch.sin(theta)
    one = torch.ones_like(theta)
    k = torch.where(
        small, 0.5 + theta2 / 12.0, theta / torch.where(small, one, 2.0 * sin_theta)
    )
    w = k * vee(R - R.T)
    W = hat(w)
    W2 = W @ W
    safe_t2 = torch.where(small, one, theta2)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe_t2
        - (1.0 + torch.cos(theta)) / torch.where(small, one, 2.0 * theta * sin_theta),
    )
    V_inv = torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * W + coef * W2
    return torch.cat([V_inv @ t, w])


def inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (R^T, not a general inverse)."""
    Rt = T[:3, :3].T
    return _compose(Rt, -Rt @ T[:3, 3])


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle of a (3, 3) rotation matrix (trace formula, clipped)."""
    return torch.arccos(torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0))


def orthonormalize(T: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (Newton polar iteration,
    R <- R (3 I - R^T R) / 2): float32 compose chains drift R off the
    manifold, and the rigid optimizer cannot undo a non-rigid defect."""
    R = T[:3, :3]
    eye3 = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        R = R @ (1.5 * eye3 - 0.5 * (R.T @ R))
    return _compose(R, T[:3, 3])


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(4, 4) transform from R (3, 3) and t (3,)."""
    return _compose(R, t)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply T to points of shape (..., 3)."""
    return pts @ T[:3, :3].T + T[:3, 3]


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [qx, qy, qz, qw] (TUM order), sign
    canonicalized to qw >= 0. Shepperd's four candidates, the one with the
    largest pivot (the first on ties, as ``jnp.argmax``) picked by
    ``torch.gather``: a 0-d index tensor would read the host."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01])
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20])
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21])
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22])
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22])
    idx = torch.argmax(pivots).reshape(1, 1).expand(4, 1)
    q = torch.gather(torch.stack([qx, qy, qz, qw]), 1, idx)[:, 0]
    q = q / torch.linalg.vector_norm(q)
    return torch.where(q[3] < 0, -q, q)


def from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [qx, qy, qz, qw] -> rotation matrix."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy]),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx]),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)]),
        ]
    )
