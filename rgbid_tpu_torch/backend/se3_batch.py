"""Vectorized (batched) numpy SE(3) operations for the pose-graph solver.

The port's copy of ``rgbid_tpu/backend/se3_batch.py`` (numpy only).

Everything here operates on a leading edge/node axis so the pose-graph
optimizer's per-iteration work — residuals, ANALYTIC edge Jacobians, and
normal-equation blocks for ALL edges — is a handful of einsums instead of
a Python loop (reference: Eigen per-edge loops in src/pose_graph.*,
SURVEY.md §2.1; mount empty, structure from the papers).

Twist convention matches core.se3 / reference_cpu.se3_np: xi = [rho, phi]
(translation first). The analytic Jacobians use the closed-form inverse
left Jacobian of SE(3) (Barfoot, "State Estimation for Robotics",
eqs. 7.86/7.95):

    Jl(xi) = [[Jl_so3(phi), Q(xi)], [0, Jl_so3(phi)]]
    Jl^-1  = [[A, -A Q A], [0, A]],  A = Jl_so3(phi)^-1
    Jr^-1(xi) = Jl^-1(-xi)

They are validated against central finite differences of the residual in
tests/test_backend.py (the FD path remains the oracle), and this copy is
held to the original in tests/test_torch_backend.py.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-8


def hat_b(w: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    w = np.asarray(w, np.float64)
    out = np.zeros(w.shape[:-1] + (3, 3), np.float64)
    out[..., 0, 1] = -w[..., 2]
    out[..., 0, 2] = w[..., 1]
    out[..., 1, 0] = w[..., 2]
    out[..., 1, 2] = -w[..., 0]
    out[..., 2, 0] = -w[..., 1]
    out[..., 2, 1] = w[..., 0]
    return out


def exp_b(delta: np.ndarray) -> np.ndarray:
    """(..., 6) twists -> (..., 4, 4) transforms (batched se3_np.exp)."""
    delta = np.asarray(delta, np.float64)
    v, w = delta[..., :3], delta[..., 3:]
    theta = np.linalg.norm(w, axis=-1)
    W = hat_b(w)
    W2 = W @ W
    small = theta < _EPS
    ts = np.where(small, 1.0, theta)
    a = np.where(small, 1.0 - theta**2 / 6.0, np.sin(ts) / ts)
    b = np.where(small, 0.5 - theta**2 / 24.0, (1.0 - np.cos(ts)) / ts**2)
    c = np.where(small, 1.0 / 6.0 - theta**2 / 120.0, (ts - np.sin(ts)) / ts**3)
    eye = np.broadcast_to(np.eye(3), W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    T = np.zeros(delta.shape[:-1] + (4, 4), np.float64)
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, v)
    T[..., 3, 3] = 1.0
    return T


def log_b(T: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 6) twists (batched se3_np.log).

    Same formula family as the scalar oracle (degrades near theta = pi,
    like the reference's and the oracle's log).
    """
    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    small = theta < _EPS
    ts = np.where(small, 1.0, theta)
    vee = 0.5 * np.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    k = np.where(small, 1.0 + theta**2 / 6.0, ts / np.sin(ts))
    w = k[..., None] * vee
    W = hat_b(w)
    W2 = W @ W
    coef = np.where(
        small,
        1.0 / 12.0 + theta**2 / 720.0,
        1.0 / ts**2 - (1.0 + np.cos(ts)) / (2.0 * ts * np.sin(ts)),
    )
    eye = np.broadcast_to(np.eye(3), W.shape)
    V_inv = eye - 0.5 * W + coef[..., None, None] * W2
    rho = np.einsum("...ij,...j->...i", V_inv, t)
    return np.concatenate([rho, w], axis=-1)


def inv_b(T: np.ndarray) -> np.ndarray:
    """Batched rigid inverse."""
    T = np.asarray(T, np.float64)
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def adjoint_b(T: np.ndarray) -> np.ndarray:
    """Batched SE(3) adjoint for [rho, phi] twists:
    Adj(T) = [[R, hat(t) R], [0, R]], so T exp(xi) = exp(Adj(T) xi) T."""
    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.zeros(T.shape[:-2] + (6, 6), np.float64)
    out[..., :3, :3] = R
    out[..., :3, 3:] = hat_b(t) @ R
    out[..., 3:, 3:] = R
    return out


def _so3_jl_inv_b(phi: np.ndarray) -> np.ndarray:
    """Inverse left Jacobian of SO(3), batched."""
    theta = np.linalg.norm(phi, axis=-1)
    small = theta < _EPS
    ts = np.where(small, 1.0, theta)
    W = hat_b(phi)
    coef = np.where(
        small,
        1.0 / 12.0 + theta**2 / 720.0,
        1.0 / ts**2 - (1.0 + np.cos(ts)) / (2.0 * ts * np.sin(ts)),
    )
    eye = np.broadcast_to(np.eye(3), W.shape)
    return eye - 0.5 * W + coef[..., None, None] * (W @ W)


def _se3_Q_b(xi: np.ndarray) -> np.ndarray:
    """Barfoot's Q(xi) block of the SE(3) left Jacobian (eq. 7.86)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    P = hat_b(rho)
    W = hat_b(phi)
    W2 = W @ W
    PW = P @ W
    WP = W @ P
    WPW = W @ P @ W
    theta = np.linalg.norm(phi, axis=-1)
    small = theta < _EPS
    ts = np.where(small, 1.0, theta)
    sin, cos = np.sin(ts), np.cos(ts)
    c1 = np.where(small, 1.0 / 6.0 - theta**2 / 120.0, (ts - sin) / ts**3)
    c2 = np.where(
        small,
        -1.0 / 24.0 + theta**2 / 720.0,
        (1.0 - ts**2 / 2.0 - cos) / ts**4,
    )
    c3 = np.where(
        small,
        -1.0 / 120.0 + theta**2 / 2520.0,
        (ts - sin - ts**3 / 6.0) / ts**5,
    )
    c1 = c1[..., None, None]
    c2 = c2[..., None, None]
    c3 = c3[..., None, None]
    Q = (
        0.5 * P
        + c1 * (WP + PW + WPW)
        - c2 * (W2 @ P + P @ W2 - 3.0 * WPW)
        - 0.5 * (c2 - 3.0 * c3) * (WPW @ W + W @ WPW)
    )
    return Q


def jl_inv_b(xi: np.ndarray) -> np.ndarray:
    """Inverse left Jacobian of SE(3), (..., 6) -> (..., 6, 6)."""
    xi = np.asarray(xi, np.float64)
    A = _so3_jl_inv_b(xi[..., 3:])
    Q = _se3_Q_b(xi)
    out = np.zeros(xi.shape[:-1] + (6, 6), np.float64)
    out[..., :3, :3] = A
    out[..., :3, 3:] = -A @ Q @ A
    out[..., 3:, 3:] = A
    return out


def jr_inv_b(xi: np.ndarray) -> np.ndarray:
    """Inverse right Jacobian: Jr^-1(xi) = Jl^-1(-xi)."""
    return jl_inv_b(-np.asarray(xi, np.float64))
