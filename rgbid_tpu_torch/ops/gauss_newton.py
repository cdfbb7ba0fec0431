"""ESM Gauss-Newton building blocks (K5-K7), plain PyTorch.

Counterpart of ``rgbid_tpu/ops/gauss_newton.py:97-105, 215-431, 534-546``.
``esm_residuals_and_normal_eq`` here is the plain version of the ESM
kernel (``ops/kernels.py``, ``csrc/esm_normal_eq.cu``): the CPU path and
the reference the kernel is held to on the card. Its per-pixel float
operations run in the same order as the kernel's, so the two agree
exactly on every count (valid pixels, inliers) and to rounding on the sums.

Update convention: H delta = b, then T <- T . exp(-delta).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.camera import Intrinsics
from .warp import sample_stack7, transform_project


class IrlsResult(NamedTuple):
    H: torch.Tensor  # (6, 6) normal matrix, per valid pixel
    b: torch.Tensor  # (6,)
    sigma2_int: torch.Tensor  # () lagged Student-t scale for the next iteration
    sigma2_xi: torch.Tensor
    error: torch.Tensor  # () weighted mean squared error
    n_valid: torch.Tensor  # () valid pixel count
    inlier_frac: torch.Tensor


def _esm_pointwise(
    T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr: Intrinsics, nu,
    sigma2_int, sigma2_xi, use_geometric: bool, gate_sigmas: float,
    occlusion_gate: bool, gate_cap2: float = 0.0,
):
    """Per-pixel ESM math: warp, sample, residuals, occlusion gate,
    Student-t weights, warp/prediction Jacobians, ESM gradient averaging.

    Stack layout by channel count: 7 = [I, xi, mask, gxI, gyI, gxXi, gyXi]
    (averaging on both channels), 5 = [I, xi, mask, gxI, gyI] (intensity
    only), 3 = [I, xi, mask] (template gradients alone).

    Returns (Ji (6, ...), Jx (6, ...) | None, w_i, w_x, r_i, r_x, valid).
    """
    n_ch = cur_stack.shape[0]
    Px, Py, Pz = kf_points
    up, vp, rho, front = transform_project(Px, Py, Pz, T, intr)
    samples, mask_ok, inb = sample_stack7(cur_stack, up, vp)
    i_s, xi_s = samples[0], samples[1]
    valid = kf_mask * front * inb * mask_ok
    r_i = (i_s - kf_int) * valid
    r_x = (xi_s - rho) * valid
    # The occlusion gate removes pixels from the WEIGHTS only; sigma
    # statistics, n_valid and the inlier count stay ungated.
    if occlusion_gate and use_geometric:
        thresh = (2.0 * gate_sigmas) ** 2 * sigma2_xi + 0.05**2
        if gate_cap2 > 0.0:
            thresh = torch.clamp(thresh, max=gate_cap2)
        w_gate = (r_x * r_x <= thresh).to(torch.float32)
        w_i = (nu + 1.0) / (nu + r_i * r_i / sigma2_int) * valid * w_gate / sigma2_int
        w_x = (nu + 1.0) / (nu + r_x * r_x / sigma2_xi) * valid * w_gate / sigma2_xi
    else:
        w_i = (nu + 1.0) / (nu + r_i * r_i / sigma2_int) * valid / sigma2_int
        w_x = (nu + 1.0) / (nu + r_x * r_x / sigma2_xi) * valid / sigma2_xi

    fx, fy = intr.fx, intr.fy
    iz = 1.0 / torch.clamp(Pz, min=1e-6)
    iz2 = iz * iz
    zero = torch.zeros_like(Px)
    ju = (
        fx * iz,
        zero,
        -fx * Px * iz2,
        -fx * Px * Py * iz2,
        fx * (1.0 + Px * Px * iz2),
        -fx * Py * iz,
    )
    jv = (
        zero,
        fy * iz,
        -fy * Py * iz2,
        -fy * (1.0 + Py * Py * iz2),
        fy * Px * Py * iz2,
        fy * Px * iz,
    )
    # Exact prediction Jacobian -rho'^2 [r3 | P x r3], r3 = T's third row.
    R = T[:3, :3]
    nrho2 = -(rho * rho)
    jrho = (
        nrho2 * R[2, 0],
        nrho2 * R[2, 1],
        nrho2 * R[2, 2],
        nrho2 * (Py * R[2, 2] - Pz * R[2, 1]),
        nrho2 * (Pz * R[2, 0] - Px * R[2, 2]),
        nrho2 * (Px * R[2, 1] - Py * R[2, 0]),
    )
    if n_ch >= 7:
        gxi = 0.5 * (kf_grads[0] + samples[3])
        gyi = 0.5 * (kf_grads[1] + samples[4])
        gxx = 0.5 * (kf_grads[2] + samples[5])
        gyx = 0.5 * (kf_grads[3] + samples[6])
    elif n_ch >= 5:
        gxi = 0.5 * (kf_grads[0] + samples[3])
        gyi = 0.5 * (kf_grads[1] + samples[4])
        gxx, gyx = kf_grads[2], kf_grads[3]
    else:
        gxi, gyi, gxx, gyx = kf_grads[0], kf_grads[1], kf_grads[2], kf_grads[3]
    Ji = torch.stack([gxi * ju[k] + gyi * jv[k] for k in range(6)])
    Jx = None
    if use_geometric:
        Jx = torch.stack([gxx * ju[k] + gyx * jv[k] - jrho[k] for k in range(6)])
    return Ji, Jx, w_i, w_x, r_i, r_x, valid


def esm_residuals_and_normal_eq(
    T: torch.Tensor,
    kf_int: torch.Tensor,
    kf_points: tuple,
    kf_mask: torch.Tensor,
    kf_grads: torch.Tensor,
    cur_stack: torch.Tensor,
    intr: Intrinsics,
    nu: float,
    sigma2_int: torch.Tensor,
    sigma2_xi: torch.Tensor,
    use_geometric: bool = True,
    gate_sigmas: float = 3.0,
    occlusion_gate: bool = False,
    gate_cap: float = 0.0,
) -> IrlsResult:
    """One ESM IRLS evaluation reduced to per-pixel-normalized (H, b),
    with the lagged sigma update for the next iteration. A disabled
    geometric channel stays out of H, b, the error and its sigma (which
    is returned unchanged)."""
    Ji, Jx, w_i, w_x, r_i, r_x, valid = _esm_pointwise(
        T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
        sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate,
        gate_cap2=gate_cap * gate_cap,
    )
    n_valid = valid.sum()
    inv_n = 1.0 / torch.clamp(n_valid, min=1.0)
    Ji = Ji.reshape(6, -1)
    wi = w_i.reshape(-1)
    ri = r_i.reshape(-1)
    H = (Ji * wi) @ Ji.T
    b = Ji @ (wi * ri)
    err = (wi * ri * ri).sum()
    if use_geometric:
        Jx = Jx.reshape(6, -1)
        wx = w_x.reshape(-1)
        rx = r_x.reshape(-1)
        H = H + (Jx * wx) @ Jx.T
        b = b + Jx @ (wx * rx)
        err = err + (wx * rx * rx).sum()
    inl = (valid * (r_i * r_i < gate_sigmas**2 * sigma2_int)).sum()
    w0i = (nu + 1.0) / (nu + r_i * r_i / sigma2_int)
    s2i = torch.clamp((valid * w0i * r_i * r_i).sum() * inv_n, min=1e-12)
    if use_geometric:
        w0x = (nu + 1.0) / (nu + r_x * r_x / sigma2_xi)
        s2x = torch.clamp((valid * w0x * r_x * r_x).sum() * inv_n, min=1e-12)
    else:
        s2x = sigma2_xi
    return IrlsResult(H * inv_n, b * inv_n, s2i, s2x, err * inv_n, n_valid, inl * inv_n)


def ic_update(T: torch.Tensor, H: torch.Tensor, b: torch.Tensor, damping: float, n_valid):
    """delta = solve(H + damping I, b); T <- T . exp(-delta).

    The update is a no-op when too few pixels were valid (n_valid <= 100)
    or the factorization or solve failed. ``cholesky_ex`` reports failure
    in ``info`` instead of raising, so nothing here reads the device."""
    Hd = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = torch.cholesky_solve(b[:, None], L)[:, 0]
    ok = (n_valid > 100.0) & torch.isfinite(delta).all() & (info == 0)
    delta = torch.where(ok, delta, torch.zeros_like(delta))
    return se3.orthonormalize(T @ se3.exp(-delta)), delta
