"""Gauss-Newton building blocks (K5-K7), plain PyTorch: ESM and IC.

Counterpart of ``rgbid_tpu/ops/gauss_newton.py:43-546``.
``esm_residuals_and_normal_eq`` here is the plain version of the ESM
kernel (``ops/kernels.py``, ``csrc/esm_normal_eq.cu``), ``stratified_sums``
that of the stratified kernel (``csrc/esm_stratified.cu``); ``sigma_stats_plain``,
``normal_eq_plain`` and ``residuals_and_normal_eq`` are the plain versions
of the two IC kernels (``csrc/ic_normal_eq.cu``). They are the CPU path and
the reference the kernels are held to on the card. Their per-pixel float
operations run in the same order as the kernels', so the two agree
exactly on every count (valid pixels, inliers) and to rounding on the sums.

Update convention: H delta = b, then T <- T . exp(-delta).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se3
from ..core.camera import Intrinsics
from .warp import backproject_grid, sample_stack7, sample_tracker_planes, transform_project


def round_jac(x: torch.Tensor, jac_dtype: str) -> torch.Tensor:
    """Round template Jacobian or gradient planes to the configured storage
    precision: ``"bf16"`` gives bfloat16-rounded values held as float32."""
    if jac_dtype == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


# IC template Jacobians are one (12, H, W) field: planes 0-5 photometric,
# 6-11 inverse depth.


def warp_jacobian(x, y, z, intr: Intrinsics):
    """Jw = d(u, v)/d delta at identity from template points: (ju, jv), six
    planes each. Twist delta = [v, w] (translation first)."""
    iz = 1.0 / torch.clamp(z, min=1e-6)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    fx, fy = intr.fx, intr.fy
    ju = (fx * iz, fx * zero, fx * (-x * iz2), fx * (-x * y * iz2), fx * (1.0 + x * x * iz2),
          fx * (-y * iz))
    jv = (fy * zero, fy * iz, fy * (-y * iz2), fy * -(1.0 + y * y * iz2), fy * (x * y * iz2),
          fy * (x * iz))
    return ju, jv


def rho_jacobian(x, y, z):
    """d(1/Z)/d delta at identity from template points: six planes."""
    iz2 = 1.0 / torch.clamp(z, min=1e-6) ** 2
    zero = torch.zeros_like(x)
    return (zero, zero, -iz2, -y * iz2, x * iz2, zero)


def template_jacobians(
    gx_int, gy_int, gx_xi, gy_xi, xi, mask, intr: Intrinsics, jac_dtype: str = "f32"
) -> torch.Tensor:
    """The constant IC Jacobian field of one keyframe pyramid level,
    (12, H, W), masked and then rounded to ``jac_dtype``."""
    x, y, z = backproject_grid(xi, intr)
    ju, jv = warp_jacobian(x, y, z, intr)
    jr = rho_jacobian(x, y, z)
    j_int = [(gx_int * ju[k] + gy_int * jv[k]) * mask for k in range(6)]
    j_xi = [(gx_xi * ju[k] + gy_xi * jv[k] - jr[k]) * mask for k in range(6)]
    return round_jac(torch.stack(j_int + j_xi), jac_dtype)


def student_t_sigma2(r2, valid, nu: float, sigma2_init, iters: int):
    """Masked fixed-point Student-t scale estimate (returns sigma^2)."""
    n = torch.clamp(valid.sum(), min=1.0)
    sigma2 = torch.as_tensor(sigma2_init, dtype=torch.float32, device=r2.device)
    for _ in range(max(iters, 1)):
        w = (nu + 1.0) / (nu + r2 / torch.clamp(sigma2, min=1e-12))
        sigma2 = torch.clamp((valid * w * r2).sum() / n, min=1e-12)
    return sigma2


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

    Returns (Ji (6, ...), Jx (6, ...) | None, ju, jv, w_i, w_x, r_i, r_x,
    valid): ju and jv are the warp Jacobian's six planes each (the geometry
    Gram of ``stratified_normal_eq`` reads them).
    """
    n_ch = cur_stack.shape[0]
    # The template intensity and points may be stored bfloat16
    # (TrackingConfig.plane_dtype), and so may the stack: every value is
    # widened to float32 before any arithmetic, as the kernels load it.
    Px, Py, Pz = (p.float() for p in kf_points)
    kf_int = kf_int.float()
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
    return Ji, Jx, ju, jv, w_i, w_x, r_i, r_x, valid


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
    Ji, Jx, _ju, _jv, w_i, w_x, r_i, r_x, valid = _esm_pointwise(
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


# The 50 per-pixel quantities of the depth-stratified reduction, in column
# order: 21 H (upper triangle, row by row), 6 b, the valid count, the
# weighted error, then 21 geometry Gram entries (upper triangle).
STRATIFIED_SUMS = 50
_UPPER = [(a, c) for a in range(6) for c in range(a, 6)]


def stratified_sums(
    T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr: Intrinsics, nu, sigma2_int,
    sigma2_xi, strata, use_geometric: bool = True, gate_sigmas: float = 3.0,
    occlusion_gate: bool = True,
) -> torch.Tensor:
    """The plain version of the stratified kernel: the (K, 50) raw sums
    (``STRATIFIED_SUMS`` columns) of the ESM per-pixel quantities over each
    stratum, as the (K, N) one-hot ``strata`` matrix times the (N, 50)
    per-pixel matrix. No gate cap."""
    Ji, Jx, ju, jv, w_i, w_x, r_i, r_x, valid = _esm_pointwise(
        T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
        sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate,
    )
    cols = []
    for a, c in _UPPER:
        q = w_i * Ji[a] * Ji[c]
        if use_geometric:
            q = q + w_x * Jx[a] * Jx[c]
        cols.append(q)
    for a in range(6):
        q = w_i * Ji[a] * r_i
        if use_geometric:
            q = q + w_x * Jx[a] * r_x
        cols.append(q)
    cols.append(valid)
    e = w_i * r_i * r_i
    cols.append(e + w_x * r_x * r_x if use_geometric else e)
    for a, c in _UPPER:
        cols.append(valid * (ju[a] * ju[c] + jv[a] * jv[c]))
    Q = torch.stack([q.reshape(-1) for q in cols], dim=1)  # (N, 50)
    return strata.reshape(strata.shape[0], -1) @ Q


def unpack_stratified(out):
    """(K, 50) sums -> (Hk (K, 6, 6), bk (K, 6), nk (K,), Gk (K, 6, 6),
    ek (K,)); numpy arrays in, numpy arrays out, tensors likewise."""
    stack = np.stack if isinstance(out, np.ndarray) else torch.stack
    col = {ac: j for j, ac in enumerate(_UPPER)}

    def sym(base):
        return stack([stack([out[:, base + col[min(a, c), max(a, c)]] for c in range(6)], 1)
                      for a in range(6)], 1)

    return sym(0), out[:, 21:27], out[:, 27], sym(29), out[:, 28]


def stratified_normal_eq(
    T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr: Intrinsics, nu, sigma2_int,
    sigma2_xi, strata, use_geometric: bool = True, gate_sigmas: float = 3.0,
    occlusion_gate: bool = True,
):
    """Depth-stratified normal equations (the JAX package's contract):
    per-stratum RAW sums (K, 6, 6) H, (K, 6) b, (K,) n, (K, 6, 6) geometry
    Gram G = sum valid (ju ju^T + jv jv^T), (K,) weighted error, from the
    ESM per-pixel math at ``T`` with the given (fixed) scales."""
    return unpack_stratified(stratified_sums(
        T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu, sigma2_int, sigma2_xi,
        strata, use_geometric, gate_sigmas, occlusion_gate,
    ))


# IC (inverse-compositional) IRLS: the Pallas form of
# rgbid_tpu/ops/pallas_kernels.py:84-287, with the warp and the 3-plane
# gather that the TPU left in XLA folded in, as the CUDA kernels do.


class SigmaStats(NamedTuple):
    """One step of the Student-t scale fixed point (the sigma kernel)."""

    swi: torch.Tensor  # () sum of valid * w(sigma2_int) * r_i^2
    swx: torch.Tensor  # () the same for the inverse-depth channel
    n: torch.Tensor  # () valid pixel count
    sigma2_int: torch.Tensor  # () max(swi / max(n, 1), 1e-12)
    sigma2_xi: torch.Tensor  # () likewise, or the incoming scale when the channel is off


def _ic_pointwise(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr: Intrinsics):
    """Warp the template points, gather [I, xi, mask] from the current
    level: (r_i, r_x, valid)."""
    Px, Py, Pz = kf_points
    up, vp, rho, front = transform_project(Px, Py, Pz, T, intr)
    i_s, xi_s, mask_ok, inb = sample_tracker_planes(
        torch.stack([cur_int, cur_xi, cur_mask]), up, vp
    )
    valid = kf_mask * front * inb * mask_ok
    return (i_s - kf_int) * valid, (xi_s - rho) * valid, valid


def _student_w0(r, sigma2, nu: float):
    """Student-t weight without the 1/sigma^2 factor. It divides by the raw
    sigma^2, as the Pallas kernels do; ``student_t_sigma2`` clamps sigma^2
    at 1e-12 first, and the two agree for every sigma^2 >= 1e-12 (every
    scale the loop produces is clamped there)."""
    return (nu + 1.0) / (nu + r * r / sigma2)


def _sigma_step(pw, nu: float, sigma2_int, sigma2_xi, use_geometric: bool) -> SigmaStats:
    r_i, r_x, valid = pw
    swi = (valid * _student_w0(r_i, sigma2_int, nu) * r_i * r_i).sum()
    swx = (valid * _student_w0(r_x, sigma2_xi, nu) * r_x * r_x).sum()
    n = valid.sum()
    n1 = torch.clamp(n, min=1.0)
    s2i = torch.clamp(swi / n1, min=1e-12)
    s2x = torch.clamp(swx / n1, min=1e-12) if use_geometric else sigma2_xi
    return SigmaStats(swi, swx, n, s2i, s2x)


def _normal_eq(pw, jac12, nu: float, sigma2_int, sigma2_xi, use_geometric: bool,
               gate_sigmas: float, lagged: bool) -> IrlsResult:
    r_i, r_x, valid = pw
    w0i = _student_w0(r_i, sigma2_int, nu)
    w0x = _student_w0(r_x, sigma2_xi, nu)
    wi = (w0i * valid / sigma2_int).reshape(-1)
    ri = r_i.reshape(-1)
    Ji = jac12[:6].reshape(6, -1)
    H = (Ji * wi) @ Ji.T
    b = Ji @ (wi * ri)
    err = (wi * ri * ri).sum()
    if use_geometric:
        wx = (w0x * valid / sigma2_xi).reshape(-1)
        rx = r_x.reshape(-1)
        Jx = jac12[6:].reshape(6, -1)
        H = H + (Jx * wx) @ Jx.T
        b = b + Jx @ (wx * rx)
        err = err + (wx * rx * rx).sum()
    inl = (valid * (r_i * r_i < gate_sigmas**2 * sigma2_int)).sum()
    n_valid = valid.sum()
    inv_n = 1.0 / torch.clamp(n_valid, min=1.0)
    s2i, s2x = sigma2_int, sigma2_xi
    if lagged:
        s2i = torch.clamp((valid * w0i * r_i * r_i).sum() * inv_n, min=1e-12)
        if use_geometric:
            s2x = torch.clamp((valid * w0x * r_x * r_x).sum() * inv_n, min=1e-12)
    return IrlsResult(H * inv_n, b * inv_n, s2i, s2x, err * inv_n, n_valid, inl * inv_n)


def sigma_stats_plain(
    T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr: Intrinsics, nu: float,
    sigma2_int, sigma2_xi, use_geometric: bool = True,
) -> SigmaStats:
    """The sigma kernel's plain version: one fixed-point step of both
    Student-t scales from this pose's residuals (exact sigma mode)."""
    pw = _ic_pointwise(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr)
    return _sigma_step(pw, nu, sigma2_int, sigma2_xi, use_geometric)


def normal_eq_plain(
    T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr: Intrinsics,
    nu: float, sigma2_int, sigma2_xi, use_geometric: bool = True, gate_sigmas: float = 3.0,
    lagged: bool = True,
) -> IrlsResult:
    """The normal-equation kernel's plain version: Student-t weights from
    the given scales and the per-pixel-normalized (H, b) from the stored
    (12, H, W) field. ``lagged`` returns the updated scales for the next
    iteration; otherwise the scales used are returned."""
    pw = _ic_pointwise(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr)
    return _normal_eq(pw, jac12, nu, sigma2_int, sigma2_xi, use_geometric, gate_sigmas, lagged)


def residuals_and_normal_eq(
    T: torch.Tensor,
    kf_int: torch.Tensor,
    kf_points: tuple,
    kf_mask: torch.Tensor,
    jac12: torch.Tensor,
    cur_int: torch.Tensor,
    cur_xi: torch.Tensor,
    cur_mask: torch.Tensor,
    intr: Intrinsics,
    nu: float,
    sigma2_int,
    sigma2_xi,
    sigma_iters: int,
    use_geometric: bool = True,
    gate_sigmas: float = 3.0,
    sigma_mode: str = "exact",
) -> IrlsResult:
    """One IC IRLS evaluation (the contract of the JAX package's function
    and of its Pallas twin). ``sigma_mode="exact"`` first runs
    ``max(sigma_iters, 1)`` scale steps on this pose's residuals and weights
    with the result; any other mode weights with the incoming scales and
    returns the updated ones for the next iteration (lagged). A disabled
    geometric channel stays out of H, b and the error and keeps its
    incoming scale."""
    pw = _ic_pointwise(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr)
    exact = sigma_mode == "exact"
    if exact:
        for _ in range(max(sigma_iters, 1)):
            st = _sigma_step(pw, nu, sigma2_int, sigma2_xi, use_geometric)
            sigma2_int, sigma2_xi = st.sigma2_int, st.sigma2_xi
    return _normal_eq(pw, jac12, nu, sigma2_int, sigma2_xi, use_geometric, gate_sigmas,
                      lagged=not exact)


def step_norm(delta: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm of a (6,) step in the kernels' float order: the
    squares summed from the first, then the square root. The IRLS kernels'
    early exit (``TrackingConfig.early_exit_tol`` / ``conv_skip_tol``) tests
    ``not (step_norm(delta) > tol)`` with the float32 tolerance."""
    s = delta[0] * delta[0]
    for k in range(1, 6):
        s = s + delta[k] * delta[k]
    # Correctly rounded, as the card's sqrtf is: PyTorch's float32 sqrt on
    # the CPU may be an ulp off, while a float64 root rounded to float32 is
    # the correctly rounded float32 root.
    return torch.sqrt(s.double()).float()


def ic_update(T: torch.Tensor, H: torch.Tensor, b: torch.Tensor, damping: float, n_valid,
              min_valid: float = 100.0):
    """delta = solve(H + damping I, b); T <- T . exp(-delta).

    The update is a no-op when too few pixels were valid (n_valid <=
    ``min_valid``, 100 as in the JAX package's ``ic_update``) or the
    factorization or solve failed; ``min_valid=-inf`` leaves the decision to
    the last two, as the JAX package's ``SpmdTracker`` does.
    ``cholesky_ex`` reports failure in ``info`` instead of raising, so
    nothing here reads the device."""
    Hd = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = torch.cholesky_solve(b[:, None], L)[:, 0]
    ok = (n_valid > min_valid) & torch.isfinite(delta).all() & (info == 0)
    delta = torch.where(ok, delta, torch.zeros_like(delta))
    return se3.orthonormalize(T @ se3.exp(-delta)), delta
