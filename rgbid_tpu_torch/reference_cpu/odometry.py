"""Numpy CPU reference: dense RGB-D inverse-depth odometry (K1–K7, K10).

The port's copy of ``rgbid_tpu/reference_cpu/odometry.py`` (numpy only):
``SlamSystem._try_relocalize`` preprocesses a lost frame with it, as the
JAX package does.

Forward-compositional iteratively-reweighted Gauss-Newton over a Gaussian
pyramid, minimizing the joint photometric + inverse-depth geometric error
with Student-t robust weights — the reference's front-end algorithm
(SURVEY.md §3.2; Gutiérrez-Gómez et al., "Dense RGB-D visual odometry using
inverse depth", RAS 2016). The device tracker (tracking/tracker.py) uses the
*inverse-compositional* formulation; both minimize the same objective and
are cross-validated on synthetic data.

Conventions (shared with the device path):
  * xi = 1/Z (inverse depth); invalid pixels have xi = 0 and mask = False.
  * T = T_ck maps reference(keyframe)-frame points into the current frame.
  * twist delta = [v, w], update T <- exp(delta) @ T (forward compositional,
    perturbation on the left / in the current frame).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.camera import Intrinsics, level_intrinsics
from ..core.config import TrackingConfig
from . import se3_np

# ---------------------------------------------------------------------------
# K1: preprocess


def intensity_from_rgb(rgb_u8: np.ndarray) -> np.ndarray:
    """Luma in [0, 1] from (H, W, 3) uint8 RGB (ITU-R BT.601 weights)."""
    rgb = rgb_u8.astype(np.float32) / 255.0
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def inverse_depth_from_u16(
    depth_u16: np.ndarray,
    depth_scale: float = 5000.0,
    min_depth: float = 0.3,
    max_depth: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(xi, mask): xi = 1/meters where valid, else 0."""
    d = depth_u16.astype(np.float32) / depth_scale
    mask = (d > min_depth) & (d < max_depth)
    xi = np.where(mask, 1.0 / np.maximum(d, 1e-6), 0.0).astype(np.float32)
    return xi, mask


# ---------------------------------------------------------------------------
# K3: masked Gaussian pyramid (binomial 1-4-6-4-1, stride-2 subsample)

_BINOMIAL = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _blur1d(img: np.ndarray, axis: int) -> np.ndarray:
    """Separable 5-tap binomial blur with zero padding (numerator only)."""
    out = np.zeros_like(img)
    for k, c in enumerate(_BINOMIAL):
        shift = k - 2
        src = np.roll(img, -shift, axis=axis)
        # zero out wrapped-around entries
        idx = [slice(None)] * img.ndim
        if shift > 0:
            idx[axis] = slice(img.shape[axis] - shift, None)
        elif shift < 0:
            idx[axis] = slice(0, -shift)
        if shift != 0:
            src[tuple(idx)] = 0.0
        out += c * src
    return out


def masked_blur(img: np.ndarray, mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Validity-renormalized Gaussian blur: blur(img*m)/blur(m).

    Returns (blurred, weight) where weight = blur(mask) in [0, 1]; a pixel of
    the blurred output is meaningful where weight is large enough.
    """
    m = mask.astype(np.float32)
    num = _blur1d(_blur1d(img * m, 0), 1)
    den = _blur1d(_blur1d(m, 0), 1)
    out = np.where(den > 1e-6, num / np.maximum(den, 1e-6), 0.0)
    return out.astype(np.float32), den


def downsample(img: np.ndarray, mask: np.ndarray, min_weight: float = 0.25):
    """One pyramid step: masked blur then 2x subsample at even indices."""
    blurred, wgt = masked_blur(img, mask)
    out = blurred[::2, ::2]
    out_mask = (wgt[::2, ::2] > min_weight) & mask[::2, ::2]
    return out.astype(np.float32), out_mask


def build_pyramid(img: np.ndarray, mask: np.ndarray, levels: int):
    """Returns lists [L0..L_{levels-1}] of (img, mask)."""
    imgs, masks = [img.astype(np.float32)], [mask.astype(bool)]
    for _ in range(levels - 1):
        i2, m2 = downsample(imgs[-1], masks[-1])
        imgs.append(i2)
        masks.append(m2)
    return imgs, masks


# ---------------------------------------------------------------------------
# K4: gradients (central differences, masked)


def gradients(img: np.ndarray, mask: np.ndarray):
    """(gx, gy) central differences; zero where any neighbor is invalid."""
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    ok_x = np.zeros_like(mask)
    ok_y = np.zeros_like(mask)
    ok_x[:, 1:-1] = mask[:, 2:] & mask[:, :-2]
    ok_y[1:-1, :] = mask[2:, :] & mask[:-2, :]
    return np.where(ok_x, gx, 0.0), np.where(ok_y, gy, 0.0)


# ---------------------------------------------------------------------------
# K5: warp + bilinear sampling


def bilinear_sample(img: np.ndarray, mask: np.ndarray, u: np.ndarray, v: np.ndarray):
    """Sample img at continuous (u, v). valid = in-bounds & 4 corners masked."""
    h, w = img.shape
    inb = (u >= 0) & (u <= w - 1.001) & (v >= 0) & (v <= h - 1.001)
    uc = np.clip(u, 0, w - 1.001)
    vc = np.clip(v, 0, h - 1.001)
    u0 = np.floor(uc).astype(np.int64)
    v0 = np.floor(vc).astype(np.int64)
    fu = (uc - u0).astype(np.float32)
    fv = (vc - v0).astype(np.float32)
    u1 = np.minimum(u0 + 1, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    val = (
        img[v0, u0] * (1 - fu) * (1 - fv)
        + img[v0, u1] * fu * (1 - fv)
        + img[v1, u0] * (1 - fu) * fv
        + img[v1, u1] * fu * fv
    )
    ok = inb & mask[v0, u0] & mask[v0, u1] & mask[v1, u0] & mask[v1, u1]
    return val.astype(np.float32), ok


def warp_points(
    xi_ref: np.ndarray, mask_ref: np.ndarray, T: np.ndarray, intr: Intrinsics
):
    """Backproject every reference pixel, transform by T, project.

    Returns (u', v', rho', P' (H,W,3), valid) where rho' = 1/Z' is the
    predicted inverse depth in the current frame.
    """
    h, w = xi_ref.shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z = 1.0 / np.maximum(xi_ref, 1e-8)
    x = (u - intr.cx) / intr.fx * z
    y = (v - intr.cy) / intr.fy * z
    P = np.stack([x, y, z], axis=-1)
    Pp = P @ T[:3, :3].T.astype(np.float32) + T[:3, 3].astype(np.float32)
    zp = Pp[..., 2]
    front = zp > 1e-6
    rho = 1.0 / np.maximum(zp, 1e-6)
    up = intr.fx * Pp[..., 0] * rho + intr.cx
    vp = intr.fy * Pp[..., 1] * rho + intr.cy
    return up, vp, rho.astype(np.float32), Pp, mask_ref & front


# ---------------------------------------------------------------------------
# K6: Student-t scale estimation


def student_t_sigma(r: np.ndarray, valid: np.ndarray, nu: float, sigma0: float, iters: int = 3):
    """Fixed-point update of the Student-t scale sigma."""
    sigma2 = sigma0 * sigma0
    rv = r[valid]
    if rv.size == 0:
        return sigma0
    r2 = rv.astype(np.float64) ** 2
    for _ in range(iters):
        w = (nu + 1.0) / (nu + r2 / sigma2)
        sigma2 = float((w * r2).mean())
        sigma2 = max(sigma2, 1e-12)
    return float(np.sqrt(sigma2))


def student_t_weights(r: np.ndarray, sigma: float, nu: float):
    return ((nu + 1.0) / (nu + (r / sigma) ** 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# K7: Gauss-Newton normal equations (forward compositional)


def _projection_jacobian(Pp: np.ndarray, intr: Intrinsics):
    """J_pi: d(u,v)/dP' for P' = (X, Y, Z), shape (H, W, 2, 3)."""
    X, Y, Z = Pp[..., 0], Pp[..., 1], Pp[..., 2]
    iz = 1.0 / np.maximum(Z, 1e-6)
    iz2 = iz * iz
    zeros = np.zeros_like(X)
    Ju = np.stack([intr.fx * iz, zeros, -intr.fx * X * iz2], axis=-1)
    Jv = np.stack([zeros, intr.fy * iz, -intr.fy * Y * iz2], axis=-1)
    return np.stack([Ju, Jv], axis=-2)


def _se3_point_jacobian(Pp: np.ndarray):
    """d(exp(delta) P')/d delta at delta=0: [I | -hat(P')], (H, W, 3, 6)."""
    X, Y, Z = Pp[..., 0], Pp[..., 1], Pp[..., 2]
    zeros = np.zeros_like(X)
    ones = np.ones_like(X)
    row0 = np.stack([ones, zeros, zeros, zeros, Z, -Y], axis=-1)
    row1 = np.stack([zeros, ones, zeros, -Z, zeros, X], axis=-1)
    row2 = np.stack([zeros, zeros, ones, Y, -X, zeros], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def _rho_jacobian(Pp: np.ndarray):
    """d(1/Z')/d delta at delta=0 for P' perturbed on the left, (H, W, 6)."""
    X, Y, Z = Pp[..., 0], Pp[..., 1], Pp[..., 2]
    iz2 = 1.0 / np.maximum(Z, 1e-6) ** 2
    zeros = np.zeros_like(X)
    # d rho/dP' = [0, 0, -1/Z^2]; times [I | -hat(P')]
    return np.stack([zeros, zeros, -iz2, -Y * iz2, X * iz2, zeros], axis=-1)


@dataclass
class GNStats:
    error: float
    sigma_int: float
    sigma_xi: float
    valid_fraction: float
    inlier_fraction: float
    n_valid: int


def gauss_newton_step(
    T: np.ndarray,
    ref_int: np.ndarray,
    ref_xi: np.ndarray,
    ref_mask: np.ndarray,
    cur_int: np.ndarray,
    cur_xi: np.ndarray,
    cur_mask: np.ndarray,
    cur_gx_int: np.ndarray,
    cur_gy_int: np.ndarray,
    cur_gx_xi: np.ndarray,
    cur_gy_xi: np.ndarray,
    intr: Intrinsics,
    cfg: TrackingConfig,
    sigma_int: float,
    sigma_xi: float,
):
    """One forward-compositional IRLS Gauss-Newton step.

    Returns (T_new, GNStats, H) — H is the 6x6 normal matrix (for the pose
    covariance at the finest level).
    """
    up, vp, rho, Pp, front = warp_points(ref_xi, ref_mask, T, intr)
    i_s, ok_i = bilinear_sample(cur_int, np.ones_like(cur_mask, bool), up, vp)
    xi_s, ok_x = bilinear_sample(cur_xi, cur_mask, up, vp)
    valid = front & ok_i & ok_x
    r_i = np.where(valid, i_s - ref_int, 0.0)
    r_x = np.where(valid, xi_s - rho, 0.0)

    sigma_int = student_t_sigma(r_i, valid, cfg.student_t_nu, sigma_int, cfg.sigma_iters)
    sigma_xi = student_t_sigma(r_x, valid, cfg.student_t_nu, sigma_xi, cfg.sigma_iters)
    w_i = student_t_weights(r_i, sigma_int, cfg.student_t_nu) * valid
    w_x = student_t_weights(r_x, sigma_xi, cfg.student_t_nu) * valid

    # Image gradients sampled at the warped locations (FC formulation).
    gxi_s, _ = bilinear_sample(cur_gx_int, np.ones_like(cur_mask, bool), up, vp)
    gyi_s, _ = bilinear_sample(cur_gy_int, np.ones_like(cur_mask, bool), up, vp)
    gxx_s, _ = bilinear_sample(cur_gx_xi, cur_mask, up, vp)
    gyx_s, _ = bilinear_sample(cur_gy_xi, cur_mask, up, vp)

    Jpi = _projection_jacobian(Pp, intr)  # (H, W, 2, 3)
    Jp = _se3_point_jacobian(Pp)  # (H, W, 3, 6)
    Jw = np.einsum("hwij,hwjk->hwik", Jpi, Jp)  # (H, W, 2, 6)
    J_i = gxi_s[..., None] * Jw[..., 0, :] + gyi_s[..., None] * Jw[..., 1, :]
    J_x = (
        gxx_s[..., None] * Jw[..., 0, :]
        + gyx_s[..., None] * Jw[..., 1, :]
        - _rho_jacobian(Pp)
    )

    wi = (w_i / max(sigma_int**2, 1e-12))[..., None]
    wx = (w_x / max(sigma_xi**2, 1e-12))[..., None]
    H = np.einsum("hwi,hwj->ij", wi * J_i, J_i).astype(np.float64)
    b = np.einsum("hwi,hw->i", wi * J_i, r_i).astype(np.float64)
    if cfg.use_geometric:
        H += np.einsum("hwi,hwj->ij", wx * J_x, J_x)
        b += np.einsum("hwi,hw->i", wx * J_x, r_x)

    n_valid = int(valid.sum())
    n_ref = max(int(ref_mask.sum()), 1)
    if n_valid < 20:
        stats = GNStats(np.inf, sigma_int, sigma_xi, n_valid / n_ref, 0.0, n_valid)
        return T, stats, H, sigma_int, sigma_xi

    H_damped = H + cfg.damping * np.eye(6)
    delta = -np.linalg.solve(H_damped, b)
    T_new = se3_np.exp(delta) @ T

    err = float(
        (
            (w_i * r_i**2).sum() / max(sigma_int**2, 1e-12)
            + (w_x * r_x**2).sum() / max(sigma_xi**2, 1e-12)
        )
        / n_valid
    )
    inl = float(
        ((np.abs(r_i) < cfg.gate_sigmas * sigma_int) & valid).sum() / n_valid
    )
    stats = GNStats(err, sigma_int, sigma_xi, n_valid / n_ref, inl, n_valid)
    return T_new, stats, H, sigma_int, sigma_xi


# ---------------------------------------------------------------------------
# Full coarse-to-fine tracker


@dataclass
class CpuFramePyramid:
    intensity: List[np.ndarray]
    xi: List[np.ndarray]
    mask: List[np.ndarray]
    gx_int: List[np.ndarray]
    gy_int: List[np.ndarray]
    gx_xi: List[np.ndarray]
    gy_xi: List[np.ndarray]


def preprocess_frame(
    rgb_u8: np.ndarray,
    depth_u16: np.ndarray,
    levels: int,
    depth_scale: float = 5000.0,
    min_depth: float = 0.3,
    max_depth: float = 10.0,
) -> CpuFramePyramid:
    intensity = intensity_from_rgb(rgb_u8)
    xi, mask = inverse_depth_from_u16(depth_u16, depth_scale, min_depth, max_depth)
    ints, _ = build_pyramid(intensity, np.ones_like(mask), levels)
    xis, masks = build_pyramid(xi, mask, levels)
    gx_i, gy_i, gx_x, gy_x = [], [], [], []
    for l in range(levels):
        full = np.ones_like(masks[l])
        a, b = gradients(ints[l], full)
        c, d = gradients(xis[l], masks[l])
        gx_i.append(a)
        gy_i.append(b)
        gx_x.append(c)
        gy_x.append(d)
    return CpuFramePyramid(ints, xis, masks, gx_i, gy_i, gx_x, gy_x)


def track(
    ref: CpuFramePyramid,
    cur: CpuFramePyramid,
    intr: Intrinsics,
    cfg: TrackingConfig,
    T_init: Optional[np.ndarray] = None,
):
    """Coarse-to-fine IRLS Gauss-Newton tracking.

    Returns (T_ck, stats_per_level, H_finest).
    """
    T = np.eye(4) if T_init is None else T_init.copy()
    sigma_int, sigma_xi = cfg.init_sigma_int, cfg.init_sigma_xi
    all_stats = []
    H = np.eye(6)
    for level in range(cfg.levels - 1, -1, -1):
        intr_l = level_intrinsics(intr, level)
        n_iters = cfg.iters[level] if level < len(cfg.iters) else cfg.iters[-1]
        for _ in range(n_iters):
            T, stats, H, sigma_int, sigma_xi = gauss_newton_step(
                T,
                ref.intensity[level],
                ref.xi[level],
                ref.mask[level],
                cur.intensity[level],
                cur.xi[level],
                cur.mask[level],
                cur.gx_int[level],
                cur.gy_int[level],
                cur.gx_xi[level],
                cur.gy_xi[level],
                intr_l,
                cfg,
                sigma_int,
                sigma_xi,
            )
        all_stats.append(stats)
    return T, all_stats, H
