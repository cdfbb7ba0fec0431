"""Numpy oracle for inverse-depth fusion + uncertainty propagation (K8+K9).

The port's copy of ``rgbid_tpu/reference_cpu/fusion.py`` (numpy only), on
the port's own ``Intrinsics``, ``FusionConfig`` and ``odometry``: the
oracle that ``mapping/fusion.py``'s ``fuse_inverse_depth`` (``fuse``) and
``fuse_frame`` / ``fuse_and_grow`` (``fuse_grow``) are held to.

Reference semantics (SURVEY.md §3.4, integrate.cu/covariance.cu): each
non-keyframe frame's inverse depth is fused into the active keyframe with
a per-pixel 1-D Kalman update, gated for occlusions/dynamics.

Formulation note: the reference scatters ("warp measurements into
keyframe"); we use the equivalent gather form via projective data
association — for every valid keyframe pixel, look up the corresponding
current-frame measurement through the current keyframe depth estimate,
re-express it as a keyframe-frame inverse depth, then update. This is
scatter-free (TPU-friendly) and uses identical update math.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import Intrinsics
from ..core.config import FusionConfig
from .odometry import bilinear_sample, warp_points


def _observe(xi, mask, cur_xi, cur_mask, T_ck, pose_cov, intr: Intrinsics,
             cfg: FusionConfig):
    """The measurement each keyframe pixel sees, warped through the inverse
    depth ``xi`` over ``mask``. Returns (valid, xi_obs_kf, var_obs): where
    the current frame gives a measurement in front of both cameras, that
    measurement as a keyframe-frame inverse depth (0 elsewhere), and its
    variance."""
    # 1. Correspondence: warp keyframe pixels into the current frame.
    up, vp, _, _, front = warp_points(xi, mask, T_ck, intr)
    xi_obs_cur, ok = bilinear_sample(cur_xi, cur_mask, up, vp)
    valid = front & ok & (xi_obs_cur > 1e-6)

    # 2. Re-express the measurement in the keyframe frame:
    #    current-frame point along the ray of pixel (up, vp) at depth 1/xi_obs.
    zc = 1.0 / np.maximum(xi_obs_cur, 1e-6)
    dir_x = (up - intr.cx) / intr.fx
    dir_y = (vp - intr.cy) / intr.fy
    T_kc = np.linalg.inv(T_ck)
    R, t = T_kc[:3, :3].astype(np.float64), T_kc[:3, 3].astype(np.float64)
    Xk = R[0, 0] * dir_x * zc + R[0, 1] * dir_y * zc + R[0, 2] * zc + t[0]
    Yk = R[1, 0] * dir_x * zc + R[1, 1] * dir_y * zc + R[1, 2] * zc + t[1]
    Zk = R[2, 0] * dir_x * zc + R[2, 1] * dir_y * zc + R[2, 2] * zc + t[2]
    valid &= Zk > 1e-6
    xi_obs_kf = np.where(valid, 1.0 / np.maximum(Zk, 1e-6), 0.0).astype(np.float32)

    # 3. Uncertainty propagation (K9).
    # (a) sensor noise through the frame change:
    #     Zk = (r3 . dir_c)/xi_c + t_z  =>  d xi_kf/d xi_c = (r3.dir)/ (Zk^2 xi_c^2) ... derive:
    #     d Zk/d xi_c = -(r3 . dir_c)/xi_c^2 ; d xi_kf/d Zk = -1/Zk^2
    #     => d xi_kf/d xi_c = (r3 . dir_c) / (Zk^2 xi_c^2)
    r3dir = R[2, 0] * dir_x + R[2, 1] * dir_y + R[2, 2]
    dxi = r3dir / (np.maximum(Zk, 1e-6) ** 2 * np.maximum(xi_obs_cur, 1e-6) ** 2)
    var_sensor = (dxi**2) * cfg.sensor_sigma_xi**2
    # (b) pose uncertainty: xi_kf = 1/e3.(T_kc P_c); left-perturbation twist
    #     J = -xi^2 * [0, 0, 1, Yk, -Xk, 0]
    xi2 = xi_obs_kf.astype(np.float64) ** 2
    J = np.stack(
        [
            np.zeros_like(Xk),
            np.zeros_like(Xk),
            -xi2,
            -xi2 * Yk,
            xi2 * Xk,
            np.zeros_like(Xk),
        ],
        axis=-1,
    )
    var_pose = np.einsum("hwi,ij,hwj->hw", J, pose_cov, J)
    var_obs = np.maximum(var_sensor + var_pose, cfg.min_variance)
    return valid, xi_obs_kf, var_obs


def fuse(
    kf_xi: np.ndarray,
    kf_var: np.ndarray,
    kf_mask: np.ndarray,
    cur_xi: np.ndarray,
    cur_mask: np.ndarray,
    T_ck: np.ndarray,
    pose_cov: np.ndarray,
    intr: Intrinsics,
    cfg: FusionConfig,
):
    """One fusion step. Returns (xi', var', mask', n_fused).

    T_ck: current <- keyframe. pose_cov: 6x6 covariance of T_ck (twist
    convention [v, w]); pass zeros to disable pose-uncertainty propagation.
    """
    valid, xi_obs_kf, var_obs = _observe(kf_xi, kf_mask, cur_xi, cur_mask, T_ck, pose_cov,
                                         intr, cfg)

    # 4. Occlusion / dynamics gate.
    resid = xi_obs_kf - kf_xi
    gate = resid**2 <= cfg.gate_k**2 * (kf_var + var_obs)
    fuse_mask = valid & kf_mask & gate

    # 5. Kalman update.
    k_gain = kf_var / np.maximum(kf_var + var_obs, 1e-12)
    xi_new = np.where(fuse_mask, kf_xi + k_gain * resid, kf_xi).astype(np.float32)
    var_new = np.where(fuse_mask, (1.0 - k_gain) * kf_var, kf_var)
    var_new = np.clip(var_new, cfg.min_variance, cfg.max_variance).astype(np.float32)
    return xi_new, var_new, kf_mask, int(fuse_mask.sum())


def fuse_grow(
    kf_xi: np.ndarray,
    kf_var: np.ndarray,
    kf_mask: np.ndarray,
    kf_hits: np.ndarray,
    cur_xi: np.ndarray,
    cur_mask: np.ndarray,
    T_ck: np.ndarray,
    pose_cov: np.ndarray,
    intr: Intrinsics,
    cfg: FusionConfig,
    guess: np.ndarray,
    gmask: np.ndarray,
):
    """Oracle for the FULL K8 step: Kalman refinement + hit counts +
    gather-form validity growth (mirrors mapping.fusion.fuse_and_grow):
    INVALID keyframe pixels are warped along the coarse-pyramid ``guess``
    and claim the observation when the measurement re-expressed in the
    keyframe closes the loop with the guess.

    Returns (xi', var', mask', hits', n_fused, n_claimed).
    """
    xi_eff = np.where(kf_mask.astype(bool), kf_xi, guess).astype(np.float32)
    mask_eff = kf_mask.astype(bool) | (gmask > 0.5)
    valid, xi_obs_kf, var_obs = _observe(xi_eff, mask_eff, cur_xi, cur_mask, T_ck, pose_cov,
                                         intr, cfg)

    resid = xi_obs_kf - kf_xi
    gate = resid**2 <= cfg.gate_k**2 * (kf_var + var_obs)
    fuse_mask = valid & kf_mask.astype(bool) & gate
    k_gain = kf_var / np.maximum(kf_var + var_obs, 1e-12)
    xi_new = np.where(fuse_mask, kf_xi + k_gain * resid, kf_xi).astype(np.float32)
    var_new = np.where(fuse_mask, (1.0 - k_gain) * kf_var, kf_var)

    consistent = np.abs(xi_obs_kf - guess) <= cfg.claim_tol
    claim_m = (
        (~kf_mask.astype(bool)) & (gmask > 0.5) & valid & consistent
    )
    xi_new = np.where(claim_m, xi_obs_kf, xi_new).astype(np.float32)
    var_new = np.where(claim_m, cfg.claim_var_inflation * var_obs, var_new)
    var_new = np.clip(var_new, cfg.min_variance, cfg.max_variance).astype(np.float32)
    mask_new = kf_mask.astype(bool) | claim_m
    hits_new = np.where(
        claim_m, 1.0, kf_hits + fuse_mask.astype(np.float32)
    ).astype(np.float32)
    return xi_new, var_new, mask_new, hits_new, int(fuse_mask.sum()), int(claim_m.sum())
