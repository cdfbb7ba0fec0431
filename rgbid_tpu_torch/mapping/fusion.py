"""Inverse-depth fusion + uncertainty propagation (K8 + K9).

Counterpart of ``rgbid_tpu/mapping/fusion.py:55-237``. ``fuse_core`` is the
wrapper of the fusion kernel (``csrc/fusion.cu``, the counterpart of
``_fusion_kernel`` in ``rgbid_tpu/ops/pallas_kernels.py``): on a CPU tensor
it runs ``fuse_core_plain``, on a CUDA tensor it launches the kernel or
raises. ``fuse_core.launches`` counts launches.

The kernel folds in what the JAX package computed outside its Pallas
kernel: the hypothesis choice ``xi_eff = where(kf_mask, kf_xi, guess)``,
``warp_points`` and the corner gather of ``[cur_xi, cur_xi, cur_mask]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.camera import Intrinsics
from ..ops import _build
from ..ops.warp import sample_tracker_planes, warp_points

_THREADS = 256  # kThreads in csrc/fusion.cu


def hole_guess(levels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel depth hypothesis for invalid level-0 pixels, cascaded from
    the finest pyramid level whose renormalized-blur value exists there
    (nearest-neighbour upsample). Returns (guess, gmask) at level 0."""
    xi0 = levels[0].xi
    h, w = xi0.shape
    guess = torch.zeros_like(xi0)
    gmask = torch.zeros_like(xi0)
    for l in range(1, len(levels)):
        f = 2**l
        up = levels[l].xi.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)[:h, :w]
        hl, wl = up.shape
        if hl < h or wl < w:
            up = torch.nn.functional.pad(up, (0, w - wl, 0, h - hl))
        um = (up > 1e-6).to(torch.float32)
        take = (gmask < 0.5) & (um > 0.5)
        guess = torch.where(take, up, guess)
        gmask = torch.maximum(gmask, um)
    return guess, gmask


def _rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[:3, :3].T
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = Rt
    out[:3, 3] = -Rt @ T[:3, 3]
    return out


def fuse_core_plain(
    kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr: Intrinsics,
    cfg, guess: Optional[torch.Tensor] = None, gmask: Optional[torch.Tensor] = None,
):
    """Kalman refinement of valid keyframe pixels plus (when ``guess`` is
    given) gather-form claiming of invalid ones, in plain PyTorch.

    Returns (xi', var', fuse_mask, claim_mask, n_fused)."""
    grow = guess is not None
    if grow:
        xi_eff = torch.where(kf_mask > 0, kf_xi, guess)
        mask_eff = torch.maximum(kf_mask, gmask)
    else:
        xi_eff, mask_eff = kf_xi, kf_mask
    up, vp, _, _, front = warp_points(xi_eff, mask_eff, T_ck, intr)
    stack = torch.stack([cur_xi, cur_xi, cur_mask])
    xi_obs_cur, _, mask_ok, inb = sample_tracker_planes(stack, up, vp)
    valid = front * inb * mask_ok * (xi_obs_cur > 1e-6)

    zc = 1.0 / torch.clamp(xi_obs_cur, min=1e-6)
    dir_x = (up - intr.cx) * (1.0 / intr.fx)
    dir_y = (vp - intr.cy) * (1.0 / intr.fy)
    T_kc = _rigid_inverse(T_ck)
    R, t = T_kc[:3, :3], T_kc[:3, 3]
    Xk = (R[0, 0] * dir_x + R[0, 1] * dir_y + R[0, 2]) * zc + t[0]
    Yk = (R[1, 0] * dir_x + R[1, 1] * dir_y + R[1, 2]) * zc + t[1]
    Zk = (R[2, 0] * dir_x + R[2, 1] * dir_y + R[2, 2]) * zc + t[2]
    valid = valid * (Zk > 1e-6)
    zk = torch.clamp(Zk, min=1e-6)
    xi_obs_kf = torch.where(valid > 0, 1.0 / zk, torch.zeros_like(zk))

    # K9a: sensor noise through the frame change.
    r3dir = R[2, 0] * dir_x + R[2, 1] * dir_y + R[2, 2]
    xc = torch.clamp(xi_obs_cur, min=1e-6)
    dxi = r3dir / (zk * zk * (xc * xc))
    var_sensor = dxi * dxi * (cfg.sensor_sigma_xi**2)
    # K9b: pose covariance through J = -xi^2 [0, 0, 1, Yk, -Xk, 0].
    xi2 = xi_obs_kf * xi_obs_kf
    j2 = -xi2
    j3 = j2 * Yk
    j4 = xi2 * Xk
    C = pose_cov
    var_pose = (
        j2 * (C[2, 2] * j2 + C[2, 3] * j3 + C[2, 4] * j4)
        + j3 * (C[3, 2] * j2 + C[3, 3] * j3 + C[3, 4] * j4)
        + j4 * (C[4, 2] * j2 + C[4, 3] * j3 + C[4, 4] * j4)
    )
    var_obs = torch.clamp(var_sensor + var_pose, min=cfg.min_variance)

    # K8: occlusion gate + Kalman update.
    resid = xi_obs_kf - kf_xi
    gate = (resid * resid <= (kf_var + var_obs) * (cfg.gate_k**2)).to(torch.float32)
    fuse_mask = valid * kf_mask * gate
    k_gain = kf_var / torch.clamp(kf_var + var_obs, min=1e-12)
    xi_new = torch.where(fuse_mask > 0, kf_xi + k_gain * resid, kf_xi)
    var_new = torch.where(fuse_mask > 0, (1.0 - k_gain) * kf_var, kf_var)
    var_new = torch.clamp(var_new, cfg.min_variance, cfg.max_variance)

    claim_mask = torch.zeros_like(kf_mask)
    if grow:
        consistent = (torch.abs(xi_obs_kf - guess) <= cfg.claim_tol).to(torch.float32)
        claim_mask = (kf_mask < 0.5).to(torch.float32) * gmask * valid * consistent
        xi_new = torch.where(claim_mask > 0, xi_obs_kf, xi_new)
        var_new = torch.where(
            claim_mask > 0,
            torch.clamp(var_obs * cfg.claim_var_inflation, cfg.min_variance, cfg.max_variance),
            var_new,
        )
    return xi_new, var_new, fuse_mask, claim_mask, fuse_mask.sum()


def _fuse_cuda(
    kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr: Intrinsics,
    cfg, guess, gmask,
):
    dev = kf_xi.device
    h, w = kf_xi.shape
    grow = guess is not None
    planes = [("kf_xi", kf_xi), ("kf_var", kf_var), ("kf_mask", kf_mask),
              ("cur_xi", cur_xi), ("cur_mask", cur_mask)]
    if grow:
        planes += [("guess", guess), ("gmask", gmask)]
    for name, t in planes:
        _build.require(t, name, dev, (h, w))
    T_ck = T_ck.contiguous()
    T_kc = _rigid_inverse(T_ck)
    pose_cov = pose_cov.contiguous()
    _build.require(T_ck, "T_ck", dev, (4, 4))
    _build.require(pose_cov, "pose_cov", dev, (6, 6))

    lib = _build.library()
    n_blocks = (h * w + _THREADS - 1) // _THREADS
    xi_new = torch.empty_like(kf_xi)
    var_new = torch.empty_like(kf_xi)
    fuse_mask = torch.empty_like(kf_xi)
    claim_mask = torch.empty_like(kf_xi)
    partials = torch.empty((max(n_blocks, 1),), dtype=torch.float32, device=dev)
    n_fused = torch.empty((1,), dtype=torch.float32, device=dev)
    p = _build.FusionParams(
        h=h, w=w, grow=int(grow), fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        inv_fx=1.0 / intr.fx, inv_fy=1.0 / intr.fy, umax=w - 1.001, vmax=h - 1.001,
        sensor_var=cfg.sensor_sigma_xi**2, gate_k2=cfg.gate_k**2,
        min_var=cfg.min_variance, max_var=cfg.max_variance,
        claim_tol=cfg.claim_tol, claim_infl=cfg.claim_var_inflation,
    )
    status = lib.fusion_launch(
        p, T_ck.data_ptr(), T_kc.data_ptr(), pose_cov.data_ptr(), kf_xi.data_ptr(),
        kf_var.data_ptr(), kf_mask.data_ptr(), cur_xi.data_ptr(), cur_mask.data_ptr(),
        guess.data_ptr() if grow else None, gmask.data_ptr() if grow else None,
        xi_new.data_ptr(), var_new.data_ptr(), fuse_mask.data_ptr(),
        claim_mask.data_ptr(), partials.data_ptr(), n_fused.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "fusion_launch")
    fuse_core.launches += 1
    return xi_new, var_new, fuse_mask, claim_mask, n_fused[0]


def fuse_core(
    kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr: Intrinsics,
    cfg, guess=None, gmask=None,
):
    """Fusion of one frame into the keyframe's level-0 planes; the device
    of ``kf_xi`` decides between the plain version (CPU) and the kernel
    (CUDA). Returns (xi', var', fuse_mask, claim_mask, n_fused)."""
    if kf_xi.device.type == "cpu":
        return fuse_core_plain(
            kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr, cfg,
            guess, gmask,
        )
    if kf_xi.device.type != "cuda":
        raise ValueError(f"no fusion kernel for device {kf_xi.device}")
    return _fuse_cuda(
        kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr, cfg,
        guess, gmask,
    )


fuse_core.launches = 0


def fuse_and_grow(
    kf_xi, kf_var, kf_mask, kf_hits, cur_xi, cur_mask, T_ck, pose_cov,
    intr: Intrinsics, cfg, guess=None, gmask=None,
):
    """The full K8 step: Kalman refinement + hit counts + validity growth
    (when a guess is given and cfg.grow_validity is on). ``kf_mask`` is
    the full estimate mask. Returns (xi', var', mask', hits', n_fused)."""
    if not cfg.grow_validity:
        guess = gmask = None
    xi_new, var_new, fuse_mask, claim_mask, n = fuse_core(
        kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr, cfg,
        guess=guess, gmask=gmask,
    )
    hits_new = torch.where(claim_mask > 0, torch.ones_like(kf_hits), kf_hits + fuse_mask)
    mask_new = torch.maximum(kf_mask, claim_mask)
    return xi_new, var_new, mask_new, hits_new, n
