"""Inverse-depth fusion + uncertainty propagation (K8 + K9).

Counterpart of ``rgbid_tpu/mapping/fusion.py:55-237`` and of the fusion
step of ``rgbid_tpu/tracking/step.py`` (the pose-noise floor, the hole
guess, ``fuse_and_grow``). ``fuse_frame`` is the wrapper of the fusion
kernel (``csrc/fusion.cu``, the counterpart of ``_fusion_kernel`` in
``rgbid_tpu/ops/pallas_kernels.py``): on a CPU tensor it runs
``fuse_frame_plain``, on a CUDA tensor it launches the kernel or raises.
``fuse_frame.launches`` counts launches: one per tracked frame, since the
per-frame step enqueues the launch on every frame with a device word that
says whether the frame fuses (kept and on the cadence); on the other
frames the launch copies the planes through.

The kernel folds in what the JAX package computed outside its Pallas
kernel: the pose-noise floor added to the tracker's covariance,
``hole_guess``, the hypothesis choice ``xi_eff = where(kf_mask, kf_xi,
guess)``, ``warp_points``, the corner gather of ``[cur_xi, cur_mask]``,
``_rigid_inverse``, and the hit-count and mask update of
``fuse_and_grow``. ``hole_guess``, ``fuse_core_plain``, ``fuse_core`` and
``fuse_and_grow`` keep the JAX package's contracts as the plain building
blocks of ``fuse_frame_plain``; they have no kernel of their own.
``fuse_inverse_depth`` is the JAX package's Kalman-only step (no growth,
no pose-noise floor, the mask returned as given): ``fuse_core_plain`` on
the CPU, one launch of the same fusion kernel with growth and the floor
off on the card, counted in ``fuse_frame.launches`` too.

The numpy oracle of these functions is ``reference_cpu/fusion.py``, the
port's copy of the JAX package's: ``fuse`` for ``fuse_inverse_depth`` and
``fuse_core_plain`` without a guess, ``fuse_grow`` for ``fuse_and_grow``
and ``fuse_frame`` (given the pose-noise floor and ``hole_guess``'s
guess), held to within the JAX package's fusion tests' tolerances.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.camera import Intrinsics
from ..ops import _build
from ..ops.kernels import workspace
from ..ops.warp import sample_tracker_planes, warp_points


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
    """[R^T, -(R^T t)], the product summed in row order as the kernel
    does (elementwise, so every device rounds it alike)."""
    R, t = T[:3, :3], T[:3, 3]
    tk = -(R[0] * t[0] + R[1] * t[1] + R[2] * t[2])
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = R.T
    out[:3, 3] = tk
    return out


def pose_noise_floor(cfg, device) -> torch.Tensor:
    """The fixed pose-noise floor added to the tracker's covariance before
    fusion: diag(pose_trans_sigma^2 x 3, pose_rot_sigma^2 x 3)."""
    floor = torch.full((6,), cfg.pose_trans_sigma**2, dtype=torch.float32, device=device)
    floor[3:] = cfg.pose_rot_sigma**2
    return torch.diag(floor)


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


def fuse_core(
    kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr: Intrinsics,
    cfg, guess=None, gmask=None,
):
    """Fusion of one frame into the keyframe's level-0 planes, the JAX
    package's ``_fuse_core`` contract: returns (xi', var', fuse_mask,
    claim_mask, n_fused). Plain PyTorch on the CPU; on the card the fusion
    kernel writes no fuse or claim plane, so this raises there: call
    ``fuse_frame``."""
    _plain_only(kf_xi, "fuse_core")
    return fuse_core_plain(
        kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr, cfg, guess, gmask,
    )


def _plain_only(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(
            f"{name} runs on the CPU only; on {t.device} call fuse_frame, whose kernel does "
            "the whole fusion step in one launch"
        )


def _grow(kf_mask, kf_hits, fuse_mask, claim_mask):
    """Hit counts (+1 per fuse, 1 for a claim) and the grown estimate mask."""
    hits_new = torch.where(claim_mask > 0, torch.ones_like(kf_hits), kf_hits + fuse_mask)
    return torch.maximum(kf_mask, claim_mask), hits_new


def fuse_and_grow(
    kf_xi, kf_var, kf_mask, kf_hits, cur_xi, cur_mask, T_ck, pose_cov,
    intr: Intrinsics, cfg, guess=None, gmask=None,
):
    """The full K8 step: Kalman refinement + hit counts + validity growth
    (when a guess is given and cfg.grow_validity is on). ``kf_mask`` is
    the full estimate mask. Returns (xi', var', mask', hits', n_fused).
    CPU only, as ``fuse_core``."""
    if not cfg.grow_validity:
        guess = gmask = None
    xi_new, var_new, fuse_mask, claim_mask, n = fuse_core(
        kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr, cfg,
        guess=guess, gmask=gmask,
    )
    mask_new, hits_new = _grow(kf_mask, kf_hits, fuse_mask, claim_mask)
    return xi_new, var_new, mask_new, hits_new, n


def fuse_frame_plain(
    levels, kf_var, kf_mask, kf_hits, cur_xi, cur_mask, T_ck, track_cov,
    intr: Intrinsics, cfg,
):
    """``fuse_frame`` in plain PyTorch, on any device: the pose-noise floor,
    ``hole_guess`` (when cfg.grow_validity is on), ``fuse_core_plain``,
    and the hit and mask update."""
    pose_cov = track_cov + pose_noise_floor(cfg, track_cov.device)
    guess, gmask = hole_guess(levels) if cfg.grow_validity else (None, None)
    xi_new, var_new, fuse_mask, claim_mask, n = fuse_core_plain(
        levels[0].xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr, cfg, guess, gmask,
    )
    mask_new, hits_new = _grow(kf_mask, kf_hits, fuse_mask, claim_mask)
    return xi_new, var_new, mask_new, hits_new, n


def fusion_params(levels, track_cov, intr: Intrinsics, cfg, grow: Optional[bool] = None,
                  floor: bool = True) -> _build.FusionParams:
    """The fusion kernel's by-value parameters for ``levels`` (finest first;
    the coarse levels' planes are passed by address, so they must stay
    alive and contiguous until the launch is made) and the (6, 6)
    covariance ``track_cov`` (read through its strides). ``grow`` (default
    cfg.grow_validity) turns the hole guess and the claims on; ``floor``
    False adds no pose-noise floor to the covariance."""
    h, w = levels[0].xi.shape
    grow = bool(cfg.grow_validity if grow is None else grow)
    coarse = [l.xi for l in levels[1:]] if grow else []
    if len(coarse) > _build.MAX_COARSE:
        raise ValueError(f"fuse_frame reads at most {_build.MAX_COARSE} coarse levels, "
                         f"got {len(coarse)}")
    pad = (0,) * (_build.MAX_COARSE - len(coarse))
    return _build.FusionParams(
        h=h, w=w, grow=int(grow), n_coarse=len(coarse),
        cov_rs=track_cov.stride(0), cov_cs=track_cov.stride(1),
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        inv_fx=1.0 / intr.fx, inv_fy=1.0 / intr.fy, umax=w - 1.001, vmax=h - 1.001,
        sensor_var=cfg.sensor_sigma_xi**2, gate_k2=cfg.gate_k**2,
        min_var=cfg.min_variance, max_var=cfg.max_variance,
        claim_tol=cfg.claim_tol, claim_infl=cfg.claim_var_inflation,
        trans_var=cfg.pose_trans_sigma**2 if floor else 0.0,
        rot_var=cfg.pose_rot_sigma**2 if floor else 0.0,
        ch=(*(c.shape[0] for c in coarse), *pad), cw=(*(c.shape[1] for c in coarse), *pad),
        coarse=(*(c.data_ptr() for c in coarse), *pad),
    )


def _fuse_frame_cuda(
    levels, kf_var, kf_mask, kf_hits, cur_xi, cur_mask, T_ck, track_cov,
    intr: Intrinsics, cfg, grow: Optional[bool] = None, floor: bool = True, go=None,
):
    kf_xi = levels[0].xi
    dev = kf_xi.device
    h, w = kf_xi.shape
    for name, t in (("kf_xi", kf_xi), ("kf_var", kf_var), ("kf_mask", kf_mask),
                    ("kf_hits", kf_hits), ("cur_xi", cur_xi), ("cur_mask", cur_mask)):
        _build.require(t, name, dev, (h, w))
    _build.require(T_ck, "T_ck", dev, (4, 4))
    # The tracker's covariance comes out of cholesky_solve column-major; the
    # kernel reads its 3x3 block through the strides, with no copy.
    _build.require(track_cov, "track_cov", dev, (6, 6), contiguous=False)
    grow = bool(cfg.grow_validity if grow is None else grow)
    if grow:
        for l, lv in enumerate(levels[1:], 1):
            _build.require(lv.xi, f"levels[{l}].xi", dev)
            if lv.xi.dim() != 2:
                raise ValueError(f"levels[{l}].xi must be (H, W), got {tuple(lv.xi.shape)}")
    if go is not None:
        _build.require(go, "go", dev, (), dtypes=(torch.int32,))
    p = fusion_params(levels, track_cov, intr, cfg, grow, floor)
    ws = workspace(dev)
    xi_new, var_new = torch.empty_like(kf_xi), torch.empty_like(kf_xi)
    mask_new, hits_new = torch.empty_like(kf_xi), torch.empty_like(kf_xi)
    n_fused = torch.empty((), dtype=torch.float32, device=dev)
    status = _build.library().fusion_launch(
        p, ws.max_blocks, T_ck.data_ptr(), track_cov.data_ptr(), kf_xi.data_ptr(),
        kf_var.data_ptr(), kf_mask.data_ptr(), kf_hits.data_ptr(), cur_xi.data_ptr(),
        cur_mask.data_ptr(), xi_new.data_ptr(), var_new.data_ptr(), mask_new.data_ptr(),
        hits_new.data_ptr(), ws.partials.data_ptr(), ws.counter.data_ptr(), n_fused.data_ptr(),
        None if go is None else go.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "fusion_launch")
    fuse_frame.launches += 1
    return xi_new, var_new, mask_new, hits_new, n_fused


def fuse_frame(
    levels: Sequence, kf_var: torch.Tensor, kf_mask: torch.Tensor, kf_hits: torch.Tensor,
    cur_xi: torch.Tensor, cur_mask: torch.Tensor, T_ck: torch.Tensor, track_cov: torch.Tensor,
    intr: Intrinsics, cfg, go: Optional[torch.Tensor] = None,
):
    """Fuse one frame into the keyframe: the pose-noise floor added to the
    tracker's covariance ``track_cov``, the hole guess from the keyframe's
    coarse levels (when cfg.grow_validity is on), the Kalman update with
    validity growth, and the hit and mask update. ``levels`` are the
    keyframe's levels, finest first (only their ``xi`` is read);
    ``kf_mask`` is the full estimate mask; ``intr`` the level-0 camera.
    Returns (xi', var', mask', hits', n_fused). ``go``: an int32 device word;
    where it is 0 the frame is not fused: the planes come back as they went
    in and n_fused is 0 (the launch copies them through).

    The device of ``levels[0].xi`` decides: CPU runs ``fuse_frame_plain``
    (and selects under ``go``), CUDA one launch of the fusion kernel, which
    reads nothing back to the host. On CUDA the level-0 planes and the
    current frame's planes must be contiguous (H, W) float32 on the same
    card, the coarse levels contiguous float32, ``T_ck`` (4, 4) and
    ``track_cov`` (6, 6)."""
    args = (levels, kf_var, kf_mask, kf_hits, cur_xi, cur_mask, T_ck, track_cov, intr, cfg)
    kind = levels[0].xi.device.type
    if kind == "cpu":
        out = fuse_frame_plain(*args)
        if go is None:
            return out
        run = go != 0
        olds = (levels[0].xi, kf_var, kf_mask, kf_hits, torch.zeros_like(out[4]))
        return tuple(torch.where(run, a, b) for a, b in zip(out, olds))
    if kind != "cuda":
        raise ValueError(f"no fusion kernel for device {levels[0].xi.device}")
    return _fuse_frame_cuda(*args, go=go)


fuse_frame.launches = 0


class _Level0(NamedTuple):
    xi: torch.Tensor


def fuse_inverse_depth(
    kf_xi: torch.Tensor, kf_var: torch.Tensor, kf_mask: torch.Tensor, cur_xi: torch.Tensor,
    cur_mask: torch.Tensor, T_ck: torch.Tensor, pose_cov: torch.Tensor, intr: Intrinsics, cfg,
):
    """Kalman-only fusion step, the JAX package's ``fuse_inverse_depth``:
    ``pose_cov`` is used as given (no pose-noise floor), no hole is
    claimed, and the mask comes back as the input ``kf_mask`` itself.
    Returns (xi', var', kf_mask, n_fused). All planes (H, W) float32.

    On a CPU tensor it is ``fuse_core_plain`` with no guess; on a CUDA
    tensor one launch of the fusion kernel with growth off and a zero
    floor (its hit and mask planes are scratch), or it raises."""
    kind = kf_xi.device.type
    if kind == "cpu":
        xi_new, var_new, _, _, n = fuse_core_plain(
            kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov, intr, cfg)
        return xi_new, var_new, kf_mask, n
    if kind != "cuda":
        raise ValueError(f"no fusion kernel for device {kf_xi.device}")
    xi_new, var_new, _, _, n = _fuse_frame_cuda(
        (_Level0(kf_xi),), kf_var, kf_mask, torch.zeros_like(kf_xi), cur_xi, cur_mask, T_ck,
        pose_cov, intr, cfg, grow=False, floor=False,
    )
    return xi_new, var_new, kf_mask, n
