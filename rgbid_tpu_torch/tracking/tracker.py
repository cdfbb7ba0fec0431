"""Coarse-to-fine IRLS tracker, ESM and IC, without the motion consensus.

Counterpart of ``rgbid_tpu/tracking/tracker.py:40-56, 59-131, 134-230,
319-514, 950-1027``: affine illumination (ESM), the template stride with
stride-scaled backprojection intrinsics, the level loop (the ESM kernel
with the occlusion-gate cap at the finest level, or the IC kernels in
either sigma mode), the overlap / kf_count tail, and the standalone
``Tracker``. The JAX package runs its consensus only in ESM mode, so IC
mode is complete here. The TPU-only tiling is not ported.

The IRLS loop is a Python loop over ``cfg.iters``. Each iteration is the
kernel launches of one evaluation and the 6x6 solve, all on the device:
nothing in the loop reads a device value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.camera import Intrinsics, level_intrinsics
from ..ops import gauss_newton
from ..ops.gauss_newton import round_jac
from ..ops.kernels import esm_residuals_and_normal_eq, residuals_and_normal_eq
from ..ops.warp import backproject_grid
from .frames import FrameLevel, KeyframeLevel


def check_tracking_supported(t) -> None:
    """Raise NotImplementedError for a TrackingConfig setting this port does
    not run yet, naming the ROADMAP item that brings it. The consensus
    flag counts only in ESM mode, where the JAX package runs it."""
    unsupported = [
        (t.consensus and t.jacobian == "esm", "tracking.consensus=True with jacobian='esm'",
         "ROADMAP Queue 1 #8"),
        (t.plane_dtype != "f32", f"tracking.plane_dtype={t.plane_dtype!r}", "ROADMAP Queue 1 #13"),
        (t.early_exit_tol > 0, "tracking.early_exit_tol > 0", "ROADMAP Queue 1 #13"),
        (t.conv_skip_tol > 0, "tracking.conv_skip_tol > 0", "ROADMAP Queue 1 #13"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(f"rgbid_tpu_torch does not run {what} yet ({item})")


def _apply_affine_illumination(
    kf: Tuple[KeyframeLevel, ...], cur: Tuple[FrameLevel, ...], jac_dtype: str
) -> Tuple[KeyframeLevel, ...]:
    """Estimate a global gain/bias (I_cur ~= a I_kf + b) by moment matching
    at level 0 and bake it into the template: intensity' = a I + b,
    intensity-gradient planes scaled by a. The stored keyframe is not
    changed."""
    kl, cl = kf[0], cur[0]
    n = float(kl.intensity.numel())
    mean_k = kl.intensity.sum() / n
    var_k = torch.clamp((kl.intensity * kl.intensity).sum() / n - mean_k * mean_k, min=1e-8)
    mean_c = cl.intensity.sum() / n
    var_c = torch.clamp((cl.intensity * cl.intensity).sum() / n - mean_c * mean_c, min=1e-8)
    # A near-textureless image carries no gain information: identity gain.
    textured = torch.minimum(var_k, var_c) > 4e-4
    one = torch.ones_like(mean_k)
    a = torch.where(textured, torch.clamp(torch.sqrt(var_c / var_k), 0.7, 1.5), one)
    b = torch.clamp(mean_c - a * mean_k, -0.3, 0.3)
    # Dead zone: below ~2% gain / 1% bias the correction costs more than
    # it fixes, so snap to identity.
    a = torch.where(torch.abs(a - 1.0) < 0.02, one, a)
    b = torch.where(torch.abs(b) < 0.01, torch.zeros_like(b), b)
    out = []
    for lvl in kf:
        gi = round_jac(lvl.jac[:2] * a, jac_dtype)
        out.append(
            KeyframeLevel(
                intensity=a * lvl.intensity + b,
                xi=lvl.xi,
                mask=lvl.mask,
                jac=torch.cat([gi, lvl.jac[2:]], dim=0),
            )
        )
    return tuple(out)


class TrackResult(NamedTuple):
    """Per-frame tracking output (small device tensors)."""

    T: torch.Tensor  # (4, 4) current <- keyframe
    H: torch.Tensor  # (6, 6) final-level normal matrix, per valid pixel
    errors: torch.Tensor  # (levels,) weighted MSE after each level
    inlier_frac: torch.Tensor  # (levels,)
    n_valid: torch.Tensor  # (levels,)
    overlap: torch.Tensor  # () dropout-normalized valid fraction (finest)
    sigma2_int: torch.Tensor
    sigma2_xi: torch.Tensor
    kf_count: torch.Tensor  # () valid pixels of the applied finest template mask


def template_level(kl: KeyframeLevel, intr_l: Intrinsics, s: int):
    """One level's template as the kernels read it: every s-th row and
    column of every plane, the ESM gradients or the IC field included
    (contiguous copies), and the backprojected points.

    Strided pixel (i, j) is pixel (s i, s j) of the level, so
    backprojection uses plain 1/s-scaled intrinsics while projection (in
    the kernel) keeps ``intr_l``. Returns (strided level, (X, Y, Z))."""
    intr_bp = intr_l
    if s > 1:
        kl = KeyframeLevel(
            intensity=kl.intensity[::s, ::s].contiguous(),
            xi=kl.xi[::s, ::s].contiguous(),
            mask=kl.mask[::s, ::s].contiguous(),
            jac=kl.jac[:, ::s, ::s].contiguous(),
        )
        intr_bp = Intrinsics(
            fx=intr_l.fx / s, fy=intr_l.fy / s, cx=intr_l.cx / s, cy=intr_l.cy / s,
            width=kl.xi.shape[1], height=kl.xi.shape[0],
        )
    return kl, backproject_grid(kl.xi, intr_bp)


def track(
    kf: Tuple[KeyframeLevel, ...],
    cur: Tuple[FrameLevel, ...],
    T_init: torch.Tensor,
    intrs: Tuple[Intrinsics, ...],
    cfg,
    jac_dtype: str = "f32",
) -> TrackResult:
    """The production coarse-to-fine tracker without the motion consensus
    (``cfg`` is a TrackingConfig; ``check_tracking_supported`` lists the
    settings that raise). ``jac_dtype`` is the template's storage precision,
    which the ESM affine illumination rounds its rescaled planes to."""
    levels = cfg.levels
    esm = cfg.jacobian == "esm"
    dev = T_init.device
    T = T_init
    s2i = torch.full((), cfg.init_sigma_int**2, dtype=torch.float32, device=dev)
    s2x = torch.full((), cfg.init_sigma_xi**2, dtype=torch.float32, device=dev)
    H = torch.eye(6, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    if cfg.affine_illumination and esm:
        kf = _apply_affine_illumination(kf, cur, jac_dtype)
    strides = tuple(cfg.template_stride or ())
    strides = strides + (1,) * max(0, levels - len(strides))

    errors, inliers, nvalids = [], [], []
    mask0 = None
    for level in range(levels - 1, -1, -1):
        cl, intr_l = cur[level], intrs[level]
        kl, points = template_level(kf[level], intr_l, strides[level])
        n_iters = cfg.iters[level] if level < len(cfg.iters) else cfg.iters[-1]
        gate_cap = cfg.occ_gate_cap if level <= cfg.occ_gate_cap_level else 0.0
        err = inl = nv = zero
        for _ in range(n_iters):
            if esm:
                res = esm_residuals_and_normal_eq(
                    T, kl.intensity, points, kl.mask, kl.jac, cl.stack7, intr_l,
                    cfg.student_t_nu, s2i, s2x, cfg.use_geometric, cfg.gate_sigmas,
                    cfg.occlusion_gate, gate_cap=gate_cap,
                )
            else:
                res = residuals_and_normal_eq(
                    T, kl.intensity, points, kl.mask, kl.jac, cl.intensity, cl.xi, cl.mask,
                    intr_l, cfg.student_t_nu, s2i, s2x, cfg.sigma_iters, cfg.use_geometric,
                    cfg.gate_sigmas, cfg.sigma_mode,
                )
            T, _ = gauss_newton.ic_update(T, res.H, res.b, cfg.damping, res.n_valid)
            s2i, s2x, H = res.sigma2_int, res.sigma2_xi, res.H
            err, inl, nv = res.error, res.inlier_frac, res.n_valid
        errors.append(err)
        inliers.append(inl)
        nvalids.append(nv)
        if level == 0:
            mask0 = kl.mask

    # Geometric overlap normalized for sensor dropout on both sides; the
    # template count and n_valid share the template stride.
    kf_count = torch.clamp(mask0.sum(), min=1.0)
    cur_mask = cur[0].mask
    cur_frac = torch.clamp(cur_mask.sum() / float(cur_mask.numel()), 0.05, 1.0)
    overlap = torch.clamp(nvalids[-1] / (kf_count * cur_frac), 0.0, 1.0)
    # Collected coarse -> fine; stored fine -> coarse (level order).
    return TrackResult(
        T=T,
        H=H,
        errors=torch.stack(errors[::-1]),
        inlier_frac=torch.stack(inliers[::-1]),
        n_valid=torch.stack(nvalids[::-1]),
        overlap=overlap,
        sigma2_int=s2i,
        sigma2_xi=s2x,
        kf_count=kf_count,
    )


class Tracker:
    """Frame-to-keyframe tracker bound to (intrinsics, config): the JAX
    package's standalone odometry API.

        tracker = Tracker(intr, TrackingConfig(levels=3, iters=(4, 8, 16), jacobian="ic"))
        kf = keyframe_pyramid(preprocess_frame(rgb0, depth0, 3), intr)
        res = tracker.track(kf, preprocess_frame(rgb1, depth1, 3), T_init)

    The tensors' device decides where it runs. ``jac_dtype`` is the
    template's storage precision (``keyframe_pyramid``'s), which ESM's
    affine illumination rounds to; the JAX package reads it from the array.
    ESM mode needs ``consensus=False`` until the motion consensus is ported
    (ROADMAP Queue 1 #8)."""

    def __init__(self, intr: Intrinsics, cfg, jac_dtype: str = "f32"):
        check_tracking_supported(cfg)
        self.intr = intr
        self.cfg = cfg
        self.jac_dtype = jac_dtype
        self.intrs = tuple(level_intrinsics(intr, l) for l in range(cfg.levels))

    def track(
        self, kf: Tuple[KeyframeLevel, ...], cur: Tuple[FrameLevel, ...], T_init: torch.Tensor
    ) -> TrackResult:
        return track(kf, cur, T_init, self.intrs, self.cfg, self.jac_dtype)
