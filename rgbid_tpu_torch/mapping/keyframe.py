"""Keyframe state: device tensors + host metadata (Keyframe struct, K10).

Counterpart of ``rgbid_tpu/mapping/keyframe.py:25-276``, for both template
layouts: ESM (4 gradient planes per level) and IC (the (12, H, W)
Jacobian field).

``jac_dtype="bf16"`` (the config default) keeps the JAX package's numbers:
the template planes are rounded to bfloat16 precision where the reference
stores them as bfloat16, but they are held (and read by the kernels) as
float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.camera import Intrinsics
from ..ops import gauss_newton, image
from ..ops.gauss_newton import round_jac
from ..tracking.frames import FrameLevel, KeyframeLevel, template_levels


class DeviceKeyframe(NamedTuple):
    """Device-resident keyframe state.

    The template levels carry the CONFIRMED mask (hits >= confirm_hits);
    ``mask_full`` is every pixel with a depth estimate, including
    provisional claims, and is what fusion refines. ``fused_count`` is a
    device int32 scalar: the fusion cadence and the rebuild schedule are
    device predicates on it, as in the JAX package."""

    levels: Tuple[KeyframeLevel, ...]
    var: torch.Tensor  # (H, W) level-0 inverse-depth variance
    fused_count: torch.Tensor  # () int32 kept frames since the keyframe was founded
    hits: torch.Tensor  # (H, W) observation-support counts
    mask_full: torch.Tensor  # (H, W) full estimate mask

    def tensors(self) -> list:
        """Every tensor of the state, in a fixed order."""
        out = [t for lvl in self.levels for t in lvl]
        return out + [self.var, self.fused_count, self.hits, self.mask_full]

    @classmethod
    def from_tensors(cls, ts, n_levels: int) -> "DeviceKeyframe":
        levels = tuple(KeyframeLevel(*ts[4 * l:4 * l + 4]) for l in range(n_levels))
        return cls(levels, *ts[4 * n_levels:])


def select_keyframe(cond: torch.Tensor, a: DeviceKeyframe, b: DeviceKeyframe) -> DeviceKeyframe:
    """``a`` where the device bool ``cond`` holds, else ``b``, tensor by
    tensor: the predicated choice of the next keyframe state."""
    out = [torch.where(cond, x, y) for x, y in zip(a.tensors(), b.tensors())]
    return DeviceKeyframe.from_tensors(out, len(a.levels))


def _select_level(cond, a: KeyframeLevel, b: KeyframeLevel) -> KeyframeLevel:
    return KeyframeLevel(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def create_device_keyframe(
    frame: Tuple[FrameLevel, ...], intr: Intrinsics, cfg, jac_dtype: str = "f32",
    jacobian: str = "ic",
) -> DeviceKeyframe:
    """Promote a preprocessed frame to a fresh keyframe (variance = sensor)."""
    levels = template_levels(
        [l.intensity for l in frame], [l.xi for l in frame], [l.mask for l in frame],
        intr, jac_dtype, jacobian,
    )
    mask0 = frame[0].mask
    var0 = torch.where(
        mask0 > 0,
        torch.full_like(mask0, cfg.sensor_sigma_xi**2),
        torch.full_like(mask0, cfg.max_variance),
    )
    return DeviceKeyframe(
        levels=levels,
        var=var0,
        fused_count=torch.zeros((), dtype=torch.int32, device=mask0.device),
        hits=float(cfg.confirm_hits) * mask0,
        mask_full=mask0,
    )


def _rebuild_level0(old: KeyframeLevel, xi0, mask0, intr: Intrinsics, jac_dtype: str,
                    jacobian: str) -> KeyframeLevel:
    """Finest-level template refresh. Intensity never changes under fusion,
    so ESM recomputes only the two xi-gradient planes; IC recomputes its
    whole field (it mixes intensity gradients with the xi-dependent warp
    Jacobian)."""
    gx_x, gy_x = image.gradients(xi0, mask0)
    if jacobian == "esm":
        jac = torch.cat([old.jac[:2], round_jac(torch.stack([gx_x, gy_x]), jac_dtype)], dim=0)
    else:
        gx_i, gy_i = image.gradients_unmasked(old.intensity)
        jac = gauss_newton.template_jacobians(gx_i, gy_i, gx_x, gy_x, xi0, mask0, intr, jac_dtype)
    return KeyframeLevel(old.intensity, xi0, mask0, jac)


def rebuild_after_fusion(
    kf: DeviceKeyframe,
    xi0: torch.Tensor,
    var0: torch.Tensor,
    mask0: torch.Tensor,
    hits: torch.Tensor,
    intr: Intrinsics,
    jac_dtype: str = "f32",
    jacobian: str = "ic",
    coarse_every: int = 1,
    confirm_hits: float = 2.0,
    fine_every: int = 1,
) -> DeviceKeyframe:
    """Rebuild the tracking template from the fused level-0 inverse depth
    (``intr`` is the level-0 camera).

    The template is gated to confirmed pixels (hits >= confirm_hits).
    Level 0 is refreshed every ``fine_every`` fused
    frames (its xi/mask always); the coarse xi pyramid and templates every
    ``coarse_every`` fused frames. The schedule is a device predicate on
    ``fused_count``: both the rebuilt and the kept levels are made, and
    selected."""
    count = kf.fused_count + 1
    tmask = mask0 * (hits >= confirm_hits).to(torch.float32)
    old0 = kf.levels[0]
    new0 = _rebuild_level0(old0, xi0, tmask, intr, jac_dtype, jacobian)
    if fine_every > 1:
        new0 = _select_level(count % fine_every == 0, new0,
                             KeyframeLevel(old0.intensity, xi0, tmask, old0.jac))
    n_levels = len(kf.levels)
    coarse: Tuple[KeyframeLevel, ...] = ()
    if n_levels > 1:
        xi_pyr, mask_pyr = image.build_pyramid(xi0, tmask, n_levels)
        int_pyr = [l.intensity for l in kf.levels]
        coarse = template_levels(int_pyr, xi_pyr, mask_pyr, intr, jac_dtype, jacobian)[1:]
        if coarse_every > 1:
            now = count % coarse_every == 0
            coarse = tuple(_select_level(now, a, b) for a, b in zip(coarse, kf.levels[1:]))
    return DeviceKeyframe(
        levels=(new0,) + coarse, var=var0, fused_count=count, hits=hits, mask_full=mask0
    )


def retire_planes(state: DeviceKeyframe, reloc_level: int, cloud_stride: int):
    """What a finalize reads of a keyframe state, packed on the device (no
    read): xi, mask and variance of level 0, strided by ``cloud_stride``,
    then intensity, xi and mask at the reloc level. Returns (the flat
    float32 tensor, the six planes' shapes)."""
    lvl0 = state.levels[0]
    li = state.levels[min(reloc_level, len(state.levels) - 1)]
    s = max(cloud_stride, 1)
    planes = [p[::s, ::s] for p in (lvl0.xi, lvl0.mask, state.var)]
    planes += [li.intensity, li.xi, li.mask]
    flat = torch.cat([p.reshape(-1) for p in planes])
    return flat, tuple(tuple(p.shape) for p in planes)


def retire_shapes(state: DeviceKeyframe, reloc_level: int, cloud_stride: int) -> tuple:
    """The six planes' shapes in ``retire_planes``'s packing."""
    h, w = state.levels[0].xi.shape
    s = max(cloud_stride, 1)
    li = tuple(state.levels[min(reloc_level, len(state.levels) - 1)].xi.shape)
    return (((h + s - 1) // s, (w + s - 1) // s),) * 3 + (li,) * 3


@dataclass
class Keyframe:
    """Host-side keyframe record (metadata + finalized artifacts)."""

    kf_id: int
    timestamp: float
    T_wk: np.ndarray  # camera-to-world pose (updated by the pose graph)
    rgb: np.ndarray  # founding frame's image, (H, W, 3) or gray (H, W) u8
    # Founding frame's raw depth (H, W) u16; filled when the live viewer is
    # on (its keyframe pane).
    depth: Optional[np.ndarray] = None
    cloud: Optional[np.ndarray] = None  # (N, 6) xyz+rgb in keyframe coordinates
    # Place-recognition payload (filled by the back end).
    descriptors: Optional[np.ndarray] = None
    keypoints: Optional[np.ndarray] = None
    bow: Optional[dict] = None
    # Host copies of the coarse planes (intensity, xi, mask at the reloc
    # level) and the u8 gray image, filled by finalize.
    reloc_planes: Optional[dict] = None


def extract_cloud(
    intensity0: Optional[np.ndarray],
    xi0: np.ndarray,
    mask0: np.ndarray,
    var0: np.ndarray,
    intr,
    max_sigma: float = 0.05,
    stride: int = 1,
    rgb: Optional[np.ndarray] = None,
    grid_step: int = 1,
) -> np.ndarray:
    """K10: backproject the fused keyframe map -> (N, 6) xyz+rgb float32
    (host numpy, as the JAX package's function).

    The colours come from the (H, W, 3) u8 image ``rgb`` when it is given,
    else from the gray ``intensity0`` in [0, 1], replicated. ``stride``
    keeps one pixel in ``stride`` of full planes; ``grid_step`` says the
    planes are already strided by that factor (pixel (i, j) of the planes
    is pixel (i * grid_step, j * grid_step) of the image)."""
    h, w = xi0.shape
    u, v = np.meshgrid(
        np.arange(w, dtype=np.float32) * grid_step,
        np.arange(h, dtype=np.float32) * grid_step,
    )
    keep = (mask0 > 0) & (np.sqrt(np.maximum(var0, 0.0)) < max_sigma) & (xi0 > 1e-6)
    if stride > 1:
        sel = np.zeros_like(keep)
        sel[::stride, ::stride] = True
        keep &= sel
    z = 1.0 / np.maximum(xi0, 1e-6)
    x = (u - intr.cx) / intr.fx * z
    y = (v - intr.cy) / intr.fy * z
    if rgb is not None:
        c = rgb.astype(np.float32) * (1.0 / 255.0)
        cols = [c[..., 0][keep], c[..., 1][keep], c[..., 2][keep]]
    else:
        g = np.clip(intensity0, 0.0, 1.0)
        cols = [g[keep], g[keep], g[keep]]
    pts = np.stack([x[keep], y[keep], z[keep]] + cols, axis=1)
    return pts.astype(np.float32)
