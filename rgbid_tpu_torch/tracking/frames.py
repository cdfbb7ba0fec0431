"""Frame and keyframe pyramids (NamedTuples of device tensors).

Counterpart of ``rgbid_tpu/tracking/frames.py:19-160``. The ESM gather
stack is stored in ``plane_dtype`` (float32, or bfloat16 under
``TrackingConfig.plane_dtype`` "bf16" / "bf16-stack"); every other plane is
float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.camera import Intrinsics, level_intrinsics
from ..ops import gauss_newton, image


class FrameLevel(NamedTuple):
    """One pyramid level of an incoming frame."""

    intensity: torch.Tensor  # (H, W) f32 [0, 1]
    xi: torch.Tensor  # (H, W) f32 inverse depth (0 where invalid)
    mask: torch.Tensor  # (H, W) f32 {0, 1}
    # ESM mode only, the sampling stack: (7, H, W) [I, xi, mask, gxI, gyI,
    # gxXi, gyXi] at levels >= esm_geo_min_level, (5, H, W) [I, xi, mask,
    # gxI, gyI] at esm_min_level <= level < esm_geo_min_level, (3, H, W)
    # [I, xi, mask] below esm_min_level; float32 or bfloat16 (the planes
    # rounded to nearest even). None in IC mode.
    stack7: Optional[torch.Tensor] = None


class KeyframeLevel(NamedTuple):
    """One pyramid level of the tracking template (active keyframe)."""

    intensity: torch.Tensor
    xi: torch.Tensor
    mask: torch.Tensor
    # ESM: (4, H, W) template gradients gxI, gyI, gxXi, gyXi.
    # IC: (12, H, W) Jacobian field, planes 0-5 photometric, 6-11 inverse depth.
    jac: torch.Tensor


def preprocess_frame(
    rgb_u8: torch.Tensor,
    depth_u16: torch.Tensor,
    levels: int,
    depth_scale: float = 5000.0,
    min_depth: float = 0.3,
    max_depth: float = 10.0,
    esm: bool = False,
    esm_min_level: int = 0,
    esm_geo_min_level: int = 0,
    plane_dtype: torch.dtype = torch.float32,
) -> Tuple[FrameLevel, ...]:
    """Raw sensor planes -> intensity/inverse-depth pyramids on the tensors'
    device: ``rgb_u8`` (H, W, 3) uint8, ``depth_u16`` (H, W) raw depth in any
    integer dtype. Pass the config's ``esm_min_level``/``esm_geo_min_level``
    for the production ESM layout; the defaults (0) give the 7-plane stack
    at every ESM level, as the JAX function's do. ``plane_dtype`` is the
    ESM stack's storage type."""
    intensity = image.intensity_from_rgb(rgb_u8)
    xi, mask = image.inverse_depth_from_u16(depth_u16, depth_scale, min_depth, max_depth)
    return preprocess_planes(intensity, xi, mask, levels, esm, esm_min_level, esm_geo_min_level,
                             plane_dtype)


def preprocess_planes(
    intensity: torch.Tensor,
    xi: torch.Tensor,
    mask: torch.Tensor,
    levels: int,
    esm: bool = False,
    esm_min_level: int = 0,
    esm_geo_min_level: int = 0,
    plane_dtype: torch.dtype = torch.float32,
) -> Tuple[FrameLevel, ...]:
    """Intensity/inverse-depth pyramids from the level-0 planes, plus the
    per-level ESM stacks when ``esm``, stored in ``plane_dtype`` (IC mode
    builds no gradient planes and no stack)."""
    ints = image.build_pyramid_unmasked(intensity, levels)
    xis, masks = image.build_pyramid(xi, mask, levels)
    out = []
    for l in range(levels):
        stack7 = None
        if esm:
            if l >= esm_min_level:
                gx_i, gy_i = image.gradients_unmasked(ints[l])
                if l >= esm_geo_min_level:
                    gx_x, gy_x = image.gradients(xis[l], masks[l])
                    planes = [ints[l], xis[l], masks[l], gx_i, gy_i, gx_x, gy_x]
                else:
                    planes = [ints[l], xis[l], masks[l], gx_i, gy_i]
            else:
                planes = [ints[l], xis[l], masks[l]]
            stack7 = torch.stack(planes).to(plane_dtype)
        out.append(FrameLevel(ints[l], xis[l], masks[l], stack7))
    return tuple(out)


def template_levels(
    int_pyr, xi_pyr, mask_pyr, intr: Intrinsics, jac_dtype: str = "f32", jacobian: str = "ic"
) -> Tuple[KeyframeLevel, ...]:
    """Template levels from intensity/inverse-depth/mask pyramids: the 4 ESM
    gradient planes, or the IC Jacobian field through each level's
    intrinsics; rounded to ``jac_dtype`` ("bf16" rounds, keeps float32)."""
    out = []
    for l in range(len(int_pyr)):
        gx_i, gy_i = image.gradients_unmasked(int_pyr[l])
        gx_x, gy_x = image.gradients(xi_pyr[l], mask_pyr[l])
        if jacobian == "esm":
            jac = gauss_newton.round_jac(torch.stack([gx_i, gy_i, gx_x, gy_x]), jac_dtype)
        else:
            jac = gauss_newton.template_jacobians(
                gx_i, gy_i, gx_x, gy_x, xi_pyr[l], mask_pyr[l], level_intrinsics(intr, l),
                jac_dtype,
            )
        out.append(KeyframeLevel(int_pyr[l], xi_pyr[l], mask_pyr[l], jac))
    return tuple(out)


def keyframe_pyramid(
    frame: Tuple[FrameLevel, ...],
    intr: Intrinsics,
    jacobian: str = "ic",
    jac_dtype: str = "f32",
) -> Tuple[KeyframeLevel, ...]:
    """Promote a frame pyramid to a tracking template. ``jacobian`` must
    match the tracker config: "ic" (the default, as in the JAX package)
    stores the (12, H, W) field, "esm" the 4 gradient planes."""
    return template_levels(
        [l.intensity for l in frame], [l.xi for l in frame], [l.mask for l in frame],
        intr, jac_dtype, jacobian,
    )
