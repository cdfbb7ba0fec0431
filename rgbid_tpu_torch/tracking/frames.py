"""Frame and keyframe pyramids (NamedTuples of device tensors).

Counterpart of ``rgbid_tpu/tracking/frames.py:19-130``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import image


class FrameLevel(NamedTuple):
    """One pyramid level of an incoming frame."""

    intensity: torch.Tensor  # (H, W) f32 [0, 1]
    xi: torch.Tensor  # (H, W) f32 inverse depth (0 where invalid)
    mask: torch.Tensor  # (H, W) f32 {0, 1}
    # The ESM sampling stack: (7, H, W) [I, xi, mask, gxI, gyI, gxXi, gyXi]
    # at levels >= esm_geo_min_level, (5, H, W) [I, xi, mask, gxI, gyI] at
    # esm_min_level <= level < esm_geo_min_level, (3, H, W) [I, xi, mask]
    # below esm_min_level.
    stack7: torch.Tensor


class KeyframeLevel(NamedTuple):
    """One pyramid level of the tracking template (active keyframe)."""

    intensity: torch.Tensor
    xi: torch.Tensor
    mask: torch.Tensor
    jac: torch.Tensor  # (4, H, W) ESM template gradients: gxI, gyI, gxXi, gyXi


def preprocess_planes(
    intensity: torch.Tensor,
    xi: torch.Tensor,
    mask: torch.Tensor,
    levels: int,
    esm_min_level: int = 0,
    esm_geo_min_level: int = 0,
) -> Tuple[FrameLevel, ...]:
    """Intensity/inverse-depth pyramids plus the per-level ESM stacks from
    the level-0 planes (the JAX function's ``esm=True``, f32 planes)."""
    ints = image.build_pyramid_unmasked(intensity, levels)
    xis, masks = image.build_pyramid(xi, mask, levels)
    out = []
    for l in range(levels):
        if l >= esm_min_level:
            gx_i, gy_i = image.gradients_unmasked(ints[l])
            if l >= esm_geo_min_level:
                gx_x, gy_x = image.gradients(xis[l], masks[l])
                planes = [ints[l], xis[l], masks[l], gx_i, gy_i, gx_x, gy_x]
            else:
                planes = [ints[l], xis[l], masks[l], gx_i, gy_i]
        else:
            planes = [ints[l], xis[l], masks[l]]
        out.append(FrameLevel(ints[l], xis[l], masks[l], torch.stack(planes)))
    return tuple(out)
