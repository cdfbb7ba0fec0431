"""Pinhole camera model with per-pyramid-level intrinsics.

Counterpart of ``rgbid_tpu/core/camera.py``: the intrinsics and their
per-level scaling in pure Python, the pixel grid and the pinhole
back-projection and projection on torch tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


# TUM RGB-D factory calibrations (freiburg1, 2 and 3 sequences).
TUM_FR1 = Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
TUM_FR2 = Intrinsics(fx=520.9, fy=521.0, cx=325.1, cy=249.7, width=640, height=480)
TUM_FR3 = Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480)
# The synthetic renderer's and the command line's default camera (VGA).
DEFAULT = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def level_shape(height: int, width: int, level: int) -> tuple[int, int]:
    """(H, W) of pyramid level ``level`` (level 0 = full resolution)."""
    h, w = height, width
    for _ in range(level):
        h = (h + 1) // 2
        w = (w + 1) // 2
    return h, w


def level_intrinsics(intr: Intrinsics, level: int) -> Intrinsics:
    """Intrinsics for a pyramid level (half-pixel-centre convention:
    f_l = f / 2^l and c_l = (c + 0.5) / 2^l - 0.5)."""
    s = float(2**level)
    h, w = level_shape(intr.height, intr.width, level)
    return Intrinsics(
        fx=intr.fx / s,
        fy=intr.fy / s,
        cx=(intr.cx + 0.5) / s - 0.5,
        cy=(intr.cy + 0.5) / s - 0.5,
        width=w,
        height=h,
    )


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None):
    """(u, v) coordinate planes of shape (h, w), broadcast views of two
    ``arange``s (no (h, w) plane is written)."""
    u = torch.arange(w, dtype=dtype, device=device).expand(h, w)
    v = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return u, v


def backproject(u, v, xi, intr: Intrinsics):
    """Pixel (u, v) with inverse depth xi -> camera-frame point (X, Y, Z),
    Z = 1/xi. xi is clamped to 1e-8 (NaN-free); the caller masks xi <= 0."""
    z = 1.0 / torch.clamp(xi, min=1e-8)
    x = (u - intr.cx) / intr.fx * z
    y = (v - intr.cy) / intr.fy * z
    return x, y, z


def project(x, y, z, intr: Intrinsics):
    """Camera-frame point -> (u, v, rho), rho = 1/Z the inverse depth."""
    rho = 1.0 / torch.clamp(z, min=1e-8)
    u = intr.fx * x * rho + intr.cx
    v = intr.fy * y * rho + intr.cy
    return u, v, rho
