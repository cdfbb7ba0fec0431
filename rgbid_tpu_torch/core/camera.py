"""Pinhole camera model with per-pyramid-level intrinsics.

Pure-Python copy of ``rgbid_tpu/core/camera.py:19-63`` (that module
imports jax.numpy, so it cannot be loaded by path).
"""

from __future__ import annotations

from typing import NamedTuple


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
