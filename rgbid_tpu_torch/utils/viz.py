"""Offline visualization: frame panels as PNGs, trajectory and map plots.

Counterpart of ``rgbid_tpu/utils/viz.py``, without OpenCV or matplotlib.

- ``colorize_inverse_depth``, ``residual_image`` and ``frame_panel`` equal
  the JAX package's functions bit for bit: ``cv2.applyColorMap`` is a
  lookup in the TURBO and JET tables recovered from it
  (``tools/recover_viz_tables.py``, ``data/colormap_*.npy``), and
  ``cvtColor(GRAY2BGR)`` repeats the u8 grey over the three channels.
  Images are BGR, as OpenCV's; ``frame_panel(path=...)`` writes a PNG
  through ``datasets/png.py`` (RGB on disk, as ``cv2.imwrite`` stores it).
- ``plot_trajectory`` and ``plot_map_topdown`` keep the JAX package's
  signatures and write a 660 x 660 PNG drawn by ``utils/raster.py``: a
  top-down (x-z) view with equal scale on both axes, grid lines at round
  metre steps, and a legend. The map scatter keeps at most ``max_points``
  points, chosen with ``np.random.default_rng(0)`` as the JAX package
  chooses them. ``trajectory_figure`` and ``map_figure`` return the image
  and its ``raster.Axes`` without writing.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..datasets import png
from . import raster

_DATA = Path(__file__).resolve().parent.parent / "data"
FIG_PX = 660  # matplotlib's figsize (6, 6) at dpi 110
_BOX = (70, 40, FIG_PX - 20, FIG_PX - 50)  # plot box: left, top, right, bottom


@lru_cache(maxsize=None)
def colormap(name: str) -> np.ndarray:
    """(256, 3) uint8 BGR: ``cv2.applyColorMap`` of every u8 value, for
    "turbo" or "jet"."""
    return np.load(_DATA / f"colormap_{name}.npy")


def colorize_inverse_depth(xi: np.ndarray, mask: Optional[np.ndarray] = None,
                           xi_max: float = 2.0) -> np.ndarray:
    """Inverse-depth plane -> BGR colormap image (invalid = black)."""
    norm = np.clip(xi / xi_max, 0.0, 1.0)
    img = colormap("turbo")[(norm * 255).astype(np.uint8)]
    if mask is not None:
        img[mask <= 0] = 0
    return img


def residual_image(i_sampled: np.ndarray, i_template: np.ndarray,
                   valid: Optional[np.ndarray] = None, scale: float = 4.0) -> np.ndarray:
    """Photometric residual plane -> diverging-colormap BGR image."""
    r = np.clip((i_sampled - i_template) * scale, -1.0, 1.0)
    img = colormap("jet")[((r * 0.5 + 0.5) * 255).astype(np.uint8)]
    if valid is not None:
        img[valid <= 0] = 0
    return img


def gray_bgr(gray_u8: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(gray, COLOR_GRAY2BGR)``: the u8 value in all three
    channels."""
    return np.repeat(np.asarray(gray_u8, np.uint8)[..., None], 3, axis=-1)


def write_bgr(path: str, img_bgr: np.ndarray) -> None:
    """Write a BGR image as an RGB PNG (what ``cv2.imwrite`` stores)."""
    png.write(path, np.ascontiguousarray(img_bgr[..., ::-1]))


def frame_panel(intensity: np.ndarray, xi: np.ndarray, mask: np.ndarray,
                path: Optional[str] = None) -> np.ndarray:
    """Side-by-side intensity + colorized inverse depth (the reference's
    current-frame pane)."""
    gray = gray_bgr((np.clip(intensity, 0, 1) * 255).astype(np.uint8))
    depth = colorize_inverse_depth(xi, mask)
    panel = np.concatenate([gray, depth], axis=1)
    if path:
        write_bgr(path, panel)
    return panel


def _xz(poses) -> Tuple[np.ndarray, np.ndarray]:
    xyz = np.array([np.asarray(T)[:3, 3] for T in poses], np.float64).reshape(-1, 3)
    return xyz[:, 0], xyz[:, 2]


def trajectory_figure(
    trajectories: Sequence[Tuple[str, List[np.ndarray]]],
    keyframe_poses: Optional[List[np.ndarray]] = None,
):
    """(BGR image, Axes) of ``plot_trajectory``'s figure."""
    paths = [_xz(poses) for _, poses in trajectories]
    kf = _xz(keyframe_poses) if keyframe_poses else None
    xs = [p[0] for p in paths] + ([kf[0]] if kf else [])
    zs = [p[1] for p in paths] + ([kf[1]] if kf else [])
    img = raster.canvas(FIG_PX, FIG_PX)
    ax = raster.Axes(_BOX, xs, zs)
    ax.grid(img)
    entries = []
    for i, ((label, _), (x, z)) in enumerate(zip(trajectories, paths)):
        color = raster.CYCLE[i % len(raster.CYCLE)]
        raster.polyline(img, *ax.px(x, z), color, thickness=2)
        entries.append((label, color, "line"))
    if kf:
        raster.fill_squares(img, *ax.px(*kf), 3, raster.TAB_RED)
        entries.append(("keyframes", raster.TAB_RED, "square"))
    ax.frame(img, "x [m]", "z [m]")
    raster.legend(img, entries, _BOX[2] - 6, _BOX[1] + 6)
    return img, ax


def plot_trajectory(
    trajectories: Sequence[Tuple[str, List[np.ndarray]]],
    path: str,
    keyframe_poses: Optional[List[np.ndarray]] = None,
) -> None:
    """Top-down (x-z) trajectory plot; accepts [(label, [T_wc...]), ...]."""
    write_bgr(path, trajectory_figure(trajectories, keyframe_poses)[0])


def subsample(pts: np.ndarray, max_points: int) -> np.ndarray:
    """At most ``max_points`` rows, chosen as the JAX package chooses them."""
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts = pts[idx]
    return pts


def cloud_bgr(pts: np.ndarray) -> np.ndarray:
    """(N, 3) uint8 BGR colours of an (N, 6) xyz + rgb cloud (rgb in [0, 1])."""
    return (np.clip(pts[:, 3:6], 0, 1) * 255.0 + 0.5).astype(np.uint8)[:, ::-1]


def map_figure(cloud_xyzrgb: np.ndarray, max_points: int = 200000):
    """(BGR image, Axes) of ``plot_map_topdown``'s figure."""
    pts = subsample(np.asarray(cloud_xyzrgb), max_points)
    img = raster.canvas(FIG_PX, FIG_PX)
    ax = raster.Axes(_BOX, [pts[:, 0]], [pts[:, 2]])
    ax.grid(img)
    raster.scatter(img, *ax.px(pts[:, 0], pts[:, 2]), cloud_bgr(pts))
    ax.frame(img, "x [m]", "z [m]")
    return img, ax


def plot_map_topdown(cloud_xyzrgb: np.ndarray, path: str, max_points: int = 200000) -> None:
    """Top-down scatter of the global map cloud."""
    write_bgr(path, map_figure(cloud_xyzrgb, max_points)[0])
