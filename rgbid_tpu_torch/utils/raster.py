"""A small numpy rasteriser: the port's plots and the live viewer's map pane.

The JAX package draws its trajectory and map figures with matplotlib and
its labels with ``cv2.putText`` (``rgbid_tpu/utils/viz.py:50-96``,
``live_view.py:59-61, 188-234``). The port imports neither: this module
draws into (H, W, 3) uint8 BGR arrays with numpy alone.

- ``polyline``, ``fill_squares`` and ``scatter`` draw in pixel space
  (float coordinates, rounded to the nearest pixel; anything outside the
  image is clipped). A polyline is sampled at most half a pixel apart.
  ``scatter`` writes every point's own colour with one flat-index store.
- ``text`` draws a string from the glyph table that
  ``tools/recover_viz_tables.py`` recovered from ``cv2.putText``
  (FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1, LINE_AA): each glyph's
  coverage is blended over the image, glyph after glyph, as
  ``p + (c - p) * a / 255`` rounded to u8, and the pen advances by the
  glyph's advance. ``(x, y)`` is the pen's start on the baseline, as
  ``cv2.putText``'s ``org``.
- ``Axes`` maps data (x, z) in metres to pixels with one scale for both
  axes (equal aspect), the data window padded by 5 % and centred in the
  plot box; ``grid`` draws grid lines at round steps (1, 2, 2.5 or 5 times
  a power of ten, the largest giving at least four lines across the longer
  side) and ``frame`` the box, the tick labels and the axis names.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "data"

WHITE = (255, 255, 255)
BLACK = (0, 0, 0)
GRID = (235, 235, 235)
# matplotlib's tab10 colours, BGR.
TAB_BLUE = (180, 119, 31)
TAB_ORANGE = (14, 127, 255)
TAB_GREEN = (44, 160, 44)
TAB_RED = (40, 39, 214)
TAB_PURPLE = (189, 103, 148)
CYCLE = (TAB_BLUE, TAB_ORANGE, TAB_GREEN, TAB_PURPLE)


@lru_cache(maxsize=None)
def glyphs():
    """(alpha (95, h, w) uint8, advance (95,) int, (origin_y, origin_x)) of
    the printable ASCII characters 32-126."""
    with np.load(_DATA / "glyphs_simplex.npz") as z:
        return z["alpha"], z["advance"].astype(np.int64), tuple(int(v) for v in z["origin"])


def _glyph_index(ch: str) -> int:
    k = ord(ch) - 32
    return k if 0 <= k < 95 else ord("?") - 32


def text_width(s: str) -> int:
    _, adv, _ = glyphs()
    return int(sum(adv[_glyph_index(c)] for c in s))


def text_box(s: str, x: int, y: int) -> Tuple[int, int, int, int]:
    """(row0, row1, col0, col1): the pixels ``text(img, s, x, y)`` can touch."""
    alpha, _, (oy, ox) = glyphs()
    h, w = alpha.shape[1:]
    return y - oy, y - oy + h, x - ox, x - ox + text_width(s) + w


def text(img: np.ndarray, s: str, x: int, y: int, color=WHITE) -> int:
    """Draw ``s`` with its pen starting at (x, y) on the baseline; returns
    the pen's end column."""
    alpha, adv, (oy, ox) = glyphs()
    gh, gw = alpha.shape[1:]
    H, W = img.shape[:2]
    c = np.asarray(color, np.float64)
    for ch in s:
        k = _glyph_index(ch)
        r0, c0 = y - oy, x - ox
        rs, cs = max(r0, 0), max(c0, 0)
        re, ce = min(r0 + gh, H), min(c0 + gw, W)
        if rs < re and cs < ce and ch != " ":
            a = alpha[k, rs - r0:re - r0, cs - c0:ce - c0, None].astype(np.float64) / 255.0
            p = img[rs:re, cs:ce].astype(np.float64)
            img[rs:re, cs:ce] = np.round(p + (c - p) * a).astype(np.uint8)
        x += int(adv[k])
    return x


def _stamp(rows: np.ndarray, cols: np.ndarray, thickness: int):
    """Pixel centres widened to a ``thickness`` square."""
    if thickness <= 1:
        return rows, cols
    lo = -((thickness - 1) // 2)
    offs = np.arange(lo, lo + thickness)
    dr, dc = np.meshgrid(offs, offs, indexing="ij")
    return ((rows[:, None] + dr.reshape(1, -1)).reshape(-1),
            (cols[:, None] + dc.reshape(1, -1)).reshape(-1))


def _put(img: np.ndarray, rows: np.ndarray, cols: np.ndarray, color) -> None:
    H, W = img.shape[:2]
    keep = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    img.reshape(-1, 3)[rows[keep] * W + cols[keep]] = color


def polyline(img: np.ndarray, xs, ys, color, thickness: int = 1) -> None:
    """Connect the points (xs[i], ys[i]) in pixel space (column, row);
    points that are not finite break the line."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    if len(xs) == 1:
        xs, ys = np.repeat(xs, 2), np.repeat(ys, 2)
    x0, x1, y0, y1 = xs[:-1], xs[1:], ys[:-1], ys[1:]
    ok = np.isfinite(x0) & np.isfinite(x1) & np.isfinite(y0) & np.isfinite(y1)
    x0, x1, y0, y1 = x0[ok], x1[ok], y0[ok], y1[ok]
    if not len(x0):
        return
    n = np.ceil(2.0 * np.maximum(np.abs(x1 - x0), np.abs(y1 - y0))).astype(np.int64) + 1
    seg = np.repeat(np.arange(len(n)), n)
    start = np.cumsum(n) - n
    t = (np.arange(int(n.sum())) - start[seg]) / np.maximum(n[seg] - 1, 1)
    cols = np.rint(x0[seg] + (x1[seg] - x0[seg]) * t).astype(np.int64)
    rows = np.rint(y0[seg] + (y1[seg] - y0[seg]) * t).astype(np.int64)
    _put(img, *_stamp(rows, cols, thickness), color)


def fill_squares(img: np.ndarray, xs, ys, half: int, color) -> None:
    """Filled squares of side 2 half + 1 centred on the rounded points."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    ok = np.isfinite(xs) & np.isfinite(ys)
    rows = np.rint(ys[ok]).astype(np.int64)
    cols = np.rint(xs[ok]).astype(np.int64)
    _put(img, *_stamp(rows, cols, 2 * half + 1), color)


def scatter(img: np.ndarray, xs, ys, colors: np.ndarray) -> None:
    """One pixel per point, each in its own (N, 3) uint8 BGR colour."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    ok = np.isfinite(xs) & np.isfinite(ys)
    H, W = img.shape[:2]
    rows = np.rint(ys[ok]).astype(np.int64)
    cols = np.rint(xs[ok]).astype(np.int64)
    cols_ok = np.asarray(colors)[ok]
    keep = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    img.reshape(-1, 3)[rows[keep] * W + cols[keep]] = cols_ok[keep]


def nice_step(extent: float, min_lines: int = 4) -> float:
    """The largest of 1, 2, 2.5, 5 times a power of ten that puts at least
    ``min_lines`` steps into ``extent``."""
    extent = max(float(extent), 1e-9)
    raw = extent / min_lines
    p = 10.0 ** math.floor(math.log10(raw))
    for m in (5.0, 2.5, 2.0, 1.0):
        if m * p <= raw:
            return m * p
    return p


def _tick_label(v: float) -> str:
    s = f"{v:.3f}".rstrip("0").rstrip(".")
    return "0" if s in ("-0", "") else s


class Axes:
    """Equal-aspect data (x, z) -> pixel map of one plot box
    (left, top, right, bottom), fitted to the given points (a fallback
    window of +-1 m when there are none)."""

    def __init__(self, box: Tuple[int, int, int, int], xs: Sequence[np.ndarray],
                 zs: Sequence[np.ndarray]):
        self.box = box
        x = np.concatenate([np.asarray(a, np.float64).ravel() for a in xs] or [np.zeros(0)])
        z = np.concatenate([np.asarray(a, np.float64).ravel() for a in zs] or [np.zeros(0)])
        ok = np.isfinite(x) & np.isfinite(z)
        x, z = x[ok], z[ok]
        if len(x):
            x0, x1, z0, z1 = x.min(), x.max(), z.min(), z.max()
        else:
            x0, x1, z0, z1 = -1.0, 1.0, -1.0, 1.0
        span = max(x1 - x0, z1 - z0, 1e-3)
        pad = 0.05 * span
        x0, x1, z0, z1 = x0 - pad, x1 + pad, z0 - pad, z1 + pad
        left, top, right, bottom = box
        bw, bh = right - left, bottom - top
        self.scale = min(bw / max(x1 - x0, 1e-9), bh / max(z1 - z0, 1e-9))
        xc, zc = 0.5 * (x0 + x1), 0.5 * (z0 + z1)
        # The data window the box shows (larger than the data on one axis).
        self.xlim = (xc - 0.5 * bw / self.scale, xc + 0.5 * bw / self.scale)
        self.zlim = (zc - 0.5 * bh / self.scale, zc + 0.5 * bh / self.scale)
        self.step = nice_step(max(self.xlim[1] - self.xlim[0], self.zlim[1] - self.zlim[0]))

    def px(self, x, z):
        """(columns, rows) of data points; z grows upwards."""
        left, top, right, bottom = self.box
        x = np.asarray(x, np.float64)
        z = np.asarray(z, np.float64)
        return left + (x - self.xlim[0]) * self.scale, bottom - (z - self.zlim[0]) * self.scale

    def _ticks(self, lim):
        s = self.step
        return np.arange(math.ceil(lim[0] / s), math.floor(lim[1] / s) + 1) * s

    def grid(self, img: np.ndarray, color=GRID) -> None:
        left, top, right, bottom = self.box
        for v in self._ticks(self.xlim):
            c, _ = self.px(v, 0.0)
            polyline(img, [c, c], [top, bottom], color)
        for v in self._ticks(self.zlim):
            _, r = self.px(0.0, v)
            polyline(img, [left, right], [r, r], color)

    def frame(self, img: np.ndarray, xlabel: Optional[str] = None,
              zlabel: Optional[str] = None) -> None:
        """The box, tick marks and labels, and the axis names (x under the
        box, z above its left corner)."""
        left, top, right, bottom = self.box
        polyline(img, [left, right, right, left, left], [top, top, bottom, bottom, top], BLACK)
        for v in self._ticks(self.xlim):
            c, _ = self.px(v, 0.0)
            polyline(img, [c, c], [bottom, bottom + 3], BLACK)
            s = _tick_label(v)
            text(img, s, int(round(c)) - text_width(s) // 2, bottom + 17, BLACK)
        for v in self._ticks(self.zlim):
            _, r = self.px(0.0, v)
            polyline(img, [left - 3, left], [r, r], BLACK)
            s = _tick_label(v)
            text(img, s, left - 6 - text_width(s), int(round(r)) + 5, BLACK)
        if xlabel:
            text(img, xlabel, (left + right - text_width(xlabel)) // 2, bottom + 34, BLACK)
        if zlabel:
            text(img, zlabel, max(left - text_width(zlabel) // 2, 2), top - 6, BLACK)


def legend(img: np.ndarray, entries: Sequence[Tuple[str, tuple, str]],
           right: int, top: int) -> None:
    """A boxed legend with its top-right corner at (right, top); each entry
    is (label, colour, "line" or "square")."""
    if not entries:
        return
    w = max(text_width(s) for s, _, _ in entries) + 40
    h = 20 * len(entries) + 6
    left = right - w
    img[top:top + h, left:right] = WHITE
    polyline(img, [left, right, right, left, left], [top, top, top + h, top + h, top],
             (200, 200, 200))
    for i, (label, color, kind) in enumerate(entries):
        y = top + 16 + 20 * i
        if kind == "square":
            fill_squares(img, [left + 16], [y - 4], 3, color)
        else:
            polyline(img, [left + 6, left + 26], [y - 4, y - 4], color, thickness=2)
        text(img, label, left + 32, y, BLACK)


def canvas(h: int, w: int, color=WHITE) -> np.ndarray:
    img = np.empty((h, w, 3), np.uint8)
    img[:] = color
    return img
