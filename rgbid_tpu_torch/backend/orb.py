"""ORB (oriented FAST + rotated BRIEF) in numpy, stage by stage.

A host implementation of OpenCV's ``ORB_create(nfeatures)`` with its default
settings (8 levels, scale factor 1.2, edge threshold 31, patch size 31,
WTA_K 2, Harris score, FAST threshold 20), written from the published
algorithm and held to OpenCV 5.0.0 stage by stage in
``tests/test_torch_orb.py``. Nothing here imports OpenCV. Every stage is
vectorised over pixels or keypoints.

Stages, in the order ``detect_and_compute`` runs them:

1. ``build_pyramid``: level sizes ``round_half_even(size / 1.2^l)``, each
   level resized from the one before with the bit-exact linear rule
   (``resize_linear_exact``: 8-bit fixed-point weights, one rounding).
2. ``fast_corners``: FAST-9/16 with 3x3 non-maximum suppression on the
   corner score (the largest threshold at which the pixel is still a
   corner), strict comparisons.
3. Per level: drop points within 31 pixels of the border, keep the best
   ``2 n_l`` by FAST score (``retain_best`` keeps ties at the cut).
4. ``harris_responses`` on the 7x7 block; keep the best ``n_l`` (ties kept,
   so a level may return more than ``n_l``).
5. ``ic_angles``: intensity centroid over the radius-15 disc of the
   unblurred level, angle by ``fast_atan2`` (a float32 polynomial).
6. ``gaussian_blur7``: 7x7, sigma 2, float32 taps, rounded half to even.
7. ``brief_descriptors``: 256 pairs (``data/orb_pattern.npy``) rotated by
   the angle, ``bit = I(p0) < I(p1)``, packed LSB first.

OpenCV lays the levels in one buffer with a 32-pixel reflect-101 border.
No result depends on that border: a keypoint keeps at least 31 pixels from
every edge of its level, the angle's disc reaches 15, the rotated pattern
at most 19 (|(13, 13)| = 18.4) and the blur 3 more, so every pixel read
lies at least 9 inside the level. ``gaussian_blur7`` still reflects at the
edge, so that the whole plane equals OpenCV's.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import List, Tuple

import numpy as np

N_LEVELS = 8
SCALE_FACTOR = np.float32(1.2)
EDGE_THRESHOLD = 31
PATCH_SIZE = 31
HALF_PATCH = PATCH_SIZE // 2
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = np.float32(0.04)

# The 16-pixel Bresenham circle of radius 3, (dx, dy), in ring order.
_RING = np.array(
    [(0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
     (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3)], np.intp)
_NEIGHBOURS = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dx, dy) != (0, 0)]

# 7 taps of exp(-x^2 / (2 sigma^2)), sigma 2, normalised in double.
_BLUR_TAPS = np.exp(-np.arange(-3.0, 4.0) ** 2 / 8.0)
_BLUR_TAPS = (_BLUR_TAPS / _BLUR_TAPS.sum()).astype(np.float32)


@lru_cache(maxsize=None)
def pattern() -> np.ndarray:
    """The rBRIEF test pairs, (256, 4) float32: x0, y0, x1, y1."""
    path = Path(__file__).resolve().parent.parent / "data" / "orb_pattern.npy"
    p = np.load(path)
    if p.shape != (256, 4) or p.dtype != np.int8:
        raise ValueError(f"{path}: expected a (256, 4) int8 array, got {p.dtype} {p.shape}")
    p = p.astype(np.float32)
    p.flags.writeable = False  # one array for every caller
    return p


# ---------------------------------------------------------------------------
# 1. Pyramid


def level_scales() -> np.ndarray:
    """float32 scale of each level: 1.2f widened to double, raised to the
    level, rounded to float32."""
    return np.array([np.float64(SCALE_FACTOR) ** l for l in range(N_LEVELS)]).astype(np.float32)


def level_sizes(width: int, height: int) -> List[Tuple[int, int]]:
    """(width, height) of each level: the float32 quotient rounded half to
    even."""
    s = level_scales()
    w = np.rint(np.float32(width) / s).astype(int)
    h = np.rint(np.float32(height) / s).astype(int)
    return list(zip(w.tolist(), h.tolist()))


def _linear_coeffs(src: int, dst: int):
    """Left tap index and the two 8-bit weights of each output position."""
    scale = 1.0 / (np.float64(dst) / np.float64(src))
    f = scale * (np.arange(dst, dtype=np.float64) + 0.5) - 0.5
    i = np.floor(f).astype(np.int64)
    w1 = np.rint((f - i) * 256.0).astype(np.uint32)
    low, high = i < 0, i >= src - 1
    w1[low | high] = 0
    i[low] = 0
    i[high] = src - 1
    return i, np.uint32(256) - w1, w1, np.minimum(i + 1, src - 1)


def resize_linear_exact(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bit-exact bilinear resize of a uint8 plane to ``size`` = (width,
    height): pixel centres aligned, weights rounded to 1/256, the two passes
    kept in integers and the result rounded once, half up."""
    h, w = img.shape
    dw, dh = size
    ix, ax, bx, ix1 = _linear_coeffs(w, dw)
    iy, ay, by, iy1 = _linear_coeffs(h, dh)
    src = img.astype(np.uint32)
    rows = src[:, ix] * ax + src[:, ix1] * bx  # (h, dw), 8 fractional bits
    out = rows[iy] * ay[:, None] + rows[iy1] * by[:, None]
    return ((out + 32768) >> 16).astype(np.uint8)


def build_pyramid(img: np.ndarray) -> List[np.ndarray]:
    levels = [np.ascontiguousarray(img)]
    for size in level_sizes(img.shape[1], img.shape[0])[1:]:
        levels.append(resize_linear_exact(levels[-1], size))
    return levels


# ---------------------------------------------------------------------------
# 2. FAST


def _arc_max_min(d: np.ndarray) -> np.ndarray:
    """max over the 16 arcs of 9 contiguous ring pixels of the arc's minimum;
    ``d`` is (16, n)."""
    ext = np.concatenate([d, d[:8]])
    m2 = np.minimum(ext[:-1], ext[1:])
    m4 = np.minimum(m2[:-2], m2[2:])
    m8 = np.minimum(m4[:-4], m4[4:])
    return np.minimum(m8[:16], ext[8:]).max(axis=0)


def fast_corners(img: np.ndarray):
    """FAST-9/16 corners of a uint8 plane: (xs, ys, scores), row-major.

    A pixel is a corner if 9 contiguous pixels of the 16-pixel ring are all
    brighter than it by more than ``FAST_THRESHOLD``, or all darker. Its
    score is the largest threshold at which it still is one. A corner stays
    only if its score is strictly greater than the scores of its 8
    neighbours (0 where they are no corners)."""
    threshold = FAST_THRESHOLD
    h, w = img.shape
    empty = (np.zeros(0, np.intp), np.zeros(0, np.intp), np.zeros(0, np.int16))
    if h < 7 or w < 7:
        return empty

    def shifted(k):
        dx, dy = _RING[k]
        return img[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx]

    # Any arc of 9 holds one pixel of every opposite pair: a cheap test on
    # four pairs, in uint8 with the limits saturated (a saturated limit
    # cannot be passed, as the true one cannot), leaves the few candidates
    # that get the full ring.
    centre = img[3:h - 3, 3:w - 3]
    hi = centre + np.minimum(np.uint8(255) - centre, np.uint8(threshold))
    lo = centre - np.minimum(centre, np.uint8(threshold))
    bright = dark = None
    for k in (0, 4, 2, 6):
        a, b = shifted(k), shifted(k + 8)
        bk, dk = np.maximum(a, b) > hi, np.minimum(a, b) < lo
        bright = bk if bright is None else bright & bk
        dark = dk if dark is None else dark & dk
    ys, xs = np.nonzero(bright | dark)
    if len(ys) == 0:
        return empty
    ys += 3
    xs += 3
    ring = img[ys[None, :] + _RING[:, 1:2], xs[None, :] + _RING[:, 0:1]]
    d = img[ys, xs].astype(np.int16)[None, :] - ring
    score = np.maximum(_arc_max_min(d), _arc_max_min(-d))
    keep = score > threshold
    xs, ys, score = xs[keep], ys[keep], (score[keep] - 1).astype(np.int16)
    plane = np.zeros((h, w), np.int16)
    plane[ys, xs] = score
    keep = np.ones(len(xs), bool)
    for dx, dy in _NEIGHBOURS:
        keep &= score > plane[ys + dy, xs + dx]
    return xs[keep], ys[keep], score[keep]


# ---------------------------------------------------------------------------
# 3. Quotas


def features_per_level(n_features: int) -> List[int]:
    """Geometric split of ``n_features`` over the levels (ratio 1/1.2, float32
    arithmetic, each level rounded half to even, the last takes the rest)."""
    factor = np.float32(1.0 / np.float64(SCALE_FACTOR))
    desired = np.float32(
        n_features * (1.0 - np.float64(factor))
        / (1.0 - np.float64(factor) ** N_LEVELS))
    out = []
    for _ in range(N_LEVELS - 1):
        out.append(int(np.rint(desired)))
        desired = np.float32(desired * factor)
    out.append(max(n_features - sum(out), 0))
    return out


def retain_best(response: np.ndarray, n: int) -> np.ndarray:
    """Indices of the ``n`` largest responses, and of every response equal to
    the ``n``-th (ties at the cut are kept)."""
    if n <= 0:
        return np.zeros(0, np.intp)
    if len(response) <= n:
        return np.arange(len(response))
    cut = np.partition(response, len(response) - n)[len(response) - n]
    return np.nonzero(response >= cut)[0]


# ---------------------------------------------------------------------------
# 4. Harris


def harris_responses(img: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Harris response (float32) of the 7x7 block around each point: 3x3
    Sobel-like integer differences, integer sums, then
    ``(a b - c^2 - 0.04 (a + b)^2) scale^4`` in float32, in that order."""
    r = HARRIS_BLOCK // 2
    o = np.arange(-r - 1, r + 2)
    patch = img[ys[:, None, None] + o[None, :, None],
                xs[:, None, None] + o[None, None, :]].astype(np.int32)  # (n, 9, 9)
    ix = ((patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 2
          + (patch[:, :-2, 2:] - patch[:, :-2, :-2])
          + (patch[:, 2:, 2:] - patch[:, 2:, :-2]))
    iy = ((patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 2
          + (patch[:, 2:, :-2] - patch[:, :-2, :-2])
          + (patch[:, 2:, 2:] - patch[:, :-2, 2:]))
    a = (ix * ix).sum(axis=(1, 2)).astype(np.float32)
    b = (iy * iy).sum(axis=(1, 2)).astype(np.float32)
    c = (ix * iy).sum(axis=(1, 2)).astype(np.float32)
    scale = np.float32(1.0) / (np.float32(4 * HARRIS_BLOCK) * np.float32(255.0))
    scale4 = scale * scale * scale * scale
    return (a * b - c * c - HARRIS_K * (a + b) * (a + b)) * scale4


# ---------------------------------------------------------------------------
# 5. Angle


@lru_cache(maxsize=None)
def _disc_offsets():
    """(dx, dy) of the pixels of the radius-15 disc: row v spans
    [-umax[v], umax[v]], with the table made symmetric about the diagonal."""
    hp = HALF_PATCH
    umax = np.zeros(hp + 2, int)
    vmax = int(np.floor(hp * np.sqrt(np.float32(2.0)) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(np.float32(2.0)) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(float(hp * hp - v * v))))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    pts = [(u, v) for v in range(-hp, hp + 1) for u in range(-umax[abs(v)], umax[abs(v)] + 1)]
    off = np.array(pts, np.intp)
    off.flags.writeable = False  # one array for every caller
    return off


_ATAN_P1 = np.float32(0.9997878412794807 * np.float64(np.float32(180 / np.pi)))
_ATAN_P3 = np.float32(-0.3258083974640975 * np.float64(np.float32(180 / np.pi)))
_ATAN_P5 = np.float32(0.1555786518463281 * np.float64(np.float32(180 / np.pi)))
_ATAN_P7 = np.float32(-0.04432655554792128 * np.float64(np.float32(180 / np.pi)))
_ATAN_EPS = np.float32(np.finfo(np.float64).eps)


def fast_atan2(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """atan2 in degrees in [0, 360), as a float32 odd polynomial of degree 7
    in min(|x|, |y|) / max(|x|, |y|) (accurate to about 0.3 degrees)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    ax, ay = np.abs(x), np.abs(y)
    big, small = np.maximum(ax, ay), np.minimum(ax, ay)
    c = small / (big + _ATAN_EPS)
    c2 = c * c
    a = (((_ATAN_P7 * c2 + _ATAN_P5) * c2 + _ATAN_P3) * c2 + _ATAN_P1) * c
    a = np.where(ax >= ay, a, np.float32(90.0) - a)
    a = np.where(x < 0, np.float32(180.0) - a, a)
    a = np.where(y < 0, np.float32(360.0) - a, a)
    return a.astype(np.float32)


def ic_angles(img: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Orientation of each point in degrees: the direction of the intensity
    centroid of the radius-15 disc (integer moments)."""
    off = _disc_offsets()
    vals = img[ys[:, None] + off[None, :, 1], xs[:, None] + off[None, :, 0]].astype(np.int64)
    m10 = vals @ off[:, 0]
    m01 = vals @ off[:, 1]
    return fast_atan2(m01.astype(np.float32), m10.astype(np.float32))


# ---------------------------------------------------------------------------
# 6. Blur


def _fma(a: np.ndarray, k: np.float32, acc: np.ndarray) -> np.ndarray:
    """float32 fused multiply-add ``a * k + acc``: the float32 product is
    exact in float64, so one rounding of the float64 sum stands for the
    fused operation's."""
    return (a.astype(np.float64) * np.float64(k) + acc).astype(np.float32)


def _blur_plain(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """The blur's float32 sums over the padded plane ``p``, unfused: rows
    summed left to right, columns from the centre tap outward over each
    symmetric pair."""
    rows = _BLUR_TAPS[0] * p[:, :w]
    tmp = np.empty_like(rows)
    for i in range(1, 7):
        np.multiply(p[:, i:i + w], _BLUR_TAPS[i], out=tmp)
        rows += tmp
    out = _BLUR_TAPS[3] * rows[3:3 + h]
    tmp = tmp[:h]
    for i in (1, 2, 3):
        np.add(rows[3 - i:3 - i + h], rows[3 + i:3 + i + h], out=tmp)
        tmp *= _BLUR_TAPS[3 + i]
        out += tmp
    return out


def _blur_fused_at(p: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """The same sums in the same order with fused multiply-adds, at the
    pixels (ys, xs) only."""
    o = np.arange(7)
    patch = p[ys[:, None, None] + o[None, :, None], xs[:, None, None] + o[None, None, :]]
    rows = _BLUR_TAPS[0] * patch[:, :, 0]
    for i in range(1, 7):
        rows = _fma(patch[:, :, i], _BLUR_TAPS[i], rows)
    out = _BLUR_TAPS[3] * rows[:, 3]
    for i in (1, 2, 3):
        out = _fma(rows[:, 3 - i] + rows[:, 3 + i], _BLUR_TAPS[3 + i], out)
    return out


def gaussian_blur7(img: np.ndarray) -> np.ndarray:
    """7x7 Gaussian blur, sigma 2, of a uint8 plane, as OpenCV's ORB applies
    it to a level: float32 taps and fused multiply-adds, rows summed left to
    right, columns from the centre tap outward over each symmetric pair,
    reflect-101 at the edges, rounded half to even at the end.

    ORB blurs a region of its pyramid buffer in place, and for a region of
    a larger plane OpenCV's ``GaussianBlur`` takes its float filter, not the
    8-bit fixed-point one it uses on a whole plane; the two differ by one
    grey level on a few percent of the pixels, which is enough to flip a
    descriptor bit in a thousand.

    numpy has no fused multiply-add, and emulating one in float64 costs four
    times the plain float32 sum. The two sums differ by less than 1e-3 grey
    levels (14 operations of relative error 2^-24 on values under 256), so
    the plane is summed plainly and only the pixels whose sum lies within
    0.01 of a rounding boundary are summed again, fused."""
    h, w = img.shape
    p = np.pad(img, 3, mode="reflect").astype(np.float32)
    out = _blur_plain(p, h, w)
    frac = out - np.floor(out)
    frac -= np.float32(0.5)
    ys, xs = np.nonzero(np.abs(frac, out=frac) < np.float32(0.01))
    if len(ys):
        out[ys, xs] = _blur_fused_at(p, ys, xs)
    return np.rint(out, out=out).clip(0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# 7. rBRIEF


def brief_descriptors(blurred: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                      angles_deg: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 descriptors at integer points of a blurred level: the
    256 pairs rotated by the angle (float32 cos and sin of the float32 angle
    in radians, coordinates rounded half to even), ``bit = I(p0) < I(p1)``,
    bit i of the descriptor in byte i // 8 at position i % 8."""
    p = pattern()
    rad = np.asarray(angles_deg, np.float32) * np.float32(np.pi / 180.0)
    a = np.cos(rad.astype(np.float64)).astype(np.float32)[:, None]
    b = np.sin(rad.astype(np.float64)).astype(np.float32)[:, None]
    vals = []
    for k in (0, 2):
        px, py = p[None, :, k], p[None, :, k + 1]
        ix = np.rint(px * a - py * b).astype(np.intp)
        iy = np.rint(px * b + py * a).astype(np.intp)
        vals.append(blurred[ys[:, None] + iy, xs[:, None] + ix])
    return np.packbits(vals[0] < vals[1], axis=1, bitorder="little")


# ---------------------------------------------------------------------------
# The whole


@dataclass
class OrbFeatures:
    """Keypoints of one image. ``pts`` are in the image's coordinates
    (level coordinates times the level's scale); ``xs`` / ``ys`` are the
    integer coordinates in level ``octave``."""

    pts: np.ndarray  # (n, 2) float32
    octave: np.ndarray  # (n,) int
    xs: np.ndarray  # (n,) int
    ys: np.ndarray  # (n,) int
    response: np.ndarray  # (n,) float32 Harris response
    angle: np.ndarray  # (n,) float32 degrees
    descriptors: np.ndarray  # (n, 32) uint8


def detect_keypoints(level: np.ndarray, quota: int):
    """Stages 2-4 on one level: (xs, ys, harris response)."""
    h, w = level.shape
    none = (np.zeros(0, np.intp), np.zeros(0, np.intp), np.zeros(0, np.float32))
    if quota <= 0 or h <= 2 * EDGE_THRESHOLD or w <= 2 * EDGE_THRESHOLD:
        return none
    xs, ys, score = fast_corners(level)
    e = EDGE_THRESHOLD
    inside = (xs >= e) & (xs < w - e) & (ys >= e) & (ys < h - e)
    xs, ys, score = xs[inside], ys[inside], score[inside]
    keep = retain_best(score, 2 * quota)
    xs, ys = xs[keep], ys[keep]
    if len(xs) == 0:
        return none
    resp = harris_responses(level, xs, ys)
    keep = retain_best(resp, quota)
    return xs[keep], ys[keep], resp[keep]


def detect_and_compute(img: np.ndarray, n_features: int = 500) -> OrbFeatures:
    """All stages on a uint8 grayscale image. Within a level the keypoints
    come in row-major order."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected a 2-D uint8 image, got {img.dtype} {img.shape}")
    scales = level_scales()
    quotas = features_per_level(n_features)
    out = {k: [] for k in ("pts", "octave", "xs", "ys", "response", "angle", "descriptors")}
    for l, level in enumerate(build_pyramid(img)):
        xs, ys, resp = detect_keypoints(level, quotas[l])
        if len(xs) == 0:
            continue
        angle = ic_angles(level, xs, ys)
        out["descriptors"].append(brief_descriptors(gaussian_blur7(level), xs, ys, angle))
        out["pts"].append(np.stack([xs, ys], axis=1).astype(np.float32) * scales[l])
        out["octave"].append(np.full(len(xs), l))
        out["xs"].append(xs)
        out["ys"].append(ys)
        out["response"].append(resp)
        out["angle"].append(angle)
    if not out["pts"]:
        return OrbFeatures(np.zeros((0, 2), np.float32), np.zeros(0, int), np.zeros(0, np.intp),
                           np.zeros(0, np.intp), np.zeros(0, np.float32), np.zeros(0, np.float32),
                           np.zeros((0, 32), np.uint8))
    return OrbFeatures(**{k: np.concatenate(v) for k, v in out.items()})
