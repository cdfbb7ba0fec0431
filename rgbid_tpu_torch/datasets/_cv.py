"""The four OpenCV functions the synthetic renderer calls, in numpy.

``rgbid_tpu/datasets/synthetic.py`` calls ``cv2.resize`` (cubic),
``cv2.filter2D``, ``cv2.medianBlur`` and ``cv2.dilate``; the port never
imports OpenCV, so each is reproduced here at the shapes the renderer gives
it, against OpenCV 5.0.0 as the pip wheel builds it (IPP on, x86-64 with
AVX-512). ``tests/test_torch_synthetic.py`` holds each to cv2.

- ``resize_cubic``: the wheel resizes float32 with IPP's cubic, not
  OpenCV's own loop. Its taps are ``src = (dst + 0.5) * scale - 0.5`` with
  edge indices clamped and Keys' a = -0.75, and the coefficients come out of
  fused multiply-adds. IPP splits the output in two: pixels whose 4 x 4
  support lies inside the source, where the horizontal pass sums
  ``(p0 + p1) + (p2 + p3)`` and the vertical ``fma(r0, b0, r1 b1) +
  fma(r2, b2, r3 b3)``, and the border band, where the horizontal pass is
  the chain ``fma(s3, c3, fma(s2, c2, fma(s0, c0, s1 c1)))`` and the
  vertical ``(q0 + q2) + (q1 + q3)``. At the renderer's integer scales
  (8, 16, 32, 64 to 512; h/8 to h at even sizes) the interior is bit-equal
  to cv2; in the border band (12 rows and columns at a scale of 8) about 3%
  of pixels differ from cv2, by at most 2.4e-7 of the largest magnitude in
  the output (1.1e-7 measured): each pass alone is bit-equal there,
  their composition is not, and no order of these sums reproduces it. At a
  scale that is not an integer (an odd size, w/8 to w) IPP places its taps
  otherwise, and the result differs from cv2 by up to 1e-5 of the largest
  magnitude (5.8e-6 measured).
- ``filter2d_u8``: correlation with the anchor at the centre and
  ``BORDER_REFLECT_101``, then ``saturate_cast<uchar>`` (round half to
  even). OpenCV sums a kernel of area below 130 directly, over the nonzero
  taps in row-major order, each a fused multiply-add from zero: for the
  renderer's line kernels that is L <= 5 (k = 2L + 1 <= 11), and there the
  numpy form is bit-equal. From L = 6 (k = 13, area 169) OpenCV correlates
  through a float32 DFT; the numpy form keeps the direct sum, which equals
  cv2 for axis-aligned lines and is one grey level off on up to 3% of
  pixels for oblique ones (1.1-1.7% measured). The gauntlet's Kinect rows
  reach L >= 6 on a few frames (7 of 60 at VGA).
- ``median3_f32``: the 3 x 3 median with ``BORDER_REPLICATE``; a median is
  exact in any order, so it is bit-equal.
- ``dilate3_u8``: the 3 x 3 maximum, ``iterations`` times; pixels outside
  the image take no part (OpenCV's default border value for ``dilate``).
  Bit-equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_F = np.float32
_A = _F(-0.75)
# OpenCV's filter2D switches to its DFT path from this kernel area (8U in
# and out on a CPU with SSE3).
DFT_KERNEL_AREA = 130


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding: the float32 product is exact
    in float64, so one rounding of the float64 sum stands for the fused
    operation's."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F)


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """(N, 4) Keys coefficients (a = -0.75) at fractions ``x``, each
    polynomial evaluated by Horner's rule in fused multiply-adds, the last
    one as 1 minus the other three."""
    one = _F(1)
    xp = (x + one).astype(_F)
    omx = (one - x).astype(_F)
    c0 = _fma(_fma(_fma(_A, xp, -_F(5) * _A), xp, _F(8) * _A), xp, -_F(4) * _A)
    c1 = _fma((_fma(_A + _F(2), x, -(_A + _F(3))) * x).astype(_F), x, one)
    c2 = _fma((_fma(_A + _F(2), omx, -(_A + _F(3))) * omx).astype(_F), omx, one)
    c3 = ((one - c0 - c1).astype(_F) - c2).astype(_F)
    return np.stack([c0, c1, c2, c3], -1)


def _cubic_taps(n_src: int, n_dst: int):
    """Source indices (n_dst, 4), clamped, their coefficients (n_dst, 4),
    and whether all four taps lie inside the source (n_dst,)."""
    scale = 1.0 / (np.float64(n_dst) / np.float64(n_src))
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(_F)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(_F)).astype(_F)
    idx = s[:, None] + np.arange(-1, 3)[None, :]
    inner = (idx[:, 0] >= 0) & (idx[:, 3] <= n_src - 1)
    return np.clip(idx, 0, n_src - 1), _cubic_coeffs(frac), inner


def _pairs(t, c) -> np.ndarray:
    """(t0 c0 + t1 c1) + (t2 c2 + t3 c3), every product and sum in float32."""
    p = [(t[j] * c[j]).astype(_F) for j in range(4)]
    return ((p[0] + p[1]).astype(_F) + (p[2] + p[3]).astype(_F)).astype(_F)


def _chain(t, c) -> np.ndarray:
    """fma(t3, c3, fma(t2, c2, fma(t0, c0, t1 c1)))."""
    return _fma(t[3], c[3], _fma(t[2], c[2], _fma(t[0], c[0], (t[1] * c[1]).astype(_F))))


def _fma_pairs(t, c) -> np.ndarray:
    """fma(t0, c0, t1 c1) + fma(t2, c2, t3 c3)."""
    a = _fma(t[0], c[0], (t[1] * c[1]).astype(_F))
    b = _fma(t[2], c[2], (t[3] * c[3]).astype(_F))
    return (a + b).astype(_F)


def _cross_pairs(t, c) -> np.ndarray:
    """(t0 c0 + t2 c2) + (t1 c1 + t3 c3)."""
    p = [(t[j] * c[j]).astype(_F) for j in range(4)]
    return ((p[0] + p[2]).astype(_F) + (p[1] + p[3]).astype(_F)).astype(_F)


def resize_cubic(src: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(src, size, interpolation=cv2.INTER_CUBIC)`` for a 2-D
    float32 ``src``; ``size`` is (width, height) as in OpenCV. The module
    docstring states where the result equals cv2's bit for bit."""
    src = np.asarray(src, _F)
    h, w = src.shape
    W, H = size
    xi, xc, x_in = _cubic_taps(w, W)
    yi, yc, y_in = _cubic_taps(h, H)
    cols = src[:, xi]  # (h, W, 4)
    cx = [xc[:, j] for j in range(4)]
    rows_in = _pairs([cols[..., j] for j in range(4)], cx)  # (h, W)
    rows_bd = _chain([cols[..., j] for j in range(4)], cx)
    cy = [yc[:, j, None] for j in range(4)]
    out = _fma_pairs([rows_in[yi[:, j]] for j in range(4)], cy)
    # The border band: rows whose vertical taps leave the source, then the
    # columns whose horizontal taps do.
    rb = ~y_in
    if rb.any():
        out[rb] = _cross_pairs([rows_bd[yi[rb, j]] for j in range(4)],
                               [yc[rb, j, None] for j in range(4)])
    cb = ~x_in
    if cb.any():
        r = np.nonzero(y_in)[0]
        band = _cross_pairs([rows_bd[yi[r, j]][:, cb] for j in range(4)],
                            [yc[r, j, None] for j in range(4)])
        out[np.ix_(r, np.nonzero(cb)[0])] = band
    return out


def filter2d_u8(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` for a uint8 (H, W) or (H, W, C)
    image and an odd square float32 kernel: each output is the float32 sum
    of the nonzero taps in row-major order, one fused multiply-add each from
    0, rounded half to even and saturated. Bit-equal to OpenCV below
    ``DFT_KERNEL_AREA``; see the module docstring above it."""
    kernel = np.asarray(kernel, _F)
    k = kernel.shape[0]
    r = k // 2
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img, pad, mode="reflect").astype(np.float64)
    h, w = img.shape[:2]
    acc = np.zeros(img.shape, _F)
    for y, x in zip(*np.nonzero(kernel)):
        acc = (p[y:y + h, x:x + w] * np.float64(kernel[y, x]) + acc).astype(_F)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def median3_f32(z: np.ndarray) -> np.ndarray:
    """``cv2.medianBlur(z, 3)`` for a 2-D float32 ``z`` (replicated edge)."""
    z = np.asarray(z, _F)
    h, w = z.shape
    p = np.pad(z, 1, mode="edge")
    stack = np.stack([p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], -1)
    stack.sort(axis=-1)
    return stack[..., 4].copy()


def dilate3_u8(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((3, 3), np.uint8), iterations=n)`` for a
    2-D uint8 ``mask``: outside pixels take no part in the maximum."""
    out = np.asarray(mask, np.uint8)
    h, w = out.shape
    for _ in range(iterations):
        p = np.pad(out, 1, mode="constant", constant_values=0)
        m = p[0:h, 0:w].copy()
        for dy in range(3):
            for dx in range(3):
                np.maximum(m, p[dy:dy + h, dx:dx + w], out=m)
        out = m
    return out
