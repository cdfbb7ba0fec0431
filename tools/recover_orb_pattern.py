#!/usr/bin/env python3
"""Recover ORB's 256 rBRIEF test pairs from the installed OpenCV.

    python tools/recover_orb_pattern.py [--out rgbid_tpu_torch/data/orb_pattern.npy]

The port carries the pattern as data (``rgbid_tpu_torch/data/orb_pattern.npy``,
256 x 4 int8: x0, y0, x1, y1) and never imports OpenCV; this script is how
that file was made, and ``tests/test_torch_orb.py`` calls ``recover()`` to
hold the committed file to a fresh recovery. It needs cv2 and nothing else.

Method. One keypoint at the centre of a 129 x 129 image, angle 0, octave 0,
so ``ORB.compute`` samples the unrotated pattern around the centre. A single
white pixel on black is put at every offset d in [-16, 16]^2, then the same
with the image inverted. ORB blurs with a 7 x 7 Gaussian (sigma 2) and sets
bit = I(p0) < I(p1), so with g the blurred dot

    on black:  bit(d) = g(p0 - d) < g(p1 - d)     (set around p1)
    inverted:  bit(d) = g(p0 - d) > g(p1 - d)     (set around p0)

For each bit, every (p0, p1) from the bounding boxes of the two observed
maps is tried, and the one pair whose two predicted maps equal the observed
ones is kept. The script fails unless that pair exists and is unique for all
256 bits.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

HALF = 64  # the keypoint sits at (HALF, HALF) of a (2 HALF + 1)^2 image
REACH = 16  # dot offsets tried: [-REACH, REACH]^2; the pattern lies in [-13, 12]
BLUR_R = 3


def _observe(cv2):
    """(2, n, n, 256) bool: bit maps over dot offsets (dy, dx), on black and
    inverted."""
    orb = cv2.ORB_create()
    kp = cv2.KeyPoint(float(HALF), float(HALF), 31.0, 0.0, 1.0, 0)
    n = 2 * REACH + 1
    maps = np.zeros((2, n, n, 256), bool)
    for inv in (0, 1):
        for dy in range(-REACH, REACH + 1):
            for dx in range(-REACH, REACH + 1):
                img = np.zeros((2 * HALF + 1, 2 * HALF + 1), np.uint8)
                img[HALF + dy, HALF + dx] = 255
                if inv:
                    img = 255 - img
                kps, desc = orb.compute(img, [kp])
                assert len(kps) == 1 and kps[0].angle == 0.0
                maps[inv, dy + REACH, dx + REACH] = np.unpackbits(desc[0], bitorder="little")
    return maps


def _blurred_dot(cv2):
    """g on [-BLUR_R, BLUR_R]^2 embedded in zeros, indexed [dy + pad, dx + pad]."""
    pad = 2 * REACH + BLUR_R + 13
    img = np.zeros((2 * pad + 1, 2 * pad + 1), np.uint8)
    img[pad, pad] = 255
    return cv2.GaussianBlur(img, (7, 7), 2, 2, borderType=cv2.BORDER_REFLECT_101).astype(np.int32), pad


def recover() -> np.ndarray:
    """The (256, 4) int8 pattern (x0, y0, x1, y1), recovered from cv2."""
    import cv2

    maps = _observe(cv2)
    g, pad = _blurred_dot(cv2)
    d = np.arange(-REACH, REACH + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")

    def g_at(p):  # g(p - d) over all dot offsets d
        return g[p[1] - dy + pad, p[0] - dx + pad]

    pattern = np.zeros((256, 4), np.int8)
    for bit in range(256):
        boxes = []
        for inv in (1, 0):  # p0 lives in the inverted map, p1 in the plain one
            ys, xs = np.nonzero(maps[inv, :, :, bit])
            if len(ys) == 0:
                raise RuntimeError(f"bit {bit}: no dot offset sets it; widen REACH")
            boxes.append([(x, y) for y in range(ys.min() - REACH, ys.max() - REACH + 1)
                          for x in range(xs.min() - REACH, xs.max() - REACH + 1)])
        found = []
        for p0 in boxes[0]:
            g0 = g_at(p0)
            for p1 in boxes[1]:
                g1 = g_at(p1)
                if np.array_equal(g0 < g1, maps[0, :, :, bit]) and \
                        np.array_equal(g0 > g1, maps[1, :, :, bit]):
                    found.append((*p0, *p1))
        if len(found) != 1:
            raise RuntimeError(f"bit {bit}: {len(found)} pairs explain the maps, need exactly 1")
        pattern[bit] = found[0]
    return pattern


def main() -> int:
    ap = argparse.ArgumentParser()
    root = Path(__file__).resolve().parent.parent
    ap.add_argument("--out", default=str(root / "rgbid_tpu_torch" / "data" / "orb_pattern.npy"))
    args = ap.parse_args()
    pattern = recover()
    np.save(args.out, pattern)
    print(f"wrote {args.out}: {pattern.shape} {pattern.dtype}, coordinates in "
          f"[{pattern.min()}, {pattern.max()}], first pairs {pattern[:4].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
