#!/usr/bin/env python3
"""Recover the viewer's colour tables and label font from the installed OpenCV.

    python tools/recover_viz_tables.py [--out-dir rgbid_tpu_torch/data]

The port draws its panels and labels without OpenCV
(``rgbid_tpu_torch/utils/viz.py``, ``raster.py``); it carries what it needs
from OpenCV as data, and this script is how those files were made.
``tests/test_torch_viz.py`` calls ``recover()`` to hold the committed files
to a fresh recovery. It needs cv2 and nothing else.

- ``colormap_turbo.npy``, ``colormap_jet.npy``: (256, 3) uint8 BGR, the
  output of ``cv2.applyColorMap`` on every u8 input for COLORMAP_TURBO and
  COLORMAP_JET. A lookup in them is ``applyColorMap`` bit for bit.
- ``glyphs_simplex.npz``: the printable ASCII characters (32 to 126) as
  ``cv2.putText`` draws them with FONT_HERSHEY_SIMPLEX, scale 0.5,
  thickness 1, LINE_AA, the viewer's label style. ``alpha`` (95, CELL_H,
  CELL_W) uint8 is each glyph drawn alone in white on black, with the pen
  at (``origin_x``, ``origin_y``) of its cell (the text's baseline on row
  ``origin_y``); ``advance`` (95,) is how far the pen moves after it, in
  pixels: (width of 21 copies - width of one) / 20 from ``getTextSize``,
  which must come out whole. The cell is checked to hold every pixel the
  glyph touches.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

FIRST, LAST = 32, 126
CELL_H, CELL_W = 22, 19
ORIGIN_Y, ORIGIN_X = 16, 3
SCALE, THICKNESS = 0.5, 1


def recover(cv2) -> dict:
    """The three tables as arrays: {"turbo", "jet", "alpha", "advance",
    "origin"}."""
    ramp = np.arange(256, dtype=np.uint8).reshape(256, 1)
    out = {
        "turbo": cv2.applyColorMap(ramp, cv2.COLORMAP_TURBO).reshape(256, 3),
        "jet": cv2.applyColorMap(ramp, cv2.COLORMAP_JET).reshape(256, 3),
    }
    font = cv2.FONT_HERSHEY_SIMPLEX
    n = LAST - FIRST + 1
    alpha = np.zeros((n, CELL_H, CELL_W), np.uint8)
    advance = np.zeros((n,), np.int16)
    pad = 16
    for k in range(n):
        ch = chr(FIRST + k)
        one = cv2.getTextSize(ch, font, SCALE, THICKNESS)[0][0]
        many = cv2.getTextSize(ch * 21, font, SCALE, THICKNESS)[0][0]
        if (many - one) % 20:
            raise RuntimeError(f"glyph {ch!r}: advance {(many - one) / 20} is not whole")
        advance[k] = (many - one) // 20
        big = np.zeros((CELL_H + 2 * pad, CELL_W + 2 * pad), np.uint8)
        cv2.putText(big, ch, (ORIGIN_X + pad, ORIGIN_Y + pad), font, SCALE, 255, THICKNESS,
                    cv2.LINE_AA)
        cell = big[pad:pad + CELL_H, pad:pad + CELL_W]
        if int(cell.astype(np.int64).sum()) != int(big.astype(np.int64).sum()):
            raise RuntimeError(f"glyph {ch!r} reaches outside its {CELL_H}x{CELL_W} cell")
        alpha[k] = cell
    out.update(alpha=alpha, advance=advance, origin=np.array([ORIGIN_Y, ORIGIN_X], np.int16))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(Path(__file__).resolve().parent.parent
                                             / "rgbid_tpu_torch" / "data"))
    args = ap.parse_args(argv)
    import cv2

    t = recover(cv2)
    out = Path(args.out_dir)
    np.save(out / "colormap_turbo.npy", t["turbo"])
    np.save(out / "colormap_jet.npy", t["jet"])
    np.savez_compressed(out / "glyphs_simplex.npz", alpha=t["alpha"], advance=t["advance"],
                        origin=t["origin"])
    print(f"cv2 {cv2.__version__}: wrote colormap_turbo.npy, colormap_jet.npy, "
          f"glyphs_simplex.npz ({len(t['advance'])} glyphs) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
