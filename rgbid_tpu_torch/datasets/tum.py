"""TUM RGB-D benchmark sequence reader.

The port's copy of ``rgbid_tpu/datasets/tum.py``: parses rgb.txt /
depth.txt, associates timestamps greedily within 20 ms, loads 8-bit RGB
and 16-bit depth PNGs (depth scale 1/5000 m), parses groundtruth.txt, and
undistorts on the host (bilinear remap for RGB, nearest for depth, which
bilinear would blend across discontinuities). Only the I/O differs: the
PNGs go through ``datasets/png.py`` and the undistortion through
``datasets/_cv.py``, each equal to the OpenCV call it replaces. A missing,
damaged or unfinished PNG raises IOError, as the JAX package's reader does
where ``cv2.imread`` returns None; a PNG variant ``png.py`` does not read
raises its ValueError.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.camera import DEFAULT, TUM_FR1, TUM_FR2, TUM_FR3, Intrinsics
from . import Frame, _cv, png

# Standard TUM RGB-D distortion coefficients (k1, k2, p1, p2, k3) for the
# factory calibrations above; freiburg3 sequences ship pre-undistorted.
TUM_DISTORTION = {
    "freiburg1": np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633]),
    "freiburg2": np.array([0.2312, -0.7849, -0.0033, -0.0001, 0.9172]),
    "freiburg3": np.zeros(5),
}


def guess_distortion(seq_dir: str):
    name = os.path.basename(os.path.normpath(seq_dir))
    for key, coeffs in TUM_DISTORTION.items():
        short = "fr" + key[-1]
        if key in name or short in name:
            return coeffs
    return np.zeros(5)


def _read_file_list(path: str) -> List[Tuple[float, List[str]]]:
    """Parse a TUM-style index file: lines of 'timestamp data...', '#' comments."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def associate(
    a: List[Tuple[float, List[str]]],
    b: List[Tuple[float, List[str]]],
    max_difference: float = 0.02,
    offset: float = 0.0,
) -> List[Tuple[int, int]]:
    """Greedy timestamp association (the TUM toolkit's associate.py):
    among all pairs with |ta - (tb + offset)| < max_difference, take
    greedily by ascending difference while both sides are unused. Returns
    index pairs into a and b, sorted.

    Candidates come from a sorted-window search, O((N + M) log M + C),
    not the toolkit's all-pairs scan; the candidate set, and so the
    result, is the same."""
    if not a or not b:
        return []
    ta = np.asarray([t for t, _ in a], np.float64)
    tb = np.asarray([t for t, _ in b], np.float64) + offset
    order_b = np.argsort(tb, kind="stable")
    tbs = tb[order_b]
    lo = np.searchsorted(tbs, ta - max_difference, side="left")
    hi = np.searchsorted(tbs, ta + max_difference, side="right")
    candidates = []
    for i in range(len(ta)):
        for k in range(lo[i], hi[i]):
            j = int(order_b[k])
            d = abs(ta[i] - tb[j])
            if d < max_difference:
                candidates.append((d, i, j))
    candidates.sort()
    used_a, used_b, matches = set(), set(), []
    for _, i, j in candidates:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            matches.append((i, j))
    matches.sort()
    return matches


def load_calibration(path: str) -> Tuple[Intrinsics, np.ndarray]:
    """Parse a calibration file -> (Intrinsics, distortion[5]).

    Either bare numbers, ``fx fy cx cy [width height] [k1 k2 p1 p2 k3]``
    across any number of lines, or ``key: value`` / ``key = value`` lines
    with keys fx, fy, cx, cy, width, height, k1, k2, p1, p2, k3; '#'
    starts a comment."""
    keyed = {}
    numbers: List[float] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if ":" in line or "=" in line:
                key, val = line.replace("=", ":").split(":", 1)
                keyed[key.strip().lower()] = float(val)
            else:
                numbers.extend(float(x) for x in line.split())
    dist = np.zeros(5)
    if keyed:
        intr = Intrinsics(
            fx=keyed["fx"],
            fy=keyed["fy"],
            cx=keyed["cx"],
            cy=keyed["cy"],
            width=int(keyed.get("width", 640)),
            height=int(keyed.get("height", 480)),
        )
        for n, k in enumerate(("k1", "k2", "p1", "p2", "k3")):
            dist[n] = keyed.get(k, 0.0)
        return intr, dist
    if len(numbers) not in (4, 6, 9, 11):
        raise ValueError(
            f"{path}: expected 4 (fx fy cx cy), 6 (+w h), 9 (+5 distortion) "
            f"or 11 values, got {len(numbers)}"
        )
    fx, fy, cx, cy = numbers[:4]
    w, h = (int(numbers[4]), int(numbers[5])) if len(numbers) in (6, 11) else (640, 480)
    if len(numbers) == 9:
        dist = np.asarray(numbers[4:9])
    elif len(numbers) == 11:
        dist = np.asarray(numbers[6:11])
    return Intrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h), dist


def guess_intrinsics(seq_dir: str) -> Intrinsics:
    name = os.path.basename(os.path.normpath(seq_dir))
    if "freiburg1" in name or "fr1" in name:
        return TUM_FR1
    if "freiburg2" in name or "fr2" in name:
        return TUM_FR2
    if "freiburg3" in name or "fr3" in name:
        return TUM_FR3
    return DEFAULT


def _read(path: str, rel: str, reader) -> np.ndarray:
    """``reader(path)``, with every OSError (missing, damaged or unfinished
    file) raised as the JAX package's IOError."""
    try:
        return reader(path)
    except OSError as e:
        raise IOError(f"cannot read {rel}") from e


class TumSequence:
    """A TUM RGB-D sequence directory (rgb.txt, depth.txt, rgb/, depth/)."""

    def __init__(
        self,
        seq_dir: str,
        intrinsics: Optional[Intrinsics] = None,
        max_difference: float = 0.02,
        depth_scale: float = 5000.0,
        distortion: Optional[np.ndarray] = None,
        undistort: bool = True,
        calib_file: Optional[str] = None,
    ):
        self.dir = seq_dir
        # Calibration precedence: explicit file > in-directory
        # calibration.txt > explicit args > per-sequence factory guess.
        if calib_file is None:
            default_calib = os.path.join(seq_dir, "calibration.txt")
            if os.path.exists(default_calib):
                calib_file = default_calib
        if calib_file is not None:
            c_intr, c_dist = load_calibration(calib_file)
            intrinsics = intrinsics or c_intr
            distortion = distortion if distortion is not None else c_dist
        self.intrinsics = intrinsics or guess_intrinsics(seq_dir)
        self.depth_scale = depth_scale
        self.distortion = (
            distortion if distortion is not None else guess_distortion(seq_dir)
        )
        self.undistort = undistort and np.any(np.abs(self.distortion) > 1e-12)
        self._maps = None
        self._max_difference = max_difference
        self.refresh()
        # Adapt the calibration to the actual image size (sequences exported
        # at non-VGA resolutions keep the same field of view). A probe that
        # cannot be read leaves it as it is, as cv2.imread's None does in the
        # JAX package.
        if len(self._items) > 0:
            try:
                probe = png.read_unchanged(os.path.join(seq_dir, self._items[0][2]))
            except OSError:
                probe = None
            if probe is not None and (
                probe.shape[0] != self.intrinsics.height
                or probe.shape[1] != self.intrinsics.width
            ):
                sy = probe.shape[0] / self.intrinsics.height
                sx = probe.shape[1] / self.intrinsics.width
                i = self.intrinsics
                self.intrinsics = Intrinsics(
                    fx=i.fx * sx,
                    fy=i.fy * sy,
                    cx=(i.cx + 0.5) * sx - 0.5,
                    cy=(i.cy + 0.5) * sy - 0.5,
                    width=probe.shape[1],
                    height=probe.shape[0],
                )
        gt_path = os.path.join(seq_dir, "groundtruth.txt")
        self.groundtruth: Optional[np.ndarray] = None
        if os.path.exists(gt_path):
            rows = _read_file_list(gt_path)
            # (N, 8): t tx ty tz qx qy qz qw
            self.groundtruth = np.array(
                [[t] + [float(x) for x in data[:7]] for t, data in rows], dtype=np.float64
            )

    def __len__(self) -> int:
        return len(self._items)

    def refresh(self) -> int:
        """Re-read rgb.txt / depth.txt and re-associate: the live source
        (datasets/live.py) follows a growing directory by calling this
        between polls. Returns the new item count. Pairs already matched
        keep their indices (the matcher is deterministic on the full
        lists)."""
        rgb_list = _read_file_list(os.path.join(self.dir, "rgb.txt"))
        depth_list = _read_file_list(os.path.join(self.dir, "depth.txt"))
        matches = associate(rgb_list, depth_list, self._max_difference)
        self._items = [
            (rgb_list[i][0], rgb_list[i][1][0], depth_list[j][1][0]) for i, j in matches
        ]
        return len(self._items)

    def _undistort_maps(self, shape):
        """(map_x, map_y, the bilinear plan) for images of ``shape``, made once."""
        if self._maps is None:
            i = self.intrinsics
            K = np.array([[i.fx, 0, i.cx], [0, i.fy, i.cy], [0, 0, 1]])
            m1, m2 = _cv.undistort_maps(K, self.distortion, (shape[1], shape[0]))
            self._maps = (m1, m2, _cv.linear_plan(m1, m2, shape[:2]))
        return self._maps

    def __getitem__(self, idx: int) -> Frame:
        t, rgb_rel, depth_rel = self._items[idx]
        rgb = _read(os.path.join(self.dir, rgb_rel), rgb_rel, png.read_color)
        depth = _read(os.path.join(self.dir, depth_rel), depth_rel, png.read_unchanged)
        depth = depth.astype(np.uint16)
        if self.undistort:
            m1, m2, plan = self._undistort_maps(depth.shape)
            rgb = _cv.remap_linear_u8(rgb, m1, m2, plan)
            # Nearest for depth: bilinear would invent geometry at edges.
            depth = _cv.remap_nearest(depth, m1, m2)
        return Frame(t, rgb, depth)

    def frames(self) -> Iterator[Frame]:
        for i in range(len(self)):
            yield self[i]
