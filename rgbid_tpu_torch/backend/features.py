"""ORB feature extraction for place recognition (host, numpy).

Counterpart of ``rgbid_tpu/backend/features.py:17-28``, which is OpenCV's
``ORB_create(nfeatures).detectAndCompute``. The port never imports OpenCV:
``backend/orb.py`` is its own ORB (FAST-9 over 8 scales, Harris ranking,
intensity-centroid angle, rBRIEF), held to OpenCV stage by stage in
``tests/test_torch_orb.py``. It runs once per keyframe on the back-end
thread and once per relocalization attempt on the front end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import orb


def extract_orb(
    intensity_u8: np.ndarray, num_features: int = 500
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (keypoints (N, 2) float32, descriptors (N, 32) uint8); two
    empty arrays of those widths where the image yields no keypoint.

    The keypoints and descriptors are those of OpenCV's ORB as a set, keyed
    by (octave, x, y). Their order is not: levels come in turn, and within a
    level the points are row-major, where OpenCV's order falls out of a
    partial sort. The BoW database treats descriptors as a bag, so nothing
    downstream reads the order."""
    f = orb.detect_and_compute(intensity_u8, num_features)
    return f.pts, f.descriptors
