"""ORB feature extraction for place recognition (host).

Counterpart of ``rgbid_tpu/backend/features.py:17-28``, which is OpenCV's
``ORB_create(nfeatures).detectAndCompute``. The port never imports OpenCV,
and its own ORB (FAST-9 over 8 scales, Harris ranking, intensity-centroid
angle, rBRIEF) is not written yet (ROADMAP Queue 1 #3). Until it is,
``SUPPORTED`` is False, ``SlamSystem`` refuses ``backend.enabled=True`` at
construction, and ``extract_orb`` raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# True once extract_orb is implemented; system.check_supported reads it.
SUPPORTED = False


def extract_orb(
    intensity_u8: np.ndarray, num_features: int = 500
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (keypoints (N, 2) float32, descriptors (N, 32) uint8)."""
    raise NotImplementedError(
        "rgbid_tpu_torch has no ORB extractor yet (ROADMAP Queue 1 #3)"
    )
