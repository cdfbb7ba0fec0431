"""Back end: loop-closure detection + pose-graph optimization.

Counterpart of ``rgbid_tpu/backend/``: ORB features, bag-of-words place
recognition and the pose-graph solve stay on the host; loop-candidate
verification, dense alignment between keyframe pairs, runs on the device
through the ESM IRLS kernel (relocalization.py).
"""

from .place_recognition import BowDatabase, OnlineVocabulary  # noqa: F401
from .pose_graph import PoseGraph, optimize_pose_graph  # noqa: F401
from .relocalization import RelocScorer  # noqa: F401
