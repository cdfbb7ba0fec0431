from .frames import FrameLevel, KeyframeLevel, keyframe_pyramid, preprocess_frame  # noqa: F401
from .tracker import TrackResult, Tracker  # noqa: F401
