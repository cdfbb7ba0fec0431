from . import camera, config, se3  # noqa: F401
from .camera import TUM_FR1, Intrinsics, level_intrinsics, level_shape  # noqa: F401
from .config import (  # noqa: F401
    BackendConfig,
    FusionConfig,
    KeyframeConfig,
    SlamConfig,
    TrackingConfig,
)
