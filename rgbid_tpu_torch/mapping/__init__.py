from .keyframe import DeviceKeyframe, Keyframe, create_device_keyframe, rebuild_after_fusion  # noqa: F401
from .fusion import fuse_inverse_depth  # noqa: F401
