"""rgbid_tpu_torch: the PyTorch / CUDA port of rgbid_tpu (dense RGB-D SLAM).

The per-frame tracking (with the motion consensus) + fusion path of
``rgbid_tpu`` on a torch device, with the JAX package's Pallas kernels and
the consensus vote's reduction rewritten as CUDA C++ for Hopper
(``csrc/``). The JAX package stays the reference; this package never
imports it, nor JAX.

    from rgbid_tpu_torch import SlamSystem, SlamConfig, Intrinsics
    cfg = SlamConfig().override(**{"backend.enabled": False})
    slam = SlamSystem(intrinsics, cfg, device="cuda")
    pose = slam.process_frame(rgb_u8, depth_u16, timestamp)
    slam.finish()
    slam.trajectory(); slam.map_points()
"""

__version__ = "0.1.0"

from . import _precision  # noqa: F401  (float32 matmuls and convolutions)
from .core.camera import Intrinsics  # noqa: F401
from .core.config import SlamConfig  # noqa: F401
from .system import SlamSystem  # noqa: F401

__all__ = ["Intrinsics", "SlamConfig", "SlamSystem"]
