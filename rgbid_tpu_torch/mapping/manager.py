"""Host-side keyframe lifecycle (KeyframeManager).

Counterpart of ``rgbid_tpu/mapping/manager.py``: creates keyframe records
and finalizes retiring keyframes into point clouds. The JAX package's
jitted ``_packer`` becomes one ``torch.cat`` and one ``.cpu()``. What
finalize also prepares there for the back end (coarse planes for place
recognition) and the odometry edges come with the back end (ROADMAP
Queue 1 #9).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.camera import Intrinsics
from .keyframe import DeviceKeyframe, Keyframe, extract_cloud


# Cloud extraction keeps every 2nd pixel of level 0 whose inverse-depth
# sigma is under 0.05 (the JAX package's KeyframeManager defaults).
_CLOUD_STRIDE = 2
_CLOUD_MAX_SIGMA = 0.05


class KeyframeManager:
    """Tracks host keyframe records; finalizes retired keyframes.

    ``host_reads`` counts device-to-host reads (one per finalize)."""

    def __init__(self, intr: Intrinsics):
        self.intr = intr
        self.keyframes: List[Keyframe] = []
        self.host_reads = 0

    @property
    def active(self) -> Keyframe:
        return self.keyframes[-1]

    def new_keyframe(self, timestamp: float, T_wk: np.ndarray, rgb: np.ndarray) -> Keyframe:
        kf = Keyframe(kf_id=len(self.keyframes), timestamp=timestamp, T_wk=T_wk.copy(),
                      rgb=np.ascontiguousarray(rgb))
        self.keyframes.append(kf)
        return kf

    def finalize(self, kf: Keyframe, device_state: DeviceKeyframe) -> Keyframe:
        """Read the fused level-0 planes back, strided on the device (the
        cloud is all they feed), in one packed read, and extract the
        keyframe's cloud."""
        lvl0 = device_state.levels[0]
        s = _CLOUD_STRIDE
        planes = [p[::s, ::s] for p in (lvl0.xi, lvl0.mask, device_state.var)]
        self.host_reads += 1
        xi0, mask0, var0 = torch.stack(planes).cpu().numpy()
        kf.cloud = extract_cloud(
            xi0, mask0 > 0.5, var0, kf.rgb[::s, ::s], self.intr,
            max_sigma=_CLOUD_MAX_SIGMA, grid_step=s,
        )
        return kf
