"""Host-side keyframe lifecycle (KeyframeManager).

Counterpart of ``rgbid_tpu/mapping/manager.py``: creates keyframe records,
keeps the odometry edges between consecutive keyframes, and finalizes
retiring keyframes into point clouds and the coarse planes the back end
verifies loop candidates on. The JAX package's jitted ``_packer`` becomes
one ``torch.cat`` of ravelled planes and one ``.cpu()``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.camera import Intrinsics
from ..tracking.step import gray_from_rgb
from .keyframe import DeviceKeyframe, Keyframe, extract_cloud


@dataclass
class OdometryEdge:
    """Relative SE(3) constraint between consecutive keyframes."""

    from_id: int
    to_id: int
    T_rel: np.ndarray  # T_{from<-to}: maps to-frame points into from-frame
    information: np.ndarray  # 6x6 (already episode-scaled if episode)
    # Diagnostic: the inter-keyframe interval saw consensus activity, so
    # ``information`` was scaled by BackendConfig.episode_info_scale.
    episode: bool = False


class KeyframeManager:
    """Tracks host keyframe records; finalizes retired keyframes.

    ``host_reads`` counts device-to-host reads (one per finalize, whichever
    thread runs it)."""

    def __init__(
        self,
        intr: Intrinsics,
        cloud_stride: int = 2,
        cloud_max_sigma: float = 0.05,
        reloc_level: int = 2,
        on_finalize: Optional[Callable[[Keyframe], None]] = None,
    ):
        self.intr = intr
        self.cloud_stride = cloud_stride
        self.cloud_max_sigma = cloud_max_sigma
        self.reloc_level = reloc_level
        self.on_finalize = on_finalize
        self.keyframes: List[Keyframe] = []
        self.edges: List[OdometryEdge] = []
        self.host_reads = 0
        # finalize runs on the caller's thread and on the back end's.
        self._count_lock = threading.Lock()

    @property
    def active(self) -> Keyframe:
        return self.keyframes[-1]

    def new_keyframe(self, timestamp: float, T_wk: np.ndarray, rgb: np.ndarray) -> Keyframe:
        kf = Keyframe(kf_id=len(self.keyframes), timestamp=timestamp, T_wk=T_wk.copy(),
                      rgb=np.ascontiguousarray(rgb))
        self.keyframes.append(kf)
        return kf

    def add_odometry_edge(self, from_id: int, to_id: int, T_rel: np.ndarray, info: np.ndarray,
                          episode: bool = False) -> None:
        self.edges.append(OdometryEdge(from_id, to_id, T_rel.copy(), info.copy(), episode))

    def finalize(self, kf: Keyframe, device_state: DeviceKeyframe) -> Keyframe:
        """Read six fused planes back in one packed read: xi, mask and
        variance of level 0, strided on the device by ``cloud_stride`` (the
        cloud is all they feed), and intensity, xi and mask at the reloc
        level. Extract the keyframe's cloud and fill ``kf.reloc_planes``."""
        lvl0 = device_state.levels[0]
        li = device_state.levels[min(self.reloc_level, len(device_state.levels) - 1)]
        s = max(self.cloud_stride, 1)
        planes = [p[::s, ::s] for p in (lvl0.xi, lvl0.mask, device_state.var)]
        planes += [li.intensity, li.xi, li.mask]
        with self._count_lock:
            self.host_reads += 1
        packed = torch.cat([p.reshape(-1) for p in planes]).cpu().numpy()
        out, o = [], 0
        for p in planes:
            out.append(packed[o : o + p.numel()].reshape(tuple(p.shape)))
            o += p.numel()
        xi0, mask0, var0, li_int, li_xi, li_mask = out
        kf.cloud = extract_cloud(
            xi0, mask0 > 0.5, var0, kf.rgb[::s, ::s], self.intr,
            max_sigma=self.cloud_max_sigma, grid_step=s,
        )
        kf.reloc_planes = {
            "intensity": li_int,
            "xi": li_xi,
            "mask": li_mask,
            "intensity0_u8": gray_from_rgb(kf.rgb),
        }
        if self.on_finalize is not None:
            self.on_finalize(kf)
        return kf
