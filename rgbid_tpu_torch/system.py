"""SlamSystem: the public API (feed RGB-D frames -> poses + keyframe map).

Counterpart of ``rgbid_tpu/system.py:32-586`` with the back end off: the
per-frame step (track with the motion consensus + fuse/switch) on an
explicit torch device, the keyframe lifecycle on the host. The episode
tagging of odometry edges (``rgbid_tpu/system.py:197-206, 372-383``) feeds
the back end's pose graph and comes with it (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .core.camera import Intrinsics
from .core.config import SlamConfig, TrackingConfig
from .mapping import export as _export
from .mapping.keyframe import DeviceKeyframe
from .mapping.manager import KeyframeManager
from .reference_cpu import se3_np
from .tracking.step import MotionState, ProcessFrame, StepResult, pack_frame
from .tracking.tracker import check_tracking_supported


def check_supported(cfg: SlamConfig) -> None:
    """Raise NotImplementedError for a setting this port does not run yet,
    naming the ROADMAP item that brings it.

    ``tracking.kernel``, ``fusion.kernel`` and ``tracking.stacked_gather``
    are accepted and ignored: the tensor's device picks the kernel or its
    plain version, and the CUDA kernels gather per thread. The tracking
    rows are ``check_tracking_supported``'s."""
    check_tracking_supported(cfg.tracking)
    unsupported = [
        (cfg.backend.enabled, "backend.enabled=True", "ROADMAP Queue 1 #9"),
        (cfg.depth_codec != "u16", f"depth_codec={cfg.depth_codec!r}", "ROADMAP Queue 1 #13"),
        (cfg.viz.enabled, "viz.enabled=True", "ROADMAP Queue 1 #10"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(f"rgbid_tpu_torch does not run {what} yet ({item})")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class SlamSystem:
    """Dense RGB-D SLAM on a torch device.

    Usage:
        slam = SlamSystem(intrinsics, config, device="cuda")
        for rgb, depth, t in frames:
            T_wc = slam.process_frame(rgb, depth, t)
        slam.finish()
        slam.save_trajectory("traj.txt"); slam.save_map("map.ply")
    """

    def __init__(self, intr: Intrinsics, config: Optional[SlamConfig] = None, device="cuda"):
        self.intr = intr
        self.device = _resolve_device(device)
        cfg = config or SlamConfig()
        check_supported(cfg)
        # Same derivation as the JAX package (keeps the configs equal):
        # consensus strata span the sensor's inverse-depth range unless set.
        tdef = TrackingConfig()
        if (
            cfg.tracking.consensus_xi_min == tdef.consensus_xi_min
            and cfg.tracking.consensus_xi_max == tdef.consensus_xi_max
        ):
            cfg = cfg.override(
                **{
                    "tracking.consensus_xi_min": 1.0 / cfg.max_depth,
                    "tracking.consensus_xi_max": 1.0 / cfg.min_depth,
                }
            )
        self.config = cfg
        self._step = ProcessFrame(intr, cfg, self.device)
        self.reset()

    @property
    def host_reads(self) -> int:
        """Device-to-host reads so far (per-frame step + keyframe finalize)."""
        return self._step.host_reads + self.manager.host_reads

    @property
    def tracker_counts(self) -> dict:
        """What the tracker ran beyond its plain pyramids so far: the IRLS
        iterations of the consensus's masked reruns and the rescue
        pyramids."""
        return {"rerun_iters": self._step.rerun_iters, "rescues": self._step.rescues}

    def _upload(self, packed_u8: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(packed_u8)
        if self.device.type == "cuda":
            # Pinned + non_blocking: a pageable copy would synchronize.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def process_frame(self, rgb_u8: np.ndarray, depth_u16: np.ndarray, timestamp: float) -> np.ndarray:
        """Track one frame; returns the world camera pose T_wc (4x4)."""
        t0 = time.perf_counter()
        packed = self._upload(pack_frame(rgb_u8, depth_u16, self.config))
        if self._kf_state is None:
            self._kf_state = self._step.init_keyframe(packed)
            self._motion = MotionState.initial(self.device, self.config.tracking.consensus_bins)
            self.manager.new_keyframe(timestamp, np.eye(4), rgb_u8)
            T_wc = np.eye(4)
            self._record(timestamp, T_wc, None)
            return T_wc

        prev_state = self._kf_state
        res_vec, self._kf_state, self._motion = self._step(packed, prev_state, self._motion)
        res = StepResult.unpack(res_vec, self.config.tracking.levels)
        T_wc = self._handle(rgb_u8, timestamp, prev_state, res)
        self.stats[-1]["ms"] = round((time.perf_counter() - t0) * 1e3, 2)
        return T_wc

    def _handle(self, rgb_u8, timestamp, prev_state: DeviceKeyframe, res: StepResult) -> np.ndarray:
        """Host bookkeeping for one frame. ``res.T`` is the effective pose
        vs the keyframe that was active during the frame."""
        lost = bool(res.lost > 0.5)
        switch = bool(res.switch > 0.5)
        T_eff = se3_np.orthonormalize(res.T.astype(np.float64))
        T_wc = self.manager.active.T_wk @ se3_np.inv(T_eff)
        if switch and not lost:
            # The retiring keyframe's fused planes are this step's input state.
            self.manager.finalize(self.manager.active, prev_state)
            self.manager.new_keyframe(timestamp, T_wc, rgb_u8)
        self._record(timestamp, T_wc, res)
        return T_wc

    def _record(self, timestamp, T_wc, res: Optional[StepResult]):
        self._trajectory.append((timestamp, T_wc.copy()))
        rec = {"frame": self._frame_count, "t": timestamp, "kf_id": self.manager.active.kf_id}
        if res is not None:
            rec.update(
                overlap=float(res.overlap),
                inliers=float(res.inlier_frac[0]),
                error=float(res.errors[0]),
                n_fused=float(res.n_fused),
                lost=bool(res.lost > 0.5),
                switch=bool(res.switch > 0.5),
                consensus_frac=float(res.consensus_frac),
                guard_fired=bool(res.guard_fired > 0.5),
                div_trans=float(res.div_trans),
                div_rot=float(res.div_rot),
                cons_flags=float(res.cons_flags),
                cons_flags_persist=float(res.cons_flags_persist),
                rescue=bool(res.rescue > 0.5),
            )
        self.stats.append(rec)
        self._frame_count += 1

    def feed(self, frames, flight_depth: Optional[int] = None) -> List[np.ndarray]:
        """Process an iterable of frames (objects with .rgb/.depth/.timestamp
        or (rgb, depth, timestamp) tuples); returns per-frame world poses.

        Flight depth is 1 here: each frame reads its result back before the
        next one starts, so ``flight_depth`` and ``pipeline_depth`` are
        accepted and have no effect."""
        del flight_depth
        poses = []
        for f in frames:
            if hasattr(f, "rgb"):
                rgb, depth, t = f.rgb, f.depth, f.timestamp
            else:
                rgb, depth, t = f
            poses.append(self.process_frame(rgb, depth, t))
        return poses

    def reset(self) -> None:
        """Clear all tracking and map state for a fresh sequence."""
        self.manager = KeyframeManager(self.intr)
        self._kf_state: Optional[DeviceKeyframe] = None
        self._motion: Optional[MotionState] = None
        self._trajectory: List[Tuple[float, np.ndarray]] = []
        self._frame_count = 0
        self.stats: List[dict] = []

    def finish(self) -> None:
        """Finalize the active keyframe."""
        if self._kf_state is not None and self.manager.active.cloud is None:
            self.manager.finalize(self.manager.active, self._kf_state)

    def trajectory(self) -> List[Tuple[float, np.ndarray]]:
        return list(self._trajectory)

    def poses(self) -> List[np.ndarray]:
        return [T for _, T in self._trajectory]

    def map_points(self, voxel: float = 0.0) -> np.ndarray:
        clouds = [kf.cloud for kf in self.manager.keyframes]
        poses = [kf.T_wk for kf in self.manager.keyframes]
        return _export.assemble_map(clouds, poses, voxel)

    def save_trajectory(self, path: str) -> None:
        _export.write_tum_trajectory(path, self._trajectory)

    def save_map(self, path: str, voxel: float = 0.0) -> None:
        """Write the global cloud; format by extension (.ply or .pcd)."""
        if path.lower().endswith(".pcd"):
            _export.write_pcd(path, self.map_points(voxel))
        else:
            _export.write_ply(path, self.map_points(voxel))
