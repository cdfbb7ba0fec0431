"""SlamSystem: the public API (feed RGB-D frames -> poses + keyframe map).

Counterpart of ``rgbid_tpu/system.py:32-586``: the per-frame step (track
with the motion consensus + fuse/switch) on an explicit torch device, the
keyframe lifecycle and the odometry edges on the host, and a back-end
thread (loop closure + pose graph) that consumes retired keyframes,
finalizes them and publishes corrected poses, which the front end applies
before each frame. Both threads launch on the default stream. The back
end needs ORB features, which the port does not extract yet, so
``backend.enabled=True`` raises at construction (``check_supported``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .backend import features
from .backend.loop_closure import BackendThread, loop_edge
from .core.camera import Intrinsics
from .core.config import SlamConfig, TrackingConfig
from .mapping import export as _export
from .mapping.keyframe import DeviceKeyframe
from .mapping.manager import KeyframeManager
from .reference_cpu import odometry, se3_np
from .tracking.step import MotionState, ProcessFrame, StepResult, gray_from_rgb, pack_frame
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
        # The back end itself is ported; its ORB extractor is not.
        (cfg.backend.enabled and not features.SUPPORTED,
         "backend.enabled=True (no ORB extractor)", "ROADMAP Queue 1 #3"),
        (cfg.depth_codec != "u16", f"depth_codec={cfg.depth_codec!r}", "ROADMAP Queue 1 #7"),
        (cfg.viz.enabled, "viz.enabled=True", "ROADMAP Queue 1 #8"),
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
        self.backend: Optional[BackendThread] = None
        self.reset()

    @property
    def host_reads(self) -> int:
        """Device-to-host reads so far: the per-frame step, the keyframe
        finalizes (on either thread) and the back end's scorer."""
        reads = self._step.host_reads + self.manager.host_reads
        if self.backend is not None:
            reads += self.backend.loop_closer.scorer.host_reads
        return reads

    @property
    def tracker_counts(self) -> dict:
        """What the tracker ran beyond its plain pyramids so far: the IRLS
        iterations of the consensus's masked reruns and the rescue
        pyramids."""
        return {"rerun_iters": self._step.rerun_iters, "rescues": self._step.rescues}

    @property
    def T_wk(self) -> np.ndarray:
        return self.manager.active.T_wk

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
            self._found_keyframe(packed, timestamp, np.eye(4), rgb_u8)
            T_wc = np.eye(4)
            self._record(timestamp, T_wc, None)
            return T_wc

        # Live pose-graph publication: apply pending optimized keyframe
        # poses before tracking this frame.
        self._apply_pose_updates()
        prev_state = self._kf_state
        res_vec, self._kf_state, self._motion = self._step(packed, prev_state, self._motion)
        res = StepResult.unpack(res_vec, self.config.tracking.levels)
        T_wc = self._handle(rgb_u8, depth_u16, timestamp, packed, prev_state, res)
        self.stats[-1]["ms"] = round((time.perf_counter() - t0) * 1e3, 2)
        return T_wc

    def _found_keyframe(self, packed, timestamp, T_wc, rgb_u8):
        """This frame founds a fresh keyframe at ``T_wc``: new device state,
        motion model at identity, no episode pending."""
        self._kf_state = self._step.init_keyframe(packed)
        self._motion = MotionState.initial(self.device, self.config.tracking.consensus_bins)
        self._episode_since_switch = False
        return self.manager.new_keyframe(timestamp, T_wc, rgb_u8)

    def _handle(self, rgb_u8, depth_u16, timestamp, packed, prev_state: DeviceKeyframe,
                res: StepResult) -> np.ndarray:
        """Host bookkeeping for one frame. ``res.T`` is the effective pose
        vs the keyframe that was active during the frame (coast-and-hold
        already applied on lost frames)."""
        lost = bool(res.lost > 0.5)
        switch = bool(res.switch > 0.5)
        T_eff = se3_np.orthonormalize(res.T.astype(np.float64))
        T_wc = self.T_wk @ se3_np.inv(T_eff)
        # Consensus activity anywhere in the inter-keyframe interval (this
        # frame included, which may be the switch frame) marks the next
        # odometry edge episode-contaminated: persistent flags, a rescue or
        # vote exclusions; a single un-ripened flag is routine noise.
        if (
            float(res.cons_flags_persist) > 0
            or float(res.rescue) > 0.5
            or float(res.consensus_frac) > 0
        ):
            self._episode_since_switch = True
        if lost:
            self._lost_count += 1
            # Recovery: after enough consecutive lost frames, try global
            # relocalization against the keyframe BoW database.
            if (
                self.backend is not None
                and self._lost_count >= self.config.backend.reloc_after_lost
            ):
                T_reloc = self._try_relocalize(rgb_u8, depth_u16, timestamp, packed)
                if T_reloc is not None:
                    T_wc = T_reloc
                    self._lost_count = 0
                    self._relocalized = True
        else:
            self._lost_count = 0
            if switch:
                self._on_keyframe_switch(rgb_u8, timestamp, T_eff, T_wc, res, prev_state)
        self._record(timestamp, T_wc, res)
        return T_wc

    def _on_keyframe_switch(self, rgb_u8, timestamp, T_ck, T_wc, res: StepResult,
                            prev_state: DeviceKeyframe) -> None:
        old = self.manager.active
        # The retiring keyframe's fused planes are this step's input state.
        # With a back end its thread finalizes them (one packed read, the
        # cloud, then ORB and BoW), off the front end's path; without one,
        # finalize runs here.
        if self.backend is None:
            self.manager.finalize(old, prev_state)
        new = self.manager.new_keyframe(timestamp, T_wc, rgb_u8)
        # Odometry edge old->new: T_{old<-new} = inv(T_ck). An edge whose
        # interval saw consensus activity carries the mover's drag; soften
        # it so that loop-closure corrections land there, not in the clean
        # chain (BackendConfig.episode_info_scale).
        info = np.linalg.pinv(res.cov.astype(np.float64) + 1e-12 * np.eye(6))
        episode = self._episode_since_switch
        if episode:
            info = info * float(self.config.backend.episode_info_scale)
        self._episode_since_switch = False
        self.manager.add_odometry_edge(old.kf_id, new.kf_id, se3_np.inv(T_ck), info,
                                       episode=episode)
        if self.backend is not None:
            self.backend.submit(old, prev_state)

    def _try_relocalize(self, rgb_u8, depth_u16, timestamp, packed):
        """Global relocalization of a lost frame against the BoW database.

        On success the current frame becomes a fresh keyframe at the
        recovered world pose, a loop edge to the matched keyframe keeps the
        pose graph connected, and tracking resumes from identity. Returns
        the recovered T_wc, or None."""
        lc = self.backend.loop_closer
        _, desc = features.extract_orb(gray_from_rgb(rgb_u8), self.config.backend.num_features)
        if len(desc) == 0:
            return None
        with lc.db_lock:
            # A huge query id disables the temporal-adjacency exclusion:
            # when lost, ANY keyframe is a legitimate candidate.
            candidates = lc.db.query(10**9, desc)
        cand_kfs = [self.manager.keyframes[cid] for cid, _ in candidates]
        cand_kfs = [kf for kf in cand_kfs if kf.reloc_planes is not None]
        if not cand_kfs:
            return None

        # Current-frame coarse planes (host numpy; only runs on lost frames).
        level = lc.scorer.level
        pyr = odometry.preprocess_frame(
            rgb_u8, depth_u16, level + 1, self.config.depth_scale, self.config.min_depth,
            self.config.max_depth,
        )
        cur_planes = {
            "intensity": pyr.intensity[level],
            "xi": pyr.xi[level],
            "mask": pyr.mask[level].astype(np.float32),
        }
        res = lc.scorer.score_pairs([kf.reloc_planes for kf in cand_kfs],
                                    [cur_planes] * len(cand_kfs))
        accepted = [i for i in range(len(cand_kfs)) if lc.scorer.accept(res, i)]
        if not accepted:
            return None
        best = min(accepted, key=lambda i: float(res.error[i]))
        cand = cand_kfs[best]
        T_qc = se3_np.orthonormalize(np.asarray(res.T[best], np.float64))
        T_wc = cand.T_wk @ se3_np.inv(T_qc)
        new = self._found_keyframe(packed, timestamp, T_wc, rgb_u8)
        self.backend.add_external_loop_edge(loop_edge(res, best, cand.kf_id, new.kf_id))
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
                relocalized=self._relocalized,
                consensus_frac=float(res.consensus_frac),
                guard_fired=bool(res.guard_fired > 0.5),
                div_trans=float(res.div_trans),
                div_rot=float(res.div_rot),
                cons_flags=float(res.cons_flags),
                cons_flags_persist=float(res.cons_flags_persist),
                rescue=bool(res.rescue > 0.5),
            )
        self._relocalized = False
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
        """Clear all tracking, map and back-end state for a fresh sequence.
        The back-end thread, if any, is drained and replaced (the BoW
        database and the pose graph are per-sequence state)."""
        if self.backend is not None:
            self.backend.finish()
        self.manager = KeyframeManager(self.intr, reloc_level=self.config.backend.reloc_level)
        self._kf_state: Optional[DeviceKeyframe] = None
        self._motion: Optional[MotionState] = None
        self._trajectory: List[Tuple[float, np.ndarray]] = []
        self._frame_count = 0
        self._lost_count = 0
        self._relocalized = False
        # True if any frame since the last keyframe switch showed consensus
        # activity: tags the NEXT odometry edge as episode-contaminated.
        self._episode_since_switch = False
        self.stats: List[dict] = []
        self.backend = BackendThread(self) if self.config.backend.enabled else None

    def finish(self) -> None:
        """Finalize the active keyframe and drain the back end."""
        if self._kf_state is not None and self.manager.active.cloud is None:
            self.manager.finalize(self.manager.active, self._kf_state)
        if self.backend is not None:
            if self.manager.keyframes:
                self.backend.submit(self.manager.active)
            self.backend.finish()
            self._apply_pose_updates()

    def _apply_pose_updates(self) -> None:
        """Consume optimized keyframe poses from the back end (if any):
        rebase the keyframes and the recorded trajectory (each frame moves
        with its keyframe). The motion model is relative (T_ck and delta
        are keyframe- and camera-frame quantities), so it needs no
        correction. Called before every frame and at finish."""
        if self.backend is None or not self.backend.has_updates():
            return
        updates = self.backend.take_updates()
        old_poses = {kf.kf_id: kf.T_wk.copy() for kf in self.manager.keyframes}
        for kf_id, T_new in updates.items():
            self.manager.keyframes[kf_id].T_wk = T_new
        for i, rec in enumerate(self.stats):
            kf_id = rec["kf_id"]
            if kf_id in updates:
                t, T_wc = self._trajectory[i]
                correction = updates[kf_id] @ np.linalg.inv(old_poses[kf_id])
                self._trajectory[i] = (t, correction @ T_wc)

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
