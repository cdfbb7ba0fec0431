"""SlamSystem: the public API (feed RGB-D frames -> poses + keyframe map).

Counterpart of ``rgbid_tpu/system.py:32-586``: the per-frame step (track
with the motion consensus + fuse/switch, one CUDA graph replay per tracked
frame on a card) on an explicit torch device, the keyframe lifecycle and
the odometry edges on the host, and a back-end thread (loop closure + pose
graph) that consumes retired keyframes, finalizes them and publishes
corrected poses, which the front end applies at the start of each flight.
Both threads launch on the default stream.

Flights, as in the JAX package: ``_dispatch`` enqueues a frame's step and
reads nothing (the step needs no host input but its upload), ``_drain``
reads a flight's stacked result vectors back in one read and ``_handle``
does each frame's host bookkeeping in order. ``process_frame`` is a flight
of one; ``feed`` dispatches up to ``flight_depth`` (default
``config.pipeline_depth``) frames before it drains. The state a finalize
reads of each in-flight frame's input keyframe is kept in a ring of
``flight_depth`` slots (the graph overwrites the state itself), copied in
after each dispatch. The back
end's ORB features are host numpy (``backend/orb.py``): once per keyframe
on the thread, once per relocalization attempt here. With ``viz.enabled``
a third thread (``utils/live_view.py``) renders snapshots that the front
end hands it every ``viz.every_n`` frames, made from host data only.

The host path is timed in spans (``utils/profiling.py``): ``rgbid.flight``
around each flight, ``rgbid.pack``, ``rgbid.upload`` and ``rgbid.dispatch``
around each frame's packing (``pack_frame``: the gray and the depth codec in
one native pass over the pixels on the host), upload and dispatch,
``rgbid.wait`` around the flight's read and ``rgbid.handle`` around each
frame's bookkeeping. Each flight is one row of the process-wide flight log
(``flights()``), with the card's busy time from one pair of CUDA timing
events a frame. Under
``torch.profiler`` the spans name the host's part of the card's timeline.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .backend import features
from .backend.loop_closure import BackendThread, loop_edge
from .core.camera import Intrinsics
from .core.config import SlamConfig, TrackingConfig
from .mapping import export as _export
from .mapping.keyframe import DeviceKeyframe, retire_shapes
from .mapping.manager import CLOUD_STRIDE, KeyframeManager
from .reference_cpu import odometry, se3_np
from .tracking.step import (MotionState, ProcessFrame, StepResult, check_packed_shape,
                            gray_from_rgb, pack_frame)
from .tracking.tracker import check_tracking_supported
from .utils import profiling
from .utils.live_view import LiveViewer


def check_supported(cfg: SlamConfig) -> None:
    """Raise ValueError for a tracking setting this port refuses
    (``check_tracking_supported``).

    ``tracking.kernel``, ``fusion.kernel`` and ``tracking.stacked_gather``
    are accepted and ignored: the tensor's device picks the kernel or its
    plain version, and the CUDA kernels gather per thread.
    ``pipeline_depth`` and ``feed(flight_depth=...)`` set the flight depth,
    as in the JAX package."""
    check_tracking_supported(cfg.tracking)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device ("cuda" is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    return (a.index if a.index is not None else torch.cuda.current_device()) == (
        b.index if b.index is not None else torch.cuda.current_device())


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
        self._step = ProcessFrame(intr, cfg, self.device,
                                  retire=(cfg.backend.reloc_level, CLOUD_STRIDE))
        # The retire ring: one slot a frame of the flight in flight.
        self._ring: Optional[torch.Tensor] = None
        self.backend: Optional[BackendThread] = None
        # The live viewer (the reference's GUI thread), fed host data only.
        self.viewer: Optional[LiveViewer] = None
        if cfg.viz.enabled:
            self.viewer = LiveViewer(cfg.viz.out_dir, history=cfg.viz.history,
                                     map_every=cfg.viz.map_every)
        self.reset()

    @property
    def host_reads(self) -> int:
        """Device-to-host reads so far: one per flight (its result vectors),
        the keyframe finalizes (on either thread) and the back end's
        scorer."""
        reads = self._step.host_reads + self.manager.host_reads
        if self.backend is not None:
            reads += self.backend.loop_closer.scorer.host_reads
        return reads

    @property
    def tracker_counts(self) -> dict:
        """What the tracker ran beyond its plain pyramids so far: the IRLS
        iterations of the consensus's masked reruns and the rescue
        pyramids, as the frames' result vectors report them (exact once the
        frames are drained)."""
        return {"rerun_iters": self._step.rerun_iters, "rescues": self._step.rescues}

    @property
    def T_wk(self) -> np.ndarray:
        return self.manager.active.T_wk

    def flights(self) -> np.ndarray:
        """This system's rows of the flight log since its last reset, oldest
        first (``utils/profiling.py``: a flight's wall time, the host time
        of each span, the card's busy time, the garbage collections)."""
        return profiling.flights(self._flights.system)

    def _upload(self, packed_u8: np.ndarray) -> torch.Tensor:
        """The packed frame on the device, in any codec's shape: (3, H, W),
        (H, 5W/2) or (3H/2, W); ``decode_frame`` is its only reader."""
        fl = self._flights
        with fl.upload:
            t = torch.from_numpy(packed_u8)
            if self.device.type == "cuda":
                # Pinned + non_blocking: a pageable copy would synchronize.
                t = t.pin_memory()
                fl.frame_begin()
                t = t.to(self.device, non_blocking=True)
        return t

    def _packed(self, packed) -> torch.Tensor:
        """A frame's upload prepared ahead by the caller: the output of
        ``pack_frame(rgb_u8, depth_u16, config)`` as a numpy array (uploaded
        as ``_upload`` does) or as a uint8 tensor already on ``self.device``.
        A shape of another codec raises ``decode_frame``'s ValueError."""
        check_packed_shape(tuple(packed.shape), self.config)
        if isinstance(packed, torch.Tensor):
            if not _same_device(packed.device, self.device) or packed.dtype != torch.uint8:
                raise ValueError(f"packed must be a uint8 tensor on {self.device}, got "
                                 f"{packed.dtype} on {packed.device}")
            return packed
        packed = np.asarray(packed)
        if packed.dtype != np.uint8:
            raise ValueError(f"packed must be uint8 from pack_frame, got {packed.dtype}")
        return self._upload(np.ascontiguousarray(packed))

    def process_frame(self, rgb_u8: np.ndarray, depth_u16: np.ndarray, timestamp: float,
                      packed=None) -> np.ndarray:
        """Track one frame; returns the world camera pose T_wc (4x4).

        A flight of one: dispatch, one read, handle. ``packed`` optionally
        supplies the frame's upload prepared ahead of time
        (``pack_frame(rgb_u8, depth_u16, config)``, numpy or already on the
        device); it must use this system's depth codec, and is checked
        before any state changes. The bootstrap frame's founding is timed
        as its dispatch, its record as its handling."""
        fl = self._flights
        fl.open(self._frame_count)
        if packed is None:
            with fl.pack:
                packed = pack_frame(rgb_u8, depth_u16, self.config)
            packed = self._upload(packed)
        else:
            packed = self._packed(packed)
        if self._kf_state is None:
            with fl.dispatch:
                self._found_keyframe(packed, timestamp, np.eye(4), rgb_u8, depth_u16)
            T_wc = np.eye(4)
            with fl.handle:
                self._record(timestamp, T_wc, None)
            fl.close(1)
            return T_wc
        # Live pose-graph publication: apply pending optimized keyframe
        # poses before tracking this frame.
        self._apply_pose_updates()
        return self._drain([self._dispatch(rgb_u8, depth_u16, timestamp, packed, 0)])[0]

    def _ring_slot(self, slot: int) -> torch.Tensor:
        """Slot ``slot`` of the retire ring, which grows to hold it."""
        retired = self._step.retired
        ring = self._ring
        if ring is None or ring.shape[0] <= slot or ring.shape[1] != retired.numel():
            n = max(slot + 1, self.config.pipeline_depth, 0 if ring is None else ring.shape[0])
            ring = self._ring = torch.empty((n, retired.numel()), dtype=retired.dtype,
                                            device=retired.device)
        return ring[slot]

    def _dispatch(self, rgb_u8, depth_u16, timestamp, packed, slot: int) -> dict:
        """Enqueue one frame's step; no host read. What a finalize reads of
        the frame's input keyframe goes into ring slot ``slot``: if this
        frame's result later shows a switch, the retiring keyframe is
        finalized from there."""
        fl = self._flights
        with fl.dispatch:
            fl.frame_begin()
            res_vec, self._kf_state, self._motion = self._step(packed, self._kf_state,
                                                               self._motion)
            retired = self._ring_slot(slot)
            retired.copy_(self._step.retired)
            fl.frame_end()
        return {"rgb": rgb_u8, "depth": depth_u16, "t": timestamp, "packed": packed,
                "retired": retired, "res_vec": res_vec}

    def _drain(self, pending: List[dict]) -> List[np.ndarray]:
        """Read one flight's result vectors back in one read, then handle
        its frames in order, and close the flight. A frame that relocalizes
        resets the state: the rest of the flight, computed against the old
        state, is discarded and replayed frame by frame against the new one.
        Every frame's ``ms`` is the flight's wall time (its span,
        ``rgbid.flight``) over its frames."""
        fl = self._flights
        levels = self.config.tracking.levels
        with fl.wait:
            fl.settle()  # the pairs the card has finished, while it finishes the rest
            stacked = self._step.read(torch.stack([rec["res_vec"] for rec in pending]))
        poses = []
        for i, rec in enumerate(pending):
            with fl.handle:
                T_wc, relocalized = self._handle(rec, StepResult.unpack(stacked[i], levels))
            poses.append(T_wc)
            if relocalized and i + 1 < len(pending):
                for j, rec2 in enumerate(pending[i + 1:], i + 1):
                    self._apply_pose_updates()
                    rec3 = self._dispatch(rec2["rgb"], rec2["depth"], rec2["t"], rec2["packed"], j)
                    with fl.wait:
                        vec = self._step.read(rec3["res_vec"])
                    with fl.handle:
                        poses.append(self._handle(rec3, StepResult.unpack(vec, levels))[0])
                break
        ms = round(fl.close(len(poses)) * 1e-6 / len(poses), 2)
        for rec_stat in self.stats[-len(poses):]:
            rec_stat["ms"] = ms
        return poses

    def _found_keyframe(self, packed, timestamp, T_wc, rgb_u8, depth_u16):
        """This frame founds a fresh keyframe at ``T_wc``: new device state,
        motion model at identity, no episode pending."""
        self._kf_state = self._step.init_keyframe(packed)
        self._motion = MotionState.initial(self.device, self.config.tracking.consensus_bins)
        self.manager.set_shapes(retire_shapes(self._kf_state, self.manager.reloc_level,
                                              self.manager.cloud_stride))
        self._episode_since_switch = False
        return self._new_keyframe(timestamp, T_wc, rgb_u8, depth_u16)

    def _new_keyframe(self, timestamp, T_wc, rgb_u8, depth_u16):
        """The host record of a new keyframe; it keeps the raw depth for the
        viewer's keyframe pane when the viewer is on."""
        kf = self.manager.new_keyframe(timestamp, T_wc, rgb_u8)
        if self.viewer is not None:
            kf.depth = np.ascontiguousarray(depth_u16)
        return kf

    def _handle(self, rec: dict, res: StepResult):
        """Host bookkeeping for one frame of a drained flight; returns
        (T_wc, relocalized). The device already ran the lost / switch / fuse
        branch and the motion model; ``res.T`` is the effective pose vs the
        keyframe that was active during the frame (coast-and-hold already
        applied on lost frames)."""
        rgb_u8, depth_u16, timestamp = rec["rgb"], rec["depth"], rec["t"]
        lost = bool(res.lost > 0.5)
        switch = bool(res.switch > 0.5)
        T_eff = se3_np.orthonormalize(res.T.astype(np.float64))
        T_wc = self.T_wk @ se3_np.inv(T_eff)
        relocalized = False
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
                T_reloc = self._try_relocalize(rgb_u8, depth_u16, timestamp, rec["packed"])
                if T_reloc is not None:
                    T_wc = T_reloc
                    self._lost_count = 0
                    self._relocalized = True
                    relocalized = True
        else:
            self._lost_count = 0
            if switch:
                self._on_keyframe_switch(rgb_u8, depth_u16, timestamp, T_eff, T_wc, res,
                                         rec["retired"])
        self._record(timestamp, T_wc, res)
        if self.viewer is not None and self._frame_count % max(self.config.viz.every_n, 1) == 0:
            self._publish_viz(rgb_u8, depth_u16, lost)
        return T_wc, relocalized

    def _publish_viz(self, rgb_u8, depth_u16, lost: bool) -> None:
        """Hand the live viewer a snapshot of host data (lossy, cheap: lists
        and references, no device read, no rendering)."""
        act = self.manager.active
        self.viewer.publish({
            "rgb": rgb_u8,
            "depth": depth_u16,
            "frame": self._frame_count - 1,
            "n_keyframes": len(self.manager.keyframes),
            "lost": lost,
            "kf_rgb": act.rgb,
            "kf_depth": act.depth,
            "kf_id": act.kf_id,
            "poses": [T for _, T in self._trajectory[-2000:]],
            "kf_poses": [k.T_wk.copy() for k in self.manager.keyframes],
            "kf_clouds": [(k.T_wk.copy(), k.cloud) for k in self.manager.keyframes
                          if k.cloud is not None],
            "depth_scale": self.config.depth_scale,
            "min_depth": self.config.min_depth,
            "max_depth": self.config.max_depth,
        })

    def _on_keyframe_switch(self, rgb_u8, depth_u16, timestamp, T_ck, T_wc, res: StepResult,
                            retired: torch.Tensor) -> None:
        old = self.manager.active
        # The retiring keyframe's fused planes are this step's input state,
        # packed in the frame's ring slot. With a back end its thread
        # finalizes them (one packed read, the cloud, then ORB and BoW), off
        # the front end's path, from a copy: a later flight reuses the slot;
        # without one, finalize runs here.
        if self.backend is None:
            self.manager.finalize(old, retired)
        new = self._new_keyframe(timestamp, T_wc, rgb_u8, depth_u16)
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
            self.backend.submit(old, retired.clone())

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
        new = self._found_keyframe(packed, timestamp, T_wc, rgb_u8, depth_u16)
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
        or (rgb, depth, timestamp) tuples) in flights; returns per-frame
        world poses.

        Up to ``flight_depth`` (default ``config.pipeline_depth``) frames are
        dispatched without a host read (the step's inputs are all on the
        device), then one read brings the flight's results back and the
        host does each frame's bookkeeping in order (``_drain``). Pose-graph
        updates from the back end are applied at the start of a flight
        only. The results equal those of a ``process_frame`` loop whenever
        no update lands mid-run."""
        depth_k = max(int(flight_depth or self.config.pipeline_depth), 1)
        fl = self._flights
        poses: List[np.ndarray] = []
        pending: List[dict] = []
        for f in frames:
            if hasattr(f, "rgb"):
                rgb, depth, t = f.rgb, f.depth, f.timestamp
            else:
                rgb, depth, t = f
            if self._kf_state is None:
                poses.append(self.process_frame(rgb, depth, t))
                continue
            if not pending:
                fl.open(self._frame_count)
            with fl.pack:
                packed = pack_frame(rgb, depth, self.config)
            packed = self._upload(packed)
            if not pending:
                self._apply_pose_updates()
            pending.append(self._dispatch(rgb, depth, t, packed, len(pending)))
            if len(pending) >= depth_k:
                poses.extend(self._drain(pending))
                pending = []
        if pending:
            poses.extend(self._drain(pending))
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
        self._flights = profiling.FlightRecorder(self.device)
        self.backend = BackendThread(self) if self.config.backend.enabled else None

    def finish(self) -> None:
        """Finalize the active keyframe and drain the back end."""
        if self._kf_state is not None and self.manager.active.cloud is None:
            self.manager.finalize(self.manager.active, self._kf_state)  # the state after the last drain
        if self.backend is not None:
            if self.manager.keyframes:
                self.backend.submit(self.manager.active)
            self.backend.finish()
            self._apply_pose_updates()
        if self.viewer is not None:
            self.viewer.close()

    def _apply_pose_updates(self) -> None:
        """Consume optimized keyframe poses from the back end (if any):
        rebase the keyframes and the recorded trajectory (each frame moves
        with its keyframe). The motion model is relative (T_ck and delta
        are keyframe- and camera-frame quantities), so it needs no
        correction. Called at the start of every flight and at finish."""
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
