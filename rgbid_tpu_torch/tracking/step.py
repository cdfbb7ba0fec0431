"""The per-frame program: decode, preprocess, track, decide, fuse or found.

Counterpart of ``rgbid_tpu/tracking/step.py:42-327, 330-571, 585-647``,
the three upload codecs ("u16", "u12", "u16h") included. As in the JAX
package, the step reads nothing back to the host: the keep / switch / lost
choice, the fusion cadence, the consensus's reruns and rescue
(tracking/tracker.py) and the motion model are device predicates and
selects, so that frame i + 1 needs nothing from the host but its upload.
The step returns its packed ``StepResult`` as a device vector; the caller
(``SlamSystem``) reads a whole flight of them back at once.

On the card a tracked frame is one replay of a CUDA graph, the counterpart
of the JAX package's ``jax.jit``: the first tracked frame runs the step
once eagerly (the kernels build, the libraries' handles initialize, the
constants reach the card; its results and counts are dropped), then
captures it on a side stream with ``capture_error_mode="thread_local"``
(the back end's thread may launch meanwhile). Every tracked frame is then
one replay on the current stream (the default stream: one stream, one
workspace, ops/kernels.py). The graph's static buffers are the upload, the
keyframe and motion state (which the graph overwrites with the next state
at its end), the result vector and the retiring planes (what a finalize
reads of the input state). On the CPU the same step runs eagerly. There is
no eager path on the card: a failed capture raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..core import se3
from ..core.camera import Intrinsics, level_intrinsics
from ..mapping.fusion import fuse_frame
from ..mapping.keyframe import (DeviceKeyframe, create_device_keyframe, rebuild_after_fusion,
                                retire_planes, select_keyframe)
from ..ops import image
from .frames import preprocess_planes
from .tracker import TrackResult, plane_dtypes, track


class MotionState(NamedTuple):
    """Inter-frame tracking state: the constant-velocity motion model, the
    lost-frame coast-and-hold policy and the consensus streaks, all on the
    device.

    T_ck: (4, 4) pose of the last frame vs the active keyframe.
    delta: (4, 4) last inter-frame camera motion (identity while lost).
    lost_count: () f32 consecutive lost frames so far.
    cons_excluded: (consensus_bins,) f32 per-stratum consecutive-flag
    counts, the consensus persistence memory (zeroed on a lost frame).
    """

    T_ck: torch.Tensor
    delta: torch.Tensor
    lost_count: torch.Tensor
    cons_excluded: torch.Tensor = None

    @classmethod
    def initial(cls, device, cons_bins: int = 6) -> "MotionState":
        eye = torch.eye(4, dtype=torch.float32, device=device)
        return cls(T_ck=eye, delta=eye, lost_count=torch.zeros((), dtype=torch.float32, device=device),
                   cons_excluded=torch.zeros((cons_bins,), dtype=torch.float32, device=device))


class StepResult(NamedTuple):
    """Small per-frame result; travels as one packed f32 vector: the JAX
    package's layout, then the consensus's work counts (the rerun
    iterations and whether the rescue pyramid ran), which the caller adds
    to ``tracker_counts`` when it reads the vector."""

    T: np.ndarray  # (4, 4) current <- (entry) keyframe
    cov: np.ndarray  # (6, 6) pose covariance
    switch: float
    lost: float
    n_fused: float
    errors: np.ndarray  # (levels,)
    inlier_frac: np.ndarray  # (levels,)
    n_valid: np.ndarray  # (levels,)
    overlap: float
    sigma2_int: float
    sigma2_xi: float
    consensus_frac: float
    guard_fired: float
    div_trans: float
    div_rot: float
    cons_flags: float
    cons_flags_persist: float
    rescue: float
    rerun_iters: float
    rescue_ran: float

    @staticmethod
    def shapes(levels: int):
        L = levels
        return [(4, 4), (6, 6), (), (), (), (L,), (L,), (L,)] + [()] * 12

    @classmethod
    def pack(cls, fields) -> torch.Tensor:
        """Concatenate device tensors in field order into one f32 vector."""
        return torch.cat([x.reshape(-1).to(torch.float32) for x in fields])

    @classmethod
    def unpack(cls, vec, levels: int) -> "StepResult":
        v = np.asarray(vec)
        out, o = [], 0
        for shape in cls.shapes(levels):
            n = int(np.prod(shape)) if shape else 1
            out.append(v[o : o + n].reshape(shape) if shape else v[o])
            o += n
        return cls(*out)


def _native_frame(rgb_u8, shape: Optional[Tuple[int, int]] = None):
    """``rgb_u8`` as the native pass reads it (broadcast to ``shape``, the
    (h, w) of the frame's depth, as numpy's assignment broadcasts), or None
    where numpy's code runs: without a toolchain (``native.toolchain()``),
    and for what the native pass does not take (another dtype than uint8;
    not (h, w) or (h, w, >= 3)), where numpy's result or error is the
    answer."""
    if native.toolchain() is None or not isinstance(rgb_u8, np.ndarray):
        return None
    if rgb_u8.dtype != np.uint8 or not (
            rgb_u8.ndim == 2 or (rgb_u8.ndim == 3 and rgb_u8.shape[2] >= 3)):
        return None
    if shape is None or rgb_u8.shape[:2] == shape:
        return rgb_u8
    return np.broadcast_to(rgb_u8, shape + rgb_u8.shape[2:])


def gray_from_rgb_numpy(rgb_u8: np.ndarray) -> np.ndarray:
    """``gray_from_rgb`` in numpy: the oracle of the native pass, and the
    path where there is no toolchain."""
    if rgb_u8.ndim == 2:
        return rgb_u8
    c = rgb_u8.astype(np.uint32)
    return ((9798 * c[..., 0] + 19235 * c[..., 1] + 3735 * c[..., 2] + 16384) >> 15).astype(
        np.uint8
    )


def gray_from_rgb(rgb_u8: np.ndarray) -> np.ndarray:
    """BT.601 luma in 15-bit fixed point, rounded: (9798 R + 19235 G +
    3735 B + 16384) >> 15. This is OpenCV's ``cvtColor(RGB2GRAY)`` for u8
    (checked equal on all 256^3 colours against OpenCV 5.0.0), which the
    JAX package calls; a 2-D input is already gray and is returned as it
    is. One native pass over the pixels (``native/pack_frame.cpp``) where
    there is a toolchain, else ``gray_from_rgb_numpy``; the bytes are the
    same."""
    if rgb_u8.ndim == 2:
        return rgb_u8
    frame = _native_frame(rgb_u8)
    if frame is None:
        return gray_from_rgb_numpy(rgb_u8)
    out = np.empty(frame.shape[:2], np.uint8)
    native.pack_gray(frame, out)
    return out


_U12_LUTS: dict = {}


def _u12_lut(depth_scale: float, min_depth: float, max_depth: float) -> np.ndarray:
    """Raw u16 depth -> 12-bit inverse-depth code (65536 entries, cached).
    Code 0 = invalid. Validity uses the float32 arithmetic of the u16
    path (``image.inverse_depth_from_u16``: f32(raw) * f32(1 / scale),
    strict f32 compares), so both codecs give the same mask for every
    (scale, min, max); the code itself is computed in float64, as the JAX
    package computes it."""
    key = (depth_scale, min_depth, max_depth)
    lut = _U12_LUTS.get(key)
    if lut is None:
        raw = np.arange(65536, dtype=np.float64)
        xi = depth_scale / np.maximum(raw, 1.0)
        xi_min, xi_max = 1.0 / max_depth, 1.0 / min_depth
        step = (xi_max - xi_min) / 4094.0
        code = np.rint((xi - xi_min) / step).astype(np.int64) + 1
        d32 = raw.astype(np.float32) * np.float32(1.0 / depth_scale)
        valid = (d32 > np.float32(min_depth)) & (d32 < np.float32(max_depth))
        lut = np.where(valid, np.clip(code, 1, 4095), 0).astype(np.uint16)
        _U12_LUTS[key] = lut
    return lut


def pack_frame(rgb_u8: np.ndarray, depth_u16: np.ndarray, cfg=None) -> np.ndarray:
    """Host side: gray u8 + depth into one u8 upload buffer, by
    ``cfg.depth_codec`` (None: "u16"):

    - "u16": (3, H, W) [gray, depth lo-byte, depth hi-byte], exact;
    - "u12": (H, W + 3W/2), each row the gray row, then the row's 12-bit
      inverse-depth codes (``_u12_lut``) bit-packed 2 px -> 3 B; W even;
    - "u16h": (3H/2, W), the gray image, then the raw depth decimated at
      stride 2 (real sensor values, no averaging) as its bytes; H and W
      even. The device rebuilds full-resolution inverse depth with
      ``image.upsample2x_renorm``.

    The gray (``gray_from_rgb``) is one native pass over the pixels
    (``native/pack_frame.cpp``) where there is a toolchain, written straight
    into the codec's gray rows; under "u16" the same pass writes the depth's
    two byte planes. The u12 and u16h depth parts are numpy. Without a
    toolchain, or for an input the native pass does not take
    (``_native_frame``), all of it is numpy; the bytes are the same.
    ``pack_frame.native_calls`` and ``pack_frame.numpy_calls`` count the
    frames packed each way.
    """
    h, w = depth_u16.shape
    codec = "u16" if cfg is None else cfg.depth_codec
    if codec == "u12" and w % 2:
        raise ValueError(f"depth_codec='u12' needs an even width, got {w}")
    if codec == "u16h" and (h % 2 or w % 2):
        raise ValueError(f"depth_codec='u16h' needs an even height and width, got {h}x{w}")
    frame = _native_frame(rgb_u8, (h, w))
    if frame is not None and codec == "u16":
        out = native.pack_u16(frame, depth_u16)
        pack_frame.native_calls += 1
        return out
    if codec == "u12":
        code = _u12_lut(cfg.depth_scale, cfg.min_depth, cfg.max_depth)[depth_u16]
        v = code.reshape(h, w // 2, 2)
        v0, v1 = v[..., 0], v[..., 1]
        trip = np.empty((h, w // 2, 3), np.uint8)
        trip[..., 0] = v0 >> 4
        trip[..., 1] = ((v0 & 0xF) << 4) | (v1 >> 8)
        trip[..., 2] = v1 & 0xFF
        out = np.empty((h, w + (3 * w) // 2), np.uint8)
        out[:, w:] = trip.reshape(h, (3 * w) // 2)
        gray = out[:, :w]
    elif codec == "u16h":
        out = np.empty((h + h // 2, w), np.uint8)
        out[h:] = np.ascontiguousarray(depth_u16[::2, ::2]).view(np.uint8).reshape(h // 2, w)
        gray = out[:h]
    else:
        d8 = np.ascontiguousarray(depth_u16).view(np.uint8).reshape(h, w, 2)
        out = np.empty((3, h, w), np.uint8)
        out[1] = d8[..., 0]
        out[2] = d8[..., 1]
        gray = out[0]
    if frame is None:
        gray[...] = gray_from_rgb_numpy(rgb_u8)
        pack_frame.numpy_calls += 1
    else:
        native.pack_gray(frame, gray)
        pack_frame.native_calls += 1
    return out


pack_frame.native_calls = 0
pack_frame.numpy_calls = 0


def check_packed_shape(shape: tuple, cfg) -> None:
    """Raise ValueError when a packed buffer of ``shape`` was not made by
    ``pack_frame`` with ``cfg.depth_codec`` (``decode_frame``'s check)."""
    if cfg.depth_codec == "u12":
        if len(shape) != 2 or shape[1] % 5 != 0:
            raise ValueError(
                f"depth_codec='u12' expects a (H, 5*W/2) packed buffer from "
                f"pack_frame(..., cfg) with the same codec; got shape {shape}. (A "
                f"(3, H, W) buffer means the frame was packed with the 'u16' codec.)"
            )
    elif cfg.depth_codec == "u16h":
        # An even width as well as rows divisible by 3: a (H, 5W/2) u12
        # buffer then passes only when W % 4 == 0 and H % 3 == 0 (the JAX
        # package's check).
        if len(shape) != 2 or shape[0] % 3 != 0 or shape[1] % 2 != 0:
            raise ValueError(
                f"depth_codec='u16h' expects a (3H/2, W) packed buffer (W even) from "
                f"pack_frame(..., cfg) with the same codec; got shape {shape}. (A (3, H, W) "
                f"buffer means the frame was packed with the 'u16' codec; a (H, 5W/2) one "
                f"with 'u12'.)"
            )
    elif len(shape) != 3 or shape[0] != 3:
        raise ValueError(
            f"depth_codec='u16' expects a (3, H, W) packed buffer [gray, depth-lo, "
            f"depth-hi]; got shape {shape}. (A 2-D buffer means the frame was packed "
            f"with the 'u12' or 'u16h' codec: pass the same cfg to pack_frame and "
            f"SlamSystem.)"
        )


def unpack_frame(packed_u8: torch.Tensor):
    """Device side: the u16 codec's inverse, (3, H, W) -> (gray u8, depth).
    The depth holds the raw u16 values in int32 (``torch.uint16`` lacks
    the shift and ``or`` on some backends)."""
    return packed_u8[0], packed_u8[1].to(torch.int32) | (packed_u8[2].to(torch.int32) << 8)


def decode_frame(packed_u8: torch.Tensor, cfg):
    """Device side: a packed upload -> (gray u8, xi, mask), by
    ``cfg.depth_codec``. Plain PyTorch ops, as the JAX package's decode is
    XLA. u12 rebuilds xi from its code with no divide; u16h decodes the
    half-resolution raw depth like u16, then upsamples. A buffer packed
    with another codec raises ValueError (its shape tells)."""
    shape = tuple(packed_u8.shape)
    check_packed_shape(shape, cfg)
    if cfg.depth_codec == "u12":
        h, w = shape[0], (shape[1] * 2) // 5
        gray = packed_u8[:, :w]
        trip = packed_u8[:, w:].reshape(h, w // 2, 3).to(torch.int32)
        b0, b1, b2 = trip[..., 0], trip[..., 1], trip[..., 2]
        v0 = (b0 << 4) | (b1 >> 4)
        v1 = ((b1 & 0xF) << 8) | b2
        code = torch.stack([v0, v1], -1).reshape(h, w)
        xi_min, xi_max = 1.0 / cfg.max_depth, 1.0 / cfg.min_depth
        step = (xi_max - xi_min) / 4094.0
        mask = (code > 0).to(torch.float32)
        xi = ((code.to(torch.float32) - 1.0) * step + xi_min) * mask
        return gray, xi, mask
    if cfg.depth_codec == "u16h":
        h = (shape[0] * 2) // 3
        gray = packed_u8[:h]
        d8 = packed_u8[h:]
        d16 = d8[:, 0::2].to(torch.int32) | (d8[:, 1::2].to(torch.int32) << 8)
        xi_h, mask_h = image.inverse_depth_from_u16(d16, cfg.depth_scale, cfg.min_depth,
                                                    cfg.max_depth)
        xi, mask = image.upsample2x_renorm(xi_h, mask_h)
        return gray, xi, mask
    gray, d16 = unpack_frame(packed_u8)
    xi, mask = image.inverse_depth_from_u16(d16, cfg.depth_scale, cfg.min_depth, cfg.max_depth)
    return gray, xi, mask


def frame_pyramid(packed_u8: torch.Tensor, cfg):
    tcfg = cfg.tracking
    gray, xi, mask = decode_frame(packed_u8, cfg)
    intensity = gray.to(torch.float32) * (1.0 / 255.0)
    return preprocess_planes(
        intensity, xi, mask, tcfg.levels, tcfg.jacobian == "esm", tcfg.esm_min_level,
        tcfg.esm_geo_min_level, plane_dtypes(tcfg)[0],
    )


def _solve_spd(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B through Cholesky; NaN where the factorization fails (the
    JAX package's cho_factor semantics), without a device read."""
    L, info = torch.linalg.cholesky_ex(A)
    X = torch.cholesky_solve(B, L)
    return torch.where(info == 0, X, torch.full_like(X, float("nan")))


class _Graph(NamedTuple):
    """One captured step: the graph, its static buffers, and the launches a
    replay makes per counter."""

    graph: "torch.cuda.CUDAGraph"
    packed: torch.Tensor
    kf: DeviceKeyframe
    motion: MotionState
    res: torch.Tensor
    retired: Optional[torch.Tensor]
    counts: dict
    slots: np.ndarray
    nodes: int


def _counters():
    """(object, attribute) of every launch count a step adds to."""
    from ..mapping import fusion
    from ..ops import kernels
    from . import consensus

    return ((kernels.esm_residuals_and_normal_eq, "launches"), (kernels.esm_stratified, "launches"),
            (kernels.ic_normal_eq, "launches"), (kernels.ic_normal_eq, "sigma_phases"),
            (kernels.ic_sigma_stats, "launches"), (kernels.irls_solve_step, "launches"),
            (fusion.fuse_frame, "launches"), (consensus.consensus_vote, "launches"))


def _read_counts():
    from ..ops import kernels

    return {c: getattr(*c) for c in _counters()}, kernels._LAUNCHED.copy()


def _write_counts(counts, slots) -> None:
    from ..ops import kernels

    for (obj, attr), v in counts.items():
        setattr(obj, attr, v)
    kernels._LAUNCHED[:] = slots


class ProcessFrame:
    """The per-frame step bound to (intrinsics, config, device).

    ``__call__(packed, kf, motion)`` returns (the packed StepResult as a
    device vector, the next keyframe state, the next motion state) and
    reads nothing back. On the card these are the graph's buffers: the next
    call overwrites them, so a caller copies what must outlive it (the
    system keeps the vector; ``retired`` is the packed planes a finalize
    of the call's input keyframe reads, when ``retire`` = (reloc level,
    cloud stride) is given). ``host_reads`` counts the reads of result
    vectors (``read``), ``rerun_iters`` and ``rescues`` what those vectors
    report: the IRLS iterations of the consensus's masked reruns and the
    rescue pyramids run (each 40 iterations at the default iters plus two
    level-0 evaluations). ``replays`` and ``captures`` count the graph's.

    In IC mode the consensus is off, as in the JAX package."""

    def __init__(self, intr: Intrinsics, cfg, device, retire=None):
        self.intr = intr
        self.cfg = cfg
        self.device = torch.device(device)
        self.intrs = tuple(level_intrinsics(intr, l) for l in range(cfg.tracking.levels))
        self.retire = retire
        self.retired: Optional[torch.Tensor] = None
        self.host_reads = 0
        self.rerun_iters = 0
        self.rescues = 0
        self.replays = 0
        self.captures = 0
        self._graph: Optional[_Graph] = None

    def init_keyframe(self, packed_u8: torch.Tensor) -> DeviceKeyframe:
        return self._found(frame_pyramid(packed_u8, self.cfg))

    def _found(self, cur) -> DeviceKeyframe:
        """A new keyframe from the frame pyramid ``cur``."""
        tcfg = self.cfg.tracking
        return create_device_keyframe(cur, self.intr, self.cfg.fusion, tcfg.jac_dtype, tcfg.jacobian)

    def read(self, vecs: torch.Tensor) -> np.ndarray:
        """One host read of (stacked) result vectors; their consensus work
        is added to ``rerun_iters`` and ``rescues``."""
        self.host_reads += 1
        out = vecs.cpu().numpy()
        rows = out.reshape(-1, out.shape[-1])
        self.rerun_iters += int(round(float(rows[:, -2].sum())))
        self.rescues += int(round(float(rows[:, -1].sum())))
        return out

    @property
    def graph_nodes(self) -> int:
        """The captured graph's node count (0 before the capture)."""
        return 0 if self._graph is None else self._graph.nodes

    def __call__(
        self, packed_u8: torch.Tensor, kf: DeviceKeyframe, motion: MotionState
    ) -> Tuple[torch.Tensor, DeviceKeyframe, MotionState]:
        if self.device.type != "cuda":
            res, kf2, motion2 = self.step(packed_u8, kf, motion)
            if self.retire is not None:
                self.retired = retire_planes(kf, *self.retire)[0]
            return res, kf2, motion2
        g = self._graph
        if g is None or g.packed.shape != packed_u8.shape:
            g = self._graph = self._capture(packed_u8, kf, motion)
        if packed_u8 is not g.packed:
            g.packed.copy_(packed_u8)
        if kf is not g.kf:
            for dst, src in zip(g.kf.tensors(), kf.tensors()):
                dst.copy_(src)
        if motion is not g.motion:
            for dst, src in zip(g.motion, motion):
                dst.copy_(src)
        g.graph.replay()
        self.replays += 1
        for (obj, attr), v in g.counts.items():
            setattr(obj, attr, getattr(obj, attr) + v)
        from ..ops import kernels

        kernels._LAUNCHED[:] += g.slots
        self.retired = g.retired
        return g.res.clone(), g.kf, g.motion

    def _capture(self, packed_u8, kf: DeviceKeyframe, motion: MotionState) -> _Graph:
        """Warm the step up eagerly, then capture it (see the module
        docstring). Neither adds to any launch or iteration count."""
        from ..ops import kernels

        dev = self.device
        counts0, slots0 = _read_counts()
        runs0 = kernels.workspace(dev).runs.clone()
        self.step(packed_u8, kf, motion)
        if self.retire is not None:
            retire_planes(kf, *self.retire)
        _write_counts(counts0, slots0)
        kernels.workspace(dev).runs.copy_(runs0)
        s_packed = packed_u8.clone()
        s_kf = DeviceKeyframe.from_tensors([t.clone() for t in kf.tensors()], len(kf.levels))
        s_motion = MotionState(*(t.clone() for t in motion))
        # keep_graph: the captured graph stays readable for its node count;
        # it is instantiated right after.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        side = torch.cuda.Stream(dev)
        retired = None
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            res, kf2, motion2 = self.step(s_packed, s_kf, s_motion)
            if self.retire is not None:
                retired = retire_planes(s_kf, *self.retire)[0]
            # The next state into the input buffers, after every read of them.
            for dst, src in zip(s_kf.tensors(), kf2.tensors()):
                dst.copy_(src)
            for dst, src in zip(s_motion, motion2):
                dst.copy_(src)
        counts1, slots1 = _read_counts()
        _write_counts(counts0, slots0)
        nodes = _graph_nodes(graph)
        graph.instantiate()
        self.captures += 1
        deltas = {c: counts1[c] - counts0[c] for c in counts0}
        return _Graph(graph, s_packed, s_kf, s_motion, res, retired, deltas, slots1 - slots0,
                      nodes)

    def step(
        self, packed_u8: torch.Tensor, kf: DeviceKeyframe, motion: MotionState
    ) -> Tuple[torch.Tensor, DeviceKeyframe, MotionState]:
        """The step itself, eagerly: (packed StepResult as a device vector,
        new keyframe state, new motion state), with no host read."""
        cfg = self.cfg
        tcfg, kcfg, fcfg = cfg.tracking, cfg.keyframe, cfg.fusion
        dev = self.device
        eye4 = torch.eye(4, dtype=torch.float32, device=dev)
        cur = frame_pyramid(packed_u8, cfg)
        # Constant-velocity prediction.
        T_init = se3.orthonormalize(se3.inv(motion.delta) @ motion.T_ck)
        tr: TrackResult = track(kf.levels, cur, T_init, self.intrs, tcfg, tcfg.jac_dtype,
                                cons_prev=motion.cons_excluded)

        # Pose covariance: inverse of the final (un-normalized) normal matrix.
        Hd = tr.H * torch.clamp(tr.n_valid[0], min=1.0) + 1e-8 * torch.eye(
            6, dtype=torch.float32, device=dev
        )
        cov = _solve_spd(Hd, torch.eye(6, dtype=torch.float32, device=dev))

        finite = torch.isfinite(tr.T).all()
        lost = (~finite) | (tr.n_valid[0] < tcfg.min_valid_fraction * tr.kf_count)
        D = se3.inv(T_init) @ tr.T
        div_t = torch.linalg.vector_norm(D[:3, 3])
        div_r = se3.rotation_angle(D[:3, :3])
        # Stress flags: strata flagged this frame, and persistently.
        stress_n = (tr.cons_excluded > 0.5).to(torch.float32).sum()
        stress_p = (tr.cons_excluded >= float(tcfg.consensus_persist)).to(torch.float32).sum()
        guard_fired = torch.zeros((), dtype=torch.bool, device=dev)
        if tcfg.divergence_guard and tcfg.consensus:
            # "Confidently wrong": divergence from the prior while stress
            # flags persist declares the frame lost.
            guard_fired = (((div_t > tcfg.div_trans_thresh) | (div_r > tcfg.div_rot_thresh))
                           & (stress_p > 0.5) & finite)
            lost = lost | guard_fired
        t_norm = torch.linalg.vector_norm(tr.T[:3, 3])
        angle = se3.rotation_angle(tr.T[:3, :3])
        sigma_t = torch.sqrt(torch.clamp(torch.trace(cov[:3, :3]), min=0.0))
        switch = (
            (tr.overlap < kcfg.min_overlap)
            | (t_norm > kcfg.max_translation)
            | (angle > kcfg.max_rotation)
            | (sigma_t > kcfg.max_pose_sigma)
        )
        if tcfg.rescue_refound and tcfg.consensus:
            # A rescue that corrected the pose refounds the keyframe.
            switch = switch | (tr.rescue > 0.5)
        switch = switch & ~lost

        # Three-way, by predicate: lost -> the state as it was; switch -> a
        # new keyframe from this frame; else fuse (on the cadence) or only
        # advance the count. Every branch is made and the state selected.
        found = self._found(cur)
        if fcfg.enabled:
            keep = ~lost & ~switch
            if fcfg.fuse_every > 1:
                keep_fuse = keep & (kf.fused_count % fcfg.fuse_every == 0)
            else:
                keep_fuse = keep
            fused, n_fused = self._fuse(kf, cur, tr.T, cov, keep_fuse.to(torch.int32))
            counted = kf._replace(fused_count=kf.fused_count + 1)
            kf2 = select_keyframe(lost, kf, select_keyframe(
                switch, found, select_keyframe(keep_fuse, fused, counted)))
        else:
            n_fused = torch.zeros((), dtype=torch.float32, device=dev)
            kf2 = select_keyframe(switch, found, kf)

        # Motion model: coast one prediction step on the first lost frame,
        # then hold; reset the velocity and the consensus streaks while
        # lost; re-anchor at identity on a new keyframe.
        first_lost = motion.lost_count < 0.5
        T_eff = torch.where(lost, torch.where(first_lost, T_init, motion.T_ck), tr.T)
        motion2 = MotionState(
            T_ck=torch.where(switch, eye4, T_eff),
            delta=torch.where(lost, eye4, se3.orthonormalize(motion.T_ck @ se3.inv(tr.T))),
            lost_count=torch.where(lost, motion.lost_count + 1.0, torch.zeros_like(motion.lost_count)),
            cons_excluded=torch.where(lost, torch.zeros_like(tr.cons_excluded), tr.cons_excluded),
        )
        res = StepResult.pack([
            T_eff, cov, switch, lost, n_fused, tr.errors, tr.inlier_frac, tr.n_valid,
            tr.overlap, tr.sigma2_int, tr.sigma2_xi, tr.consensus_frac, guard_fired, div_t, div_r,
            stress_n, stress_p, tr.rescue, tr.rerun_iters, tr.rescue_ran,
        ])
        return res, kf2, motion2

    def _fuse(self, kf: DeviceKeyframe, cur, T, cov, go):
        """One fusion launch (the pose-noise floor, hole guess, Kalman
        update, hit counts and mask; the planes copied through where ``go``
        is 0), then the template rebuild."""
        cfg = self.cfg
        fcfg, tcfg = cfg.fusion, cfg.tracking
        xi2, var2, mask2, hits2, n_fused = fuse_frame(
            kf.levels, kf.var, kf.mask_full, kf.hits, cur[0].xi, cur[0].mask, T, cov,
            self.intrs[0], fcfg, go=go,
        )
        kf2 = rebuild_after_fusion(
            kf, xi2, var2, mask2, hits2, self.intr, tcfg.jac_dtype, tcfg.jacobian,
            fcfg.coarse_rebuild_every, confirm_hits=fcfg.confirm_hits,
            fine_every=fcfg.fine_rebuild_every,
        )
        return kf2, n_fused


def _graph_nodes(graph) -> int:
    """The node count of a captured graph (kept, not yet instantiated),
    through the driver's ``cuGraphGetNodes`` on ``raw_cuda_graph``; -1
    where the driver library cannot be loaded."""
    import ctypes

    try:
        drv = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return -1
    n = ctypes.c_size_t(0)
    status = drv.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if status == 0 else -1
