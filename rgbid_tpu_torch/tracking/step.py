"""The per-frame program: decode, preprocess, track, decide, fuse or found.

Counterpart of ``rgbid_tpu/tracking/step.py:42-327, 330-571, 585-647``,
the three upload codecs ("u16", "u12", "u16h") included.
The JAX package keeps the keep/switch/lost choice and the fusion cadence
on the device (``lax.switch``, ``lax.cond``) so that a whole flight of
frames runs without a host read. Here they are Python branches: after
tracking, the frame reads its packed result (lost and switch flags
included) back once, then runs exactly one branch. The fusion cadence
needs no read, because ``DeviceKeyframe.fused_count`` is a host integer.
A fused frame reads ``n_fused`` back at its end. In ESM mode the motion
consensus adds one read per vote (two a frame) and one on a frame whose
rescue runs (tracking/tracker.py). ``ProcessFrame.host_reads`` counts them
all.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import se3
from ..core.camera import Intrinsics, level_intrinsics
from ..mapping.fusion import fuse_frame
from ..mapping.keyframe import DeviceKeyframe, create_device_keyframe, rebuild_after_fusion
from ..ops import image
from .frames import preprocess_planes
from .tracker import TrackResult, plane_dtypes, track


class MotionState(NamedTuple):
    """Inter-frame tracking state: the constant-velocity motion model, the
    lost-frame coast-and-hold policy and the consensus streaks.

    T_ck: (4, 4) pose of the last frame vs the active keyframe.
    delta: (4, 4) last inter-frame camera motion (identity while lost).
    lost_count: () f32 consecutive lost frames so far.
    cons_excluded: (consensus_bins,) f32 per-stratum consecutive-flag
    counts, the consensus persistence memory (zeroed on a lost frame). It
    lives on the HOST as a numpy array: the consensus decisions that read
    and update it run on the host (tracking/tracker.py).
    """

    T_ck: torch.Tensor
    delta: torch.Tensor
    lost_count: torch.Tensor
    cons_excluded: np.ndarray = None

    @classmethod
    def initial(cls, device, cons_bins: int = 6) -> "MotionState":
        eye = torch.eye(4, dtype=torch.float32, device=device)
        return cls(T_ck=eye, delta=eye, lost_count=torch.zeros((), dtype=torch.float32, device=device),
                   cons_excluded=np.zeros((cons_bins,), np.float32))


class StepResult(NamedTuple):
    """Small per-frame result; travels as one packed f32 vector in the JAX
    package's layout. The consensus fields that come out of host decisions
    (consensus_frac, cons_flags, cons_flags_persist, rescue) are written
    into the host vector after the read."""

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

    @staticmethod
    def shapes(levels: int):
        L = levels
        return [(4, 4), (6, 6), (), (), (), (L,), (L,), (L,), (), (), (), (), (), (), (), (), (), ()]

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


# Offsets in the packed vector, after T (16 floats) and cov (36); the
# fields after the three per-level vectors depend on the level count.
_SWITCH, _LOST, _N_FUSED = 52, 53, 54


def _tail_offsets(levels: int):
    """(consensus_frac, cons_flags, cons_flags_persist, rescue) offsets."""
    o = 55 + 3 * levels + 3  # overlap, sigma2_int, sigma2_xi
    return o, o + 4, o + 5, o + 6


def gray_from_rgb(rgb_u8: np.ndarray) -> np.ndarray:
    """BT.601 luma in 15-bit fixed point, rounded: (9798 R + 19235 G +
    3735 B + 16384) >> 15. This is OpenCV's ``cvtColor(RGB2GRAY)`` for u8
    (checked equal on all 256^3 colours against OpenCV 5.0.0), which the
    JAX package calls; a 2-D input is already gray."""
    if rgb_u8.ndim == 2:
        return rgb_u8
    c = rgb_u8.astype(np.uint32)
    return ((9798 * c[..., 0] + 19235 * c[..., 1] + 3735 * c[..., 2] + 16384) >> 15).astype(
        np.uint8
    )


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
    """
    h, w = depth_u16.shape
    gray = gray_from_rgb(rgb_u8)
    codec = "u16" if cfg is None else cfg.depth_codec
    if codec == "u12":
        if w % 2:
            raise ValueError(f"depth_codec='u12' needs an even width, got {w}")
        code = _u12_lut(cfg.depth_scale, cfg.min_depth, cfg.max_depth)[depth_u16]
        v = code.reshape(h, w // 2, 2)
        v0, v1 = v[..., 0], v[..., 1]
        trip = np.empty((h, w // 2, 3), np.uint8)
        trip[..., 0] = v0 >> 4
        trip[..., 1] = ((v0 & 0xF) << 4) | (v1 >> 8)
        trip[..., 2] = v1 & 0xFF
        out = np.empty((h, w + (3 * w) // 2), np.uint8)
        out[:, :w] = gray
        out[:, w:] = trip.reshape(h, (3 * w) // 2)
        return out
    if codec == "u16h":
        if h % 2 or w % 2:
            raise ValueError(f"depth_codec='u16h' needs an even height and width, got {h}x{w}")
        out = np.empty((h + h // 2, w), np.uint8)
        out[:h] = gray
        out[h:] = np.ascontiguousarray(depth_u16[::2, ::2]).view(np.uint8).reshape(h // 2, w)
        return out
    d8 = np.ascontiguousarray(depth_u16).view(np.uint8).reshape(h, w, 2)
    out = np.empty((3, h, w), np.uint8)
    out[0] = gray
    out[1] = d8[..., 0]
    out[2] = d8[..., 1]
    return out


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
    gray = packed_u8[0]
    d16 = packed_u8[1].to(torch.int32) | (packed_u8[2].to(torch.int32) << 8)
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


class ProcessFrame:
    """The per-frame step bound to (intrinsics, config, device).

    ``host_reads`` counts device-to-host reads made by ``__call__``;
    ``rerun_iters`` and ``rescues`` count the IRLS iterations of the
    consensus's masked reruns and the rescue pyramids run (each 40
    iterations at the default iters plus two level-0 evaluations).

    In IC mode the consensus is off, as in the JAX package."""

    def __init__(self, intr: Intrinsics, cfg, device):
        self.intr = intr
        self.cfg = cfg
        self.device = torch.device(device)
        self.intrs = tuple(level_intrinsics(intr, l) for l in range(cfg.tracking.levels))
        self.host_reads = 0
        self.rerun_iters = 0
        self.rescues = 0

    def init_keyframe(self, packed_u8: torch.Tensor) -> DeviceKeyframe:
        return self._found(frame_pyramid(packed_u8, self.cfg))

    def _found(self, cur) -> DeviceKeyframe:
        """A new keyframe from the frame pyramid ``cur``."""
        tcfg = self.cfg.tracking
        return create_device_keyframe(cur, self.intr, self.cfg.fusion, tcfg.jac_dtype, tcfg.jacobian)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        self.host_reads += 1
        return t.cpu().numpy()

    def __call__(
        self, packed_u8: torch.Tensor, kf: DeviceKeyframe, motion: MotionState
    ) -> Tuple[np.ndarray, DeviceKeyframe, MotionState]:
        """Returns (packed StepResult as a host vector, new keyframe state,
        new motion state)."""
        cfg = self.cfg
        tcfg, kcfg, fcfg = cfg.tracking, cfg.keyframe, cfg.fusion
        dev = self.device
        eye4 = torch.eye(4, dtype=torch.float32, device=dev)
        cur = frame_pyramid(packed_u8, cfg)
        # Constant-velocity prediction.
        T_init = se3.orthonormalize(se3.inv(motion.delta) @ motion.T_ck)
        tr: TrackResult = track(kf.levels, cur, T_init, self.intrs, tcfg, tcfg.jac_dtype,
                                cons_prev=motion.cons_excluded, read=self._read)
        self.rerun_iters += tr.rerun_iters
        self.rescues += int(tr.rescue_ran)

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
        # Stress flags (host): strata flagged this frame, and persistently.
        stress_n = float((tr.cons_excluded > 0.5).sum())
        stress_p = float((tr.cons_excluded >= float(tcfg.consensus_persist)).sum())
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        guard_fired = zero > 0.0
        if tcfg.divergence_guard and tcfg.consensus and stress_p > 0.5:
            # "Confidently wrong": divergence from the prior while stress
            # flags persist declares the frame lost.
            guard_fired = ((div_t > tcfg.div_trans_thresh) | (div_r > tcfg.div_rot_thresh)) & finite
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
        if tcfg.rescue_refound and tcfg.consensus and tr.rescue > 0.5:
            # A rescue that corrected the pose refounds the keyframe.
            switch = torch.ones_like(switch)
        switch = switch & ~lost
        first_lost = motion.lost_count < 0.5
        T_eff = torch.where(lost, torch.where(first_lost, T_init, motion.T_ck), tr.T)
        fields = [
            T_eff, cov, switch, lost, zero, tr.errors, tr.inlier_frac, tr.n_valid,
            tr.overlap, tr.sigma2_int, tr.sigma2_xi, zero, guard_fired, div_t, div_r,
            zero, zero, zero,
        ]
        # The frame's one mandatory host read: the branch below needs the
        # lost and switch flags.
        res = self._read(StepResult.pack(fields))
        o_frac, o_flags, o_persist, o_rescue = _tail_offsets(tcfg.levels)
        res[o_frac], res[o_flags], res[o_persist] = tr.consensus_frac, stress_n, stress_p
        res[o_rescue] = tr.rescue
        is_lost = bool(res[_LOST] > 0.5)
        is_switch = bool(res[_SWITCH] > 0.5)

        # Three-way: lost -> no-op; switch -> new keyframe; else fuse.
        n_fused = None
        if is_lost:
            kf2 = kf
        elif is_switch:
            kf2 = self._found(cur)
        elif not fcfg.enabled:
            kf2 = kf
        elif fcfg.fuse_every > 1 and kf.fused_count % fcfg.fuse_every != 0:
            # Off-cycle: the count still advances so the cadence holds.
            kf2 = kf._replace(fused_count=kf.fused_count + 1)
        else:
            kf2, n_fused = self._fuse(kf, cur, tr.T, cov)
        if n_fused is not None:
            res[_N_FUSED] = self._read(n_fused)

        # Motion model: coast one prediction step on the first lost frame,
        # then hold; reset the velocity and the consensus streaks while
        # lost; re-anchor at identity on a new keyframe.
        if is_lost:
            T_ck_new = T_eff
            delta_new = eye4
            lost_count = motion.lost_count + 1.0
            streaks = np.zeros_like(tr.cons_excluded)
        else:
            T_ck_new = eye4 if is_switch else tr.T
            delta_new = se3.orthonormalize(motion.T_ck @ se3.inv(tr.T))
            lost_count = torch.zeros_like(motion.lost_count)
            streaks = tr.cons_excluded
        motion2 = MotionState(T_ck=T_ck_new, delta=delta_new, lost_count=lost_count,
                              cons_excluded=streaks)
        return res, kf2, motion2

    def _fuse(self, kf: DeviceKeyframe, cur, T, cov):
        """One fusion launch on the card (the pose-noise floor, hole guess,
        Kalman update, hit counts and mask), then the template rebuild."""
        cfg = self.cfg
        fcfg, tcfg = cfg.fusion, cfg.tracking
        xi2, var2, mask2, hits2, n_fused = fuse_frame(
            kf.levels, kf.var, kf.mask_full, kf.hits, cur[0].xi, cur[0].mask, T, cov,
            self.intrs[0], fcfg,
        )
        kf2 = rebuild_after_fusion(
            kf, xi2, var2, mask2, hits2, self.intr, tcfg.jac_dtype, tcfg.jacobian,
            fcfg.coarse_rebuild_every, confirm_hits=fcfg.confirm_hits,
            fine_every=fcfg.fine_rebuild_every,
        )
        return kf2, n_fused
