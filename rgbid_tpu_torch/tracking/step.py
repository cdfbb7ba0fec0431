"""The per-frame program: decode, preprocess, track, decide, fuse or found.

Counterpart of ``rgbid_tpu/tracking/step.py:42-327, 330-571, 585-647``.
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
from .tracker import TrackResult, track


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
    """BT.601 luma, rounded (numpy; a 2-D input is already gray)."""
    if rgb_u8.ndim == 2:
        return rgb_u8
    f = rgb_u8.astype(np.float32)
    return np.clip(
        0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2] + 0.5, 0, 255
    ).astype(np.uint8)


def pack_frame(rgb_u8: np.ndarray, depth_u16: np.ndarray, cfg=None) -> np.ndarray:
    """Host side: gray u8 + depth into one (3, H, W) u8 upload buffer
    [gray, depth lo-byte, depth hi-byte] (the "u16" codec)."""
    if cfg is not None and cfg.depth_codec != "u16":
        raise NotImplementedError(
            f"depth_codec={cfg.depth_codec!r}: only 'u16' is ported (ROADMAP Queue 1 #2)"
        )
    h, w = depth_u16.shape
    d8 = np.ascontiguousarray(depth_u16).view(np.uint8).reshape(h, w, 2)
    out = np.empty((3, h, w), np.uint8)
    out[0] = gray_from_rgb(rgb_u8)
    out[1] = d8[..., 0]
    out[2] = d8[..., 1]
    return out


def decode_frame(packed_u8: torch.Tensor, cfg):
    """Device side: packed (3, H, W) u8 upload -> (gray u8, xi, mask)."""
    if packed_u8.dim() != 3 or packed_u8.shape[0] != 3:
        raise ValueError(
            f"depth_codec='u16' expects a (3, H, W) packed buffer "
            f"[gray, depth-lo, depth-hi]; got shape {tuple(packed_u8.shape)}"
        )
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
        tcfg.esm_geo_min_level,
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
