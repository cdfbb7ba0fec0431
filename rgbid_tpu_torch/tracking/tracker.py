"""Coarse-to-fine IRLS tracker, ESM and IC, with the motion consensus.

Counterpart of ``rgbid_tpu/tracking/tracker.py:40-1027``: affine
illumination (ESM), the template stride with stride-scaled backprojection
intrinsics, the level loop (the ESM kernel with the occlusion-gate cap at
the finest level, or the IC kernels in either sigma mode), the ESM
tracker's depth-stratified motion consensus (the episode mask, the votes
after the coarse levels with their same-level masked reruns, the attack
probe, ``div_rescue``, the rescue pyramid accepted on level-0 evidence,
the streak update and transfer), the overlap / kf_count tail, and the
standalone ``Tracker``. The JAX package runs its consensus only in ESM
mode, and so does this one. The TPU-only tiling and the
``RGBID_DEBUG_LEVELS`` debug print are not ported.

The IRLS loop is a Python loop over ``cfg.iters``. Each iteration is one
call of ``esm_irls_step`` or ``ic_irls_step``: on the card, one kernel
launch that evaluates, solves and updates the pose (IC exact mode runs its
scale steps inside it), and no other op; nothing in the loop reads a device
value back to the host.

The consensus branches on the host where the JAX package uses
``lax.cond``. A vote is one ``esm_stratified`` launch and one read of its
(K, 50) sums and the baseline scale; ``analyze`` / ``decide``
(tracking/consensus.py), the member vectors and the streak counts are host
numpy. A rescue reads its two evidence errors and the correction's size
once; ``div_rescue`` reads the divergence once on a frame whose flagged
strata could let it fire. Every read goes through ``read``, so a caller can
count them. Masked template masks are built from per-level stratum-index
planes by device ops: no host vector is uploaded.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import se3
from ..core.camera import Intrinsics, level_intrinsics
from ..ops.gauss_newton import round_jac, unpack_stratified
from ..ops.kernels import esm_irls_step, esm_residuals_and_normal_eq, esm_stratified, ic_irls_step
from ..ops.warp import backproject_grid
from . import consensus as cons
from .frames import FrameLevel, KeyframeLevel

_F32 = np.float32


def check_tracking_supported(t) -> None:
    """Raise NotImplementedError for a TrackingConfig setting this port does
    not run yet, naming the ROADMAP item that brings it."""
    unsupported = [
        (t.plane_dtype != "f32", f"tracking.plane_dtype={t.plane_dtype!r}", "ROADMAP Queue 1 #7"),
        (t.early_exit_tol > 0, "tracking.early_exit_tol > 0", "ROADMAP Queue 1 #7"),
        (t.conv_skip_tol > 0, "tracking.conv_skip_tol > 0", "ROADMAP Queue 1 #7"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(f"rgbid_tpu_torch does not run {what} yet ({item})")


def _apply_affine_illumination(
    kf: Tuple[KeyframeLevel, ...], cur: Tuple[FrameLevel, ...], jac_dtype: str
) -> Tuple[KeyframeLevel, ...]:
    """Estimate a global gain/bias (I_cur ~= a I_kf + b) by moment matching
    at level 0 and bake it into the template: intensity' = a I + b,
    intensity-gradient planes scaled by a. The stored keyframe is not
    changed."""
    kl, cl = kf[0], cur[0]
    n = float(kl.intensity.numel())
    mean_k = kl.intensity.sum() / n
    var_k = torch.clamp((kl.intensity * kl.intensity).sum() / n - mean_k * mean_k, min=1e-8)
    mean_c = cl.intensity.sum() / n
    var_c = torch.clamp((cl.intensity * cl.intensity).sum() / n - mean_c * mean_c, min=1e-8)
    # A near-textureless image carries no gain information: identity gain.
    textured = torch.minimum(var_k, var_c) > 4e-4
    one = torch.ones_like(mean_k)
    a = torch.where(textured, torch.clamp(torch.sqrt(var_c / var_k), 0.7, 1.5), one)
    b = torch.clamp(mean_c - a * mean_k, -0.3, 0.3)
    # Dead zone: below ~2% gain / 1% bias the correction costs more than
    # it fixes, so snap to identity.
    a = torch.where(torch.abs(a - 1.0) < 0.02, one, a)
    b = torch.where(torch.abs(b) < 0.01, torch.zeros_like(b), b)
    out = []
    for lvl in kf:
        gi = round_jac(lvl.jac[:2] * a, jac_dtype)
        out.append(
            KeyframeLevel(
                intensity=a * lvl.intensity + b,
                xi=lvl.xi,
                mask=lvl.mask,
                jac=torch.cat([gi, lvl.jac[2:]], dim=0),
            )
        )
    return tuple(out)


class TrackResult(NamedTuple):
    """Per-frame tracking output: small device tensors, and the consensus
    fields on the host (they come out of host decisions)."""

    T: torch.Tensor  # (4, 4) current <- keyframe
    H: torch.Tensor  # (6, 6) final-level normal matrix, per valid pixel
    errors: torch.Tensor  # (levels,) weighted MSE after each level
    inlier_frac: torch.Tensor  # (levels,)
    n_valid: torch.Tensor  # (levels,)
    overlap: torch.Tensor  # () dropout-normalized valid fraction (finest)
    sigma2_int: torch.Tensor
    sigma2_xi: torch.Tensor
    kf_count: torch.Tensor  # () valid pixels of the APPLIED finest template mask
    # Pixel fraction masked out by the consensus (the largest over the vote
    # levels; 0 when nothing acted or the consensus is off).
    consensus_frac: float = 0.0
    # (consensus_bins,) f32 numpy: per-stratum consecutive-flag counts after
    # this frame, for the next frame's persistence gates (MotionState).
    cons_excluded: Optional[np.ndarray] = None
    # 1.0 when a rescue re-track was accepted AND corrected the pose by more
    # than rescue_refound_min_trans / _rot (the keyframe-refound trigger).
    rescue: float = 0.0
    # What the frame ran beyond its plain pyramid: IRLS iterations of the
    # masked same-level reruns, and whether the rescue pyramid (all levels
    # plus two level-0 evidence evaluations) ran.
    rerun_iters: int = 0
    rescue_ran: bool = False


def template_level(kl: KeyframeLevel, intr_l: Intrinsics, s: int):
    """One level's template as the kernels read it: every s-th row and
    column of every plane, the ESM gradients or the IC field included
    (contiguous copies), and the backprojected points.

    Strided pixel (i, j) is pixel (s i, s j) of the level, so
    backprojection uses plain 1/s-scaled intrinsics while projection (in
    the kernel) keeps ``intr_l``. Returns (strided level, (X, Y, Z))."""
    intr_bp = intr_l
    if s > 1:
        kl = KeyframeLevel(
            intensity=kl.intensity[::s, ::s].contiguous(),
            xi=kl.xi[::s, ::s].contiguous(),
            mask=kl.mask[::s, ::s].contiguous(),
            jac=kl.jac[:, ::s, ::s].contiguous(),
        )
        intr_bp = Intrinsics(
            fx=intr_l.fx / s, fy=intr_l.fy / s, cx=intr_l.cx / s, cy=intr_l.cy / s,
            width=kl.xi.shape[1], height=kl.xi.shape[0],
        )
    return kl, backproject_grid(kl.xi, intr_bp)


_EDGES: dict = {}


def _edges_on(dev: torch.device, edges: np.ndarray) -> torch.Tensor:
    """The stratum edges as a tensor on ``dev``, made once per device and
    edge set. On a card the copy is from pinned memory and does not block
    (a pageable copy would synchronize)."""
    key = (str(dev), edges.tobytes())
    t = _EDGES.get(key)
    if t is None:
        t = torch.from_numpy(edges.copy())
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        _EDGES[key] = t
    return t


def _read_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class _Pyramid:
    """One frame's templates and the IRLS loop over them."""

    def __init__(self, kf, cur, intrs, cfg, jac_dtype, dev):
        self.cfg, self.cur, self.intrs = cfg, cur, intrs
        self.esm = cfg.jacobian == "esm"
        self.s2i0 = torch.full((), cfg.init_sigma_int**2, dtype=torch.float32, device=dev)
        self.s2x0 = torch.full((), cfg.init_sigma_xi**2, dtype=torch.float32, device=dev)
        self.zero = torch.zeros((), dtype=torch.float32, device=dev)
        self.eye6 = torch.eye(6, dtype=torch.float32, device=dev)
        if cfg.affine_illumination and self.esm:
            kf = _apply_affine_illumination(kf, cur, jac_dtype)
        strides = tuple(cfg.template_stride or ())
        strides = strides + (1,) * max(0, cfg.levels - len(strides))
        self.tmpl = [template_level(kf[l], intrs[l], strides[l]) for l in range(cfg.levels)]

    def n_iters(self, level: int) -> int:
        iters = self.cfg.iters
        return iters[level] if level < len(iters) else iters[-1]

    def run(self, level, T, s2i, s2x, H, mask):
        """One level's IRLS loop from (T, sigmas, H) with the given template
        mask: (T, s2i, s2x, H, err, inlier_frac, n_valid)."""
        cfg = self.cfg
        kl, points = self.tmpl[level]
        cl, intr_l = self.cur[level], self.intrs[level]
        gate_cap = cfg.occ_gate_cap if level <= cfg.occ_gate_cap_level else 0.0
        err = inl = nv = self.zero
        for _ in range(self.n_iters(level)):
            if self.esm:
                step = esm_irls_step(
                    T, kl.intensity, points, mask, kl.jac, cl.stack7, intr_l,
                    cfg.student_t_nu, s2i, s2x, cfg.use_geometric, cfg.gate_sigmas,
                    cfg.occlusion_gate, gate_cap, damping=cfg.damping,
                )
            else:
                step = ic_irls_step(
                    T, kl.intensity, points, mask, kl.jac, cl.intensity, cl.xi, cl.mask,
                    intr_l, cfg.student_t_nu, s2i, s2x, cfg.sigma_iters, cfg.use_geometric,
                    cfg.gate_sigmas, cfg.sigma_mode, damping=cfg.damping,
                )
            T, res = step.T, step.result
            s2i, s2x, H = res.sigma2_int, res.sigma2_xi, res.H
            err, inl, nv = res.error, res.inlier_frac, res.n_valid
        return T, s2i, s2x, H, err, inl, nv


def _tail(pyr: _Pyramid, T, H, s2i, s2x, errors, inliers, nvalids, mask0, **consensus):
    # Geometric overlap normalized for sensor dropout on both sides; the
    # template count and n_valid share the template stride.
    kf_count = torch.clamp(mask0.sum(), min=1.0)
    cur_mask = pyr.cur[0].mask
    cur_frac = torch.clamp(cur_mask.sum() / float(cur_mask.numel()), 0.05, 1.0)
    overlap = torch.clamp(nvalids[-1] / (kf_count * cur_frac), 0.0, 1.0)
    # Collected coarse -> fine; stored fine -> coarse (level order).
    return TrackResult(
        T=T, H=H, errors=torch.stack(errors[::-1]), inlier_frac=torch.stack(inliers[::-1]),
        n_valid=torch.stack(nvalids[::-1]), overlap=overlap, sigma2_int=s2i, sigma2_xi=s2x,
        kf_count=kf_count, **consensus,
    )


def track(
    kf: Tuple[KeyframeLevel, ...],
    cur: Tuple[FrameLevel, ...],
    T_init: torch.Tensor,
    intrs: Tuple[Intrinsics, ...],
    cfg,
    jac_dtype: str = "f32",
    cons_prev=None,
    read=None,
) -> TrackResult:
    """The production coarse-to-fine tracker (``cfg`` is a TrackingConfig;
    ``check_tracking_supported`` lists the settings that raise).
    ``jac_dtype`` is the template's storage precision, which the ESM affine
    illumination rounds its rescaled planes to.

    ``cons_prev`` is the previous frame's per-stratum consecutive-flag
    counts ((consensus_bins,) host array, what MotionState carries); None
    waives the consensus persistence gates (single-shot tracking), and the
    returned counts then start from a zero history. ``read`` copies a device
    tensor to a host numpy array (default: ``t.cpu().numpy()``)."""
    pyr = _Pyramid(kf, cur, intrs, cfg, jac_dtype, T_init.device)
    if cfg.consensus and pyr.esm:
        return _track_consensus(pyr, T_init, cons_prev, read or _read_host)
    T, s2i, s2x, H = T_init, pyr.s2i0, pyr.s2x0, pyr.eye6
    errors, inliers, nvalids = [], [], []
    for level in range(cfg.levels - 1, -1, -1):
        T, s2i, s2x, H, err, inl, nv = pyr.run(level, T, s2i, s2x, H, pyr.tmpl[level][0].mask)
        errors.append(err)
        inliers.append(inl)
        nvalids.append(nv)
    n_bins = cfg.consensus_bins
    return _tail(pyr, T, H, s2i, s2x, errors, inliers, nvalids, pyr.tmpl[0][0].mask,
                 cons_excluded=np.zeros((n_bins,), _F32))


def _track_consensus(pyr: _Pyramid, T_init, cons_prev, read) -> TrackResult:
    """The ESM tracker with the depth-stratified motion consensus
    (``rgbid_tpu/tracking/tracker.py:232-318, 475-948``), its ``lax.cond``
    branches taken on the host."""
    cfg = pyr.cfg
    levels, K = cfg.levels, cfg.consensus_bins
    persist = cfg.consensus_persist
    edges = cons.stratum_edges(cfg.consensus_xi_min, cfg.consensus_xi_max, K)
    idx_planes: dict = {}

    def level_mask(level, member, mask=None):
        """``member_mask`` at one level: the template mask (or ``mask``)
        without the strata whose member is 0."""
        kl = pyr.tmpl[level][0]
        mask = kl.mask if mask is None else mask
        if member.min() >= 0.5:
            return mask
        if level not in idx_planes:
            idx_planes[level] = cons.stratum_index(kl.xi, _edges_on(kl.xi.device, edges))
        return cons.excluded_mask(idx_planes[level], mask, member)

    member = np.ones((K,), _F32)
    if cons_prev is not None:
        cons_hist = np.asarray(cons_prev, _F32).reshape(K)
        # Episode mask: strata with a ripe streak start excluded at every
        # level, the coarsest included; a neighbour of one is masked too,
        # but only if it has a live streak of its own.
        hot = (cons_hist >= _F32(persist)).astype(_F32)
        zpad = np.zeros((1,), _F32)
        hot_n = np.maximum(np.concatenate([zpad, hot[:-1]]), np.concatenate([hot[1:], zpad]))
        hot = np.maximum(hot, hot_n * (cons_hist >= _F32(1.0)).astype(_F32))
        member = _F32(1.0) - hot
    else:
        cons_hist = np.full((K,), 100.0, _F32)
    flags_any = np.zeros((K,), _F32)
    nk_last = np.ones((K,), _F32)
    probe_fire = False
    probe_cand = np.zeros((K,), _F32)
    excl_any = np.zeros((K,), _F32)
    rescue_flag = False
    consensus_frac = _F32(0.0)
    rerun_iters = 0
    det_l = min(cfg.consensus_level, levels - 1)

    T, s2i, s2x, H = T_init, pyr.s2i0, pyr.s2x0, pyr.eye6
    errors, inliers, nvalids = [], [], []
    mask0 = None
    for level in range(levels - 1, -1, -1):
        kl, points = pyr.tmpl[level]
        cl, intr_l = pyr.cur[level], pyr.intrs[level]
        mask_l = level_mask(level, member)
        pre = (T, s2i, s2x, H)
        T, s2i, s2x, H, err, inl, nv = pyr.run(level, *pre, mask_l)
        if 1 <= level <= det_l:
            # The vote: fixed init sigmas, occlusion gate on, the FULL
            # template mask (a masked mover stays monitored).
            sums = esm_stratified(
                T, kl.intensity, points, kl.mask, kl.jac, cl.stack7, intr_l, cfg.student_t_nu,
                pyr.s2i0, pyr.s2x0, kl.xi, edges, cfg.use_geometric, cfg.gate_sigmas,
                occlusion_gate=True,
            )
            # Template aging: thresholds inflate with the motion since the
            # keyframe.
            t_norm = torch.linalg.vector_norm(T[:3, 3])
            ang = se3.rotation_angle(T[:3, :3])
            bscale = (1.0 + 12.0 * torch.clamp(t_norm - 0.06, min=0.0)
                      + 8.0 * torch.clamp(ang - 0.05, min=0.0))
            host = read(torch.cat([sums.reshape(-1), bscale.reshape(1)]))
            Hk, bk, nk, Gk, ek = unpack_stratified(host[:-1].reshape(K, -1))
            # Tolerance in pixels of the calibration rig, scaled by the
            # full-resolution focal length (level-independent).
            tol_l = cfg.consensus_tol * (intr_l.fx * (2.0**level) / cfg.consensus_ref_fx)
            verdict = cons.analyze(Hk, bk, nk, Gk, ek, tol_l, cfg.consensus_min_frac,
                                   cfg.consensus_err_ratio, cfg.consensus_err_floor,
                                   baseline_scale=host[-1])
            flags_any = np.maximum(flags_any, np.maximum(verdict.excluded, verdict.hostage))
            nk_last = nk
            decision = cons.decide(verdict, cons_hist, nk, cfg.consensus_trigger_frac,
                                   cfg.consensus_max_frac, persist)
            if cfg.attack_probe:
                # Attack-probe candidate: a vote exclusion under a clear
                # majority names a victim; the stratum that can drag the
                # pose is the highest information-density agreeing
                # minority voter.
                tot_k = np.maximum(nk.sum(dtype=_F32), _F32(1.0))
                voter_k = nk >= _F32(cfg.consensus_min_frac) * tot_k
                pool = (voter_k & (verdict.excluded < 0.5)
                        & (nk < _F32(cons.MINORITY_CAP) * tot_k))
                dens = np.where(pool, verdict.info_share / np.maximum(nk / tot_k, _F32(1e-6)),
                                _F32(-1.0))
                fire_l = verdict.excluded.sum() > 0.5 and verdict.majority_ok and pool.any()
                if fire_l:
                    probe_cand = np.zeros((K,), _F32)
                    probe_cand[int(np.argmax(dens))] = 1.0
                probe_fire = probe_fire or fire_l
                excl_any = np.maximum(excl_any, verdict.excluded)
            member2 = member * decision.member
            consensus_frac = max(consensus_frac, _F32(decision.excluded_frac))
            rescue_flag = rescue_flag or decision.rescue
            # Rerun the level from its pre-level state only when a stratum
            # was NEWLY excluded (an episode-masked mover keeps flagging).
            if decision.triggered and bool((member2 < member).any()) and not decision.rescue:
                T, s2i, s2x, H, err, inl, nv = pyr.run(level, *pre, level_mask(level, member2))
                rerun_iters += pyr.n_iters(level)
            member = member2
        errors.append(err)
        inliers.append(inl)
        nvalids.append(nv)
        if level == 0:
            mask0 = mask_l

    # Streak counts for the next frame: leaky and neighbour-crediting, from
    # the REAL history (zeros when none was given), capped a little above
    # the gate.
    hist_real = (np.asarray(cons_prev, _F32).reshape(K) if cons_prev is not None
                 else np.zeros((K,), _F32))
    flagged = flags_any > 0.5
    zpad = np.zeros((1,), _F32)
    fpad = np.zeros((1,), bool)
    left_h, right_h = np.concatenate([zpad, hist_real[:-1]]), np.concatenate([hist_real[1:], zpad])
    left_f, right_f = np.concatenate([fpad, flagged[:-1]]), np.concatenate([flagged[1:], fpad])
    credit = np.maximum(np.where(left_f, _F32(0.0), left_h), np.where(right_f, _F32(0.0), right_h))
    base = np.maximum(hist_real, credit)
    streak_cap = _F32(float(persist) + 4.0)
    cons_excluded = np.where(flagged, np.minimum(base + _F32(1.0), streak_cap),
                             np.maximum(hist_real - _F32(1.0), _F32(0.0))).astype(_F32)

    rescue_any = rescue_flag
    rescue_member = member
    if cfg.div_rescue:
        # Divergence-triggered rescue: the converged pose diverges hard from
        # the prior on a frame whose flagged strata are a real minority.
        flagged2 = np.maximum(flagged.astype(_F32), (cons_hist >= _F32(persist)).astype(_F32))
        frac = (flagged2 * nk_last).sum(dtype=_F32) / np.maximum(nk_last.sum(dtype=_F32),
                                                                  _F32(1.0))
        div_fire = False
        if frac > _F32(0.01) and frac <= _F32(cfg.consensus_max_frac) and not rescue_flag:
            D = se3.inv(T_init) @ T
            div = read(torch.stack([torch.linalg.vector_norm(D[:3, 3]),
                                    se3.rotation_angle(D[:3, :3])]))
            div_fire = bool(div[0] > _F32(cfg.div_trans_thresh)
                            or div[1] > _F32(cfg.div_rot_thresh))
        if div_fire:
            rescue_member = member * (_F32(1.0) - flagged2)
            rescue_any = True
            consensus_frac = max(consensus_frac, frac)
    rescue_margin = _F32(1.0)
    probe_go = False
    if cfg.attack_probe:
        # The probe is folded into the one rescue pyramid: it fires only when
        # no hostage/divergence rescue does and must beat the main pose by
        # the strict margin.
        probe_go = probe_fire and not rescue_any
        if probe_go:
            rescue_member = member * (_F32(1.0) - probe_cand)
            rescue_margin = _F32(cfg.probe_margin)
        rescue_any = rescue_any or probe_go

    rescue_out = 0.0
    if rescue_any:
        # Masked re-track from the prior with init sigmas, accepted only on
        # fixed-sigma level-0 evidence on the retained template.
        Tr, s2ir, s2xr, Hr = T_init, pyr.s2i0, pyr.s2x0, pyr.eye6
        errs_r, inls_r, nvs_r = [], [], []
        mask0_r = None
        for level in range(levels - 1, -1, -1):
            mask_r = level_mask(level, rescue_member)
            Tr, s2ir, s2xr, Hr, e, i, n = pyr.run(level, Tr, s2ir, s2xr, Hr, mask_r)
            errs_r.append(e)
            inls_r.append(i)
            nvs_r.append(n)
            if level == 0:
                mask0_r = mask_r
        evid_mask = mask0_r
        if probe_go:
            # The probe's evidence is judged on unaccused pixels only.
            evid_mask = level_mask(0, _F32(1.0) - np.clip(excl_any, 0.0, 1.0), mask0_r)
        kl0, pts0 = pyr.tmpl[0]
        cl0, intr0 = pyr.cur[0], pyr.intrs[0]

        def err0_fixed(Tq):
            return esm_residuals_and_normal_eq(
                Tq, kl0.intensity, pts0, evid_mask, kl0.jac, cl0.stack7, intr0,
                cfg.student_t_nu, pyr.s2i0, pyr.s2x0, cfg.use_geometric, cfg.gate_sigmas,
                cfg.occlusion_gate, gate_cap=cfg.occ_gate_cap,
            ).error

        D_r = se3.inv(T) @ Tr
        ev = read(torch.stack([err0_fixed(Tr), err0_fixed(T),
                               torch.linalg.vector_norm(D_r[:3, 3]),
                               se3.rotation_angle(D_r[:3, :3])]))
        accepted = bool(ev[0] <= rescue_margin * ev[1])
        if accepted:
            T, s2i, s2x, H = Tr, s2ir, s2xr, Hr
            errors, inliers, nvalids, mask0 = errs_r, inls_r, nvs_r, mask0_r
            # Only a rescue that CORRECTED the pose is evidence of drag
            # worth refounding over.
            corrected = (ev[2] > _F32(cfg.rescue_refound_min_trans)
                         or ev[3] > _F32(cfg.rescue_refound_min_rot))
            rescue_out = 1.0 if corrected else 0.0
            if probe_go:
                # Streak transfer on an accepted probe: the probed stratum
                # gets the credit, the vote-excluded victims decay, every
                # uninvolved stratum keeps its normal update.
                cons_excluded = np.where(
                    probe_cand > 0.5, np.minimum(hist_real + _F32(1.0), streak_cap),
                    np.where(excl_any > 0.5, np.maximum(hist_real - _F32(1.0), _F32(0.0)),
                             cons_excluded)).astype(_F32)

    return _tail(pyr, T, H, s2i, s2x, errors, inliers, nvalids, mask0,
                 consensus_frac=float(consensus_frac), cons_excluded=cons_excluded,
                 rescue=rescue_out, rerun_iters=rerun_iters, rescue_ran=rescue_any)


class Tracker:
    """Frame-to-keyframe tracker bound to (intrinsics, config): the JAX
    package's standalone odometry API.

        tracker = Tracker(intr, TrackingConfig(levels=3, iters=(4, 8, 16), jacobian="ic"))
        kf = keyframe_pyramid(preprocess_frame(rgb0, depth0, 3), intr)
        res = tracker.track(kf, preprocess_frame(rgb1, depth1, 3), T_init)

    The tensors' device decides where it runs. ``jac_dtype`` is the
    template's storage precision (``keyframe_pyramid``'s), which ESM's
    affine illumination rounds to; the JAX package reads it from the array.
    In ESM mode the consensus runs as configured (on by default)."""

    def __init__(self, intr: Intrinsics, cfg, jac_dtype: str = "f32"):
        check_tracking_supported(cfg)
        self.intr = intr
        self.cfg = cfg
        self.jac_dtype = jac_dtype
        self.intrs = tuple(level_intrinsics(intr, l) for l in range(cfg.levels))

    def track(
        self, kf: Tuple[KeyframeLevel, ...], cur: Tuple[FrameLevel, ...], T_init: torch.Tensor,
        cons_prev=None,
    ) -> TrackResult:
        """``cons_prev``: the per-stratum consecutive-flag counts from the
        previous frame (streaming); None waives the persistence gates."""
        return track(kf, cur, T_init, self.intrs, self.cfg, self.jac_dtype, cons_prev)
