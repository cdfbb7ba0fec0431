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
value back to the host. Under ``early_exit_tol`` or ``conv_skip_tol`` (one
mechanism here: the JAX package's ``while_loop`` and its ``cond`` inside
the ``fori_loop`` carry the same state) each iteration gets the previous
one's step and the tolerance, and an iteration after a step of norm <= tol
is skipped on the device (ops/kernels.py); the host still enqueues the whole
budget, so ``cfg.iters`` are budgets and the launch counts do not change.

``plane_dtype`` (ESM only, as in the JAX package): under "bf16" and
"bf16-points" the backprojected template points, and for the IRLS loop the
template intensity, are stored bfloat16; the vote and the rescue's
level-0 evidence read the float32 intensity with those points. The stack's
type comes from the frame (tracking/frames.py; "bf16" and "bf16-stack").

The consensus reads nothing back to the host: where the JAX package uses
``lax.cond`` the port predicates on the device. A vote is one
``esm_stratified`` launch and one ``consensus_vote`` launch
(tracking/consensus.py): ``analyze``, ``decide`` and the vote's
bookkeeping write the member vector, the frame's flags and a word that is
1 when the level's masked rerun must run. The rerun's IRLS launches, and
the whole rescue pyramid with its two level-0 evidence evaluations, are
enqueued on every frame and given such a word (``go``): held, a launch
copies the step it would have replaced (ops/kernels.py). The rescue's
acceptance, the probe's evidence mask, ``div_rescue`` and the streak
update are device selects. Masked template masks are gathers of the
device member vector over per-level stratum-index planes.

Row sharding (``parallel/tracker_spmd.py``, ESM only): ``track`` takes a
``reduce`` that sums a tensor over the ranks, and per level the row offset
of the rank's band in strided rows. The keyframe planes are the rank's row
band; the current frame is whole on every rank. Each rank then sums
across ranks at the five places where the JAX tracker psums
(``rgbid_tpu/tracking/tracker.py:96-101, 391-392, 828-829, 964-970`` and
``gauss_newton.py:516-517``): the affine-illumination template sums, every
IRLS iteration (``esm_result``, ``allreduce_irls``, ``irls_solve_step``:
three steps where the one-process iteration is one launch), the vote's
(K, 50) sums before they are read, the rescue's level-0 evidence, and
``kf_count``. Every predicate is made from such summed values, which are
the same bits on every rank, so all ranks hold or run the same launches
(and make the same all-reduces, held or not). Without ``reduce`` nothing
of this runs: the iteration is the one fused launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import se3
from ..core.camera import Intrinsics, level_intrinsics
from ..ops.gauss_newton import round_jac
from ..ops.kernels import (EVAL_SLOT, allreduce_irls, esm_irls_step, esm_residuals_and_normal_eq,
                           esm_result, esm_stratified, ic_irls_step, irls_solve_step)
from ..ops.warp import backproject_grid
from . import consensus as cons
from .frames import FrameLevel, KeyframeLevel

_F32 = np.float32


PLANE_DTYPES = ("f32", "bf16", "bf16-stack", "bf16-points")


def check_tracking_supported(t) -> None:
    """Raise for a TrackingConfig setting this port refuses: a
    ``plane_dtype`` outside ``PLANE_DTYPES`` (ValueError; the JAX package
    runs any other string as "f32")."""
    if t.plane_dtype not in PLANE_DTYPES:
        raise ValueError(f"tracking.plane_dtype={t.plane_dtype!r}: expected one of {PLANE_DTYPES}")


def plane_dtypes(t):
    """(stack dtype, template-plane dtype) of ``t.plane_dtype``: the frame's
    ESM gather stack is bfloat16 under "bf16" and "bf16-stack", the ESM
    template's points and intensity under "bf16" and "bf16-points"."""
    check_tracking_supported(t)
    bf, f32 = torch.bfloat16, torch.float32
    return (bf if t.plane_dtype in ("bf16", "bf16-stack") else f32,
            bf if t.plane_dtype in ("bf16", "bf16-points") else f32)



def _apply_affine_illumination(
    kf: Tuple[KeyframeLevel, ...], cur: Tuple[FrameLevel, ...], jac_dtype: str, reduce=None
) -> Tuple[KeyframeLevel, ...]:
    """Estimate a global gain/bias (I_cur ~= a I_kf + b) by moment matching
    at level 0 and bake it into the template: intensity' = a I + b,
    intensity-gradient planes scaled by a. The stored keyframe is not
    changed. Under row sharding the template's sums are summed over the
    ranks; the count is the current frame's, which is whole on every rank
    and of the template's full size."""
    kl, cl = kf[0], cur[0]
    n = float(cl.intensity.numel())
    sum_k, sq_k = kl.intensity.sum(), (kl.intensity * kl.intensity).sum()
    if reduce is not None:
        sum_k, sq_k = reduce(torch.stack([sum_k, sq_k])).unbind()
    mean_k = sum_k / n
    var_k = torch.clamp(sq_k / n - mean_k * mean_k, min=1e-8)
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
    """Per-frame tracking output: small device tensors, the consensus
    fields included."""

    T: torch.Tensor  # (4, 4) current <- keyframe
    H: torch.Tensor  # (6, 6) final-level normal matrix, per valid pixel
    errors: torch.Tensor  # (levels,) weighted MSE after each level
    inlier_frac: torch.Tensor  # (levels,)
    n_valid: torch.Tensor  # (levels,)
    overlap: torch.Tensor  # () dropout-normalized valid fraction (finest)
    sigma2_int: torch.Tensor
    sigma2_xi: torch.Tensor
    kf_count: torch.Tensor  # () valid pixels of the APPLIED finest template mask
    # () Pixel fraction masked out by the consensus (the largest over the
    # vote levels; 0 when nothing acted or the consensus is off).
    consensus_frac: Optional[torch.Tensor] = None
    # (consensus_bins,) f32: per-stratum consecutive-flag counts after this
    # frame, for the next frame's persistence gates (MotionState).
    cons_excluded: Optional[torch.Tensor] = None
    # () 1.0 when a rescue re-track was accepted AND corrected the pose by
    # more than rescue_refound_min_trans / _rot (the keyframe-refound
    # trigger).
    rescue: Optional[torch.Tensor] = None
    # () What the frame ran beyond its plain pyramid: IRLS iterations of the
    # masked same-level reruns, and 1.0 when the rescue pyramid (all levels
    # plus two level-0 evidence evaluations) ran.
    rerun_iters: Optional[torch.Tensor] = None
    rescue_ran: Optional[torch.Tensor] = None


def template_level(kl: KeyframeLevel, intr_l: Intrinsics, s: int, row_offset: int = 0):
    """One level's template as the kernels read it: every s-th row and
    column of every plane, the ESM gradients or the IC field included
    (contiguous copies), and the backprojected points.

    Strided pixel (i, j) is pixel (s i, s j) of the level, so
    backprojection uses plain 1/s-scaled intrinsics while projection (in
    the kernel) keeps ``intr_l``. ``row_offset``: the first row of a row
    band, in strided rows. Returns (strided level, (X, Y, Z))."""
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
    return kl, backproject_grid(kl.xi, intr_bp, row_offset)


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


class _Pyramid:
    """One frame's templates and the IRLS loop over them."""

    def __init__(self, kf, cur, intrs, cfg, jac_dtype, dev, reduce=None, row_offsets=None):
        self.cfg, self.cur, self.intrs = cfg, cur, intrs
        self.esm = cfg.jacobian == "esm"
        if reduce is not None and not self.esm:
            raise ValueError("row-sharded tracking runs the ESM tracker only")
        self.reduce = reduce
        # One early exit for both knobs (0: every iteration runs).
        self.tol = cfg.early_exit_tol if cfg.early_exit_tol > 0 else cfg.conv_skip_tol
        self.s2i0 = torch.full((), cfg.init_sigma_int**2, dtype=torch.float32, device=dev)
        self.s2x0 = torch.full((), cfg.init_sigma_xi**2, dtype=torch.float32, device=dev)
        self.zero = torch.zeros((), dtype=torch.float32, device=dev)
        self.eye6 = torch.eye(6, dtype=torch.float32, device=dev)
        if cfg.affine_illumination and self.esm:
            kf = _apply_affine_illumination(kf, cur, jac_dtype, reduce)
        strides = tuple(cfg.template_stride or ())
        strides = strides + (1,) * max(0, cfg.levels - len(strides))
        offsets = row_offsets or (0,) * cfg.levels
        self.tmpl = [template_level(kf[l], intrs[l], strides[l], offsets[l])
                     for l in range(cfg.levels)]
        # The IRLS loop's template intensity; tmpl keeps the float32 one
        # (the vote and the rescue's evidence read it).
        self.int_loop = [kl.intensity for kl, _ in self.tmpl]
        tmpl_dtype = plane_dtypes(cfg)[1]
        if self.esm and tmpl_dtype != torch.float32:
            self.tmpl = [(kl, tuple(p.to(tmpl_dtype) for p in pts)) for kl, pts in self.tmpl]
            self.int_loop = [i.to(tmpl_dtype) for i in self.int_loop]

    def n_iters(self, level: int) -> int:
        iters = self.cfg.iters
        return iters[level] if level < len(iters) else iters[-1]

    def run(self, level, T, s2i, s2x, H, mask, go=None, hold=None):
        """One level's IRLS loop from (T, sigmas, H) with the given template
        mask: (T, s2i, s2x, H, err, inlier_frac, n_valid, last step). Every
        run starts with no previous step, so its first iteration always
        runs. With a predicate word ``go`` (ESM) every iteration is held
        when the word is 0: the loop's first step is then ``hold`` and the
        run returns ``hold``'s values."""
        cfg = self.cfg
        kl, points = self.tmpl[level]
        kf_int = self.int_loop[level]
        cl, intr_l = self.cur[level], self.intrs[level]
        gate_cap = cfg.occ_gate_cap if level <= cfg.occ_gate_cap_level else 0.0
        err = inl = nv = self.zero
        step = None
        for _ in range(self.n_iters(level)):
            held = None if go is None else (hold if step is None else step)
            if self.reduce is not None:
                res = esm_result(
                    T, kf_int, points, mask, kl.jac, cl.stack7, intr_l, cfg.student_t_nu, s2i,
                    s2x, cfg.use_geometric, cfg.gate_sigmas, cfg.occlusion_gate, gate_cap,
                    prev=step, tol=self.tol, go=go, hold=held,
                )
                step = irls_solve_step(T, allreduce_irls(res, self.reduce), cfg.damping,
                                       prev=step, tol=self.tol, slot=level, go=go, hold=held)
            elif self.esm:
                step = esm_irls_step(
                    T, kf_int, points, mask, kl.jac, cl.stack7, intr_l,
                    cfg.student_t_nu, s2i, s2x, cfg.use_geometric, cfg.gate_sigmas,
                    cfg.occlusion_gate, gate_cap, damping=cfg.damping, prev=step, tol=self.tol,
                    slot=level, go=go, hold=held,
                )
            else:
                step = ic_irls_step(
                    T, kl.intensity, points, mask, kl.jac, cl.intensity, cl.xi, cl.mask,
                    intr_l, cfg.student_t_nu, s2i, s2x, cfg.sigma_iters, cfg.use_geometric,
                    cfg.gate_sigmas, cfg.sigma_mode, damping=cfg.damping, prev=step,
                    tol=self.tol, slot=level,
                )
            T, res = step.T, step.result
            s2i, s2x, H = res.sigma2_int, res.sigma2_xi, res.H
            err, inl, nv = res.error, res.inlier_frac, res.n_valid
        return T, s2i, s2x, H, err, inl, nv, step


def _tail(pyr: _Pyramid, T, H, s2i, s2x, errors, inliers, nvalids, mask0, **consensus):
    # Without the consensus its fields are device zeros.
    zero = pyr.zero
    consensus = {"consensus_frac": zero, "rescue": zero, "rerun_iters": zero,
                 "rescue_ran": zero, **consensus}
    consensus.setdefault("cons_excluded", torch.zeros((pyr.cfg.consensus_bins,),
                                                      dtype=torch.float32, device=zero.device))
    # Geometric overlap normalized for sensor dropout on both sides; the
    # template count and n_valid share the template stride. Under row
    # sharding the template count is summed over the ranks, the current
    # frame's (whole on every rank) is not.
    kf_count = mask0.sum()
    if pyr.reduce is not None:
        kf_count = pyr.reduce(kf_count.reshape(1))[0]
    kf_count = torch.clamp(kf_count, min=1.0)
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
    reduce=None,
    row_offsets=None,
) -> TrackResult:
    """The production coarse-to-fine tracker (``cfg`` is a TrackingConfig;
    ``check_tracking_supported`` lists the settings that raise; the frame's
    stack type is the caller's, ``plane_dtypes(cfg)[0]`` on the main path).
    ``jac_dtype`` is the template's storage precision, which the ESM affine
    illumination rounds its rescaled planes to.

    ``cons_prev`` is the previous frame's per-stratum consecutive-flag
    counts ((consensus_bins,) float32, what MotionState carries: a tensor,
    or a host array that is copied up); None waives the consensus
    persistence gates (single-shot tracking), and the returned counts then
    start from a zero history. Nothing is read back to the host.

    Row sharding (ESM only; ValueError otherwise): ``reduce`` sums a tensor
    over the ranks and returns the sum, the same bits on every rank;
    ``kf`` is then this rank's row band of every level and
    ``row_offsets[l]`` the band's first row at level l in template-stride
    rows. See the module docstring."""
    pyr = _Pyramid(kf, cur, intrs, cfg, jac_dtype, T_init.device, reduce, row_offsets)
    if cfg.consensus and pyr.esm:
        return _track_consensus(pyr, T_init, cons_prev)
    T, s2i, s2x, H = T_init, pyr.s2i0, pyr.s2x0, pyr.eye6
    errors, inliers, nvalids = [], [], []
    for level in range(cfg.levels - 1, -1, -1):
        T, s2i, s2x, H, err, inl, nv, _ = pyr.run(level, T, s2i, s2x, H,
                                                   pyr.tmpl[level][0].mask)
        errors.append(err)
        inliers.append(inl)
        nvalids.append(nv)
    return _tail(pyr, T, H, s2i, s2x, errors, inliers, nvalids, pyr.tmpl[0][0].mask)


def _hist_tensor(cons_prev, k: int, dev: torch.device) -> torch.Tensor:
    """The streak history as a (K,) float32 tensor on ``dev`` (a tensor is
    taken as it is; a host array is copied up, for single-shot callers)."""
    if isinstance(cons_prev, torch.Tensor):
        return cons_prev.to(device=dev, dtype=torch.float32).reshape(k)
    return torch.from_numpy(np.asarray(cons_prev, _F32).reshape(k).copy()).to(dev)


def _shift(x: torch.Tensor, pad: torch.Tensor):
    """(left neighbour, right neighbour) of every stratum, ``pad`` outside."""
    return torch.cat([pad, x[:-1]]), torch.cat([x[1:], pad])


def _track_consensus(pyr: _Pyramid, T_init, cons_prev) -> TrackResult:
    """The ESM tracker with the depth-stratified motion consensus
    (``rgbid_tpu/tracking/tracker.py:232-318, 475-948``), every
    ``lax.cond`` a device predicate: the masked reruns and the rescue
    pyramid are always enqueued, their launches run only where the vote's
    word is 1, and the rescue's acceptance selects on the device."""
    cfg = pyr.cfg
    levels, K = cfg.levels, cfg.consensus_bins
    persist = float(cfg.consensus_persist)
    dev = T_init.device
    f32 = torch.float32
    edges = cons.stratum_edges(cfg.consensus_xi_min, cfg.consensus_xi_max, K)
    edges_t = _edges_on(dev, edges)
    idx_planes: dict = {}

    def level_mask(level, member, mask=None):
        """``member_mask`` at one level: the template mask (or ``mask``)
        without the strata whose member is 0, from the level's
        stratum-index plane (made once per frame)."""
        kl = pyr.tmpl[level][0]
        if level not in idx_planes:
            idx_planes[level] = cons.stratum_index(kl.xi, edges_t)
        return cons.masked(idx_planes[level], kl.mask if mask is None else mask, member)

    zpad = torch.zeros((1,), dtype=f32, device=dev)
    if cons_prev is not None:
        hist = _hist_tensor(cons_prev, K, dev)
        hist_real = hist
        # Episode mask: strata with a ripe streak start excluded at every
        # level, the coarsest included; a neighbour of one is masked too,
        # but only if it has a live streak of its own.
        hot = (hist >= persist).to(f32)
        left, right = _shift(hot, zpad)
        hot = torch.maximum(hot, torch.maximum(left, right) * (hist >= 1.0).to(f32))
        member = 1.0 - hot
    else:
        hist = torch.full((K,), 100.0, dtype=f32, device=dev)
        hist_real = torch.zeros((K,), dtype=f32, device=dev)
        member = torch.ones((K,), dtype=f32, device=dev)
    state = cons.VoteState.initial(member)
    rerun_iters = pyr.zero
    det_l = min(cfg.consensus_level, levels - 1)

    T, s2i, s2x, H = T_init, pyr.s2i0, pyr.s2x0, pyr.eye6
    errors, inliers, nvalids = [], [], []
    mask0 = last = None
    for level in range(levels - 1, -1, -1):
        kl, points = pyr.tmpl[level]
        cl, intr_l = pyr.cur[level], pyr.intrs[level]
        mask_l = level_mask(level, state[:K])
        pre = (T, s2i, s2x, H)
        T, s2i, s2x, H, err, inl, nv, last = pyr.run(level, *pre, mask_l)
        if 1 <= level <= det_l:
            # The vote: fixed init sigmas, occlusion gate on, the FULL
            # template mask (a masked mover stays monitored).
            sums = esm_stratified(
                T, kl.intensity, points, kl.mask, kl.jac, cl.stack7, intr_l, cfg.student_t_nu,
                pyr.s2i0, pyr.s2x0, kl.xi, edges, cfg.use_geometric, cfg.gate_sigmas,
                occlusion_gate=True,
            )
            if pyr.reduce is not None:
                sums = pyr.reduce(sums)
            # Template aging: thresholds inflate with the motion since the
            # keyframe.
            t_norm = torch.linalg.vector_norm(T[:3, 3])
            ang = se3.rotation_angle(T[:3, :3])
            bscale = (1.0 + 12.0 * torch.clamp(t_norm - 0.06, min=0.0)
                      + 8.0 * torch.clamp(ang - 0.05, min=0.0))
            # Tolerance in pixels of the calibration rig, scaled by the
            # full-resolution focal length (level-independent).
            tol_l = cfg.consensus_tol * (intr_l.fx * (2.0**level) / cfg.consensus_ref_fx)
            state, go, _ = cons.consensus_vote(sums, bscale, hist, state,
                                               cons.VoteParams.of(cfg, tol_l))
            # The level's masked rerun from its pre-level state, run only
            # when a stratum was NEWLY excluded (the vote's word); held, it
            # leaves the level's result as it is.
            T, s2i, s2x, H, err, inl, nv, last = pyr.run(
                level, *pre, level_mask(level, state[:K]), go=go, hold=last)
            rerun_iters = rerun_iters + go.to(f32) * float(pyr.n_iters(level))
        errors.append(err)
        inliers.append(inl)
        nvalids.append(nv)
        if level == 0:
            mask0 = mask_l
    st = cons.VoteState.split(state, K)
    member = st.member
    consensus_frac = st.consensus_frac[0]

    # Streak counts for the next frame: leaky and neighbour-crediting, from
    # the REAL history (zeros when none was given), capped a little above
    # the gate.
    flagged = st.flags_any > 0.5
    left_h, right_h = _shift(hist_real, zpad)
    left_f, right_f = _shift(flagged, torch.zeros((1,), dtype=torch.bool, device=dev))
    credit = torch.maximum(torch.where(left_f, 0.0, left_h), torch.where(right_f, 0.0, right_h))
    base = torch.maximum(hist_real, credit)
    streak_cap = persist + 4.0
    cons_excluded = torch.where(flagged, torch.clamp(base + 1.0, max=streak_cap),
                                torch.clamp(hist_real - 1.0, min=0.0))

    rescue_flag = st.rescue_flag[0] > 0.5
    rescue_any = rescue_flag
    rescue_member = member
    if cfg.div_rescue:
        # Divergence-triggered rescue: the converged pose diverges hard from
        # the prior on a frame whose flagged strata are a real minority.
        D = se3.inv(T_init) @ T
        div_t = torch.linalg.vector_norm(D[:3, 3])
        div_r = se3.rotation_angle(D[:3, :3])
        flagged2 = torch.maximum(flagged.to(f32), (hist >= persist).to(f32))
        frac = (cons._seqsum(flagged2 * st.nk_last)
                / torch.clamp(cons._seqsum(st.nk_last), min=1.0))
        div_fire = (((div_t > cfg.div_trans_thresh) | (div_r > cfg.div_rot_thresh))
                    & (frac > 0.01) & (frac <= cfg.consensus_max_frac) & ~rescue_flag)
        rescue_member = torch.where(div_fire, member * (1.0 - flagged2), member)
        rescue_any = rescue_flag | div_fire
        consensus_frac = torch.maximum(consensus_frac, torch.where(div_fire, frac, 0.0))
    rescue_margin = torch.ones((), dtype=f32, device=dev)
    probe_go = None
    if cfg.attack_probe:
        # The probe is folded into the one rescue pyramid: it fires only when
        # no hostage/divergence rescue does and must beat the main pose by
        # the strict margin.
        probe_go = (st.probe_fire[0] > 0.5) & ~rescue_any
        rescue_member = torch.where(probe_go, member * (1.0 - st.probe_cand), rescue_member)
        rescue_margin = torch.where(probe_go, float(cfg.probe_margin), rescue_margin)
        rescue_any = rescue_any | probe_go

    # The rescue: a masked re-track from the prior with init sigmas,
    # accepted only on fixed-sigma level-0 evidence on the retained
    # template. Always enqueued; its launches run only on a rescue frame.
    go_r = rescue_any.to(torch.int32)
    Tr, s2ir, s2xr, Hr = T_init, pyr.s2i0, pyr.s2x0, pyr.eye6
    errs_r, inls_r, nvs_r = [], [], []
    mask0_r, held = None, last
    for level in range(levels - 1, -1, -1):
        mask_r = level_mask(level, rescue_member)
        Tr, s2ir, s2xr, Hr, e, i, n, held = pyr.run(level, Tr, s2ir, s2xr, Hr, mask_r, go=go_r,
                                                    hold=held)
        errs_r.append(e)
        inls_r.append(i)
        nvs_r.append(n)
        if level == 0:
            mask0_r = mask_r
    evid_mask = mask0_r
    if probe_go is not None:
        # The probe's evidence is judged on unaccused pixels only.
        evid_mask = torch.where(
            probe_go, level_mask(0, 1.0 - torch.clamp(st.excl_any, 0.0, 1.0), mask0_r), mask0_r)
    kl0, pts0 = pyr.tmpl[0]
    cl0, intr0 = pyr.cur[0], pyr.intrs[0]

    def err0_fixed(Tq):
        args = (Tq, kl0.intensity, pts0, evid_mask, kl0.jac, cl0.stack7, intr0,
                cfg.student_t_nu, pyr.s2i0, pyr.s2x0, cfg.use_geometric, cfg.gate_sigmas,
                cfg.occlusion_gate, cfg.occ_gate_cap)
        if pyr.reduce is not None:
            return allreduce_irls(esm_result(*args, go=go_r, hold=last), pyr.reduce)[44]
        return esm_residuals_and_normal_eq(*args, go=go_r, hold=last, slot=EVAL_SLOT).error

    accepted = rescue_any & (err0_fixed(Tr) <= rescue_margin * err0_fixed(T))
    # Only a rescue that CORRECTED the pose is evidence of drag worth
    # refounding over.
    D_r = se3.inv(T) @ Tr
    corrected = ((torch.linalg.vector_norm(D_r[:3, 3]) > cfg.rescue_refound_min_trans)
                 | (se3.rotation_angle(D_r[:3, :3]) > cfg.rescue_refound_min_rot))
    rescue_out = (accepted & corrected).to(f32)
    if probe_go is not None:
        # Streak transfer on an accepted probe: the probed stratum gets the
        # credit, the vote-excluded victims decay, every uninvolved stratum
        # keeps its normal update.
        transfer = torch.where(
            st.probe_cand > 0.5, torch.clamp(hist_real + 1.0, max=streak_cap),
            torch.where(st.excl_any > 0.5, torch.clamp(hist_real - 1.0, min=0.0), cons_excluded))
        cons_excluded = torch.where(probe_go & accepted, transfer, cons_excluded)

    def pick(a, b):
        return torch.where(accepted, a, b)

    return _tail(pyr, pick(Tr, T), pick(Hr, H), pick(s2ir, s2i), pick(s2xr, s2x),
                 [pick(a, b) for a, b in zip(errs_r, errors)],
                 [pick(a, b) for a, b in zip(inls_r, inliers)],
                 [pick(a, b) for a, b in zip(nvs_r, nvalids)], pick(mask0_r, mask0),
                 consensus_frac=consensus_frac, cons_excluded=cons_excluded, rescue=rescue_out,
                 rerun_iters=rerun_iters, rescue_ran=rescue_any.to(f32))


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
