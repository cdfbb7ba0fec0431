"""Depth-stratified motion consensus: reject coherently moving foreground.

Counterpart of ``rgbid_tpu/tracking/consensus.py:57-429``. A near-field
mover covering a pixel minority can carry most of the Fisher information
(warp Jacobians scale as 1/z^2) and drag the pose; it lives in other
inverse-depth strata than the static scene, and its strata disagree with
the pixel-count majority about the pose. Per vote (the tracker runs one
after each of the two coarse levels):

1. the template's pixels are binned into K log-spaced inverse-depth strata
   and reduced to per-stratum normal equations, a geometry Gram and
   fixed-sigma error sums (``ops/kernels.py::esm_stratified``, one launch);
2. ``analyze`` solves each stratum's correction inside its well-observed
   eigenspace and holds a pixel-count-majority vote in the induced-flow
   metric, with an error-outlier test and hostage detection;
3. ``decide`` acts only on persistent, minority-sized disagreement.

Steps 2 and 3 are tensor functions on the sums' device, and read nothing
back to the host: the vote's outcome is a device member vector and a
device word that predicates the masked rerun (tracking/tracker.py).
``consensus_vote`` runs ``analyze``, ``decide`` and the tracker's
per-vote bookkeeping for one vote: on a CUDA tensor as one launch of
``csrc/consensus_vote.cu`` (one block), on a CPU tensor as ``vote_plain``,
which is ``analyze`` and ``decide`` below in the kernel's float order.
The JAX package's semantics are kept where PyTorch's differ:
``nanmedian`` takes the mean of the two middle values (``torch.nanmedian``
the lower one), ``argmax`` ties go to the first index, and the per-stratum
eigensolve is a fixed-sweep cyclic Jacobi in float64 (``jacobi_eigh``):
``torch.linalg.eigh`` checks its status on the host, which synchronizes.
Sums over the K strata are taken in stratum order, one add at a time, as
the kernel takes them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build

# Pixel-minority caps shared by every "a mover is a pixel minority" gate:
# MINORITY_CAP bounds the dominance / hostage candidates and the tracker's
# attack-probe pool; ERR_MINORITY_CAP, looser, bounds the error-outlier
# test only (a transiting panel covers 34-35% of vote-level pixels at its
# peak, and its streak must not break there).
MINORITY_CAP = 0.35
ERR_MINORITY_CAP = 0.40

# Cyclic Jacobi: sweeps of five rounds, each round three disjoint pairs
# (the round-robin order of six indices), so all six indices turn once per
# round. Ten sweeps take a 6x6 normal matrix to float64 roundoff.
JACOBI_SWEEPS = 10
JACOBI_ROUNDS = (((0, 1), (2, 3), (4, 5)), ((0, 2), (1, 4), (3, 5)), ((0, 4), (2, 5), (1, 3)),
                 ((0, 5), (4, 3), (2, 1)), ((0, 3), (5, 1), (4, 2)))


def stratum_edges(xi_min: float, xi_max: float, k: int) -> np.ndarray:
    """K+1 log-spaced inverse-depth bin edges (float32, host)."""
    return np.geomspace(xi_min, xi_max, k + 1).astype(np.float32)


def stratum_index(xi: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Per-pixel stratum index in [0, K-1] (clamped; invalid pixels land in
    a bin too, and are removed by the validity mask downstream). ``edges``
    is a float32 tensor on the device of ``xi``."""
    k = edges.shape[0] - 1
    idx = torch.searchsorted(edges, xi.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, k - 1)


def stratum_onehot(xi: torch.Tensor, mask: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(K, H, W) one-hot stratum membership of the valid pixels."""
    k = edges.shape[0] - 1
    idx = stratum_index(xi, edges)
    # A comparison, not one_hot: one_hot checks its indices on the host.
    oh = (idx[None] == torch.arange(k, device=idx.device)[:, None, None]).to(torch.float32)
    return oh * mask[None]


def member_mask(xi: torch.Tensor, mask: torch.Tensor, edges: torch.Tensor,
                member: torch.Tensor) -> torch.Tensor:
    """Per-pixel keep mask: the pixels of strata voted out of the consensus
    leave the template. ``member`` is a (K,) float32 tensor on the device
    of ``xi``."""
    return masked(stratum_index(xi, edges), mask, member)


def masked(idx: torch.Tensor, mask: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """``member_mask`` from a precomputed stratum-index plane: a gather of
    the device member vector, no host value."""
    return mask * member[idx]


class ConsensusResult(NamedTuple):
    excluded: torch.Tensor  # (K,) f32: 1 = stratum disagrees with the majority
    majority_ok: torch.Tensor  # () bool: a genuine pixel majority exists
    deltas: torch.Tensor  # (K, 6) per-stratum preferred corrections
    hostage: torch.Tensor  # (K,) f32: the pose is held by this aligned minority
    info_share: torch.Tensor  # (K,) f32 Fisher-information share per stratum
    dominant: torch.Tensor  # (K,) f32: information-dominant minority voters (diagnostic)


class ConsensusDecision(NamedTuple):
    member: torch.Tensor  # (K,) f32: 1 = stratum kept
    triggered: torch.Tensor  # () bool: act on the verdict
    excluded_frac: torch.Tensor  # () f32: pixel fraction masked out
    rescue: torch.Tensor  # () bool: re-track the whole pyramid from the prior


def _seqsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first dimension, one add at a time in index order."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def _seqmax(x: torch.Tensor) -> torch.Tensor:
    """Max over the last dimension in index order (NaN-free inputs)."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = torch.maximum(acc, x[..., k])
    return acc


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """np.nanmedian of a (K,) float32 vector as a device scalar: the mean of
    the two middle values of the non-NaN entries, 0 when there is none or
    the median is not finite."""
    valid = ~torch.isnan(x)
    c = _seqsum(valid.to(torch.int64))
    srt = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))))[0]
    last = x.shape[0] - 1
    # gather, not indexing: a 0-d tensor index is read on the host.
    lo = srt.gather(0, torch.clamp((c - 1) // 2, 0, last).reshape(1))[0]
    hi = srt.gather(0, torch.clamp(c // 2, 0, last).reshape(1))[0]
    med = (lo + hi) / 2.0
    return torch.where((c > 0) & torch.isfinite(med), med, torch.zeros_like(med))


_JACOBI_INDEX: dict = {}


def _jacobi_plan(device):
    """Per round: (P, Q, partner, sign, pair) index tensors on ``device``."""
    key = str(device)
    plan = _JACOBI_INDEX.get(key)
    if plan is None:
        plan = []
        for pairs in JACOBI_ROUNDS:
            partner, sign, pair = [0] * 6, [0.0] * 6, [0] * 6
            for i, (p, q) in enumerate(pairs):
                partner[p], partner[q] = q, p
                sign[p], sign[q] = -1.0, 1.0
                pair[p] = pair[q] = i
            mk = lambda v, dt: torch.tensor(v, dtype=dt).to(device)  # noqa: E731
            plan.append((mk([p for p, _ in pairs], torch.int64), mk([q for _, q in pairs], torch.int64),
                         mk(partner, torch.int64), mk(sign, torch.float64), mk(pair, torch.int64)))
        _JACOBI_INDEX[key] = plan
    return plan


def jacobi_eigh(A: torch.Tensor):
    """Eigenvalues (K, 6) and eigenvectors (K, 6, 6, columns) of symmetric
    float64 (K, 6, 6) matrices by ``JACOBI_SWEEPS`` sweeps of cyclic Jacobi
    rotations, unsorted. Every rotation of a round is applied to the
    columns, then to the rows (a'[i][r] = a[i][r] c_r + a[i][partner r]
    (sign_r s_r)), then to the eigenvector columns: the kernel's order."""
    K = A.shape[0]
    V = torch.eye(6, dtype=torch.float64, device=A.device).expand(K, 6, 6).clone()
    plan = _jacobi_plan(A.device)
    one = torch.ones((), dtype=torch.float64, device=A.device)
    for _ in range(JACOBI_SWEEPS):
        for P, Q, partner, sign, pair in plan:
            app, aqq, apq = A[:, P, P], A[:, Q, Q], A[:, P, Q]
            theta = (aqq - app) / (2.0 * apq)
            sgn = torch.where(theta >= 0.0, one, -one)
            t = sgn / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            t = torch.where(apq == 0.0, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            cv = c[:, pair]  # (K, 6)
            sv = s[:, pair] * sign
            A = A * cv[:, None, :] + A[:, :, partner] * sv[:, None, :]
            A = A * cv[:, :, None] + A[:, partner, :] * sv[:, :, None]
            V = V * cv[:, None, :] + V[:, :, partner] * sv[:, None, :]
    return torch.diagonal(A, dim1=1, dim2=2), V


def analyze(Hk, bk, nk, Gk, ek, tol: float, min_frac: float, err_ratio: float = 4.0,
            err_floor: float = 1.0, baseline_scale=1.0) -> ConsensusResult:
    """Per-stratum corrections and the pixel-count-majority consensus, on
    raw per-stratum sums (float32 tensors): (K, 6, 6) H, (K, 6) b, (K,) n,
    (K, 6, 6) geometry Gram, (K,) weighted error. ``tol`` is in pixels at
    the vote level; ``baseline_scale`` (a float or a device scalar)
    inflates the thresholds with the motion since the keyframe. Two
    disagreement tests: the delta vote (slow movers inside the basin) and
    the error outlier (fast movers whose fixed-sigma error saturates)."""
    f32 = torch.float32
    K = nk.shape[0]
    bscale = torch.as_tensor(baseline_scale, dtype=f32, device=nk.device)
    n_total = torch.clamp(_seqsum(nk), min=1.0)
    inv_n = 1.0 / torch.clamp(nk, min=1.0)
    Hn = Hk * inv_n[:, None, None]
    bn = bk * inv_n[:, None]
    # Truncated-eigenspace solves: blind directions of a single depth band
    # are zeroed exactly, well-observed ones recovered exactly.
    ev, V = jacobi_eigh(Hn.double())
    keep = ev > 0.01 * _seqmax(ev)[:, None]
    inv_eig = torch.where(keep, 1.0 / torch.clamp(ev, min=1e-12), torch.zeros_like(ev))
    bd = bn.double()
    proj = V[:, 0, :] * bd[:, 0:1]
    for l in range(1, 6):
        proj = proj + V[:, l, :] * bd[:, l:l + 1]
    w = inv_eig * proj
    d64 = V[:, :, 0] * w[:, 0:1]
    for j in range(1, 6):
        d64 = d64 + V[:, :, j] * w[:, j:j + 1]
    deltas = d64.to(f32)
    deltas = torch.where(torch.isfinite(deltas), deltas, torch.zeros_like(deltas))

    voter = nk >= min_frac * n_total
    voter_f = voter.to(f32)
    # Agreement in induced image flow: m[j, k] = (d_j - d_k)^T (G_j/n_j)
    # (d_j - d_k), the mean squared flow hypothesis k imposes on stratum j.
    Gn = Gk * inv_n[:, None, None]
    diff = deltas[:, None, :] - deltas[None, :, :]  # (K, K, 6): j - k
    m = None
    for i in range(6):
        ti = Gn[:, i, 0][:, None] * diff[:, :, 0]
        for l in range(1, 6):
            ti = ti + Gn[:, i, l][:, None] * diff[:, :, l]
        m = diff[:, :, i] * ti if m is None else m + diff[:, :, i] * ti
    tol_eff = tol * bscale
    agree = m <= tol_eff * tol_eff  # agree[j, k]: j agrees with hypothesis k
    support = _seqsum(agree.to(f32) * (nk * voter_f)[:, None])
    support = torch.where(voter, support, torch.full_like(support, -1.0))
    best = torch.argmax(support)  # ties: the first index, as jnp.argmax

    agree_best = agree.gather(1, best.reshape(1, 1).expand(K, 1))[:, 0]
    excluded_vote = voter & ~agree_best
    err_n = ek * inv_n
    nan = torch.full_like(err_n, float("nan"))
    err_med = nanmedian(torch.where(voter, err_n, nan))
    excluded_err = (voter & (nk < ERR_MINORITY_CAP * n_total)
                    & (err_n > torch.clamp(err_ratio * err_med * bscale, min=err_floor)))
    enough_voters = _seqsum(voter.to(torch.int64)) >= 3
    majority_ok = (support.gather(0, best.reshape(1))[0] > 0.6 * n_total) & enough_voters
    excluded = (excluded_vote & majority_ok) | excluded_err

    # Hostage: the stratum holding a dragged pose is the information-
    # dominant aligned minority while the majority's error climbs.
    info = Hk[:, 0, 0]
    for i in range(1, 6):
        info = info + Hk[:, i, i]
    info_share = info / torch.clamp(_seqsum(info), min=1e-12)
    pix_share = nk / n_total
    dominant = voter & (info_share > 2.0 * torch.clamp(pix_share, min=1e-6))
    others = voter & ~excluded & ~dominant
    others_med = nanmedian(torch.where(others, err_n, nan))
    minority = nk < MINORITY_CAP * n_total
    hostage = (dominant & enough_voters & minority
               & (others_med > 2.0 * torch.clamp(err_n, min=1e-3)) & (others_med > 0.35))
    # A live hostage explains the majority's decorrelation: the error
    # path's flags point at the dragged static majority that frame.
    hostage_any = _seqsum(hostage.to(f32)) > 0.5
    excluded = torch.where(hostage_any, excluded_vote & majority_ok, excluded)
    return ConsensusResult(
        excluded=excluded.to(f32),
        majority_ok=majority_ok,
        deltas=deltas,
        hostage=hostage.to(f32),
        info_share=info_share,
        dominant=(dominant & minority).to(f32),
    )


def decide(verdict: ConsensusResult, prev_counts: torch.Tensor, nk: torch.Tensor,
           trigger_frac: float, max_frac: float, persist: int = 3) -> ConsensusDecision:
    """Act only on persistent (flagged on the previous ``persist - 1``
    frames too), minority-sized disagreement under a pixel majority;
    persistent hostage flags ask for a rescue that also masks every
    recently identified mover stratum."""
    n_total = torch.clamp(_seqsum(nk), min=1.0)
    gate = (prev_counts >= float(persist - 1)).to(torch.float32)
    persistent = verdict.excluded * gate
    excluded_frac = _seqsum(persistent * nk) / n_total
    triggered = (excluded_frac > trigger_frac) & (excluded_frac < max_frac) & verdict.majority_ok
    hostage_p = verdict.hostage * gate
    rescue = _seqsum(hostage_p) > 0.5
    recent = (prev_counts >= float(persist)).to(torch.float32)
    excl = torch.where(rescue, torch.maximum(torch.maximum(persistent, hostage_p), recent),
                       persistent)
    act = triggered | rescue
    member = torch.where(act, 1.0 - excl, torch.ones_like(nk))
    frac = _seqsum(excl * nk) / n_total
    return ConsensusDecision(member=member, triggered=act,
                             excluded_frac=torch.where(act, frac, torch.zeros_like(frac)),
                             rescue=rescue)


# ---------------------------------------------------------------------------
# One vote of the tracker: analyze, decide and the per-vote bookkeeping.


class VoteParams(NamedTuple):
    """The by-value parameters of one vote (TrackingConfig's consensus
    fields; ``tol`` already scaled to the vote's level)."""

    tol: float
    min_frac: float
    err_ratio: float
    err_floor: float
    trigger_frac: float
    max_frac: float
    persist: int
    attack_probe: bool

    @classmethod
    def of(cls, cfg, tol: float) -> "VoteParams":
        return cls(tol, cfg.consensus_min_frac, cfg.consensus_err_ratio, cfg.consensus_err_floor,
                   cfg.consensus_trigger_frac, cfg.consensus_max_frac, cfg.consensus_persist,
                   bool(cfg.attack_probe))


# The vote state, one float32 vector of 5K + 3: member, flags_any (the
# frame's raw flags, excluded or hostage, at any vote), nk_last (the last
# vote's stratum counts), probe_cand (one-hot attack-probe candidate),
# excl_any (strata vote-excluded at any vote), then probe_fire,
# consensus_frac and rescue_flag.
def state_size(k: int) -> int:
    return 5 * k + 3


class VoteState(NamedTuple):
    member: torch.Tensor
    flags_any: torch.Tensor
    nk_last: torch.Tensor
    probe_cand: torch.Tensor
    excl_any: torch.Tensor
    probe_fire: torch.Tensor
    consensus_frac: torch.Tensor
    rescue_flag: torch.Tensor

    @classmethod
    def split(cls, v: torch.Tensor, k: int) -> "VoteState":
        return cls(*v.split([k, k, k, k, k, 1, 1, 1]))

    @classmethod
    def initial(cls, member: torch.Tensor) -> torch.Tensor:
        """The state before a frame's first vote, from its episode member
        vector."""
        k = member.shape[0]
        zeros = torch.zeros((2 * k + 3,), dtype=torch.float32, device=member.device)
        return torch.cat([member, torch.zeros_like(member), torch.ones_like(member), zeros])


# Diagnostics a vote writes beside the state: deltas (6K), excluded,
# hostage, dominant, info_share, the decision's member (K each), then
# majority_ok, triggered, rescue, excluded_frac.
def diag_size(k: int) -> int:
    return 11 * k + 4


class VoteDiag(NamedTuple):
    deltas: torch.Tensor
    excluded: torch.Tensor
    hostage: torch.Tensor
    dominant: torch.Tensor
    info_share: torch.Tensor
    member: torch.Tensor
    majority_ok: torch.Tensor
    triggered: torch.Tensor
    rescue: torch.Tensor
    excluded_frac: torch.Tensor

    @classmethod
    def split(cls, v: torch.Tensor, k: int) -> "VoteDiag":
        d, e, h, dm, i, m, rest = v.split([6 * k, k, k, k, k, k, 4])
        return cls(d.view(k, 6), e, h, dm, i, m, *rest.unbind())


def vote_plain(sums: torch.Tensor, bscale: torch.Tensor, hist: torch.Tensor,
               state: torch.Tensor, p: VoteParams):
    """``consensus_vote`` in plain PyTorch: (state', go, diag)."""
    from ..ops.gauss_newton import unpack_stratified

    f32 = torch.float32
    K = sums.shape[0]
    st = VoteState.split(state, K)
    Hk, bk, nk, Gk, ek = unpack_stratified(sums)
    verdict = analyze(Hk, bk, nk, Gk, ek, p.tol, p.min_frac, p.err_ratio, p.err_floor, bscale)
    flags_any = torch.maximum(st.flags_any, torch.maximum(verdict.excluded, verdict.hostage))
    decision = decide(verdict, hist, nk, p.trigger_frac, p.max_frac, p.persist)
    probe_cand, probe_fire, excl_any = st.probe_cand, st.probe_fire, st.excl_any
    if p.attack_probe:
        # Attack-probe candidate: a vote exclusion under a clear majority
        # names a victim; the stratum that can drag the pose is the highest
        # information-density agreeing minority voter.
        tot_k = torch.clamp(_seqsum(nk), min=1.0)
        voter_k = nk >= p.min_frac * tot_k
        pool = voter_k & (verdict.excluded < 0.5) & (nk < MINORITY_CAP * tot_k)
        dens = torch.where(pool, verdict.info_share / torch.clamp(nk / tot_k, min=1e-6),
                           torch.full_like(nk, -1.0))
        fire_l = ((_seqsum(verdict.excluded) > 0.5) & verdict.majority_ok
                  & (_seqsum(pool.to(f32)) > 0.5))
        onehot = (torch.arange(K, device=sums.device) == torch.argmax(dens)).to(f32)
        probe_cand = torch.where(fire_l, onehot, probe_cand)
        probe_fire = torch.maximum(probe_fire, fire_l.to(f32).reshape(1))
        excl_any = torch.maximum(excl_any, verdict.excluded)
    member2 = st.member * decision.member
    consensus_frac = torch.maximum(st.consensus_frac, decision.excluded_frac.reshape(1))
    rescue_flag = torch.maximum(st.rescue_flag, decision.rescue.to(f32).reshape(1))
    # Rerun the level from its pre-level state only when a stratum was
    # NEWLY excluded (an episode-masked mover keeps flagging).
    changed = _seqsum((member2 < st.member).to(f32)) > 0.5
    go = (decision.triggered & changed & ~decision.rescue).to(torch.int32)
    state2 = torch.cat([member2, flags_any, nk, probe_cand, excl_any, probe_fire, consensus_frac,
                        rescue_flag])
    diag = torch.cat([verdict.deltas.reshape(-1), verdict.excluded, verdict.hostage,
                      verdict.dominant, verdict.info_share, decision.member,
                      torch.stack([verdict.majority_ok.to(f32), decision.triggered.to(f32),
                                   decision.rescue.to(f32), decision.excluded_frac])])
    return state2, go, diag


def consensus_vote(sums: torch.Tensor, bscale: torch.Tensor, hist: torch.Tensor,
                   state: torch.Tensor, p: VoteParams):
    """One consensus vote from the (K, 50) stratified sums, the baseline
    scale (a device scalar), the streak history ``hist`` (K,) and the vote
    state (``VoteState``): ``analyze``, ``decide``, then the vote's
    bookkeeping (the member vector, the frame's raw flags, the attack-probe
    candidate, consensus_frac, the rescue flag). Returns (state', go,
    diag): the new state, an int32 word that is 1 when the level's masked
    rerun must run, and the vote's diagnostics (``VoteDiag``). CPU runs
    ``vote_plain``; CUDA one launch of one block, which reads nothing back
    to the host."""
    dev = sums.device
    if dev.type == "cpu":
        return vote_plain(sums, bscale, hist, state, p)
    if dev.type != "cuda":
        raise ValueError(f"no consensus vote kernel for device {dev}")
    K = sums.shape[0]
    if not 1 <= K <= _build.MAX_STRATA:
        raise ValueError(f"{K} strata: the kernel takes 1 to {_build.MAX_STRATA}")
    _build.require(sums, "sums", dev, (K, 50))
    _build.require(bscale, "bscale", dev, ())
    _build.require(hist, "hist", dev, (K,))
    _build.require(state, "state", dev, (state_size(K),))
    state2 = torch.empty_like(state)
    go = torch.empty((), dtype=torch.int32, device=dev)
    diag = torch.empty((diag_size(K),), dtype=torch.float32, device=dev)
    params = _build.VoteParams(
        k=K, tol=p.tol, min_frac=p.min_frac, err_ratio=p.err_ratio, err_floor=p.err_floor,
        trigger_frac=p.trigger_frac, max_frac=p.max_frac, persist=int(p.persist),
        attack_probe=int(bool(p.attack_probe)))
    status = _build.library().consensus_vote_launch(
        params, sums.data_ptr(), bscale.data_ptr(), hist.data_ptr(), state.data_ptr(),
        state2.data_ptr(), go.data_ptr(), diag.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "consensus_vote_launch")
    consensus_vote.launches += 1
    return state2, go, diag


consensus_vote.launches = 0
