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

Here steps 2 and 3 run on the host, in numpy float32, on the (K, 50) sums
of one vote: the vote's outcome decides host branches anyway (the masked
rerun and the rescue), so the vote costs one read of those sums, where on
the device the same work would be about a hundred tiny launches and would
still need a read for the branch. numpy also gives the JAX package's
semantics where PyTorch would not: ``np.nanmedian`` takes the mean of the
two middle values (``torch.nanmedian`` the lower one), and the per-stratum
eigensolver runs without cuSOLVER's synchronizing status check.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

_F32 = np.float32

# Pixel-minority caps shared by every "a mover is a pixel minority" gate:
# MINORITY_CAP bounds the dominance / hostage candidates and the tracker's
# attack-probe pool; ERR_MINORITY_CAP, looser, bounds the error-outlier
# test only (a transiting panel covers 34-35% of vote-level pixels at its
# peak, and its streak must not break there).
MINORITY_CAP = 0.35
ERR_MINORITY_CAP = 0.40


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
    oh = torch.nn.functional.one_hot(idx, k).permute(2, 0, 1).to(torch.float32)
    return oh * mask[None]


def member_mask(xi: torch.Tensor, mask: torch.Tensor, edges: torch.Tensor,
                member: torch.Tensor) -> torch.Tensor:
    """Per-pixel keep mask: the pixels of strata voted out of the consensus
    leave the template. ``member`` is a (K,) float32 tensor on the device
    of ``xi``."""
    return mask * member[stratum_index(xi, edges)]


def excluded_mask(idx: torch.Tensor, mask: torch.Tensor, member: np.ndarray) -> torch.Tensor:
    """``member_mask`` for a host member vector of 0s and 1s, from a
    stratum-index plane: every stratum whose member is 0 is cut out of
    ``mask`` by device ops alone, so the host vector is never uploaded."""
    for k in np.flatnonzero(np.asarray(member) < 0.5):
        mask = mask * (idx != int(k))
    return mask


class ConsensusResult(NamedTuple):
    excluded: np.ndarray  # (K,) f32: 1 = stratum disagrees with the majority
    majority_ok: bool  # a genuine pixel majority exists
    deltas: np.ndarray  # (K, 6) per-stratum preferred corrections
    hostage: np.ndarray  # (K,) f32: the pose is held by this aligned minority
    info_share: np.ndarray  # (K,) f32 Fisher-information share per stratum
    dominant: np.ndarray  # (K,) f32: information-dominant minority voters (diagnostic)


class ConsensusDecision(NamedTuple):
    member: np.ndarray  # (K,) f32: 1 = stratum kept
    triggered: bool  # act on the verdict
    excluded_frac: float  # pixel fraction masked out (f32 value)
    rescue: bool  # re-track the whole pyramid from the prior with member masked


def _nanmedian(x: np.ndarray) -> np.float32:
    """np.nanmedian (the mean of the two middle values), 0 when all-NaN."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        m = np.nanmedian(x)
    return _F32(m) if np.isfinite(m) else _F32(0.0)


def analyze(Hk, bk, nk, Gk, ek, tol: float, min_frac: float, err_ratio: float = 4.0,
            err_floor: float = 1.0, baseline_scale=1.0) -> ConsensusResult:
    """Per-stratum corrections and the pixel-count-majority consensus, on
    raw per-stratum sums (float32 numpy): (K, 6, 6) H, (K, 6) b, (K,) n,
    (K, 6, 6) geometry Gram, (K,) weighted error. ``tol`` is in pixels at
    the vote level; ``baseline_scale`` inflates the thresholds with the
    motion since the keyframe. Two disagreement tests: the delta vote
    (slow movers inside the basin) and the error outlier (fast movers
    whose fixed-sigma error saturates)."""
    Hk, bk, nk, Gk, ek = (np.asarray(a, _F32) for a in (Hk, bk, nk, Gk, ek))
    bscale = _F32(baseline_scale)
    n_total = np.maximum(nk.sum(dtype=_F32), _F32(1.0))
    inv_n = _F32(1.0) / np.maximum(nk, _F32(1.0))
    Hn = Hk * inv_n[:, None, None]
    bn = bk * inv_n[:, None]
    # Truncated-eigenspace solves: blind directions of a single depth band
    # are zeroed exactly, well-observed ones recovered exactly.
    eigval, eigvec = np.linalg.eigh(Hn)  # ascending
    keep = eigval > _F32(0.01) * eigval[:, -1:]
    inv_eig = np.where(keep, _F32(1.0) / np.maximum(eigval, _F32(1e-12)), _F32(0.0))
    deltas = np.einsum("kij,kj,klj,kl->ki", eigvec, inv_eig, eigvec, bn).astype(_F32)
    deltas = np.where(np.isfinite(deltas), deltas, _F32(0.0))

    voter = nk >= _F32(min_frac) * n_total
    # Agreement in induced image flow: m[j, k] = (d_j - d_k)^T (G_j/n_j)
    # (d_j - d_k), the mean squared flow hypothesis k imposes on stratum j.
    Gn = Gk * inv_n[:, None, None]
    diff = deltas[:, None, :] - deltas[None, :, :]
    m = np.einsum("jki,jil,jkl->jk", diff, Gn, diff).astype(_F32)
    tol_eff = _F32(tol) * bscale
    agree = m <= tol_eff * tol_eff  # agree[j, k]: j agrees with hypothesis k
    support = (agree * (nk * voter.astype(_F32))[:, None]).sum(axis=0, dtype=_F32)
    support = np.where(voter, support, _F32(-1.0))
    best = int(np.argmax(support))  # ties: the first index, as jnp.argmax

    excluded_vote = voter & ~agree[:, best]
    err_n = ek * inv_n
    err_med = _nanmedian(np.where(voter, err_n, np.nan).astype(_F32))
    excluded_err = (
        voter
        & (nk < _F32(ERR_MINORITY_CAP) * n_total)
        & (err_n > np.maximum(_F32(err_ratio) * err_med * bscale, _F32(err_floor)))
    )
    enough_voters = int(voter.sum()) >= 3
    majority_ok = bool(support[best] > _F32(0.6) * n_total) and enough_voters
    excluded = (excluded_vote & majority_ok) | excluded_err

    # Hostage: the stratum holding a dragged pose is the information-
    # dominant aligned minority while the majority's error climbs.
    info = np.trace(Hk, axis1=1, axis2=2).astype(_F32)
    info_share = info / np.maximum(info.sum(dtype=_F32), _F32(1e-12))
    pix_share = nk / n_total
    dominant = voter & (info_share > _F32(2.0) * np.maximum(pix_share, _F32(1e-6)))
    others = voter & ~excluded & ~dominant
    others_med = _nanmedian(np.where(others, err_n, np.nan).astype(_F32))
    hostage = (
        dominant
        & enough_voters
        & (nk < _F32(MINORITY_CAP) * n_total)
        & (others_med > _F32(2.0) * np.maximum(err_n, _F32(1e-3)))
        & (others_med > _F32(0.35))
    ).astype(_F32)
    # A live hostage explains the majority's decorrelation: the error
    # path's flags point at the dragged static majority that frame.
    if hostage.sum() > 0.5:
        excluded = excluded_vote & majority_ok
    return ConsensusResult(
        excluded=excluded.astype(_F32),
        majority_ok=majority_ok,
        deltas=deltas,
        hostage=hostage,
        info_share=info_share.astype(_F32),
        dominant=(dominant & (nk < _F32(MINORITY_CAP) * n_total)).astype(_F32),
    )


def decide(verdict: ConsensusResult, prev_counts, nk, trigger_frac: float, max_frac: float,
           persist: int = 3) -> ConsensusDecision:
    """Act only on persistent (flagged on the previous ``persist - 1``
    frames too), minority-sized disagreement under a pixel majority;
    persistent hostage flags ask for a rescue that also masks every
    recently identified mover stratum."""
    prev = np.asarray(prev_counts, _F32)
    nk = np.asarray(nk, _F32)
    n_total = np.maximum(nk.sum(dtype=_F32), _F32(1.0))
    gate = (prev >= _F32(persist - 1)).astype(_F32)
    persistent = verdict.excluded * gate
    excluded_frac = (persistent * nk).sum(dtype=_F32) / n_total
    triggered = (
        bool(excluded_frac > _F32(trigger_frac))
        and bool(excluded_frac < _F32(max_frac))
        and verdict.majority_ok
    )
    hostage_p = verdict.hostage * gate
    rescue = bool(hostage_p.sum() > 0.5)
    recent = (prev >= _F32(persist)).astype(_F32)
    excl = np.maximum(np.maximum(persistent, hostage_p), recent) if rescue else persistent
    act = triggered or rescue
    member = (_F32(1.0) - excl) if act else np.ones_like(nk)
    frac = (excl * nk).sum(dtype=_F32) / n_total
    return ConsensusDecision(
        member=member.astype(_F32),
        triggered=act,
        excluded_frac=float(frac) if act else 0.0,
        rescue=rescue,
    )
