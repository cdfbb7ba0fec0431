"""Dense relocalization scoring on the ESM kernel (K11).

Counterpart of ``rgbid_tpu/backend/relocalization.py:26-177``: loop
candidates are verified by dense ESM alignment of two keyframes' coarse
planes over a three-level mini-pyramid. Every IRLS iteration is one call of
``ops/kernels.py::esm_irls_step``: on the card one launch of
``csrc/esm_normal_eq.cu`` (evaluation, 6x6 solve and pose update), on the
CPU its plain version. There is no other implementation of the ESM math
here.

The JAX package runs all pairs as one ``jit(vmap)`` program and pads the
batch to ``max_candidates`` with zero pairs, because such a program
specializes on its batch size. Nothing here compiles, so the port loops
over the real pairs and pads nothing: a pair's result does not depend on
how many pairs are scored with it.

Per ``score_pairs`` call: one pinned, non-blocking upload per distinct
plane set, ``3 * reloc_iters`` launches per pair, and one read of every
pair's stacked results. The scorer counts its own work (``launches``,
``irls_steps``, ``host_reads``); its launches are kept out of
``esm_residuals_and_normal_eq.launches``, which counts the per-frame path
(``ops/kernels.py::count_launches_into``). It launches on the calling
thread's current stream, which is the default stream unless the caller
changed it, so its launches queue behind the front end's on the kernels'
one workspace.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.camera import Intrinsics, level_intrinsics
from ..core.config import SlamConfig
from ..ops import image
from ..ops.kernels import count_launches_into, esm_irls_step
from ..ops.warp import backproject_grid

SCORER_DAMPING = 1e-6  # the JAX package's ic_update damping in the scorer


class RelocResult(NamedTuple):
    T: np.ndarray  # (B, 4, 4) T_{query<-candidate} (maps template -> current)
    H: np.ndarray  # (B, 6, 6)
    error: np.ndarray  # (B,)
    inlier_frac: np.ndarray  # (B,)
    n_valid: np.ndarray  # (B,)
    sigma_int: np.ndarray  # (B,) final photometric residual scale (absolute)
    sigma_xi: np.ndarray  # (B,) final inverse-depth residual scale (absolute)


def _level_up(intr: Intrinsics) -> Intrinsics:
    """Intrinsics one pyramid level coarser than ``intr``."""
    return Intrinsics(
        fx=intr.fx / 2,
        fy=intr.fy / 2,
        cx=(intr.cx + 0.5) / 2 - 0.5,
        cy=(intr.cy + 0.5) / 2 - 0.5,
        width=(intr.width + 1) // 2,
        height=(intr.height + 1) // 2,
    )


def mini_pyramid(planes: torch.Tensor):
    """[(intensity, xi, mask)] at the stored level and two levels coarser
    (intensity blurred under a mask of ones, xi under its own mask)."""
    out = [tuple(planes.unbind(0))]
    for _ in range(2):
        inten, xi, mask = out[-1]
        inten2, _ = image.downsample(inten, torch.ones_like(mask))
        xi2, mask2 = image.downsample(xi, mask)
        out.append((inten2, xi2, mask2))
    return out


class RelocScorer:
    """Pair aligner bound to (intrinsics, config, device)."""

    def __init__(self, intr: Intrinsics, cfg: SlamConfig, device):
        if cfg.backend.reloc_iters < 1:
            raise ValueError("backend.reloc_iters must be at least 1")
        self.cfg = cfg
        self.device = torch.device(device)
        self.level = min(cfg.backend.reloc_level, cfg.tracking.levels - 1)
        self.intr_l = level_intrinsics(intr, self.level)
        intr_l2 = level_intrinsics(intr, self.level + 1)
        # Fine to coarse, as mini_pyramid orders its levels.
        self.intrs = (self.intr_l, intr_l2, _level_up(intr_l2))
        self.launches = 0  # kernel launches (CUDA only)
        self.irls_steps = 0  # esm_irls_step calls, either device
        self.host_reads = 0  # device-to-host reads: one per score_pairs

    def _upload(self, planes: dict) -> torch.Tensor:
        """(3, h, w) float32 [intensity, xi, mask] on the device."""
        t = torch.from_numpy(
            np.stack([np.asarray(planes[k], np.float32) for k in ("intensity", "xi", "mask")])
        )
        if self.device.type == "cuda":
            # Pinned + non_blocking: a pageable copy would synchronize.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @staticmethod
    def level_args(tmpl, cur, intr_l: Intrinsics):
        """What one level gives ``esm_irls_step`` between the pose and the
        camera: (template intensity, template points, template mask,
        template gradients (4, h, w), current 7-plane stack), from the
        level's (intensity, xi, mask) of the template and of the current
        view. The gradients stay float32: nothing is rounded to bfloat16
        here, unlike the tracker's stored templates."""
        t_int, t_xi, t_mask = tmpl
        c_int, c_xi, c_mask = cur
        gx_i, gy_i = image.gradients_unmasked(t_int)
        gx_x, gy_x = image.gradients(t_xi, t_mask)
        t_grads = torch.stack([gx_i, gy_i, gx_x, gy_x])
        cgx_i, cgy_i = image.gradients_unmasked(c_int)
        cgx_x, cgy_x = image.gradients(c_xi, c_mask)
        c_stack7 = torch.stack([c_int, c_xi, c_mask, cgx_i, cgy_i, cgx_x, cgy_x])
        t_points = tuple(p.contiguous() for p in backproject_grid(t_xi, intr_l))
        return t_int.contiguous(), t_points, t_mask.contiguous(), t_grads, c_stack7

    def _align_level(self, tmpl, cur, T, s2i, s2x, intr_l: Intrinsics):
        """``reloc_iters`` ESM IRLS iterations at one level. Returns the
        pose after the last update, the scales and the evaluation of the
        last iteration (taken at the pose before its update)."""
        args = self.level_args(tmpl, cur, intr_l)
        nu = self.cfg.tracking.student_t_nu
        res = None
        for _ in range(self.cfg.backend.reloc_iters):
            step = esm_irls_step(T, *args, intr_l, nu, s2i, s2x, occlusion_gate=True,
                                 gate_cap=0.0, damping=SCORER_DAMPING)
            self.irls_steps += 1
            T, res = step.T, step.result
            s2i, s2x = res.sigma2_int, res.sigma2_xi
        return T, s2i, s2x, res

    def _single_pair(self, tmpl: torch.Tensor, cur: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        """Coarse-to-fine alignment of one pair; its result row of 57
        floats: T, H, error, inlier share, n_valid and the two final
        scales."""
        dev = self.device
        s2i = torch.full((), 0.01, dtype=torch.float32, device=dev)
        s2x = torch.full((), 0.0025, dtype=torch.float32, device=dev)
        tp, cp = mini_pyramid(tmpl), mini_pyramid(cur)
        for lvl in (2, 1, 0):
            T, s2i, s2x, res = self._align_level(tp[lvl], cp[lvl], T, s2i, s2x, self.intrs[lvl])
        return torch.cat([T.reshape(-1), res.H.reshape(-1),
                          torch.stack([res.error, res.inlier_frac, res.n_valid]),
                          torch.sqrt(torch.stack([s2i, s2x]))])

    def score_pairs(
        self,
        templates: List[dict],
        currents: List[dict],
        T_inits: Optional[List[np.ndarray]] = None,
    ) -> RelocResult:
        """templates/currents: lists of reloc_planes dicts with keys
        intensity/xi/mask at the reloc level. Returns stacked host results.

        T maps template(candidate)-frame points into current(query)-frame.
        """
        B = len(templates)
        assert B == len(currents) and B > 0
        eye = np.eye(4, dtype=np.float32)
        t_list = [eye] * B if T_inits is None else [np.asarray(T, np.float32) for T in T_inits]
        T0 = torch.from_numpy(np.stack(t_list))
        if self.device.type == "cuda":
            T0 = T0.pin_memory().to(self.device, non_blocking=True)
        uploaded: dict = {}  # one upload per distinct plane set

        def on_device(planes: dict) -> torch.Tensor:
            if id(planes) not in uploaded:
                uploaded[id(planes)] = self._upload(planes)
            return uploaded[id(planes)]

        with count_launches_into(self):
            rows = [self._single_pair(on_device(t), on_device(c), T0[i])
                    for i, (t, c) in enumerate(zip(templates, currents))]
        self.host_reads += 1
        out = torch.stack(rows).cpu().numpy()
        return RelocResult(
            T=out[:, :16].reshape(B, 4, 4),
            H=out[:, 16:52].reshape(B, 6, 6),
            error=out[:, 52],
            inlier_frac=out[:, 53],
            n_valid=out[:, 54],
            sigma_int=out[:, 55],
            sigma_xi=out[:, 56],
        )

    def accept(self, res: RelocResult, i: int) -> bool:
        """Acceptance gate (convergence + residual + inlier thresholds)."""
        return all(m > 0 for m in self.margins(res, i).values())

    def margins(self, res: RelocResult, i: int) -> dict:
        """Signed distance of pair ``i`` to each acceptance gate, positive
        inside. ``accept`` is "every margin positive"; the error and
        inlier statistics are Student-t scale-normalized and nearly
        scale-invariant, so the absolute scales ``sigma_int`` and
        ``sigma_xi`` are the discriminative gates."""
        b = self.cfg.backend
        h, w = self.intr_l.height, self.intr_l.width
        return {
            "finite": 1.0 if np.isfinite(np.asarray(res.T[i])).all() else -1.0,
            "n_valid": float(res.n_valid[i]) - 0.2 * h * w,
            "error": b.max_reloc_residual - float(res.error[i]),
            "inlier_frac": float(res.inlier_frac[i]) - b.min_reloc_inliers,
            "sigma_int": b.max_reloc_sigma_int - float(res.sigma_int[i]),
            "sigma_xi": b.max_reloc_sigma_xi - float(res.sigma_xi[i]),
        }
