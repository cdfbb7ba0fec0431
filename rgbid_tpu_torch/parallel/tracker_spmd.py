"""Row-sharded execution of the production tracker across ranks.

Counterpart of ``rgbid_tpu/parallel/tracker_spmd.py``. The JAX package
wraps its tracker in a ``shard_map``; here every rank of a 1-D mesh calls
``ShardedTracker.track`` with the same inputs, and
``tracking/tracker.py::track`` runs with a ``reduce`` that all-reduces
over the mesh's process group:

* each rank takes its row band of every keyframe level (unstrided; the
  tracker decimates its own band by the template stride) and backprojects
  it with the band's global rows (``row_offsets``, in strided rows);
* the current frame is whole on every rank (a template pixel can warp
  anywhere in it);
* each IRLS iteration is the rank's evaluation, two all-reduces (the valid
  count, then the 48 weighted result floats) and the same 6x6 solve on
  every rank (``ops/kernels.py``: ``esm_result``, ``allreduce_irls``,
  ``irls_solve_step``); the vote's (K, 50) sums, the rescue's evidence,
  the affine-illumination sums and the template count are all-reduced
  too, so every rank takes the same host branches and returns the same
  ``TrackResult``.

ESM only, as in the JAX package. Every level's height must divide by the
mesh size and every band's height by the level's template stride (a band
decimated on its own then equals the global decimation); anything else
raises ValueError. ``allreduces`` counts the collectives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.camera import Intrinsics, level_intrinsics
from ..tracking.frames import FrameLevel, KeyframeLevel
from ..tracking.tracker import TrackResult, check_tracking_supported, track


class ShardedTracker:
    """The production ESM tracker over the ranks of ``mesh`` (a 1-D
    ``DeviceMesh``, ``parallel/mesh.py``), bound to (intrinsics, config).
    ``jac_dtype`` is the template's storage precision, as ``Tracker``'s."""

    def __init__(self, mesh, intr: Intrinsics, cfg, jac_dtype: str = "f32"):
        if cfg.jacobian != "esm":
            raise ValueError("ShardedTracker supports the ESM production path")
        check_tracking_supported(cfg)
        self.mesh = mesh
        self.cfg = cfg
        self.jac_dtype = jac_dtype
        self.group = mesh.get_group()
        self.n = mesh.size()
        self.rank = mesh.get_local_rank()
        self.intrs = tuple(level_intrinsics(intr, l) for l in range(cfg.levels))
        strides = tuple(cfg.template_stride or ())
        self.strides = strides + (1,) * max(0, cfg.levels - len(strides))
        for l in range(cfg.levels):
            h = self.intrs[l].height
            if h % self.n:
                raise ValueError(f"level {l} height {h} not divisible by mesh size {self.n}")
            # A band decimated on its own equals the global decimation only
            # when the band height divides by the stride.
            if (h // self.n) % self.strides[l]:
                raise ValueError(f"level {l} per-rank band height {h // self.n} not divisible "
                                 f"by template_stride {self.strides[l]}")
        self.bands = tuple(self.intrs[l].height // self.n for l in range(cfg.levels))
        # Each band's first row at its level, in strided rows.
        self.row_offsets = tuple(self.rank * self.bands[l] // self.strides[l]
                                 for l in range(cfg.levels))
        self.allreduces = 0

    def band(self, kf: Tuple[KeyframeLevel, ...]) -> Tuple[KeyframeLevel, ...]:
        """This rank's row band of every keyframe level (contiguous)."""
        out = []
        for l, kl in enumerate(kf):
            r0, r1 = self.rank * self.bands[l], (self.rank + 1) * self.bands[l]
            out.append(KeyframeLevel(
                intensity=kl.intensity[r0:r1].contiguous(), xi=kl.xi[r0:r1].contiguous(),
                mask=kl.mask[r0:r1].contiguous(), jac=kl.jac[:, r0:r1].contiguous()))
        return tuple(out)

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        self.allreduces += 1
        return t

    def track(
        self,
        kf: Tuple[KeyframeLevel, ...],
        cur: Tuple[FrameLevel, ...],
        T_init: torch.Tensor,
        cons_prev: Optional[np.ndarray] = None,
    ) -> TrackResult:
        """Track ``cur`` against the whole keyframe pyramid ``kf`` (each rank
        uses its band of it); every rank returns the same result.
        ``cons_prev`` defaults to the zero history of a fresh MotionState:
        without it the tracker would waive the consensus persistence gates,
        a single-shot semantic that a streaming caller must not get."""
        if cons_prev is None:
            cons_prev = torch.zeros((self.cfg.consensus_bins,), dtype=torch.float32,
                                    device=T_init.device)
        return track(self.band(kf), cur, T_init, self.intrs, self.cfg, self.jac_dtype,
                     cons_prev, reduce=self._reduce, row_offsets=self.row_offsets)
