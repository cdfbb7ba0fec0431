"""Single-level IC tracking with the keyframe's rows split across ranks.

Counterpart of ``rgbid_tpu/parallel/spmd.py`` (``SpmdTracker``). The JAX
package runs one ``shard_map`` over a device mesh; here every rank of a
1-D ``DeviceMesh`` (``mesh.py``) calls ``track`` with the whole arrays and
takes its own contiguous band of the keyframe's rows (planes and IC
Jacobian field); the current frame is whole on every rank, since a band's
pixel can warp anywhere in it. The band's points are backprojected with
its global rows, the expression of the JAX module's ``_warp_block``.

Each iteration, on every rank (three launches, three all-reduces):

1. ``ic_sigma_stats`` at the current scales: the band's raw sums
   sum valid w(sigma2) r^2 per channel and its valid count (the
   ``ic_sigma_kernel`` launch);
2. one all-reduce of the stacked three floats;
3. the global scales max(sum / max(N, 1), 1e-12), on the device;
4. ``ic_result`` at those scales: the band's lagged normal equations, a
   per-pixel mean over the band (the ``ic_normal_kernel`` launch);
5. ``allreduce_irls``: the global mean, weighted by the bands' counts (two
   all-reduces);
6. ``irls_solve_step`` with ``min_valid=-inf``: the damped Cholesky solve
   and ``orthonormalize(T . exp(-delta))``, the same bits on every rank
   (the ``csrc/irls_solve.cu`` launch).

The JAX module steps on any finite delta, where ``ic_update`` also asks
for more than 100 valid pixels; ``min_valid=-inf`` keeps the JAX module's
rule, so only the factorization and finiteness decide. The loop starts
from sigma^2 = (0.01, 0.0025) and returns the last iteration's scales.
Under NCCL it reads nothing back to the host; gloo copies a card's
tensors through the host at every all-reduce. ``allreduces`` counts the
collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.camera import Intrinsics
from ..ops.kernels import allreduce_irls, ic_result, ic_sigma_stats, irls_solve_step
from ..ops.warp import backproject_grid

# The scales the JAX module starts from.
SIGMA2_INIT = (0.01, 0.0025)


class SpmdTracker:
    """Row-sharded single-level IC IRLS over the ranks of ``mesh``, bound to
    the level's intrinsics ``intr_l``, the Student-t ``nu`` and ``damping``.

    Usage, on every rank:
        tr = SpmdTracker(make_mesh(), intr_l)
        T, s2i, s2x = tr.track(kf_int, kf_xi, kf_mask, jac12, cur_int, cur_xi,
                               cur_mask, T0, iters=10)
    """

    def __init__(self, mesh, intr_l: Intrinsics, nu: float = 5.0, damping: float = 1e-6):
        self.mesh = mesh
        self.intr_l = intr_l
        self.nu = nu
        self.damping = damping
        self.group = mesh.get_group()
        self.n = mesh.size()
        self.rank = mesh.get_local_rank()
        if intr_l.height % self.n:
            raise ValueError(f"height {intr_l.height} not divisible by mesh size {self.n}")
        self.band = intr_l.height // self.n
        self.allreduces = 0

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        self.allreduces += 1
        return t

    def track(self, kf_int, kf_xi, kf_mask, jac12, cur_int, cur_xi, cur_mask, T0,
              iters: int):
        """``iters`` IRLS iterations from ``T0`` (current <- keyframe) with
        the keyframe's (H, W) planes and (12, H, W) Jacobian field and the
        current frame's planes, all float32 on one device, (H, W) the
        level's size. Returns (T, sigma2_int, sigma2_xi), the same bits on
        every rank."""
        h, w = self.intr_l.height, self.intr_l.width
        if tuple(kf_int.shape) != (h, w):
            raise ValueError(f"keyframe planes must be the level's {h}x{w}, got "
                             f"{tuple(kf_int.shape)}")
        r0, r1 = self.rank * self.band, (self.rank + 1) * self.band
        b_int, b_xi = kf_int[r0:r1].contiguous(), kf_xi[r0:r1].contiguous()
        b_mask, b_jac = kf_mask[r0:r1].contiguous(), jac12[:, r0:r1].contiguous()
        pts = backproject_grid(b_xi, self.intr_l, row_offset=r0)
        intr, nu = self.intr_l, self.nu
        # Filled on the device: a tensor made from host data would copy
        # (and, from pageable memory, synchronize).
        s2i, s2x = (torch.full((), s, dtype=torch.float32, device=T0.device)
                    for s in SIGMA2_INIT)
        T = T0
        for _ in range(iters):
            st = ic_sigma_stats(T, b_int, pts, b_mask, cur_int, cur_xi, cur_mask, intr, nu,
                                s2i, s2x)
            sums = self._reduce(torch.stack([st.swi, st.swx, st.n]))
            s2i, s2x = torch.clamp(sums[:2] / torch.clamp(sums[2], min=1.0), min=1e-12).unbind()
            res = ic_result(T, b_int, pts, b_mask, b_jac, cur_int, cur_xi, cur_mask, intr, nu,
                            s2i, s2x)
            T = irls_solve_step(T, allreduce_irls(res, self._reduce), self.damping,
                                min_valid=float("-inf")).T
        return T, s2i, s2x
