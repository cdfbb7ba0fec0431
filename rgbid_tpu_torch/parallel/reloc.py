"""Relocalization scoring with the candidate pairs split across ranks.

Counterpart of ``rgbid_tpu/parallel/reloc.py``: the JAX package shards the
batch axis of its vmapped scorer over a mesh; here each rank scores its
contiguous share of the pairs with its own ``RelocScorer`` (no collective
inside), and one ``all_gather_object`` puts every rank's rows together in
the caller's pair order. The batch is padded with zero pairs to a multiple
of the mesh size, as the reference pads it, and the padding is dropped.
A pair's result does not depend on the pairs scored with it
(``backend/relocalization.py``), so each row equals ``score_pairs``'s.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..backend.relocalization import RelocResult, RelocScorer


def shard_reloc_batch(scorer: RelocScorer, mesh, templates, currents) -> RelocResult:
    """Like ``scorer.score_pairs(templates, currents)``, with the pairs split
    over the ranks of ``mesh``; every rank gets the whole result."""
    n = mesh.size()
    rank = mesh.get_local_rank()
    B = len(templates)
    assert B == len(currents) and B > 0
    pad = (-B) % n
    zt = {k: np.zeros_like(templates[0][k]) for k in templates[0]}
    temps = list(templates) + [zt] * pad
    curs = list(currents) + [dict(zt)] * pad
    per = (B + pad) // n
    mine = scorer.score_pairs(temps[rank * per:(rank + 1) * per],
                              curs[rank * per:(rank + 1) * per])
    parts = [None] * n
    dist.all_gather_object(parts, tuple(mine), group=mesh.get_group())
    return RelocResult(*[np.concatenate([p[f] for p in parts])[:B]
                         for f in range(len(RelocResult._fields))])
