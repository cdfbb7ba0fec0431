"""Lightweight per-stage wall-clock profiling.

The port's copy of ``rgbid_tpu/utils/profiling.py``. ``StageTimer``
measures host wall time between enter and exit: device work is included
only where the timed code ends in a host read (``SlamSystem.process_frame``
reads every frame's result back). For device traces, ``trace(logdir)``
wraps ``torch.profiler`` and writes a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List


class StageTimer:
    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, dict]:
        import numpy as np

        out = {}
        for k, v in self.times.items():
            a = np.asarray(v)
            out[k] = {
                "n": len(v),
                "mean_ms": float(a.mean() * 1e3),
                "median_ms": float(np.median(a) * 1e3),
                "max_ms": float(a.max() * 1e3),
            }
        return out

    def report(self) -> str:
        rows = [
            f"{k:24s} n={s['n']:4d} med={s['median_ms']:8.2f} ms  max={s['max_ms']:8.2f} ms"
            for k, s in sorted(self.summary().items())
        ]
        return "\n".join(rows)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the enclosed code (host, and the card's
    kernels when CUDA is available), written to ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
