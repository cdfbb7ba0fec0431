"""The program's flight log over the untraced window.

The program keeps a process-wide log of its flights
(``rgbid_tpu_torch/utils/profiling.py``: one row a ``feed`` flight, with the
host nanoseconds of its spans ``rgbid.pack``, ``rgbid.upload``,
``rgbid.dispatch``, ``rgbid.wait`` and ``rgbid.handle`` and the card's busy
nanoseconds from one pair of CUDA timing events a frame). ``window_rows``
takes the rows of the run's untraced window; the readers of the
``host_*_us_per_frame.offline`` metrics and ``device_idle_pct.untraced``
reduce them. A program without the log (ImportError or AttributeError)
gives no rows, and its readers no value.
"""

from __future__ import annotations

from typing import Optional


def window_rows(ctx: dict):
    """The rows of the untraced window, in frame order: the last system's
    rows whose first frame is past the warm-up (``1 + warmup_frames``),
    taken until their frames sum to the window's. None where the program
    has no flight log, the sum does not come out exactly or a row in the
    window was profiled. Never raises: a reader of a program that logs
    otherwise reads nothing."""
    try:
        import numpy as np

        from rgbid_tpu_torch.utils import profiling

        rows = profiling.flights()
        if len(rows) == 0:
            return None
        rows = rows[rows["system"] == rows["system"][-1]]
        rows = rows[rows["first_frame"] >= 1 + int(ctx["traffic"]["warmup_frames"])]
        rows = rows[np.argsort(rows["first_frame"], kind="stable")]
        want = int(ctx["window"]["frames"])
        cum = np.cumsum(rows["frames"])
        n = int(np.searchsorted(cum, want))
        if n >= len(cum) or int(cum[n]) != want:
            return None
        rows = rows[:n + 1]
        return None if rows["profiled"].any() else rows
    except Exception:  # noqa: BLE001 - the run goes on without the metric
        return None


def span_us_per_frame(ctx: dict, span: str) -> Optional[float]:
    """Microseconds a frame of the program's span ``rgbid.<span>`` over the
    untraced window; cells that feed flights."""
    if ctx["traffic"]["entry"] != "feed":
        return None
    rows = window_rows(ctx)
    if rows is None:
        return None
    return float(rows[f"{span}_ns"].sum()) * 1e-3 / int(rows["frames"].sum())


def device_idle_pct(ctx: dict) -> Optional[float]:
    """100 x (1 - the card's busy time summed over the untraced window's
    frames / the window's wall time); None without busy time (the CPU)."""
    if ctx["traffic"]["entry"] != "feed":
        return None
    rows = window_rows(ctx)
    if rows is None:
        return None
    busy_s = float(rows["busy_ns"].sum()) * 1e-9
    if busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / ctx["window"]["seconds"])
