"""Host spans, the flight log, stage timers and profiler traces.

The port's copy of ``rgbid_tpu/utils/profiling.py``, grown into the port's
one timing system.

**Spans.** ``Span(name)`` times a block of host code: ``with span: ...``
reads ``time.perf_counter_ns`` at each end and adds the nanoseconds to the
span's ``ns`` and one to its ``n``; a ``SinkSpan(name, sink)`` also hands
each block's nanoseconds to ``sink``. While a ``torch.profiler`` records, the block
is also entered in the profiler's host timeline under its name, as a host
operation: not as a user annotation, which the profiler mirrors onto the
device's timeline. The profiler stamps host and device events on one wall
clock, so a span sits on the card's timeline, and an idle gap of the card
is named by the span the host was in.

**The flight log.** Every ``SlamSystem`` times its host path with the
span ``rgbid.flight`` and its five children (``SPANS``); each flight of
``feed`` (``process_frame`` is a flight of one) is one row of a
process-wide ring of ``ROWS`` rows
(``FLIGHT_DTYPE``), allocated at the first row and overwritten oldest
first when full. ``flights(system)`` returns the rows still held. A row
holds:

- ``rgbid.flight``: from the flight's first ``pack_frame`` to the end of
  its last ``_handle`` (``wall_ns``; ``start_ns`` on the wall clock of
  ``time.time_ns``, the profiler's, so a row can be laid over a trace);
- ``rgbid.pack``: ``pack_frame``, the gray and depth codec on the host,
  one native pass over the pixels (``native/pack_frame.cpp``; numpy
  without a toolchain);
- ``rgbid.upload``: ``_upload``: ``from_numpy``, ``pin_memory``, the
  host-to-device copy's enqueue;
- ``rgbid.dispatch``: ``_dispatch``: the step graph's input copies, its
  replay, the launch counters, the retire ring's copy, the result's clone
  (for the bootstrap frame, the keyframe's founding);
- ``rgbid.wait``: the flight's one read of its result vectors, the time the
  host is blocked on the card plus the copy back (and the reads of the
  event pairs already finished, below);
- ``rgbid.handle``: each frame's ``_handle``: unpacking, pose algebra, the
  records, a keyframe switch's bookkeeping;
- ``busy_ns``: the card's time from each frame's upload to the end of its
  ring copy, summed over the frames: one pair of CUDA timing events a
  frame, recorded and read through libcuda (``_libcuda``); the pairs the
  card has finished are read inside ``rgbid.wait`` before the flight's
  read, the rest after it, so nothing synchronizes (0 on the CPU);
- ``gc_ns`` and ``gc_n``: the interpreter's garbage collections that ran
  during the flight (any thread's);
- ``profiled``: a profiler was recording during the flight.

A relocalization's replayed frames add to the row of the flight they belong
to; ``frames`` counts each frame once. The accumulation is always on: two
clock reads a span, two event records and one elapsed-time read a frame.

``StageTimer`` and the back end's ``timings`` record through ``SinkSpan``.
``trace(logdir)`` writes a ``torch.profiler`` Chrome trace that carries the
spans beside the card's kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch.autograd.profiler as _autograd_profiler

try:  # A host operation in the profiler's timeline, with no device mirror.
    from torch._C._profiler import _RecordFunctionFast as _HostOp
except ImportError:  # pragma: no cover - a torch without it enters no span
    _HostOp = None

_now = time.perf_counter_ns
# perf_counter_ns + _WALL_OFFSET is the wall clock of time.time_ns().
_WALL_OFFSET = time.time_ns() - time.perf_counter_ns()

# The child spans of a flight, in the order of a frame's host path.
SPANS = ("pack", "upload", "dispatch", "wait", "handle")

FLIGHT_DTYPE = np.dtype(
    [("system", np.int64), ("first_frame", np.int64), ("frames", np.int64),
     ("start_ns", np.int64), ("wall_ns", np.int64)]
    + [(f"{s}_{k}", np.int64) for s in SPANS for k in ("ns", "n")]
    + [("busy_ns", np.int64), ("gc_ns", np.int64), ("gc_n", np.int64), ("profiled", np.bool_)])

ROWS = 65536

_LOCK = threading.Lock()
_LOG: Optional[np.ndarray] = None
_WRITTEN = 0
_SYSTEM_IDS = itertools.count()
# Garbage collections: total ns, count, start of the one running.
_GC = [0, 0, 0]
_GC_HOOKED = False


def _profiling() -> bool:
    return _HostOp is not None and _autograd_profiler._is_profiler_enabled


class Span:
    """A named host span (see the module docstring). One object times one
    block at a time; it is not re-entrant, so a thread makes its own."""

    __slots__ = ("name", "ns", "n", "_t0", "_op")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0
        self.n = 0
        self._t0 = 0
        self._op = None

    def __enter__(self) -> "Span":
        if _autograd_profiler._is_profiler_enabled and _HostOp is not None:
            self._op = _HostOp(self.name)
            self._op.__enter__()
        self._t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.ns += _now() - self._t0
        self.n += 1
        if self._op is not None:
            self._op.__exit__(None, None, None)
            self._op = None
        return False


class SinkSpan(Span):
    """A span that hands each block's nanoseconds to ``sink``."""

    __slots__ = ("sink",)

    def __init__(self, name: str, sink: Callable[[int], None]):
        super().__init__(name)
        self.sink = sink

    def __exit__(self, exc_type, exc, tb) -> bool:
        ns = self.ns
        super().__exit__(exc_type, exc, tb)
        self.sink(self.ns - ns)
        return False


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _GC[2] = _now()
    else:
        _GC[0] += _now() - _GC[2]
        _GC[1] += 1


def _append(row: tuple) -> None:
    global _LOG, _WRITTEN
    with _LOCK:
        if _LOG is None:
            _LOG = np.zeros(ROWS, FLIGHT_DTYPE)
        _LOG[_WRITTEN % len(_LOG)] = row
        _WRITTEN += 1


def flights(system: Optional[int] = None) -> np.ndarray:
    """The flight log's rows still held (``FLIGHT_DTYPE``), oldest first; of
    one system (``FlightRecorder.system``) where ``system`` is given."""
    with _LOCK:
        if _LOG is None:
            rows = np.zeros(0, FLIGHT_DTYPE)
        elif _WRITTEN <= len(_LOG):
            rows = _LOG[:_WRITTEN].copy()
        else:
            i = _WRITTEN % len(_LOG)
            rows = np.concatenate([_LOG[i:], _LOG[:i]])
    return rows if system is None else rows[rows["system"] == system]


def flight_summary(rows: np.ndarray) -> dict:
    """Over ``rows`` of the flight log: the host microseconds a frame of each
    child span (``us_per_frame``) and the card's idle share of the flights'
    wall time in percent (``device_idle_pct``; None without a card)."""
    frames = int(rows["frames"].sum())
    wall, busy = int(rows["wall_ns"].sum()), int(rows["busy_ns"].sum())
    return {
        "frames": frames,
        "us_per_frame": {s: float(rows[f"{s}_ns"].sum()) * 1e-3 / max(frames, 1) for s in SPANS},
        "device_idle_pct": 100.0 * (1.0 - busy / wall) if busy > 0 and wall > 0 else None,
    }


# CUDA_ERROR_NOT_READY: an event pair not yet completed.
_NOT_READY = 600
_LIBCUDA = None


def _libcuda():
    """libcuda's ``cuEventRecord`` and ``cuEventElapsedTime`` through ctypes:
    on the events of ``torch.cuda.Event`` the cheapest route from Python
    (``Event.record()`` builds a Stream object first, and ``elapsed_time``
    raises on a pair not yet completed where libcuda returns a code)."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuEventRecord.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cuEventRecord.restype = ctypes.c_int
        lib.cuEventElapsedTime.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                                           ctypes.c_void_p]
        lib.cuEventElapsedTime.restype = ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


def _fail(call: str, status: int):
    raise RuntimeError(f"{call} failed with CUDA error {status}")


class FlightRecorder:
    """One system's spans and its rows of the flight log.

    ``open(first_frame)`` starts a flight, ``close(frames)`` ends it and
    writes its row. On a card, ``frame_begin`` records a frame's first
    timing event on the current stream (the upload calls it right before
    its copy; ``_dispatch`` where the frame had no upload) and
    ``frame_end`` its second, after the frame's last device work; the
    events come from a pool that grows to the deepest flight's two a frame.
    ``settle`` reads the pairs that have completed (the drain calls it
    while the card finishes the flight, before the read); ``close``, after
    the flight's read, reads the rest and sums them. No call synchronizes."""

    def __init__(self, device):
        global _GC_HOOKED
        self.system = next(_SYSTEM_IDS)
        self.flight = Span("rgbid.flight")
        self.pack, self.upload, self.dispatch, self.wait, self.handle = self._children = tuple(
            Span("rgbid." + s) for s in SPANS)
        self._cuda = device.type == "cuda"
        self._device = device
        self._pool: List[tuple] = []  # (start, end) torch.cuda.Event pairs
        self._pairs: List[tuple] = []  # their CUevent handles, as ctypes pointers
        self._stream = None
        self._cu_record = None
        self._ms = ctypes.c_float()
        self._k = 0
        self._read = 0
        self._busy_ms = 0.0
        self._begun = False
        self._open = False
        self._first = 0
        self._gc0 = (0, 0)
        self._profiled = False
        if self._cuda:
            self._cu_record = _libcuda().cuEventRecord
            self._stream = self._current_stream()
        if not _GC_HOOKED:
            _GC_HOOKED = True
            gc.callbacks.append(_on_gc)

    def _current_stream(self):
        import torch

        index = self._device.index
        return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device() if index is None else index))

    def open(self, first_frame: int) -> None:
        """Start the flight whose first frame is the system's frame
        ``first_frame``. A flight left open by an exception is dropped."""
        if self._open:
            self.flight.__exit__(None, None, None)
        for s in self._children:
            s.ns = s.n = 0
        self.flight.ns = self.flight.n = 0
        self._first, self._k, self._read, self._busy_ms = first_frame, 0, 0, 0.0
        self._begun, self._open = False, True
        self._gc0 = (_GC[0], _GC[1])
        self._profiled = _profiling()
        if self._cuda:
            self._stream = self._current_stream()
        self.flight.__enter__()

    def frame_begin(self) -> None:
        """The current frame's first timing event, unless it has one."""
        if self._begun or not self._cuda:
            return
        if self._k == len(self._pairs):
            self._grow()
        status = self._cu_record(self._pairs[self._k][0], self._stream)
        if status:
            _fail("cuEventRecord", status)
        self._begun = True

    def frame_end(self) -> None:
        """The current frame's second timing event; the next frame's pair
        comes next."""
        if not self._cuda:
            return
        if not self._begun:
            self.frame_begin()
        status = self._cu_record(self._pairs[self._k][1], self._stream)
        if status:
            _fail("cuEventRecord", status)
        self._k += 1
        self._begun = False

    def _grow(self) -> None:
        """One more pair in the pool."""
        import torch

        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for event in pair:
            event.record()  # torch creates the CUevent at its first record
        self._pool.append(pair)
        self._pairs.append(tuple(ctypes.c_void_p(e.cuda_event) for e in pair))

    def settle(self) -> bool:
        """Add the flight's completed event pairs, in order, to its busy
        time; True when every pair so far is read."""
        if self._read == self._k:
            return True
        lib, ms = _libcuda(), self._ms
        while self._read < self._k:
            start, end = self._pairs[self._read]
            status = lib.cuEventElapsedTime(ctypes.byref(ms), start, end)
            if status == _NOT_READY:
                return False
            if status:
                _fail("cuEventElapsedTime", status)
            self._busy_ms += ms.value
            self._read += 1
        return True

    def close(self, frames: int) -> int:
        """End the flight of ``frames`` frames, write its row; returns the
        flight's wall nanoseconds. Comes after the flight's read."""
        self.flight.__exit__(None, None, None)
        self._open = False
        profiled = self._profiled or _profiling()
        if not self.settle():
            raise RuntimeError("a frame's event pair had not completed at its flight's close")
        gc_ns, gc_n = _GC[0] - self._gc0[0], _GC[1] - self._gc0[1]
        c = self._children
        _append((self.system, self._first, frames, self.flight._t0 + _WALL_OFFSET, self.flight.ns,
                 c[0].ns, c[0].n, c[1].ns, c[1].n, c[2].ns, c[2].n, c[3].ns, c[3].n, c[4].ns,
                 c[4].n, round(self._busy_ms * 1e6), gc_ns, gc_n, profiled))
        return self.flight.ns


class StageTimer:
    """Host wall seconds of named stages (``times``). Each stage is a
    ``Span``, so it shows in a profiler trace under its name."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    def stage(self, name: str) -> Span:
        return SinkSpan(name, lambda ns: self.times[name].append(ns * 1e-9))

    def summary(self) -> Dict[str, dict]:
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
    kernels when CUDA is available), written to ``logdir/trace.json``.

    The Chrome trace carries the program's spans (``rgbid.flight`` and its
    children, the back end's ``rgbid.backend.*``, ``StageTimer`` stages)
    as host operations on the card's timeline: an idle stretch of the card
    lies under the span the host was in."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
