"""The port's host spans and flight log (``rgbid_tpu_torch/utils/profiling.py``)
on the CPU at 160x120: the rows a ``feed`` and a ``process_frame`` loop
write, the ring's wrap, the spans under ``torch.profiler`` (host operations,
not user annotations, on the profiler's wall clock, none without a
profiler), ``trace(logdir)``'s Chrome trace, the garbage collections a
flight counts, the CLI's report and the timers that record through spans."""

import gc
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rgbid_tpu_torch as port
from rgbid_tpu_torch import system as system_mod
from rgbid_tpu_torch.backend import loop_closure
from rgbid_tpu_torch.cli import main as cli_main
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.datasets import synthetic
from rgbid_tpu_torch.utils import profiling

torch.set_num_threads(2)

TINY = Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120)
CFG = {"backend.enabled": False, "tracking.levels": 3, "tracking.iters": (4, 8, 16)}
CHILDREN = [f"rgbid.{s}" for s in profiling.SPANS]


@pytest.fixture(scope="module")
def clip():
    seq = synthetic.generate_sequence(n_frames=11, intr=TINY, motion="orbit", trans_amp=0.12,
                                      rot_amp=0.03, xi_noise_sigma=0.003, seed=4)
    return [(f.rgb, f.depth, f.timestamp) for f in seq.frames()]


def _system():
    return port.SlamSystem(TINY, port.SlamConfig().override(**CFG), device="cpu")


def test_feed_rows_tile_the_frames(clip):
    """The bootstrap frame, then a feed of 10 frames in flights of 4: rows
    of 1, 4, 4 and 2 frames with contiguous first frames, every span of a
    tracked flight timed, the children inside the flight's wall, and each
    frame's ``ms`` the flight's wall over its frames."""
    slam = _system()
    slam.process_frame(*clip[0])
    slam.feed(clip[1:], flight_depth=4)
    rows = slam.flights()
    assert list(rows["frames"]) == [1, 4, 4, 2]
    assert list(rows["first_frame"]) == [0, 1, 5, 9]
    assert (rows["system"] == slam._flights.system).all()
    assert not rows["profiled"].any() and (rows["busy_ns"] == 0).all()
    tracked = rows[1:]
    for s in profiling.SPANS:
        assert (tracked[f"{s}_ns"] > 0).all(), s
    assert list(tracked["pack_n"]) == list(tracked["frames"])
    assert list(tracked["dispatch_n"]) == list(tracked["frames"])
    assert list(tracked["handle_n"]) == list(tracked["frames"])
    assert (tracked["wait_n"] == 1).all()
    children = sum(rows[f"{s}_ns"] for s in profiling.SPANS)
    assert (children <= rows["wall_ns"]).all()
    assert (np.diff(rows["start_ns"]) >= rows["wall_ns"][:-1]).all()
    for row in tracked:
        ms = round(row["wall_ns"] * 1e-6 / row["frames"], 2)
        first = row["first_frame"]
        assert [r["ms"] for r in slam.stats[first:first + row["frames"]]] == [ms] * row["frames"]


def test_process_frame_rows_are_flights_of_one(clip):
    slam = _system()
    for f in clip[:4]:
        slam.process_frame(*f)
    rows = slam.flights()
    assert list(rows["frames"]) == [1, 1, 1, 1]
    assert list(rows["first_frame"]) == [0, 1, 2, 3]
    # The bootstrap's founding is its dispatch; it reads nothing back.
    assert rows["wait_n"][0] == 0 and rows["dispatch_n"][0] == 1
    assert (rows["wait_n"][1:] == 1).all() and (rows["dispatch_ns"] > 0).all()


def test_a_reset_starts_a_new_system_of_rows(clip):
    slam = _system()
    slam.process_frame(*clip[0])
    first = slam._flights.system
    slam.reset()
    slam.process_frame(*clip[0])
    assert slam._flights.system != first
    assert list(slam.flights()["first_frame"]) == [0]
    assert len(profiling.flights(first)) == 1


def test_the_ring_keeps_the_newest_rows(monkeypatch):
    monkeypatch.setattr(profiling, "ROWS", 8)
    monkeypatch.setattr(profiling, "_LOG", None)
    monkeypatch.setattr(profiling, "_WRITTEN", 0)
    rec = profiling.FlightRecorder(torch.device("cpu"))
    for i in range(5):
        rec.open(i)
        rec.close(1)
    assert list(profiling.flights(rec.system)["first_frame"]) == [0, 1, 2, 3, 4]
    for i in range(5, 19):
        rec.open(i)
        rec.close(1)
    rows = profiling.flights()
    assert len(rows) == 8 and list(rows["first_frame"]) == list(range(11, 19))
    assert (np.diff(rows["start_ns"]) > 0).all()


def test_spans_are_host_operations_on_the_wall_clock(clip):
    """Under torch.profiler each span appears once per use, as a host
    operation that is not a user annotation (the profiler would mirror one
    onto the device's timeline), stamped between two ``time.time_ns``
    reads; the rows say the profiler was recording, and lie on the same
    clock."""
    slam = _system()
    slam.process_frame(*clip[0])
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        slam.feed(clip[1:7], flight_depth=3)
    t1 = time.time_ns()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("rgbid.")]
    names = [e.name() for e in events]
    assert names.count("rgbid.flight") == 2
    for name in ("rgbid.pack", "rgbid.upload", "rgbid.dispatch", "rgbid.handle"):
        assert names.count(name) == 6, name
    assert names.count("rgbid.wait") == 2
    for e in events:
        assert not e.is_user_annotation(), e.name()
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert t0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= t1
    rows = slam.flights()[1:]
    assert rows["profiled"].all()
    flights = sorted(e.start_ns() for e in events if e.name() == "rgbid.flight")
    # The row's start and the profiler's stamp are one clock, a few
    # microseconds apart (the span's own entry).
    assert np.abs(np.asarray(flights) - rows["start_ns"]).max() < 5e6


def test_no_span_enters_the_profiler_when_none_records(clip, monkeypatch):
    made = []
    host_op = profiling._HostOp

    def counting(name):
        made.append(name)
        return host_op(name)

    monkeypatch.setattr(profiling, "_HostOp", counting)
    slam = _system()
    slam.feed(clip[:5], flight_depth=4)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        slam.feed(clip[5:7], flight_depth=4)
    assert made.count("rgbid.flight") == 1 and made.count("rgbid.pack") == 2


def test_trace_writes_the_spans_into_its_chrome_trace(clip, tmp_path):
    slam = _system()
    slam.process_frame(*clip[0])
    with profiling.trace(str(tmp_path)):
        slam.feed(clip[1:4], flight_depth=3)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name", "").startswith("rgbid.")]
    names = {e["name"] for e in spans}
    assert names == {"rgbid.flight", *CHILDREN}
    assert all(e["cat"] == "cpu_op" for e in spans)
    flight = next(e for e in spans if e["name"] == "rgbid.flight")
    for e in spans:
        assert flight["ts"] <= e["ts"] and e["ts"] + e["dur"] <= flight["ts"] + flight["dur"] + 1


def test_a_collection_inside_a_flight_is_counted(clip, monkeypatch):
    pack = system_mod.pack_frame

    def collecting(*a, **k):
        gc.collect()
        return pack(*a, **k)

    slam = _system()
    slam.process_frame(*clip[0])
    monkeypatch.setattr(system_mod, "pack_frame", collecting)
    slam.feed(clip[1:4], flight_depth=3)
    row = slam.flights()[-1]
    assert row["gc_n"] >= 3 and 0 < row["gc_ns"] <= row["pack_ns"]


def test_timers_record_through_spans():
    """``StageTimer`` keeps seconds, the back end's ``timings`` milliseconds;
    both enter the profiler under their names."""
    timer = profiling.StageTimer()
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("load"):
            time.sleep(0.002)
        with loop_closure._timed(timings, "orb"):
            time.sleep(0.002)
    assert timer.summary()["load"]["n"] == 1 and 0.002 <= timer.times["load"][0] < 1.0
    assert len(timings["orb"]) == 1 and 2.0 <= timings["orb"][0] < 1000.0
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("load") == 1 and names.count("rgbid.backend.orb") == 1


def test_cli_reports_the_host_path_by_span(tmp_path, capsys):
    rc = cli_main(["--synthetic", "12", "--max-frames", "6", "--quiet", "--device", "cpu",
                   "--intrinsics", "129.3,129.1,79.5,59.5,160,120",
                   "--set", "tracking.levels=3", "--set", "tracking.iters=[4,8,16]",
                   "--set", "backend.enabled=false"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result["host_us_per_frame"]) == set(profiling.SPANS)
    assert all(v > 0 for v in result["host_us_per_frame"].values())
    assert result["device_idle_pct"] is None


class _FakeLibcuda:
    """libcuda's two event calls over a clock the test advances: an event
    records the clock's reading, and completes once the test says so."""

    def __init__(self):
        self.now, self.stamp, self.done = 0.0, {}, set()

    def cuEventRecord(self, event, stream):
        if not event.value:
            return 400  # CUDA_ERROR_INVALID_HANDLE
        self.stamp[event.value] = self.now
        self.done.discard(event.value)
        return 0

    def cuEventElapsedTime(self, ms, start, end):
        if start.value not in self.done or end.value not in self.done:
            return profiling._NOT_READY
        ms._obj.value = self.stamp[end.value] - self.stamp[start.value]
        return 0


def test_event_pairs_are_read_as_they_complete(monkeypatch):
    """The card's busy time of a flight: one pair a frame from the pool;
    ``settle`` reads the pairs that have completed and stops at the first
    that has not, ``close`` reads the rest; a second flight reuses the
    pool."""
    lib = _FakeLibcuda()
    handles = iter(range(1, 1000))

    class Event:
        """torch.cuda.Event: its CUevent exists from the first record."""

        def __init__(self, enable_timing):
            assert enable_timing
            self.cuda_event = 0

        def record(self):
            self.cuda_event = self.cuda_event or next(handles)

    monkeypatch.setattr(profiling, "_libcuda", lambda: lib)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    rec = profiling.FlightRecorder(torch.device("cuda"))
    for flight, busy in enumerate(([2.0, 3.0, 4.0], [1.5])):
        rec.open(10 * flight)
        for ms in busy:
            rec.frame_begin()
            rec.frame_begin()  # the upload's event stands: one pair a frame
            lib.now += ms
            rec.frame_end()
            lib.now += 10.0  # the card idles between frames
        assert len(rec._pool) == 3
        pairs = rec._pairs[:len(busy)]
        lib.done.update(h.value for pair in pairs[:-1] for h in pair)
        assert rec.settle() is False
        assert rec._read == len(busy) - 1
        lib.done.update(h.value for h in pairs[-1])
        rec.close(len(busy))
        row = profiling.flights(rec.system)[-1]
        assert row["busy_ns"] == round(sum(busy) * 1e6) and row["frames"] == len(busy)
    rec.open(20)
    rec.frame_begin()
    rec.frame_end()
    with pytest.raises(RuntimeError, match="had not completed"):
        rec.close(1)
