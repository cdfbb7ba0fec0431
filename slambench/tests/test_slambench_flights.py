"""The readers of the program's flight log (``harness/flights.py``): the
host spans' microseconds a frame in tiny traced feed cells on the CPU, no
idle share without a card, and no value from a program without the log
(the parent commit's case) or from a window the log does not cover
exactly."""

import numpy as np
import pytest
from conftest import ROOT, run_tiny

from harness import cell, flights

HOST = [f"host_{s}_us_per_frame.offline" for s in ("pack", "upload", "dispatch", "wait", "handle")]
NEW = HOST + ["device_idle_pct.untraced"]


@pytest.mark.parametrize("workload", ["tiny.esm", "tiny.ic"])
def test_tiny_feed_cells_report_the_host_spans(tiny_root, workload):
    out = run_tiny(tiny_root, workload, trace=True)
    assert out["correct"] is True
    for name in HOST:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "us/frame"
    assert "device_idle_pct.untraced" not in out["metrics"]


def _ctx(frames=8, warmup=8, seconds=0.5):
    return {"traffic": {"entry": "feed", "warmup_frames": warmup},
            "window": {"frames": frames, "seconds": seconds}}


def _rows(first_frames, sizes, system=3, profiled=(), busy_ns=0):
    from rgbid_tpu_torch.utils import profiling

    rows = np.zeros(len(sizes), profiling.FLIGHT_DTYPE)
    rows["system"] = system
    rows["first_frame"] = first_frames
    rows["frames"] = sizes
    rows["pack_ns"] = 4000 * rows["frames"]
    rows["busy_ns"] = busy_ns
    rows["profiled"][list(profiled)] = True
    return rows


def test_window_rows_take_the_last_system_past_the_warm_up(monkeypatch):
    from rgbid_tpu_torch.utils import profiling

    old = _rows([0, 1, 5], [1, 4, 4], system=2)
    new = _rows([0, 1, 5, 9, 13, 17], [1, 4, 4, 4, 4, 4], busy_ns=10**8)
    monkeypatch.setattr(profiling, "flights", lambda: np.concatenate([old, new]))
    rows = flights.window_rows(_ctx())
    assert list(rows["first_frame"]) == [9, 13]
    assert flights.span_us_per_frame(_ctx(), "pack") == pytest.approx(4.0)
    assert flights.device_idle_pct(_ctx(seconds=0.5)) == pytest.approx(60.0)
    assert flights.window_rows(_ctx(frames=6)) is None
    assert flights.window_rows(_ctx(frames=20)) is None
    monkeypatch.setattr(profiling, "flights", lambda: _rows([9, 13, 17], [4, 4, 4],
                                                          profiled=[1]))
    assert flights.window_rows(_ctx()) is None
    assert flights.window_rows(_ctx(frames=4)) is not None


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_without_a_flight_log(monkeypatch, name):
    """The parent commit's program: ``utils.profiling`` with no ``flights``."""
    from rgbid_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "flights")
    read = cell.reader(name, ROOT)
    assert read(_ctx()) is None
    monkeypatch.setattr(profiling, "flights", lambda: _rows([9, 13], [4, 4], busy_ns=10**8),
                        raising=False)
    assert read(_ctx()) is not None
    assert read({**_ctx(), "traffic": {"entry": "process_frame", "warmup_frames": 8}}) is None
