"""The port's flight profiler (``rgbid_tpu_torch.eval.profile_flight``) on
the CPU: two of the JAX package's variants, one timed flight each at QVGA,
and the JSON fields every line carries."""

import json

import pytest
import torch

from rgbid_tpu.eval import profile_flight as jprofile
from rgbid_tpu_torch.eval import profile_flight

torch.set_num_threads(2)


def test_variants_are_the_jax_packages():
    assert [(n, o) for n, o, _ in profile_flight.VARIANTS] == [
        (n, o) for n, o, _ in jprofile.VARIANTS]


@pytest.mark.parametrize("only", ["base,no_consensus"])
def test_two_variants_one_flight_on_cpu(tmp_path, only):
    """Flights of 2 QVGA frames (a bootstrap frame and one warm-up flight,
    then one timed flight and one profiled): per variant its name and
    overrides, positive times with one flight time, no loss, a keyframe at
    least, no graph (the CPU runs the step eagerly) and the CPU operators
    per tracked frame from torch.profiler; dropping the consensus drops
    operators."""
    out = tmp_path / "profile.jsonl"
    rc = profile_flight.main(["--res", "320x240", "--flights", "1", "--depth", "2", "--only",
                              only, "--device", "cpu", "--out", str(out)])
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["variant"] for r in rows] == only.split(",")
    for r in rows:
        assert set(r) >= {"variant", "overrides", "mean_ms_per_frame",
                          "median_flight_ms_per_frame", "flight_ms", "keyframes", "lost",
                          "warmup_s", "graph_replays", "graph_nodes", "events_per_frame", "what"}
        assert r["mean_ms_per_frame"] > 0 and r["median_flight_ms_per_frame"] > 0
        assert len(r["flight_ms"]) == 1 and r["lost"] == 0 and r["keyframes"] >= 1
        assert r["graph_replays"] == 0 and r["graph_nodes"] == 0
        ev = r["events_per_frame"]
        assert ev["kind"] == "cpu operators" and ev["total"] > 0 and len(ev["top"]) <= 12
    assert rows[0]["overrides"] == {} and rows[1]["overrides"] == {"tracking.consensus": False}
    assert rows[1]["events_per_frame"]["total"] < rows[0]["events_per_frame"]["total"]
