"""The port's command line (``python -m rgbid_tpu_torch``) on the CPU:
``tests/test_cli_and_snapshot.py::test_cli_synthetic_run`` with
``--device cpu``, and ``--snapshot`` then ``--resume`` (the resumed run goes
on from the saved state). ``--viz`` and ``--live-viz`` are in
``tests/test_torch_viz.py`` and ``tests/test_torch_live_view.py``."""

import json
import os

from rgbid_tpu_torch.cli import main as cli_main


def test_cli_synthetic_run(tmp_path, capsys):
    out_dir = str(tmp_path / "run")
    rc = cli_main(
        [
            "--synthetic", "40",
            "--max-frames", "8",
            "--out-dir", out_dir,
            "--eval",
            "--quiet",
            "--set", "tracking.levels=3",
            "--set", "tracking.iters=[4,8,16]",
            "--set", "backend.enabled=false",
            "--device", "cpu",
        ]
    )
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["frames"] == 8
    assert result["lost_frames"] == 0
    assert result["ate"]["rmse"] < 0.01
    assert os.path.exists(os.path.join(out_dir, "trajectory.txt"))
    assert os.path.exists(os.path.join(out_dir, "map.ply"))
    lines = open(os.path.join(out_dir, "frames.jsonl")).read().splitlines()
    recs = [json.loads(line) for line in lines]
    assert recs[0]["type"] == "run_header" and "config_hash" in recs[0]
    assert sum(r["type"] == "frame" for r in recs) == 8
    assert recs[-1]["type"] == "result"


def test_cli_snapshot_then_resume(tmp_path, capsys):
    """``--snapshot`` writes the state after 6 frames; ``--resume`` restores
    it (the JAX package's wiring: the restored records, then the source's
    frames again) and runs on; the resumed run's first 6 logged records are
    the saved run's."""
    state = str(tmp_path / "state.npz")
    common = ["--synthetic", "12", "--intrinsics", "258.6,258.2,159.3,127.6,320,240",
              "--quiet", "--eval", "--set", "tracking.levels=3",
              "--set", "tracking.iters=[4,8,16]", "--set", "backend.enabled=false",
              "--device", "cpu"]
    assert cli_main(common + ["--max-frames", "6", "--snapshot", state,
                              "--out-dir", str(tmp_path / "a")]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["snapshot"] == state and first["frames"] == 6 and os.path.exists(state)
    assert cli_main(common + ["--max-frames", "4", "--resume", state,
                              "--out-dir", str(tmp_path / "b")]) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["frames"] == 10 and second["lost_frames"] == 0
    assert second["config_hash"] == first["config_hash"]

    def frames(run):
        lines = open(tmp_path / run / "frames.jsonl").read().splitlines()
        return [json.loads(line) for line in lines if '"type": "frame"' in line]

    a, b = frames("a"), frames("b")
    assert len(a) == 6 and len(b) == 10
    assert b[:6] == a
