"""The port's command line (``python -m rgbid_tpu_torch``) on the CPU:
``tests/test_cli_and_snapshot.py::test_cli_synthetic_run`` with
``--device cpu``, and each option whose module is not ported raising
``NotImplementedError`` that names an open ROADMAP Queue 1 item, before
any frame is rendered."""

import json
import os
import re

import pytest

from rgbid_tpu_torch import cli
from rgbid_tpu_torch.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


_UNPORTED_ARGV = {
    "--tum": ["--tum", "seq_dir"],
    "--live": ["--live", "capture_dir"],
    "--calib": ["--synthetic", "4", "--calib", "calib.txt"],
    "--live-idle": ["--synthetic", "4", "--live-idle", "5"],
    "--resume": ["--synthetic", "4", "--resume", "state.npz"],
    "--snapshot": ["--synthetic", "4", "--snapshot", "state.npz"],
    "--viz": ["--synthetic", "4", "--viz"],
    "--live-viz": ["--synthetic", "4", "--live-viz", "viz_dir"],
}


@pytest.mark.parametrize("flag", [flag for _, flag in cli.UNPORTED])
def test_unported_flag_raises_before_any_work(flag, monkeypatch, tmp_path):
    """The raise names an item of ROADMAP Queue 1 that is not marked done,
    and comes before the renderer or the system is touched."""
    from rgbid_tpu_torch.datasets import synthetic

    def no_work(*a, **k):
        raise AssertionError("work started before the refusal")

    monkeypatch.setattr(synthetic, "generate_sequence", no_work)
    with pytest.raises(NotImplementedError, match=re.escape(flag)) as err:
        cli_main(_UNPORTED_ARGV[flag] + ["--out-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert not (tmp_path / "run").exists()
    item = re.search(r"ROADMAP Queue 1 #(\d+)", str(err.value)).group(1)
    queue1 = open(os.path.join(REPO, "ROADMAP.md")).read().split("### Queue 1")[1].split("### Queue 2")[0]
    entry = re.search(rf"^{item}\. \*\*(.*)$", queue1, re.M)
    assert entry is not None, f"ROADMAP Queue 1 has no item #{item}"
    assert "(done" not in entry.group(1).lower(), entry.group(1)
