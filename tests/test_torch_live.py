"""The port's live source (``rgbid_tpu_torch/datasets/live.py``):
``tests/test_live_source.py``'s two tests against the port (a writer thread
plays the capture daemon; every frame in order, exactly once, while the
capture grows; the stream ends on the idle timeout), and a PNG that is
still being written when its index line appears, which the source retries
at the next poll instead of failing or skipping it."""

import os
import threading
import time

import cv2
import numpy as np

from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.datasets import synthetic
from rgbid_tpu_torch.datasets.live import LiveSource

INTR = Intrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)


def _names(seq, i):
    t_rgb = seq.timestamps[i]
    t_depth = t_rgb + 0.004
    return t_rgb, t_depth, f"rgb/{t_rgb:.6f}.png", f"depth/{t_depth:.6f}.png"


def _append_index(root, seq, i):
    t_rgb, t_depth, rgb_name, depth_name = _names(seq, i)
    with open(os.path.join(root, "rgb.txt"), "a") as f:
        f.write(f"{t_rgb:.6f} {rgb_name}\n")
    with open(os.path.join(root, "depth.txt"), "a") as f:
        f.write(f"{t_depth:.6f} {depth_name}\n")


def _write_frame(root, seq, i):
    _, _, rgb_name, depth_name = _names(seq, i)
    cv2.imwrite(os.path.join(root, rgb_name), cv2.cvtColor(seq.rgb[i], cv2.COLOR_RGB2BGR))
    cv2.imwrite(os.path.join(root, depth_name), seq.depth[i])
    # Index lines are appended after the PNGs exist (a capture daemon's
    # order), each append its own open.
    _append_index(root, seq, i)


def _capture_dir(path):
    root = str(path)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    for name in ("rgb.txt", "depth.txt"):
        with open(os.path.join(root, name), "w") as f:
            f.write("# live capture\n")
    return root


def test_live_source_streams_growing_capture(tmp_path):
    root = _capture_dir(tmp_path / "capture")
    seq = synthetic.generate_sequence(
        n_frames=8, intr=INTR, motion="orbit", trans_amp=0.15, rot_amp=0.04,
        xi_noise_sigma=0.003, seed=5,
    )
    # Two frames exist before the consumer starts; the rest arrive live.
    _write_frame(root, seq, 0)
    _write_frame(root, seq, 1)

    def writer():
        for i in range(2, len(seq)):
            time.sleep(0.15)
            _write_frame(root, seq, i)

    w = threading.Thread(target=writer)
    w.start()
    src = LiveSource(root, poll_interval=0.03, idle_timeout=2.0)
    got, arrival = [], []
    for fr in src.frames():
        got.append(fr)
        arrival.append(time.monotonic())
    w.join()

    # Every frame, exactly once, in timestamp order.
    assert len(got) == len(seq)
    ts = [fr.timestamp for fr in got]
    assert ts == sorted(ts)
    np.testing.assert_array_equal(got[3].depth, seq.depth[3])
    # Streaming overlapped the capture: the first frames were consumed well
    # before the writer finished the last ones.
    assert arrival[1] < arrival[-1] - 0.5


def test_live_source_stop_and_idle(tmp_path):
    root = _capture_dir(tmp_path / "capture2")
    seq = synthetic.generate_sequence(
        n_frames=2, intr=INTR, motion="static", xi_noise_sigma=0.003, seed=5,
    )
    _write_frame(root, seq, 0)
    _write_frame(root, seq, 1)
    src = LiveSource(root, poll_interval=0.02, idle_timeout=0.3)
    t0 = time.monotonic()
    frames = list(src.frames())
    took = time.monotonic() - t0
    assert len(frames) == 2
    assert took < 5.0  # ended by the idle timeout, promptly


def test_live_source_retries_a_png_being_written(tmp_path):
    """Frame 1's index lines appear while its depth PNG holds only its first
    half: the source delivers frame 0, waits at frame 1, and delivers it
    (bit-equal) once the writer finishes the file; nothing is skipped."""
    root = _capture_dir(tmp_path / "capture3")
    seq = synthetic.generate_sequence(
        n_frames=3, intr=INTR, motion="orbit", trans_amp=0.15, rot_amp=0.04,
        xi_noise_sigma=0.003, seed=5,
    )
    _write_frame(root, seq, 0)
    _, _, rgb_name, depth_name = _names(seq, 1)
    cv2.imwrite(os.path.join(root, rgb_name), cv2.cvtColor(seq.rgb[1], cv2.COLOR_RGB2BGR))
    ok, buf = cv2.imencode(".png", seq.depth[1])
    data = buf.tobytes()
    with open(os.path.join(root, depth_name), "wb") as f:
        f.write(data[: len(data) // 2])
    _append_index(root, seq, 1)

    def finish_later():
        time.sleep(0.4)
        with open(os.path.join(root, depth_name), "wb") as f:
            f.write(data)
        _write_frame(root, seq, 2)

    w = threading.Thread(target=finish_later)
    w.start()
    got = list(LiveSource(root, poll_interval=0.02, idle_timeout=1.0).frames())
    w.join()
    assert [fr.timestamp for fr in got] == [float(f"{t:.6f}") for t in seq.timestamps[:3]]
    np.testing.assert_array_equal(got[1].depth, seq.depth[1])
    np.testing.assert_array_equal(got[1].rgb, seq.rgb[1])


def test_cli_live_end_to_end(tmp_path, capsys):
    """``python -m rgbid_tpu_torch --live DIR --live-idle T`` on the CPU over
    a capture of 6 frames that has stopped growing: every frame tracked
    once, none lost, and the run ends on the idle timeout."""
    import json

    from rgbid_tpu_torch.cli import main as cli_main

    root = _capture_dir(tmp_path / "capture4")
    seq = synthetic.generate_sequence(
        n_frames=6, intr=INTR, motion="orbit", trans_amp=0.15, rot_amp=0.04,
        xi_noise_sigma=0.003, seed=5,
    )
    for i in range(len(seq)):
        _write_frame(root, seq, i)
    rc = cli_main(["--live", root, "--live-idle", "0.3", "--quiet",
                   "--intrinsics", "258.6,258.2,159.3,127.6,320,240",
                   "--set", "tracking.levels=3", "--set", "tracking.iters=[4,8,16]",
                   "--set", "backend.enabled=false", "--device", "cpu"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["frames"] == 6 and result["lost_frames"] == 0
