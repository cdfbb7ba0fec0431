"""The port's live viewer (``rgbid_tpu_torch/utils/live_view.py``) and its
``SlamSystem`` wiring (``viz.enabled``), against ``tests/test_live_view.py``
and the JAX package's viewer.

The current and keyframe panes equal the JAX viewer's bit for bit outside
their labels' boxes (the labels come from the port's glyph table; see
tests/test_torch_viz.py for where they equal cv2.putText). The map pane is
the port's own drawing, of the JAX pane's size."""

import time

import cv2
import numpy as np

import rgbid_tpu_torch as port
from rgbid_tpu.utils.live_view import LiveViewer as JLiveViewer
from rgbid_tpu_torch.datasets import synthetic
from rgbid_tpu_torch.utils import live_view
from rgbid_tpu_torch.utils.live_view import LiveViewer

INTR = port.Intrinsics(fx=130.0, fy=130.0, cx=79.5, cy=59.5, width=160, height=120)


def _snapshot(frame=0, with_cloud=True):
    rng = np.random.default_rng(frame)
    rgb = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    depth = rng.integers(2000, 20000, (120, 160), dtype=np.uint16)
    poses = []
    for i in range(frame + 2):
        T = np.eye(4)
        T[:3, 3] = [0.01 * i, 0.0, 0.02 * i]
        poses.append(T)
    snap = {
        "rgb": rgb,
        "depth": depth,
        "frame": frame,
        "n_keyframes": 2,
        "lost": False,
        "kf_rgb": rgb,
        "kf_depth": depth,
        "kf_id": 1,
        "poses": poses,
        "kf_poses": poses[::2],
    }
    if with_cloud:
        cloud = rng.uniform(0, 1, (500, 6)).astype(np.float32)
        snap["kf_clouds"] = [(np.eye(4), cloud), (poses[-1], cloud)]
    return snap


# tests/test_live_view.py's four cases on the port.


def test_live_viewer_renders_atomically(tmp_path):
    v = LiveViewer(str(tmp_path), history=True, map_every=2)
    for i in range(3):
        v.publish(_snapshot(frame=i))
        time.sleep(0.05)
    v.close()
    live = tmp_path / "live.png"
    assert live.exists() and live.stat().st_size > 5000
    assert not (tmp_path / ".live.tmp.png").exists()  # atomic replace
    assert v.rendered >= 1
    assert v.rendered + v.dropped == 3
    assert v.errors == 0
    # History frames were written for every RENDERED snapshot.
    assert len(list(tmp_path.glob("live_*.png"))) == v.rendered


def test_live_viewer_lossy_queue(tmp_path):
    """Publishing faster than rendering must never block or error."""
    v = LiveViewer(str(tmp_path))
    t0 = time.perf_counter()
    for i in range(20):
        v.publish(_snapshot(frame=i, with_cloud=False))
    publish_time = time.perf_counter() - t0
    v.close()
    assert publish_time < 1.0  # non-blocking even with a busy renderer
    assert v.rendered >= 1
    assert v.rendered + v.dropped == 20
    assert (tmp_path / "live.png").exists()


def test_live_viewer_survives_bad_snapshot(tmp_path, capsys):
    v = LiveViewer(str(tmp_path))
    v.publish({"not": "a frame"})  # renderer must swallow the exception
    time.sleep(0.05)
    v.publish(_snapshot(frame=0))
    time.sleep(0.05)
    v.close()
    assert v.rendered >= 1  # thread stayed alive past the bad snapshot
    assert (tmp_path / "live.png").exists()
    # The bad snapshot was counted and printed (unless the good one replaced
    # it before the thread took it).
    assert v.errors + v.rendered + v.dropped == 2
    if v.errors:
        assert "KeyError" in capsys.readouterr().err


def test_system_live_viz_integration(tmp_path):
    """End-to-end: SlamSystem with viz.enabled publishes while tracking and
    live.png reflects the run (keyframe pane + map from finalized clouds)."""
    out = tmp_path / "live"
    cfg = port.SlamConfig().override(
        **{
            "tracking.levels": 3,
            "tracking.iters": (2, 4, 8),
            "backend.enabled": False,
            "viz.enabled": True,
            "viz.every_n": 3,
            "viz.out_dir": str(out),
            "viz.map_every": 1,
        }
    )
    seq = synthetic.generate_sequence(
        n_frames=14, intr=INTR, motion="orbit", trans_amp=0.25, rot_amp=0.06,
        xi_noise_sigma=0.003,
    )
    slam = port.SlamSystem(INTR, cfg, device="cpu")
    slam.feed(list(seq.frames()))
    slam.finish()
    assert slam.viewer.rendered >= 1
    assert slam.viewer.errors == 0
    assert (out / "live.png").exists()
    assert (out / "live.png").stat().st_size > 10000
    # The keyframe pane had real data: founding depth was captured.
    assert slam.manager.keyframes[0].depth is not None
    assert cv2.imread(str(out / "live.png")).shape == (120 * 2 + 240, 320, 3)


def test_panes_bit_equal_jax_outside_labels(tmp_path):
    """The same snapshot through both viewers: the current and keyframe panes
    (the top two thirds of live.png) equal outside each label's box, and the
    map pane has the JAX pane's shape; a LOST frame and a snapshot with no
    keyframe depth too."""
    for snap in (_snapshot(frame=3), dict(_snapshot(frame=5), lost=True, kf_depth=None),
                 dict(_snapshot(frame=1, with_cloud=False), kf_rgb=None)):
        jv = JLiveViewer(str(tmp_path / "j"))
        jv._render(snap)
        jv.close()
        ref = cv2.imread(str(tmp_path / "j" / "live.png"))
        pv = LiveViewer(str(tmp_path / "p"))
        pv._render(snap)
        pv.close()
        ours = cv2.imread(str(tmp_path / "p" / "live.png"))
        assert ours.shape == ref.shape
        np.testing.assert_array_equal(ours, np.concatenate(pv.panes(snap) + (ours[240:],)))
        for k, label in enumerate((live_view.current_label(snap), live_view.keyframe_label(snap))):
            a, b = ref[120 * k:120 * (k + 1)].copy(), ours[120 * k:120 * (k + 1)].copy()
            if k == 1 and snap.get("kf_rgb") is None:
                assert not a.any() and not b.any()
                continue
            r0, r1, c0, c1 = live_view.label_box(label)
            a[max(r0, 0):r1, max(c0, 0):c1] = 0
            b[max(r0, 0):r1, max(c0, 0):c1] = 0
            np.testing.assert_array_equal(b, a)


def _run(cfg, frames):
    slam = port.SlamSystem(INTR, cfg, device="cpu")
    reads = []
    for f in frames:
        before = slam.host_reads
        slam.process_frame(f.rgb, f.depth, f.timestamp)
        reads.append(slam.host_reads - before)
    slam.finish()
    return slam, reads


def test_viz_run_equals_run_without(tmp_path):
    """SlamSystem with the viewer on gives the records and poses of the run
    without it, with the same host reads per frame; every published
    snapshot is rendered or dropped."""
    seq = synthetic.generate_sequence(n_frames=12, intr=INTR, motion="orbit", trans_amp=0.25,
                                      rot_amp=0.06, xi_noise_sigma=0.003)
    frames = list(seq.frames())
    base = port.SlamConfig().override(**{"tracking.levels": 3, "tracking.iters": (2, 4, 8),
                                         "backend.enabled": False})
    off, reads_off = _run(base, frames)
    on, reads_on = _run(base.override(**{"viz.enabled": True, "viz.every_n": 2,
                                         "viz.map_every": 1, "viz.out_dir": str(tmp_path)}),
                        frames)
    assert reads_on == reads_off
    assert [dict(s, ms=0) for s in on.stats] == [dict(s, ms=0) for s in off.stats]
    assert all(np.array_equal(a, b) for a, b in zip(on.poses(), off.poses()))
    published = sum(1 for i in range(1, len(frames)) if (i + 1) % 2 == 0)
    assert on.viewer.rendered + on.viewer.dropped == published
    assert on.viewer.errors == 0 and off.viewer is None
    assert cv2.imread(str(tmp_path / "live.png")) is not None
