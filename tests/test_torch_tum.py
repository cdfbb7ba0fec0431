"""The port's TUM reader (``rgbid_tpu_torch/datasets/tum.py``) and the CLI's
``--tum`` path: ``tests/test_tum_format.py``'s nine tests against the port
(the directories written with cv2, as there), the undistortion maps and
both remaps against OpenCV bit for bit, and the port's ``TumSequence``
frames against the JAX package's on the same directory, bit for bit, with
the distortion on and off."""

import json
import os
import time

import cv2
import numpy as np
import pytest

from rgbid_tpu.datasets.tum import TumSequence as JaxTumSequence
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.datasets import _cv, synthetic
from rgbid_tpu_torch.datasets.tum import TUM_DISTORTION, TumSequence, associate
from rgbid_tpu_torch.mapping.export import _quat_from_R

INTR = Intrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
# The factory cameras whose distortion TUM_DISTORTION holds.
FACTORY_K = {"freiburg1": (517.3, 516.5, 318.6, 255.3), "freiburg2": (520.9, 521.0, 325.1, 249.7)}


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A synthetic sequence written as a TUM-format dataset directory."""
    root = tmp_path_factory.mktemp("rgbd_dataset_synth")  # no "freiburgN" -> no auto-distortion
    seq = synthetic.generate_sequence(
        n_frames=10, intr=INTR, motion="orbit", trans_amp=0.15, rot_amp=0.04,
        xi_noise_sigma=0.003, seed=5,
    )
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(len(seq)):
        # Depth timestamps slightly offset to exercise the association.
        t_rgb = seq.timestamps[i]
        t_depth = t_rgb + 0.004
        rgb_name = f"rgb/{t_rgb:.6f}.png"
        depth_name = f"depth/{t_depth:.6f}.png"
        cv2.imwrite(str(root / rgb_name), cv2.cvtColor(seq.rgb[i], cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(root / depth_name), seq.depth[i])
        rgb_lines.append(f"{t_rgb:.6f} {rgb_name}")
        depth_lines.append(f"{t_depth:.6f} {depth_name}")
        T = seq.gt_poses[i]
        q = _quat_from_R(T[:3, :3])
        tx, ty, tz = T[:3, 3]
        gt_lines.append(
            f"{t_rgb:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    for name, lines in [("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)]:
        with open(root / name, "w") as f:
            f.write("# header\n# t data\n")
            f.write("\n".join(lines) + "\n")
    return str(root), seq


def test_associate_greedy():
    a = [(0.0, ["a0"]), (1.0, ["a1"]), (2.0, ["a2"])]
    b = [(0.015, ["b0"]), (1.2, ["b1"]), (2.005, ["b2"])]
    assert associate(a, b, max_difference=0.02) == [(0, 0), (2, 2)]  # b1 0.2 s off


def test_tum_sequence_reads_frames(tum_dir):
    root, seq = tum_dir
    ts = TumSequence(root)
    assert len(ts) == len(seq)
    assert not ts.undistort  # unknown sequence name -> zero distortion
    # The default calibration rescaled to the 320x240 images.
    assert ts.intrinsics.width == 320 and ts.intrinsics.height == 240
    assert abs(ts.intrinsics.fx - 525.0 / 2) < 1e-6
    f = ts[0]
    assert f.rgb.shape == (240, 320, 3) and f.rgb.dtype == np.uint8
    assert f.depth.shape == (240, 320) and f.depth.dtype == np.uint16
    # The PNG round trip is lossless for RGB and 16-bit depth.
    np.testing.assert_array_equal(f.rgb, seq.rgb[0])
    np.testing.assert_array_equal(f.depth, seq.depth[0])
    assert ts.groundtruth is not None and ts.groundtruth.shape == (10, 8)


def test_cli_tum_end_to_end(tum_dir, capsys):
    root, _ = tum_dir
    from rgbid_tpu_torch.cli import main as cli_main

    rc = cli_main(
        [
            "--tum", root,
            "--intrinsics", "258.6,258.2,159.3,127.6,320,240",
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
    assert result["frames"] == 10
    assert result["lost_frames"] == 0
    # ATE against groundtruth.txt through timestamp association: under 1 cm.
    assert result["ate"]["rmse"] < 0.01
    assert result["ate"]["n"] >= 9


def test_cli_calib_flag(tum_dir, tmp_path, capsys):
    """``--calib FILE`` sets the camera (over the factory guess) and its
    distortion: the run's header holds the file's intrinsics, and with
    fr1 coefficients in the file the frames are undistorted before
    tracking, with no loss."""
    root, _ = tum_dir
    from rgbid_tpu_torch.cli import main as cli_main

    calib = tmp_path / "calib.txt"
    calib.write_text("258.6 258.2 159.3 127.6 320 240\n0.2624 -0.9531 -0.0054 0.0026 1.1633\n")
    out = tmp_path / "run"
    rc = cli_main(["--tum", root, "--calib", str(calib), "--max-frames", "4", "--quiet",
                   "--out-dir", str(out), "--set", "tracking.levels=3",
                   "--set", "tracking.iters=[4,8,16]", "--set", "backend.enabled=false",
                   "--device", "cpu"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["frames"] == 4 and result["lost_frames"] == 0
    header = json.loads(open(out / "frames.jsonl").readline())
    assert header["intrinsics"] == [258.6, 258.2, 159.3, 127.6, 320, 240]
    assert TumSequence(root, calib_file=str(calib)).undistort


def test_undistortion_path(tum_dir):
    root, seq = tum_dir
    from rgbid_tpu_torch.datasets.tum import guess_distortion

    d = guess_distortion("rgbd_dataset_freiburg1_desk")
    assert abs(d[0] - 0.2624) < 1e-9
    ts = TumSequence(root, distortion=d)
    assert ts.undistort
    f = ts[0]
    assert f.rgb.shape == seq.rgb[0].shape and f.depth.dtype == np.uint16
    assert not np.array_equal(f.rgb, seq.rgb[0])  # the remap was applied
    # Nearest remap: every depth value existed in the source image.
    src_vals = set(np.unique(seq.depth[0]).tolist())
    assert set(np.unique(f.depth).tolist()) <= src_vals | {0}
    # undistort=False restores the passthrough.
    f2 = TumSequence(root, distortion=d, undistort=False)[0]
    np.testing.assert_array_equal(f2.depth, seq.depth[0])


def test_associate_fast_matches_bruteforce_and_scales():
    """The sorted-window associate reproduces the toolkit's all-pairs greedy
    result exactly and runs a real-length index (3k entries) well inside 1 s."""

    def brute(a, b, max_difference=0.02):
        candidates = []
        for i, (ta, _) in enumerate(a):
            for j, (tb, _) in enumerate(b):
                d = abs(ta - tb)
                if d < max_difference:
                    candidates.append((d, i, j))
        candidates.sort()
        used_a, used_b, matches = set(), set(), []
        for _, i, j in candidates:
            if i not in used_a and j not in used_b:
                used_a.add(i)
                used_b.add(j)
                matches.append((i, j))
        return sorted(matches)

    for seed in range(3):
        rng = np.random.default_rng(seed)
        ta = np.cumsum(rng.uniform(0.02, 0.05, 300))
        tb = ta + rng.normal(0, 0.008, 300)
        keep_a = rng.random(300) > 0.08
        keep_b = rng.random(300) > 0.08
        a = [(float(t), ["x"]) for t in ta[keep_a]]
        b = [(float(t), ["y"]) for t in np.sort(tb[keep_b])]
        assert associate(a, b) == brute(a, b)

    ta = np.cumsum(rng.uniform(0.03, 0.037, 3000))
    tb = np.sort(ta + rng.normal(0, 0.006, 3000))
    a = [(float(t), ["x"]) for t in ta]
    b = [(float(t), ["y"]) for t in tb]
    t0 = time.perf_counter()
    m = associate(a, b)
    dt = time.perf_counter() - t0
    assert len(m) > 2500
    # A complexity guard (the all-pairs scan takes seconds here), as loose
    # as the JAX package's test.
    assert dt < 1.0, f"associate took {dt * 1e3:.1f} ms"


def test_load_calibration_formats(tmp_path):
    from rgbid_tpu_torch.datasets.tum import load_calibration

    p = tmp_path / "c1.txt"
    p.write_text("# fx fy cx cy\n520.9 521.0 325.1 249.7\n")
    intr, dist = load_calibration(str(p))
    assert (intr.fx, intr.width) == (520.9, 640) and not dist.any()

    p = tmp_path / "c2.txt"
    p.write_text("517.3 516.5 318.6 255.3 640 480\n0.2624 -0.9531 -0.0054 0.0026 1.1633\n")
    intr, dist = load_calibration(str(p))
    assert intr.cy == 255.3 and abs(dist[0] - 0.2624) < 1e-12

    p = tmp_path / "c3.txt"
    p.write_text("fx: 100.0\nfy = 101.0\ncx: 80\ncy: 60\nwidth: 160\nheight: 120\nk1: 0.1\n")
    intr, dist = load_calibration(str(p))
    assert (intr.fy, intr.height, dist[0]) == (101.0, 120, 0.1)


def test_calibration_file_pickup(tum_dir, tmp_path):
    root, _ = tum_dir
    calib = tmp_path / "calib.txt"
    calib.write_text("258.6 258.2 159.3 127.6 320 240\n")
    ts = TumSequence(root, calib_file=str(calib))
    assert abs(ts.intrinsics.fx - 258.6) < 1e-9
    assert not ts.undistort  # explicit calib: zero distortion wins over the guess


def test_prefetch_frames_order_and_errors():
    from rgbid_tpu_torch.datasets import prefetch_frames

    assert list(prefetch_frames(iter(range(100)), depth=3)) == list(range(100))

    def boom():
        yield 1
        raise RuntimeError("reader died")

    it = prefetch_frames(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="reader died"):
        list(it)


@pytest.fixture(scope="module")
def tum_dir_500(tmp_path_factory):
    """A 500-frame TUM-format directory at 160x120 (ingest scale; SLAM runs
    on a prefix)."""
    intr = Intrinsics(fx=129.3, fy=129.1, cx=79.6, cy=59.8, width=160, height=120)
    root = tmp_path_factory.mktemp("rgbd_dataset_synth500")
    seq = synthetic.generate_sequence(
        n_frames=500, intr=intr, motion="orbit", trans_amp=0.2, rot_amp=0.05,
        xi_noise_sigma=0.002, seed=11,
    )
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rng = np.random.default_rng(0)
    rgb_lines, depth_lines = [], []
    for i in range(len(seq)):
        t_rgb = seq.timestamps[i]
        t_depth = t_rgb + float(rng.uniform(0.0, 0.01))
        rgb_name = f"rgb/{t_rgb:.6f}.png"
        depth_name = f"depth/{t_depth:.6f}.png"
        cv2.imwrite(str(root / rgb_name), cv2.cvtColor(seq.rgb[i], cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(root / depth_name), seq.depth[i])
        rgb_lines.append(f"{t_rgb:.6f} {rgb_name}")
        depth_lines.append(f"{t_depth:.6f} {depth_name}")
    for name, lines in [("rgb.txt", rgb_lines), ("depth.txt", depth_lines)]:
        with open(root / name, "w") as f:
            f.write("# header\n")
            f.write("\n".join(lines) + "\n")
    (root / "calibration.txt").write_text("129.3 129.1 79.6 59.8 160 120\n")
    return str(root)


def test_cli_500_frame_ingest(tum_dir_500, capsys):
    """The CLI over the 500-frame directory: the whole index associated in
    one pass (calibration.txt in the directory picked up), SLAM over a
    prefix through the prefetch thread, on the CPU."""
    t0 = time.perf_counter()
    ts = TumSequence(tum_dir_500)
    assoc_s = time.perf_counter() - t0
    assert len(ts) == 500
    assert assoc_s < 2.0  # the whole open, the probe image's read included
    assert abs(ts.intrinsics.fx - 129.3) < 1e-9

    from rgbid_tpu_torch.cli import main as cli_main

    rc = cli_main(
        [
            "--tum", tum_dir_500,
            "--max-frames", "30",
            "--eval",
            "--quiet",
            "--set", "tracking.levels=3",
            "--set", "tracking.iters=[2,8,16]",
            "--set", "backend.enabled=false",
            "--device", "cpu",
        ]
    )
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["frames"] == 30
    assert result["lost_frames"] == 0


# ---------------------------------------------------------------------------
# The OpenCV calls the reader replaces, bit for bit


def _factory_K(name: str, w: int, h: int) -> np.ndarray:
    """The factory camera of ``name`` scaled to w x h as TumSequence scales it."""
    fx, fy, cx, cy = FACTORY_K[name]
    sx, sy = w / 640, h / 480
    return np.array([[fx * sx, 0, (cx + 0.5) * sx - 0.5], [0, fy * sy, (cy + 0.5) * sy - 0.5],
                     [0, 0, 1]])


@pytest.mark.parametrize("name", ["freiburg1", "freiburg2"])
@pytest.mark.parametrize("size", [(640, 480), (160, 120)])
def test_undistortion_equals_cv2(name, size):
    """``undistort_maps`` equals ``initUndistortRectifyMap`` exactly, and the
    two remaps equal ``cv2.remap`` exactly on those maps (random RGB and
    depth images)."""
    w, h = size
    K = _factory_K(name, w, h)
    d = TUM_DISTORTION[name]
    want = cv2.initUndistortRectifyMap(K, d, None, K, size, cv2.CV_32FC1)
    m1, m2 = _cv.undistort_maps(K, d, size)
    np.testing.assert_array_equal(m1, want[0])
    np.testing.assert_array_equal(m2, want[1])
    plan = _cv.linear_plan(m1, m2, (h, w))
    for seed in range(3):
        rng = np.random.default_rng(seed)
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        depth = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        np.testing.assert_array_equal(_cv.remap_linear_u8(rgb, m1, m2, plan),
                                      cv2.remap(rgb, m1, m2, cv2.INTER_LINEAR))
        np.testing.assert_array_equal(_cv.remap_nearest(depth, m1, m2),
                                      cv2.remap(depth, m1, m2, cv2.INTER_NEAREST))


@pytest.mark.parametrize("shape", [(240, 320), (7, 3), (1, 9), (121, 161)])
def test_remaps_equal_cv2_on_random_maps(shape):
    """Random maps reaching 3 pixels outside the image, 40% of them on
    quarter- and half-pixel fractions (where rounding ties), on 1- and
    3-channel uint8 and on uint16: exact equality."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    mx = rng.uniform(-3, w + 2, (h, w)).astype(np.float32)
    my = rng.uniform(-3, h + 2, (h, w)).astype(np.float32)
    snap = rng.random((h, w)) < 0.4
    mx[snap] = np.round(mx[snap] * 4) / 4
    my[snap] = np.round(my[snap] * 2) / 2
    for img in (rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                rng.integers(0, 256, (h, w)).astype(np.uint8)):
        np.testing.assert_array_equal(_cv.remap_linear_u8(img, mx, my),
                                      cv2.remap(img, mx, my, cv2.INTER_LINEAR))
        np.testing.assert_array_equal(_cv.remap_nearest(img, mx, my),
                                      cv2.remap(img, mx, my, cv2.INTER_NEAREST))
    d16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    np.testing.assert_array_equal(_cv.remap_nearest(d16, mx, my),
                                  cv2.remap(d16, mx, my, cv2.INTER_NEAREST))


def test_nearest_rounds_half_to_even():
    img = np.arange(1, 17, dtype=np.uint16).reshape(1, 16)
    mx = np.array([[0.5, 1.5, 2.5, 15.5, -0.5, -0.6]], np.float32)
    my = np.zeros_like(mx)
    got = _cv.remap_nearest(img, mx, my)
    np.testing.assert_array_equal(got, cv2.remap(img, mx, my, cv2.INTER_NEAREST))
    np.testing.assert_array_equal(got, [[1, 3, 3, 0, 1, 0]])


@pytest.mark.parametrize("distortion", [None, "freiburg1"])
def test_frames_equal_the_jax_reader(tum_dir, distortion):
    """``TumSequence[i]`` of the port equals the JAX package's on the same
    directory bit for bit: timestamps, RGB and depth, and the intrinsics."""
    root, _ = tum_dir
    d = None if distortion is None else TUM_DISTORTION[distortion]
    ours, ref = TumSequence(root, distortion=d), JaxTumSequence(root, distortion=d)
    assert len(ours) == len(ref) and ours.undistort == ref.undistort
    assert tuple(ours.intrinsics) == tuple(ref.intrinsics)
    for i in (0, 4, len(ref) - 1):
        a, b = ours[i], ref[i]
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.rgb, b.rgb)
        assert a.depth.dtype == b.depth.dtype
        np.testing.assert_array_equal(a.depth, b.depth)


def test_unreadable_frame_raises_ioerror(tum_dir, tmp_path):
    """A PNG cut short mid-write raises IOError, as the JAX reader's
    ``cv2.imread`` returning None does."""
    import shutil

    root, _ = tum_dir
    copy = tmp_path / "rgbd_dataset_cut"
    shutil.copytree(root, copy)
    ours, ref = TumSequence(str(copy)), JaxTumSequence(str(copy))
    depth_rel = ours._items[2][2]
    data = (copy / depth_rel).read_bytes()
    (copy / depth_rel).write_bytes(data[: len(data) // 2])
    for seq in (ours, ref):
        with pytest.raises(IOError, match="cannot read"):
            seq[2]
