"""The port's synthetic renderer against the JAX package's, and its numpy
forms of OpenCV's functions against OpenCV, on the CPU.

``rgbid_tpu_torch/datasets/_cv.py`` states each function's residue; these
tests hold it there:
- ``resize_cubic`` at the renderer's shapes: the textures (8, 16, 32 and 64
  squared to 512 squared) and the depth-hole blobs ((h/8, w/8) to (h, w) at
  QVGA, VGA and an odd size). Integer scales: bit-equal inside, at least 90%
  of the border band equal, and everything within 2.4e-7 of the largest
  magnitude. The odd size: within 1e-5 of the largest magnitude.
- ``filter2d_u8`` with the renderer's line kernels, L = 1..8, diagonal and
  axis-aligned, on a rendered frame: bit-equal where OpenCV sums directly
  (L <= 5, and every axis-aligned line); for an oblique line from L = 6,
  where OpenCV goes through a DFT, one grey level at most on at most 3% of
  pixels.
- ``median3_f32`` and ``dilate3_u8`` with zeros at the edges: bit-equal.

The sequences: one short QVGA sequence per option the gauntlet uses (each
gauntlet row's sequence settings), plus ``motion="loop"`` and ``"static"``,
from both packages with the same seed: poses, timestamps and depth equal,
RGB equal except where the Kinect blur takes OpenCV's DFT path (the
``filter2d_u8`` residue above, frame by frame). Then the four tests of
``tests/test_synthetic.py`` on the port.
"""

import cv2
import numpy as np
import pytest

from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.datasets import synthetic as jsyn
from rgbid_tpu.eval.gauntlet import scenarios as j_scenarios
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.datasets import _cv
from rgbid_tpu_torch.datasets import synthetic

RESIZE_REL = 2.4e-7  # integer scales, border band
RESIZE_ODD_REL = 1e-5
DFT_MAX_SHARE = 0.03


def _gauntlet_intr(w, h):
    return dict(fx=0.808 * w, fy=1.076 * h, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)


def _line_kernel(L, direc):
    """The renderer's motion-blur kernel (``synthetic._apply_kinect_artifacts``)."""
    k = 2 * L + 1
    kern = np.zeros((k, k), np.float32)
    direc = np.asarray(direc, np.float64) / np.hypot(*direc)
    for s in np.linspace(-L, L, 2 * k):
        x = int(round(L + s * direc[0]))
        y = int(round(L + s * direc[1]))
        kern[np.clip(y, 0, k - 1), np.clip(x, 0, k - 1)] += 1.0
    return kern / kern.sum()


@pytest.mark.parametrize(
    "src_hw,dst_wh",
    [((8, 8), (512, 512)), ((16, 16), (512, 512)), ((32, 32), (512, 512)), ((64, 64), (512, 512)),
     ((30, 40), (320, 240)), ((60, 80), (640, 480)), ((60, 80), (641, 481))],
    ids=["tex8", "tex16", "tex32", "tex64", "blob-qvga", "blob-vga", "blob-odd"])
def test_resize_cubic_matches_cv2(src_hw, dst_wh):
    rng = np.random.default_rng(sum(src_hw) + dst_wh[0])
    src = rng.standard_normal(src_hw).astype(np.float32)
    ref = cv2.resize(src, dst_wh, interpolation=cv2.INTER_CUBIC)
    out = _cv.resize_cubic(src, dst_wh)
    assert out.dtype == np.float32 and out.shape == ref.shape
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    h, w = src_hw
    W, H = dst_wh
    if W % w or H % h:
        assert rel <= RESIZE_ODD_REL, rel
        return
    x_in = _cv._cubic_taps(w, W)[2]
    y_in = _cv._cubic_taps(h, H)[2]
    inner = y_in[:, None] & x_in[None, :]
    np.testing.assert_array_equal(out[inner], ref[inner])
    assert np.mean(out[~inner] == ref[~inner]) >= 0.9
    assert rel <= RESIZE_REL, rel


@pytest.fixture(scope="module")
def frame_rgb():
    intr = Intrinsics(**_gauntlet_intr(320, 240))
    rgb, _, _, _ = synthetic.render_frame(synthetic.make_scene(3), intr, np.eye(4))
    return rgb


@pytest.mark.parametrize("direc", [(0.6, 0.8), (1.0, 0.0)], ids=["diagonal", "axis"])
@pytest.mark.parametrize("L", range(1, 9))
def test_filter2d_matches_cv2(frame_rgb, L, direc):
    kern = _line_kernel(L, direc)
    ref = cv2.filter2D(frame_rgb, -1, kern)
    out = _cv.filter2d_u8(frame_rgb, kern)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    if kern.size < _cv.DFT_KERNEL_AREA or direc[1] == 0.0:
        np.testing.assert_array_equal(out, ref)
    else:
        diff = np.abs(out.astype(int) - ref)
        assert diff.max() <= 1 and np.mean(diff > 0) <= DFT_MAX_SHARE, np.mean(diff > 0)


def test_median3_matches_cv2():
    rng = np.random.default_rng(1)
    z = (rng.random((240, 320)) * 4).astype(np.float32)
    z[rng.random(z.shape) < 0.2] = 0
    z[0], z[:, -1] = 0, 0
    np.testing.assert_array_equal(_cv.median3_f32(z), cv2.medianBlur(z, 3))


@pytest.mark.parametrize("iterations", [1, 2])
def test_dilate3_matches_cv2(iterations):
    rng = np.random.default_rng(2)
    m = (rng.random((240, 320)) < 0.05).astype(np.uint8)
    m[0, :4], m[-1, -3:], m[5:9, 0] = 1, 1, 1
    ref = cv2.dilate(m, np.ones((3, 3), np.uint8), iterations=iterations)
    np.testing.assert_array_equal(_cv.dilate3_u8(m, iterations), ref)


def _sequence_cases():
    cases = [(name, kw) for name, kw, _ in j_scenarios(6)]
    cases.append(("loop", dict(motion="loop", xi_noise_sigma=0.005)))
    cases.append(("static", dict(motion="static", depth_hole_frac=0.1)))
    return cases


@pytest.mark.parametrize("name,kw", _sequence_cases(), ids=[c[0] for c in _sequence_cases()])
def test_generate_sequence_matches_jax(name, kw):
    n = 5
    a = jsyn.generate_sequence(n_frames=n, intr=JIntrinsics(**_gauntlet_intr(320, 240)), seed=3, **kw)
    b = synthetic.generate_sequence(n_frames=n, intr=Intrinsics(**_gauntlet_intr(320, 240)), seed=3, **kw)
    assert len(b) == len(a) == n and b.timestamps == a.timestamps
    for i in range(n):
        np.testing.assert_array_equal(b.gt_poses[i], a.gt_poses[i])
        assert b.depth[i].dtype == np.uint16 and b.rgb[i].dtype == np.uint8
        np.testing.assert_array_equal(b.depth[i], a.depth[i])
        if kw.get("kinect_artifacts", 0) > 0:
            diff = np.abs(b.rgb[i].astype(int) - a.rgb[i])
            assert diff.max() <= 1 and np.mean(diff > 0) <= DFT_MAX_SHARE, (i, np.mean(diff > 0))
        else:
            np.testing.assert_array_equal(b.rgb[i], a.rgb[i])


# The four tests of tests/test_synthetic.py, run on the port.


def small_intr():
    return Intrinsics(fx=129.3, fy=129.1, cx=79.6, cy=63.8, width=160, height=120)


def test_render_static_frame():
    scene = synthetic.make_scene(0)
    rgb, d16, gray, depth = synthetic.render_frame(scene, small_intr(), np.eye(4))
    assert rgb.shape == (120, 160, 3) and rgb.dtype == np.uint8
    assert d16.shape == (120, 160) and d16.dtype == np.uint16
    hit = depth > 0
    assert hit.mean() > 0.97
    assert depth[hit].min() > 0.5 and depth[hit].max() < 8.0
    assert gray[hit].std() > 0.05


def test_depth_scale_u16():
    scene = synthetic.make_scene(0)
    _, d16, _, depth = synthetic.render_frame(scene, small_intr(), np.eye(4))
    hit = depth > 0
    np.testing.assert_allclose(d16[hit] / 5000.0, depth[hit], atol=1e-4 + 1 / 5000.0)


def test_photometric_consistency_across_views():
    """Warp pixels from view A to view B with ground-truth depth and pose;
    the intensities match."""
    intr = small_intr()
    scene = synthetic.make_scene(0)
    T_a = np.eye(4)
    T_b = synthetic.orbit_trajectory(10, trans_amp=0.2, rot_amp=0.05)[5]
    _, _, gray_a, depth_a = synthetic.render_frame(scene, intr, T_a)
    _, _, gray_b, depth_b = synthetic.render_frame(scene, intr, T_b)

    h, w = depth_a.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    z = depth_a
    valid = z > 0
    x = (u - intr.cx) / intr.fx * z
    y = (v - intr.cy) / intr.fy * z
    pts_w = np.stack([x, y, z], -1) @ T_a[:3, :3].T + T_a[:3, 3]
    T_bw = np.linalg.inv(T_b)
    pts_b = pts_w @ T_bw[:3, :3].T + T_bw[:3, 3]
    zb = pts_b[..., 2]
    ub = intr.fx * pts_b[..., 0] / zb + intr.cx
    vb = intr.fy * pts_b[..., 1] / zb + intr.cy
    inb = valid & (zb > 0.05) & (ub >= 1) & (ub < w - 2) & (vb >= 1) & (vb < h - 2)
    ui, vi = np.round(ub[inb]).astype(int), np.round(vb[inb]).astype(int)
    zb_img = depth_b[vi, ui]
    vis = (zb_img > 0) & (np.abs(zb_img - zb[inb]) < 0.03)
    diff = np.abs(gray_b[vi, ui][vis] - gray_a[inb][vis])
    assert vis.mean() > 0.5
    assert np.median(diff) < 0.03


def test_sequence_generation_and_noise():
    seq = synthetic.generate_sequence(n_frames=4, intr=small_intr(), xi_noise_sigma=0.005, seed=3)
    assert len(seq) == 4
    assert seq.gt_poses[0].shape == (4, 4)
    f = next(seq.frames())
    assert f.rgb.shape == (120, 160, 3)
    d0 = seq.depth[0].astype(np.float64) / 5000.0
    hit = d0 > 0
    assert 0.3 < d0[hit].mean() < 8.0
