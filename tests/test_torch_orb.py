"""The port's ORB (``rgbid_tpu_torch/backend/orb.py``, numpy) against
OpenCV 5.0.0, on the CPU.

The port never imports OpenCV; this file does, and holds every stage to the
OpenCV function that exposes it, then the whole to
``cv2.ORB_create(n).detectAndCompute`` and to the JAX package's
``extract_orb`` (which is that call).

Tolerances, and why:
- pyramid sizes, resize, FAST keypoints and scores, the Gaussian taps and
  the blur against ``cv2.sepFilter2D``, the rBRIEF pattern: exact. They are
  integer rules, or float32 sums in a fixed order.
- blur against ``cv2.GaussianBlur``: max |d| 1 grey level. On a whole plane
  ``GaussianBlur`` takes its 8-bit fixed-point filter; ORB blurs a region of
  its pyramid buffer, for which OpenCV takes the float filter (the same taps
  as ``sepFilter2D`` with ``getGaussianKernel(7, 2, CV_32F)``). The port
  follows ORB, so it equals ``sepFilter2D`` and is within 1 of
  ``GaussianBlur``.
- ``fast_atan2``: 1e-4 degrees against ``cv2.fastAtan2`` (measured 3.1e-5:
  one float32 ulp at 360; OpenCV's build may fuse a multiply-add).
- ``compute`` at given keypoints and angles: at most 1 bit in 1000 (measured
  0 of 51200): a rotated coordinate within one float32 ulp of a half would
  round the other way.
- the whole: at least 98% of OpenCV's keypoints in the port's output at the
  same (octave, x, y) and the reverse (a Harris response is a float32
  expression of ~1e15-sized products, and the quota cut keeps ties, so a
  last-bit difference could move a keypoint across the cut); angles within
  0.01 degrees; mean Hamming distance on matched keypoints at most 2 of 256
  bits. Measured on all nine images: the sets equal, angles within 3.1e-5
  degrees, responses and coordinates equal, Hamming distance 0.
"""

import importlib.util
import pathlib

import cv2
import numpy as np
import pytest

import chip_smoke
from rgbid_tpu.backend.features import extract_orb as cv2_extract_orb
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.datasets import synthetic
from rgbid_tpu_torch.backend import features, orb
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.tracking.step import gray_from_rgb

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZES = {"160x120": (160, 120, 300), "320x240": (320, 240, 400), "640x480": (640, 480, 500)}


def _intr(cls, w, h):
    f = 525.0 * w / 640.0
    return cls(fx=f, fy=f, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)


def _busy(w, h, seed):
    """Smooth noise, pixel noise and 30 flat rectangles: thousands of FAST
    corners a level, so every quota is full and the cuts decide."""
    r = np.random.default_rng(seed)
    im = cv2.resize(r.integers(0, 256, (h // 4 + 1, w // 4 + 1)).astype(np.float32), (w, h),
                    interpolation=cv2.INTER_CUBIC)
    im += r.normal(0, 6, (h, w))
    for _ in range(30):
        x, y = r.integers(0, w - 40), r.integers(0, h - 40)
        im[y:y + r.integers(5, 40), x:x + r.integers(5, 40)] = r.integers(0, 256)
    return np.clip(im, 0, 255).astype(np.uint8)


def _make_image(source, size):
    w, h, n = SIZES[size]
    if source == "smoke":
        frames, _ = chip_smoke.make_loop_sequence(_intr(Intrinsics, w, h), n=1)
        return gray_from_rgb(frames[0][0]), n
    if source == "synthetic":
        seq = synthetic.generate_sequence(n_frames=2, intr=_intr(JIntrinsics, w, h),
                                          motion="orbit", seed=1)
        return gray_from_rgb(seq.rgb[1]), n
    return _busy(w, h, seed=w), n


IMAGES = [(s, z) for s in ("smoke", "synthetic", "busy") for z in SIZES]


@pytest.fixture(scope="module", params=IMAGES, ids=lambda p: f"{p[0]}-{p[1]}")
def image(request):
    img, n = _make_image(*request.param)
    assert img.dtype == np.uint8 and img.ndim == 2
    return img, n


# ---------------------------------------------------------------------------
# Stages


def test_gray_rule_equals_cv2_on_these_images():
    frames, _ = chip_smoke.make_loop_sequence(_intr(Intrinsics, 160, 120), n=1)
    rgb = frames[0][0]
    np.testing.assert_array_equal(gray_from_rgb(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


def test_quotas_and_level_sizes():
    assert orb.features_per_level(500) == [109, 90, 75, 63, 52, 44, 36, 31]
    for n in (300, 400, 500, 1000):
        q = orb.features_per_level(n)
        assert sum(q) == n and all(a >= b for a, b in zip(q, q[1:]))
    assert orb.level_sizes(640, 480) == [(640, 480), (533, 400), (444, 333), (370, 278),
                                         (309, 231), (257, 193), (214, 161), (179, 134)]


def test_pyramid_equals_cv2_resize_linear_exact(image):
    img, _ = image
    levels = orb.build_pyramid(img)
    sizes = orb.level_sizes(img.shape[1], img.shape[0])
    assert len(levels) == 8
    ref = img
    for level, size in zip(levels[1:], sizes[1:]):
        ref = cv2.resize(ref, size, interpolation=cv2.INTER_LINEAR_EXACT)
        np.testing.assert_array_equal(level, ref)


def test_fast_equals_cv2_on_every_level(image):
    img, _ = image
    fd = cv2.FastFeatureDetector_create(orb.FAST_THRESHOLD, True)
    total = 0
    for level in orb.build_pyramid(img):
        ref = sorted((int(k.pt[0]), int(k.pt[1]), int(k.response)) for k in fd.detect(level))
        xs, ys, score = orb.fast_corners(level)
        assert sorted(zip(xs.tolist(), ys.tolist(), score.tolist())) == ref
        total += len(ref)
    print(f"FAST corners over 8 levels: {total}")


def test_fast_atan2_matches_cv2():
    y, x = np.meshgrid(np.arange(-40, 41, dtype=np.float32) * 371.0,
                       np.arange(-40, 41, dtype=np.float32) * 913.0, indexing="ij")
    y, x = y.ravel(), x.ravel()
    ref = np.array([cv2.fastAtan2(float(a), float(b)) for a, b in zip(y, x)], np.float32)
    got = orb.fast_atan2(y, x)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4
    # A polynomial, not atan2: (1, 2) gives 26.5671, where atan2 gives 26.5651.
    assert abs(float(orb.fast_atan2(np.float32(1), np.float32(2))) - 26.5671) < 1e-3


def test_blur_equals_cv2_float_filter_and_is_within_one_of_gaussianblur(image):
    img, _ = image
    taps = cv2.getGaussianKernel(7, 2, cv2.CV_32F)
    np.testing.assert_array_equal(orb._BLUR_TAPS, taps.ravel())
    got = orb.gaussian_blur7(img)
    np.testing.assert_array_equal(
        got, cv2.sepFilter2D(img, cv2.CV_8U, taps, taps, borderType=cv2.BORDER_REFLECT_101))
    fixed = cv2.GaussianBlur(img, (7, 7), 2, 2, borderType=cv2.BORDER_REFLECT_101)
    assert np.abs(got.astype(int) - fixed).max() <= 1


def test_committed_pattern_equals_fresh_recovery():
    spec = importlib.util.spec_from_file_location(
        "recover_orb_pattern", REPO / "tools" / "recover_orb_pattern.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.recover()
    committed = np.load(REPO / "rgbid_tpu_torch" / "data" / "orb_pattern.npy")
    assert committed.dtype == np.int8 and committed.shape == (256, 4)
    np.testing.assert_array_equal(committed, fresh)
    np.testing.assert_array_equal(orb.pattern(), fresh.astype(np.float32))
    assert committed[:2].tolist() == [[8, -3, 9, 5], [4, 2, 7, -12]]
    # The rotated pattern stays inside the radius the border argument uses.
    assert np.hypot(committed[:, 0::2], committed[:, 1::2]).max() < 19


@pytest.mark.parametrize("source", ["smoke", "busy"])
def test_compute_at_given_keypoints_and_angles(source):
    img, _ = _make_image(source, "320x240")
    r = np.random.default_rng(4)
    n = 200
    xs = r.integers(31, img.shape[1] - 31, n)
    ys = r.integers(31, img.shape[0] - 31, n)
    angles = r.uniform(0, 360, n).astype(np.float32)
    angles[:4] = [0.0, 90.0, 180.0, 270.0]
    kps = [cv2.KeyPoint(float(x), float(y), 31.0, float(a), 1.0, 0)
           for x, y, a in zip(xs, ys, angles)]
    out, ref = cv2.ORB_create().compute(img, kps)
    assert len(out) == n and all(k.angle == a for k, a in zip(out, angles))
    got = orb.brief_descriptors(orb.gaussian_blur7(img), xs, ys, angles)
    wrong = int(np.unpackbits(got ^ ref).sum())
    print(f"compute parity: {wrong} of {n * 256} bits differ")
    assert wrong <= n * 256 // 1000


# ---------------------------------------------------------------------------
# The whole


def _keyed(octave, xs, ys):
    return {(int(o), int(x), int(y)): i for i, (o, x, y) in enumerate(zip(octave, xs, ys))}


def test_detect_and_compute_matches_cv2(image):
    img, n = image
    kps, desc = cv2.ORB_create(nfeatures=n).detectAndCompute(img, None)
    f = orb.detect_and_compute(img, n)
    scales = orb.level_scales()
    ref = _keyed([k.octave for k in kps], [round(k.pt[0] / scales[k.octave]) for k in kps],
                 [round(k.pt[1] / scales[k.octave]) for k in kps])
    got = _keyed(f.octave, f.xs, f.ys)
    assert len(ref) == len(kps) and len(got) == len(f.pts)
    common = sorted(set(ref) & set(got))
    print(f"keypoints: cv2 {len(ref)}, port {len(got)}, common {len(common)}; per octave "
          f"{np.bincount(f.octave, minlength=8).tolist()}")
    assert len(ref) > 0
    assert len(common) >= 0.98 * len(ref) and len(common) >= 0.98 * len(got)
    i_ref = [ref[k] for k in common]
    i_got = [got[k] for k in common]
    d_angle = np.abs(np.array([kps[i].angle for i in i_ref], np.float32) - f.angle[i_got])
    d_angle = np.minimum(d_angle, 360.0 - d_angle)
    ham = np.unpackbits(desc[i_ref] ^ f.descriptors[i_got], axis=1).sum(axis=1)
    print(f"angle max |d| {d_angle.max():.2e} deg, Hamming mean {ham.mean():.3f} max {ham.max()}")
    assert d_angle.max() <= 0.01
    assert ham.mean() <= 2.0
    np.testing.assert_allclose(f.response[i_got], [kps[i].response for i in i_ref], rtol=1e-5)
    np.testing.assert_array_equal(f.pts[i_got], np.array([kps[i].pt for i in i_ref], np.float32))


def _rows(pts, desc):
    rows = np.concatenate([pts.view(np.uint8).reshape(len(pts), 8), desc], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_extract_orb_matches_reference_as_a_set(image):
    """The output contract: (N, 2) float32 and (N, 32) uint8, the same rows
    as the JAX package's extractor in another order (at least 98% of them)."""
    img, n = image
    pts, desc = features.extract_orb(img, n)
    rpts, rdesc = cv2_extract_orb(img, n)
    assert pts.dtype == np.float32 and pts.shape == (len(desc), 2)
    assert desc.dtype == np.uint8 and desc.shape[1] == 32
    got = {r.tobytes() for r in _rows(pts, desc)}
    ref = {r.tobytes() for r in _rows(rpts, rdesc)}
    assert len(got & ref) >= 0.98 * max(len(ref), len(got))


@pytest.mark.parametrize("shape", [(120, 160), (60, 60), (62, 200), (6, 6)],
                         ids=["blank", "smaller-than-border", "one-side-too-small", "tiny"])
def test_empty_case(shape):
    """A blank image has no corner; an image with a side of at most twice the
    31-pixel border keeps none. Both give the reference's empty arrays."""
    img = np.full(shape, 90, np.uint8) if shape == (120, 160) else _busy(200, 200, 1)[
        :shape[0], :shape[1]]
    pts, desc = features.extract_orb(np.ascontiguousarray(img), 300)
    rpts, rdesc = cv2_extract_orb(np.ascontiguousarray(img), 300)
    assert len(rpts) == 0
    assert pts.shape == rpts.shape == (0, 2) and pts.dtype == rpts.dtype == np.float32
    assert desc.shape == rdesc.shape == (0, 32) and desc.dtype == rdesc.dtype == np.uint8


def test_rejects_wrong_input():
    with pytest.raises(ValueError):
        orb.detect_and_compute(np.zeros((120, 160, 3), np.uint8))
    with pytest.raises(ValueError):
        orb.detect_and_compute(np.zeros((120, 160), np.float32))
