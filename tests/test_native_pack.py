"""The frame's host packing in one native pass (``native/pack_frame.cpp``)
against its numpy oracle and the JAX package.

``pack_frame`` and ``gray_from_rgb`` run the native pass whenever
``native.toolchain()`` finds ``g++``; their numpy code stays as the oracle
and as the path without a toolchain. Held here: the bytes of every codec
at several shapes against the numpy path and the JAX package's
``pack_frame``; the luma on all 256^3 colours against the numpy formula
and OpenCV; views (a gray frame, four channels, reversed, strided,
Fortran-ordered, broadcast) and the inputs the native pass leaves to numpy;
the counters; and a ``feed`` that packs every frame natively with poses
bit-equal to the same run on the numpy path.
"""

import cv2
import numpy as np
import pytest
import torch

import rgbid_tpu_torch as port
from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.tracking import step as jstep
from rgbid_tpu_torch import native
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import SlamConfig
from rgbid_tpu_torch.datasets import synthetic
from rgbid_tpu_torch.tracking import step

torch.set_num_threads(2)


@pytest.fixture()
def gxx():
    if native.toolchain() is None:
        pytest.skip("no g++ on this machine: pack_frame runs numpy")


@pytest.fixture()
def numpy_path(monkeypatch):
    """Within the test, no toolchain: the numpy code runs and nothing native
    is loaded."""
    monkeypatch.setattr(native, "toolchain", lambda: None)
    monkeypatch.setattr(native, "load", lambda: pytest.fail("native library loaded"))


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    depth = rng.integers(0, 65536, (h, w), np.uint16)
    depth[::7, ::5] = 0
    return rgb, depth


def _numpy_pack(rgb, depth, cfg, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "toolchain", lambda: None)
        return step.pack_frame(rgb, depth, cfg)


@pytest.mark.parametrize("codec,shape", [
    ("u16", (480, 640)), ("u16", (7, 5)), ("u16", (1, 1)), ("u16", (0, 4)),
    ("u12", (120, 160)), ("u12", (5, 6)), ("u16h", (96, 128)), ("u16h", (6, 10)),
])
def test_pack_frame_native_equals_numpy_and_jax(gxx, monkeypatch, codec, shape):
    """Every codec's buffer from the native pass equals the numpy path's and
    the JAX package's byte for byte (the JAX package converts with OpenCV,
    equal to the formula on every colour), and counts as one native frame."""
    h, w = shape
    rgb, depth = _frame(h, w, h * 1000 + w)
    cfg, jcfg = SlamConfig().override(depth_codec=codec), JSlamConfig().override(depth_codec=codec)
    n0, m0 = step.pack_frame.native_calls, step.pack_frame.numpy_calls
    ours = step.pack_frame(rgb, depth, cfg)
    assert (step.pack_frame.native_calls, step.pack_frame.numpy_calls) == (n0 + 1, m0)
    ref = _numpy_pack(rgb, depth, cfg, monkeypatch)
    assert step.pack_frame.numpy_calls == m0 + 1
    assert ours.dtype == np.uint8 and ours.shape == ref.shape and ours.flags.c_contiguous
    np.testing.assert_array_equal(ours, ref)
    if h:
        np.testing.assert_array_equal(ours, jstep.pack_frame(rgb, depth, jcfg))


def test_gray_from_rgb_all_colours(gxx):
    """All 256^3 colours as one 4096 x 4096 image: the native luma equals
    the numpy formula (taken in row blocks to bound its uint32 copies) and
    OpenCV's ``cvtColor(RGB2GRAY)``."""
    c = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    del c
    gray = step.gray_from_rgb(rgb)
    assert gray.shape == (4096, 4096) and gray.dtype == np.uint8
    for r in range(0, 4096, 512):
        np.testing.assert_array_equal(gray[r:r + 512], step.gray_from_rgb_numpy(rgb[r:r + 512]))
    np.testing.assert_array_equal(gray, cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


def _views(rgb):
    rgba = np.concatenate([rgb, rgb[..., :1] ^ 0x5A], -1)
    return {
        "contiguous": rgb,
        "gray": np.ascontiguousarray(rgb[..., 1]),
        "gray_strided": rgb[..., 2],
        "four_channels": rgba,
        "four_channels_view": rgba[..., :3],
        "bgr_view": rgb[..., ::-1],
        "rows_reversed": rgb[::-1],
        "columns_reversed": rgb[:, ::-1],
        "fortran": np.asfortranarray(rgb),
        "transposed": np.ascontiguousarray(rgb.transpose(1, 0, 2)).transpose(1, 0, 2),
    }


@pytest.mark.parametrize("view", list(_views(np.zeros((1, 1, 3), np.uint8))))
def test_native_views_equal_numpy(gxx, monkeypatch, view):
    """A 2-D gray frame (returned as it is), four channels and non-contiguous
    views are read in place and give numpy's bytes, in ``gray_from_rgb`` and
    in every codec's ``pack_frame``."""
    rgb, depth = _frame(30, 42, 11)
    src = _views(rgb)[view]
    gray = step.gray_from_rgb(src)
    if src.ndim == 2:
        assert gray is src
    np.testing.assert_array_equal(gray, step.gray_from_rgb_numpy(src))
    for codec in ("u16", "u12", "u16h"):
        cfg = SlamConfig().override(depth_codec=codec)
        n0 = step.pack_frame.native_calls
        ours = step.pack_frame(src, depth, cfg)
        assert step.pack_frame.native_calls == n0 + 1
        np.testing.assert_array_equal(ours, _numpy_pack(src, depth, cfg, monkeypatch))


@pytest.mark.parametrize("case", ["depth_rows_reversed", "depth_fortran", "depth_int16",
                                  "depth_big_endian", "rgb_broadcast_row", "rgb_int32",
                                  "rgb_float", "rgb_batch_of_one"])
def test_inputs_numpy_accepts_keep_their_bytes(gxx, monkeypatch, case):
    """Depth views and other 2-byte depth types go through the native pass
    (their bytes in memory order, as numpy's ``view(uint8)``); an RGB row
    broadcast over the frame too. What the native pass does not take (an
    RGB of another dtype, or of another rank) is packed by the numpy code,
    and counted there."""
    rgb, depth = _frame(12, 16, 5)
    native_case = case.startswith("depth") or case == "rgb_broadcast_row"
    src, d = {
        "depth_rows_reversed": (rgb, depth[::-1]),
        "depth_fortran": (rgb, np.asfortranarray(depth)),
        "depth_int16": (rgb, depth.view(np.int16)),
        "depth_big_endian": (rgb, depth.astype(">u2")),
        "rgb_broadcast_row": (rgb[:1], depth),
        "rgb_int32": (rgb.astype(np.int32) + 256, depth),
        "rgb_float": (rgb.astype(np.float32) + 0.7, depth),
        "rgb_batch_of_one": (rgb[None], depth),
    }[case]
    n0, m0 = step.pack_frame.native_calls, step.pack_frame.numpy_calls
    ours = step.pack_frame(src, d)
    assert (step.pack_frame.native_calls - n0, step.pack_frame.numpy_calls - m0) == (
        (1, 0) if native_case else (0, 1))
    np.testing.assert_array_equal(ours, _numpy_pack(src, d, None, monkeypatch))


def test_shapes_numpy_refuses_are_refused(gxx):
    """A frame whose gray does not fit the depth, or a depth of another item
    size, raises as numpy's code does (``ValueError``); fewer than three
    channels raise numpy's ``IndexError``."""
    rgb, depth = _frame(8, 10, 1)
    with pytest.raises(ValueError):
        step.pack_frame(rgb[:, :9], depth)
    with pytest.raises(ValueError):
        step.pack_frame(rgb, depth.astype(np.int32))
    with pytest.raises(IndexError):
        step.pack_frame(rgb[..., :2], depth)
    with pytest.raises(ValueError, match="even width"):
        step.pack_frame(rgb[:, :9], depth[:, :9], SlamConfig().override(depth_codec="u12"))


def test_without_toolchain_numpy_packs(numpy_path):
    """No toolchain: ``pack_frame`` runs numpy and counts it there, and
    ``gray_from_rgb`` is the numpy formula."""
    rgb, depth = _frame(24, 32, 2)
    n0, m0 = step.pack_frame.native_calls, step.pack_frame.numpy_calls
    for codec in ("u16", "u12", "u16h"):
        step.pack_frame(rgb, depth, SlamConfig().override(depth_codec=codec))
    assert (step.pack_frame.native_calls, step.pack_frame.numpy_calls) == (n0, m0 + 3)
    np.testing.assert_array_equal(step.gray_from_rgb(rgb), step.gray_from_rgb_numpy(rgb))


TINY = Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120)
CFG = {"backend.enabled": False, "tracking.levels": 3, "tracking.iters": (4, 8, 16)}


def _run(frames):
    slam = port.SlamSystem(TINY, port.SlamConfig().override(**CFG), device="cpu")
    n0, m0 = step.pack_frame.native_calls, step.pack_frame.numpy_calls
    poses = slam.feed(frames, flight_depth=3)
    return np.stack(poses), step.pack_frame.native_calls - n0, step.pack_frame.numpy_calls - m0


def test_feed_packs_every_frame_natively(gxx, monkeypatch):
    """``SlamSystem.feed`` packs each of its frames (the bootstrap one
    included) in the native pass; the poses are bit-equal to those of the
    same run with the numpy path forced."""
    seq = synthetic.generate_sequence(n_frames=7, intr=TINY, motion="orbit", trans_amp=0.12,
                                      rot_amp=0.03, xi_noise_sigma=0.003, seed=6)
    frames = [(f.rgb, f.depth, f.timestamp) for f in seq.frames()]
    poses, n_native, n_numpy = _run(frames)
    assert (n_native, n_numpy) == (len(frames), 0)
    monkeypatch.setattr(native, "toolchain", lambda: None)
    ref, n_native, n_numpy = _run(frames)
    assert (n_native, n_numpy) == (0, len(frames))
    np.testing.assert_array_equal(poses, ref)
