"""The port's upload codecs ("u12", "u16h") against the JAX package's.

Mirrors ``tests/test_device_ops.py``'s codec tests on the port: the same
seeded inputs through both packages' ``pack_frame`` (bytes equal) and
``decode_frame`` (gray and mask exact, xi bit-equal where the two compute
the same float32 operations, otherwise within one float32 ulp: see each
test), the u12 lookup table over the reference test's (scale, min, max)
grid, ``upsample2x_renorm`` with even coordinates exact, and the
codec-mismatch ``ValueError``s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.ops import image as jimage
from rgbid_tpu.tracking import step as jstep
from rgbid_tpu_torch.core.config import SlamConfig
from rgbid_tpu_torch.ops import image
from rgbid_tpu_torch.tracking import step


def _frame(h, w, seed, holes=0.0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 255, (h, w, 3), np.uint8)
    # Invalid zeros, beyond max_depth (> 50000 at scale 5000), the whole
    # range, and the exact boundary raws.
    depth = rng.integers(0, 60000, (h, w), np.uint16)
    depth[::7, ::5] = 0
    if holes:
        depth[rng.random((h, w)) < holes] = 0
    depth[0, 0] = 1500  # exactly min_depth at scale 5000: invalid
    depth[0, 1] = 50000  # exactly max_depth: invalid
    return rgb, depth


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("codec,shape", [("u12", (120, 160)), ("u16h", (96, 128)),
                                         ("u16", (48, 64))])
def test_pack_frame_bytes_equal_jax(codec, shape):
    """pack_frame gives the JAX package's buffer byte for byte. The RGB is
    gray replicated to three channels: the JAX package converts with
    OpenCV when it is installed, the port with numpy; they agree on gray."""
    h, w = shape
    rgb, depth = _frame(h, w, 3)
    rgb = np.repeat(rgb[..., :1], 3, -1)
    cfg, jcfg = SlamConfig().override(depth_codec=codec), JSlamConfig().override(depth_codec=codec)
    ours, ref = step.pack_frame(rgb, depth, cfg), jstep.pack_frame(rgb, depth, jcfg)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    assert ours.nbytes == {"u12": 2.5, "u16h": 1.5, "u16": 3.0}[codec] * h * w


@pytest.mark.parametrize("scale,dmin,dmax", [
    (5000.0, 0.3, 10.0),
    (1000.0, 0.5, 5.0),
    (5208.33, 0.3, 10.0),  # a factory scale that is inexact in float32
    (5000.0, 0.29999998, 9.999999),
])
def test_u12_lut_equals_jax_and_the_u16_mask(scale, dmin, dmax):
    """The 65536-entry table equals the JAX package's entry for entry, and
    its validity is the u16 path's mask for every raw value."""
    lut = step._u12_lut(scale, dmin, dmax)
    np.testing.assert_array_equal(lut, jstep._u12_lut(scale, dmin, dmax))
    raws = torch.arange(65536, dtype=torch.int32)
    _, mask16 = image.inverse_depth_from_u16(raws, scale, dmin, dmax)
    np.testing.assert_array_equal(lut > 0, mask16.numpy() > 0)


def test_u12_decode_matches_jax():
    """u12 decode against the JAX package on the same buffer: gray and
    mask exact; xi is the same float32 expression ((code - 1) * step +
    xi_min) * mask in both, measured bit-equal, held within 1 ulp (XLA may
    contract the multiply-add into an FMA on some CPUs). Against the u16
    path: the same mask, xi within half a quantization step."""
    cfg = SlamConfig().override(depth_codec="u12")
    jcfg = JSlamConfig().override(depth_codec="u12")
    rgb, depth = _frame(120, 160, 3)
    packed = step.pack_frame(rgb, depth, cfg)
    g, xi, m = (t.numpy() for t in step.decode_frame(torch.from_numpy(packed), cfg))
    jg, jxi, jm = (np.asarray(t) for t in jstep.decode_frame(jnp.asarray(packed), jcfg))
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(m, jm)
    assert _ulps(xi, jxi) <= 1
    g16, xi16, m16 = (t.numpy() for t in step.decode_frame(
        torch.from_numpy(step.pack_frame(rgb, depth, None)), SlamConfig()))
    np.testing.assert_array_equal(g, g16)
    np.testing.assert_array_equal(m, m16)
    q = (1.0 / cfg.min_depth - 1.0 / cfg.max_depth) / 4094.0
    assert np.abs(xi - xi16)[m16 > 0].max() <= q / 2 + 1e-6
    assert (xi[m == 0] == 0).all()


def test_u16h_decode_matches_jax():
    """u16h decode against the JAX package: gray and mask exact; xi from
    the same float32 operations (the u16 conversion, two edge-clamped
    linear upsamples, one divide), within 1 ulp of the JAX package's
    (measured bit-equal), and bit-equal at even coordinates to the
    half-resolution xi wherever that pixel is valid."""
    cfg = SlamConfig().override(depth_codec="u16h")
    jcfg = JSlamConfig().override(depth_codec="u16h")
    rgb, depth = _frame(96, 128, 7, holes=0.2)
    packed = step.pack_frame(rgb, depth, cfg)
    assert packed.shape == (96 + 48, 128)
    g, xi, m = (t.numpy() for t in step.decode_frame(torch.from_numpy(packed), cfg))
    jg, jxi, jm = (np.asarray(t) for t in jstep.decode_frame(jnp.asarray(packed), jcfg))
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(m, jm)
    assert _ulps(xi, jxi) <= 1
    xi_h, m_h = image.inverse_depth_from_u16(
        torch.from_numpy(np.ascontiguousarray(depth[::2, ::2]).astype(np.int32)),
        cfg.depth_scale, cfg.min_depth, cfg.max_depth)
    valid = m_h.numpy() > 0
    np.testing.assert_array_equal(xi[::2, ::2][valid], xi_h.numpy()[valid])
    np.testing.assert_array_equal(g, step.pack_frame(rgb, depth, None)[0])


@pytest.mark.parametrize("shape", [(24, 32), (7, 5), (1, 6)])
def test_upsample2x_renorm_matches_jax(shape):
    """upsample2x_renorm on sparse-valid fields (odd sizes and one row
    included): mask exact, values within 1 ulp of the JAX package's
    (measured bit-equal), even coordinates bit-equal to the input where it
    is valid."""
    rng = np.random.default_rng(sum(shape))
    xi = rng.uniform(0.1, 3.0, shape).astype(np.float32)
    mask = (rng.random(shape) > 0.3).astype(np.float32)
    xi *= mask
    out, om = (t.numpy() for t in image.upsample2x_renorm(torch.from_numpy(xi),
                                                            torch.from_numpy(mask)))
    jout, jom = (np.asarray(t) for t in jimage.upsample2x_renorm(jnp.asarray(xi),
                                                                   jnp.asarray(mask)))
    assert out.shape == (2 * shape[0], 2 * shape[1])
    np.testing.assert_array_equal(om, jom)
    assert _ulps(out, jout) <= 1
    np.testing.assert_array_equal(out[::2, ::2][mask > 0], xi[mask > 0])


def test_decode_frame_rejects_codec_mismatch():
    """A buffer packed with another codec raises ValueError naming the
    codec, as the JAX package's decode does, with the same message."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (16, 32, 3), np.uint8)
    depth = rng.integers(2000, 25000, (16, 32), np.uint16)
    cfgs = {c: SlamConfig().override(depth_codec=c) for c in ("u16", "u12", "u16h")}
    jcfgs = {c: JSlamConfig().override(depth_codec=c) for c in ("u16", "u12", "u16h")}
    for packed_with, decode_with in [("u16", "u12"), ("u12", "u16"), ("u16", "u16h"),
                                     ("u16h", "u16")]:
        packed = step.pack_frame(rgb, depth, cfgs[packed_with])
        with pytest.raises(ValueError, match=decode_with) as ours:
            step.decode_frame(torch.from_numpy(packed), cfgs[decode_with])
        with pytest.raises(ValueError) as ref:
            jstep.decode_frame(jnp.asarray(packed), jcfgs[decode_with])
        # The same text up to the hint that follows it (the port's u16 hint
        # names u16h too).
        assert str(ours.value).split(". (A")[0] == str(ref.value).split(". (A")[0]


def _packed_run(codec: str, packed_as):
    """Six frames of the smoke's scene at 96x72 through a fresh system, the
    upload prepared by ``pack_frame`` ahead of time (``packed_as`` "numpy"
    or "tensor", alternating with none) or not at all (None)."""
    import chip_smoke
    import rgbid_tpu_torch as port

    intr = port.Intrinsics(fx=90.0, fy=90.0, cx=47.5, cy=35.5, width=96, height=72)
    frames, _ = chip_smoke.make_sequence(intr, n=6)
    cfg = SlamConfig().override(**{"depth_codec": codec, "backend.enabled": False,
                                   "tracking.levels": 3, "tracking.iters": (4, 8, 12)})
    slam = port.SlamSystem(intr, cfg, device="cpu")
    poses = []
    for i, (rgb, depth, t) in enumerate(frames):
        packed = None
        if packed_as is not None and i % 3 != 2:
            packed = step.pack_frame(rgb, depth, cfg)
            if packed_as == "tensor":
                packed = torch.from_numpy(packed)
        poses.append(slam.process_frame(rgb, depth, t, packed=packed))
    recs = [{k: v for k, v in r.items() if k != "ms"} for r in slam.stats]
    return poses, recs, slam


@pytest.mark.parametrize("codec", ["u16", "u12"])
def test_process_frame_takes_packed_upload(codec):
    """``process_frame(..., packed=pack_frame(...))`` (the JAX package's
    signature), as numpy or as a tensor already on the system's device,
    gives the poses and per-frame records of the run without it, bit for
    bit (the same bytes reach the same step)."""
    poses, recs, _ = _packed_run(codec, None)
    for packed_as in ("numpy", "tensor"):
        p2, r2, _ = _packed_run(codec, packed_as)
        for a, b in zip(poses, p2):
            np.testing.assert_array_equal(a, b)
        assert r2 == recs
    assert any(r.get("n_fused", 0) > 0 for r in recs)


def test_process_frame_refuses_packed_of_another_codec():
    """A packed buffer of another codec raises ``decode_frame``'s ValueError
    before any state changes; so do a non-uint8 buffer and a tensor on
    another device or of another type."""
    _, _, slam = _packed_run("u16", None)
    rgb, depth = _frame(72, 96, 5)
    before = (slam._frame_count, len(slam.stats), slam._kf_state, slam._motion,
              len(slam._trajectory))
    u12 = step.pack_frame(rgb, depth, SlamConfig().override(depth_codec="u12"))
    with pytest.raises(ValueError, match="depth_codec='u16' expects"):
        slam.process_frame(rgb, depth, 9.0, packed=u12)
    good = step.pack_frame(rgb, depth, SlamConfig())
    for bad in (good.astype(np.int16), torch.from_numpy(good).to(torch.int16),
                torch.from_numpy(good).to("meta")):
        with pytest.raises(ValueError, match="packed must be"):
            slam.process_frame(rgb, depth, 9.0, packed=bad)
    after = (slam._frame_count, len(slam.stats), slam._kf_state, slam._motion,
             len(slam._trajectory))
    assert all(a is b or a == b for a, b in zip(before, after))
