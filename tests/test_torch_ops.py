"""rgbid_tpu_torch building blocks against the JAX package, on the CPU.

Every input is made with numpy from a seed and handed to both packages;
outputs come back as numpy. Tolerances are stated where they are used.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbid_tpu.core import se3 as jse3
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.config import FusionConfig as JFusionConfig
from rgbid_tpu.mapping.keyframe import create_device_keyframe as j_create_kf
from rgbid_tpu.ops import image as jimage
from rgbid_tpu.ops import warp as jwarp
from rgbid_tpu.tracking.frames import preprocess_planes as j_preprocess
from rgbid_tpu_torch.core import se3 as tse3
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import FusionConfig
from rgbid_tpu_torch.mapping.keyframe import create_device_keyframe as t_create_kf
from rgbid_tpu_torch.ops import image as timage
from rgbid_tpu_torch.ops import warp as twarp
from rgbid_tpu_torch.tracking.frames import preprocess_planes as t_preprocess

torch.set_num_threads(2)

H, W = 48, 64
INTR = Intrinsics(fx=60.0, fy=61.0, cx=31.3, cy=23.6, width=W, height=H)
JINTR = JIntrinsics(*INTR)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _planes(seed=0, h=H, w=W):
    """Smooth intensity in [0, 1] and a u16 depth with invalid holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    inten = 0.5 + 0.3 * np.sin(xx / 5.0) * np.cos(yy / 7.0) + 0.05 * rng.standard_normal((h, w))
    inten = np.clip(inten, 0, 1).astype(np.float32)
    depth_m = 1.5 + 0.5 * np.sin(xx / 11.0) + 0.3 * np.cos(yy / 9.0)
    d16 = np.round(depth_m * 5000).astype(np.uint16)
    d16[rng.random((h, w)) < 0.1] = 0  # dropout
    d16[5:12, 20:30] = 0  # a hole
    return inten, d16


def _twists(seed=1):
    rng = np.random.default_rng(seed)
    tw = [rng.normal(0, s, 6) for s in (0.3, 0.05, 1.0)]
    tw.append(np.array([0.1, -0.2, 0.05, 1e-5, -2e-5, 1e-5]))  # small-angle branch
    tw.append(np.zeros(6))
    return [t.astype(np.float32) for t in tw]


@pytest.mark.parametrize("k", range(5))
def test_se3_matches_jax(k):
    """exp/log/inv/orthonormalize/rotation_angle. Tolerance 2e-6: float32
    rounding in a different operation order (both compute in f32)."""
    d = _twists()[k]
    Tj = np.asarray(jse3.exp(jnp.asarray(d)))
    Tt = _np(tse3.exp(_t(d)))
    np.testing.assert_allclose(Tt, Tj, atol=2e-6)
    np.testing.assert_allclose(
        _np(tse3.log(_t(Tj))), np.asarray(jse3.log(jnp.asarray(Tj))), atol=2e-5
    )
    np.testing.assert_allclose(
        _np(tse3.inv(_t(Tj))), np.asarray(jse3.inv(jnp.asarray(Tj))), atol=2e-6
    )
    noisy = (Tj + np.float32(1e-3) * np.eye(4, dtype=np.float32)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tse3.orthonormalize(_t(noisy))),
        np.asarray(jse3.orthonormalize(jnp.asarray(noisy))),
        atol=2e-6,
    )
    np.testing.assert_allclose(
        float(tse3.rotation_angle(_t(Tj[:3, :3]))),
        float(jse3.rotation_angle(jnp.asarray(Tj[:3, :3]))),
        atol=2e-4,  # arccos near 0 amplifies f32 trace rounding
    )


def test_inverse_depth_and_pyramids_match_jax():
    """Sensor conversion exact; pyramid values within 1e-6 (5-tap sums in a
    different order), masks exact."""
    inten, d16 = _planes()
    xj, mj = jimage.inverse_depth_from_u16(jnp.asarray(d16), 5000.0, 0.3, 10.0)
    xt, mt = timage.inverse_depth_from_u16(torch.from_numpy(d16.astype(np.int32)), 5000.0, 0.3, 10.0)
    np.testing.assert_array_equal(_np(xt), np.asarray(xj))
    np.testing.assert_array_equal(_np(mt), np.asarray(mj))

    ij = jimage.build_pyramid_unmasked(jnp.asarray(inten), 4)
    it = timage.build_pyramid_unmasked(_t(inten), 4)
    xpj, mpj = jimage.build_pyramid(xj, mj, 4)
    xpt, mpt = timage.build_pyramid(xt, mt, 4)
    for l in range(4):
        np.testing.assert_allclose(_np(it[l]), np.asarray(ij[l]), atol=1e-6)
        np.testing.assert_allclose(_np(xpt[l]), np.asarray(xpj[l]), atol=1e-6)
        np.testing.assert_array_equal(_np(mpt[l]), np.asarray(mpj[l]))


def test_gradients_match_jax():
    """Central differences: the same two roundings in both (exact)."""
    inten, d16 = _planes(3)
    xj, mj = jimage.inverse_depth_from_u16(jnp.asarray(d16))
    gj = jimage.gradients(xj, mj)
    gt = timage.gradients(_t((xj)), _t((mj)))
    uj = jimage.gradients_unmasked(jnp.asarray(inten))
    ut = timage.gradients_unmasked(_t(inten))
    for a, b in zip(gt + ut, gj + uj):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_warp_and_sampling_match_jax_at_edges():
    """Backprojection/projection within f32 rounding (1e-5 relative);
    sampling at coordinates on and around the [0, w - 1.001] clip: the
    in-bounds flag and the all-corner mask product exact, the blend within
    1e-6."""
    rng = np.random.default_rng(7)
    inten, d16 = _planes(5)
    xi, mask = (np.asarray(a) for a in jimage.inverse_depth_from_u16(jnp.asarray(d16)))
    bj = jwarp.backproject_grid(jnp.asarray(xi), JINTR)
    bt = twarp.backproject_grid(_t(xi), INTR)
    for a, b in zip(bt, bj):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5)
    T = np.asarray(jse3.exp(jnp.asarray(np.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.005], np.float32))))
    pj = jwarp.transform_project(*bj, jnp.asarray(T), JINTR)
    pt = twarp.transform_project(*(_t(p) for p in bj), _t(T), INTR)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-4)

    # (u, v, in bounds): on the clip, just past it, and the last pixel.
    edges = [(0.0, 0.0, 1), (-1e-4, 5.0, 0), (W - 1.001, H - 1.001, 1), (W - 1.0005, 5.0, 0),
             (W - 1.0, 5.0, 0), (W - 1.002, H - 1.002, 1), (W + 3.0, 5.0, 0), (5.0, -0.5, 0)]
    u = np.concatenate([[e[0] for e in edges], rng.uniform(-2, W + 1, 200)]).astype(np.float32)
    v = np.concatenate([[e[1] for e in edges], rng.uniform(-2, H + 1, 200)]).astype(np.float32)
    stack = np.stack([inten, xi, mask, inten * 2, xi * 3, inten - 0.5, xi + 1]).astype(np.float32)
    blend_j, ok_j, inb_j = jwarp.sample_stack7(jnp.asarray(stack), jnp.asarray(u), jnp.asarray(v))
    blend_t, ok_t, inb_t = twarp.sample_stack7(_t(stack), _t(u), _t(v))
    np.testing.assert_array_equal(_np(inb_t), np.asarray(inb_j))
    np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
    np.testing.assert_allclose(_np(blend_t), np.asarray(blend_j), atol=1e-6)
    assert _np(inb_t)[: len(edges)].tolist() == [e[2] for e in edges]


@pytest.mark.parametrize("geo_min", [0, 2])
def test_preprocess_planes_matches_jax(geo_min):
    """The production layout: 3 planes at L0 (esm_min_level=1), 7 planes
    above (5 at L1 when esm_geo_min_level=2). Tolerance 1e-6 (blur sums)."""
    inten, d16 = _planes(11)
    xj, mj = jimage.inverse_depth_from_u16(jnp.asarray(d16))
    pj = j_preprocess(jnp.asarray(inten), xj, mj, 4, True, 1, esm_geo_min_level=geo_min)
    pt = t_preprocess(_t(inten), _t((xj)),
                      _t((mj)), 4, True, 1, geo_min)
    chans = [3, 5 if geo_min == 2 else 7, 7, 7]
    for l in range(4):
        assert tuple(pt[l].stack7.shape) == (chans[l],) + tuple(pj[l].xi.shape)
        np.testing.assert_allclose(_np(pt[l].stack7), np.asarray(pj[l].stack7), atol=1e-6)
        np.testing.assert_array_equal(_np(pt[l].mask), np.asarray(pj[l].mask))


@pytest.mark.parametrize("jac_dtype", ["f32", "bf16"])
def test_create_device_keyframe_matches_jax(jac_dtype):
    """Template levels, variance, hits and masks. Gradient planes within
    1e-6 at f32; at bf16 within one bf16 step (at most 2^-7 relative) as an
    input differing in its last f32 bit can round to the neighbouring
    bf16 value."""
    inten, d16 = _planes(13)
    xj, mj = jimage.inverse_depth_from_u16(jnp.asarray(d16))
    pj = j_preprocess(jnp.asarray(inten), xj, mj, 4, True, 1)
    pt = t_preprocess(_t(inten), _t((xj)),
                      _t((mj)), 4, True, 1, 0)
    jd = jnp.bfloat16 if jac_dtype == "bf16" else jnp.float32
    kj = j_create_kf(pj, JINTR, JFusionConfig(), jd, "esm")
    kt = t_create_kf(pt, INTR, FusionConfig(), jac_dtype, "esm")
    for lj, lt in zip(kj.levels, kt.levels):
        np.testing.assert_allclose(_np(lt.intensity), np.asarray(lj.intensity), atol=1e-6)
        np.testing.assert_array_equal(_np(lt.mask), np.asarray(lj.mask))
        jac_j = np.asarray(lj.jac.astype(jnp.float32))
        if jac_dtype == "bf16":
            np.testing.assert_allclose(_np(lt.jac), jac_j, rtol=2**-7, atol=1e-6)
        else:
            np.testing.assert_allclose(_np(lt.jac), jac_j, atol=1e-6)
    np.testing.assert_array_equal(_np(kt.var), np.asarray(kj.var))
    np.testing.assert_array_equal(_np(kt.hits), np.asarray(kj.hits))
    np.testing.assert_array_equal(_np(kt.mask_full), np.asarray(kj.mask_full))
    assert kt.fused_count == int(kj.fused_count) == 0
