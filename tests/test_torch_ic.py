"""The port's inverse-compositional (IC) tracking path against the JAX package.

Covers the IC template Jacobians, the Student-t scale, the two IC kernels'
plain versions (against the JAX package's XLA function and its Pallas
kernels in interpret mode), ``ic_irls_step`` (one iteration with the
damped solve and pose update) against the Pallas chain followed by the JAX
package's ``ic_update``, the IC keyframe, the tracker, the per-frame
step and SlamSystem, the standalone odometry API
(``preprocess_frame`` / ``keyframe_pyramid`` / ``Tracker``), and the
chip_smoke scene tracked on the CPU under IC (which fixes the IC ATE bound
chip_smoke holds the card to). Inputs are rendered by the JAX package's
synthetic renderer from seeds and handed to both packages as numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import rgbid_tpu_torch as port
from rgbid_tpu.core import se3 as jse3
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.camera import level_intrinsics
from rgbid_tpu.core.config import FusionConfig as JFusionConfig
from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.core.config import TrackingConfig as JTrackingConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.mapping import keyframe as jkeyframe
from rgbid_tpu.ops import gauss_newton as jgn
from rgbid_tpu.ops import image as jimage
from rgbid_tpu.ops import pallas_kernels as jpk
from rgbid_tpu.ops import warp as jwarp
from rgbid_tpu.system import SlamSystem as JSlamSystem
from rgbid_tpu.tracking import Tracker as JTracker
from rgbid_tpu.tracking import keyframe_pyramid as j_keyframe_pyramid
from rgbid_tpu.tracking import preprocess_frame as j_preprocess_frame
from rgbid_tpu.tracking.frames import preprocess_planes as j_preprocess
from rgbid_tpu.tracking.step import ProcessFrame as JProcessFrame
from rgbid_tpu.tracking.step import StepResult as JStepResult
from rgbid_tpu.tracking.step import decode_frame as j_decode
from rgbid_tpu.tracking.step import pack_frame as j_pack
from rgbid_tpu.tracking.tracker import _track_impl
from rgbid_tpu_torch import convert
from rgbid_tpu_torch import tracking as ttracking
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import FusionConfig, TrackingConfig
from rgbid_tpu_torch.mapping import keyframe as tkeyframe
from rgbid_tpu_torch.ops import gauss_newton as tgn
from rgbid_tpu_torch.ops import kernels
from rgbid_tpu_torch.tracking.step import StepResult, frame_pyramid
from rgbid_tpu_torch.tracking.tracker import track as t_track

torch.set_num_threads(2)

SMALL = JIntrinsics(fx=103.4, fy=103.3, cx=63.7, cy=47.7, width=128, height=96)
ODD = JIntrinsics(fx=103.4, fy=103.3, cx=64.1, cy=48.3, width=129, height=97)
QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
IC = {"tracking.jacobian": "ic", "backend.enabled": False}
DAMPING = JTrackingConfig().damping


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _gray3(rgb):
    """Gray replicated to 3 channels: both packages then see the same luma
    (the port converts with numpy, the JAX package with OpenCV when present)."""
    return np.repeat(rgb.mean(-1, keepdims=True).astype(np.uint8), 3, -1)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(0)


def _pair(scene, intr):
    """IC keyframe (bf16 field) of one frame and the pyramid of a frame 2
    orbit steps later, with the relative ground-truth pose."""
    T1 = synthetic.orbit_trajectory(40, trans_amp=0.25, rot_amp=0.06)[2]
    f0 = synthetic.render_frame(scene, intr, np.eye(4))
    f1 = synthetic.render_frame(scene, intr, T1)
    pyr0 = j_preprocess_frame(jnp.asarray(f0[0]), jnp.asarray(f0[1]), 3)
    pyr1 = j_preprocess_frame(jnp.asarray(f1[0]), jnp.asarray(f1[1]), 3)
    kf = jkeyframe.create_device_keyframe(pyr0, intr, JFusionConfig(), jnp.bfloat16, "ic")
    return kf, pyr1, np.linalg.inv(T1).astype(np.float32)


@pytest.fixture(scope="module")
def pairs(scene):
    return {"small": _pair(scene, SMALL), "odd": _pair(scene, ODD)}


@pytest.fixture(scope="module")
def pallas_refs():
    """Pallas chain results (interpret mode) by case label, shared by the
    tests of this module that hold the port to them."""
    return {}


def _inputs(pair, intr, level, stride):
    """One level's template (strided, with stride-scaled backprojection)
    and current planes, as the tracker hands them to the kernels."""
    kf, cur, T = pair
    kl, cl = kf.levels[level], cur[level]
    il = level_intrinsics(intr, level)
    s = stride
    bp = il if s == 1 else JIntrinsics(il.fx / s, il.fy / s, il.cx / s, il.cy / s,
                                       kl.xi[::s, ::s].shape[1], kl.xi[::s, ::s].shape[0])
    pts = jwarp.backproject_grid(kl.xi[::s, ::s], bp)
    jac = kl.jac[:, ::s, ::s].astype(jnp.float32)
    return (T, kl.intensity[::s, ::s], pts, kl.mask[::s, ::s], jac, cl.intensity, cl.xi,
            cl.mask, il)


def _within(out, ref, tol, what=""):
    """|out - ref| <= tol everywhere (tol broadcasts)."""
    excess = np.abs(out - ref) - tol
    assert (excess <= 0).all(), f"{what} max excess {excess.max():.3e}"


def _bf16_step(out, ref):
    """One bfloat16 step at the larger magnitude of each pair."""
    m = np.maximum(np.abs(out), np.abs(ref))
    return np.exp2(np.floor(np.log2(np.maximum(m, 1e-30))) - 7)


def _to_torch(T, kf_int, pts, kf_mask, jac, ci, cx, cm, il):
    return (_t(T), _t(kf_int), tuple(_t(p) for p in pts), _t(kf_mask), _t(jac), _t(ci), _t(cx),
            _t(cm), Intrinsics(*il))


# ---------------------------------------------------------------------------
# Ops


@pytest.mark.parametrize("jac_dtype", ["f32", "bf16"])
def test_template_jacobians_match_jax(scene, jac_dtype):
    """The (12, H, W) field of every level of a VGA/5 keyframe. f32: within
    1e-5 of the plane's largest entry (backprojection in another operation
    order, measured ~1e-7). bf16: within one bfloat16 step (2^-8 to 2^-7 of
    the value), as a 1-ulp float32 difference before the cast can round to
    the neighbouring bfloat16 value."""
    f0 = synthetic.render_frame(scene, SMALL, np.eye(4))
    pyr = j_preprocess_frame(jnp.asarray(f0[0]), jnp.asarray(f0[1]), 3)
    jd = jnp.bfloat16 if jac_dtype == "bf16" else jnp.float32
    for l, lev in enumerate(pyr):
        il = level_intrinsics(SMALL, l)
        gx_i, gy_i = map(np.asarray, jimage.gradients_unmasked(lev.intensity))
        gx_x, gy_x = map(np.asarray, jimage.gradients(lev.xi, lev.mask))
        ref = np.asarray(jgn.template_jacobians(gx_i, gy_i, gx_x, gy_x, lev.xi, lev.mask, il, jd)
                         .astype(jnp.float32))
        out = tgn.template_jacobians(_t(gx_i), _t(gy_i), _t(gx_x), _t(gy_x), _t(lev.xi),
                                     _t(lev.mask), Intrinsics(*il), jac_dtype).numpy()
        assert out.shape == ref.shape == (12,) + lev.xi.shape
        scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
        if jac_dtype == "bf16":
            _within(out, ref, _bf16_step(out, ref) + 1e-6 * scale.max(), f"level {l}")
        else:
            _within(out, ref, 1e-5 * scale, f"level {l}")


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_student_t_sigma2_matches_jax(iters):
    """Masked fixed point from numpy residuals: within 1e-5 relative
    (sums over 5000 values in another order)."""
    rng = np.random.default_rng(iters)
    r2 = (rng.standard_normal(5000) * 0.05) ** 2
    valid = (rng.random(5000) < 0.8).astype(np.float32)
    r2 = (r2 * valid).astype(np.float32)
    ref = float(jgn.student_t_sigma2(jnp.asarray(r2), jnp.asarray(valid), 5.0, jnp.float32(0.01), iters))
    out = float(tgn.student_t_sigma2(_t(r2), _t(valid), 5.0, 0.01, iters))
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def _check(res, ref, what, inl_tol):
    """H and b to 2e-4 of each entry plus 1e-5 of the largest entry (sums
    over ~1e4 pixels in another order); n_valid exact (the same per-pixel
    f32 sequence); error and the scales to 1e-4 relative; the inlier
    fraction to ``inl_tol``."""
    H, Hr = res.H.numpy(), np.asarray(ref.H)
    b, br = res.b.numpy(), np.asarray(ref.b)
    np.testing.assert_allclose(H, Hr, rtol=2e-4, atol=1e-5 * np.abs(Hr).max(), err_msg=what)
    np.testing.assert_allclose(b, br, rtol=2e-4, atol=1e-5 * np.abs(br).max(), err_msg=what)
    assert float(res.n_valid) == float(ref.n_valid), what
    for f in ("error", "sigma2_int", "sigma2_xi"):
        np.testing.assert_allclose(float(getattr(res, f)), float(getattr(ref, f)), rtol=1e-4,
                                   err_msg=f"{what} {f}")
    assert abs(float(res.inlier_frac) - float(ref.inlier_frac)) <= inl_tol, what


# (label, pair, intrinsics, level, template stride, use_geometric, sigma_mode, sigma_iters)
CASES = [
    ("L0 stride2 lagged", "small", SMALL, 0, 2, True, "lagged", 1),
    ("L0 stride2 exact x1", "small", SMALL, 0, 2, True, "exact", 1),
    ("L1 exact x2", "small", SMALL, 1, 1, True, "exact", 2),
    ("L1 exact x3", "small", SMALL, 1, 1, True, "exact", 3),
    ("L1 geo-off lagged", "small", SMALL, 1, 1, False, "lagged", 1),
    ("L2 geo-off exact x2", "small", SMALL, 2, 1, False, "exact", 2),
    ("odd L0 stride2 exact x1", "odd", ODD, 0, 2, True, "exact", 1),
    ("odd L1 lagged", "odd", ODD, 1, 1, True, "lagged", 1),
]


def _case(pairs, case, pallas_refs):
    """The case's JAX arguments, its Pallas chain result and the port's
    arguments (CPU tensors)."""
    label, key, intr, level, stride, geo, mode, iters = case
    args = _inputs(pairs[key], intr, level, stride)
    s2i, s2x = np.float32(0.01), np.float32(0.0025)
    jargs = (jnp.asarray(args[0]),) + args[1:] + (5.0, jnp.asarray(s2i), jnp.asarray(s2x), iters,
                                                   geo, 3.0, mode)
    if label not in pallas_refs:
        pallas_refs[label] = jpk.residuals_and_normal_eq_pallas(*jargs)
    targs = _to_torch(*args) + (5.0, torch.tensor(s2i), torch.tensor(s2x), iters, geo, 3.0, mode)
    return jargs, pallas_refs[label], targs


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_residuals_and_normal_eq_matches_pallas_and_xla(pairs, pallas_refs, case):
    """The IC wrapper on CPU tensors (the plain version) against both JAX
    twins. The plain version follows the Pallas kernels' form, so against
    them the inlier fraction agrees to 1e-6; against the XLA function in
    exact mode, whose scale comes out of another reduction order, a pixel
    may sit on the inlier gate, so it agrees to within 2 pixels."""
    label, key, intr, level, stride, geo, mode, iters = case
    jargs, ref_pallas, targs = _case(pairs, case, pallas_refs)
    ref_xla = jgn.residuals_and_normal_eq(*jargs)
    res = kernels.residuals_and_normal_eq(*targs)
    n = float(res.n_valid)
    assert n > 300
    _check(res, ref_pallas, f"{label} vs pallas", 1e-6)
    _check(res, ref_xla, f"{label} vs xla", 2.0 / n if mode == "exact" else 1e-6)
    if not geo:  # a disabled channel keeps its incoming scale
        assert float(res.sigma2_xi) == float(targs[11])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ic_irls_step_matches_jax(pairs, pallas_refs, case):
    """One IC IRLS iteration, ``ic_irls_step`` on CPU tensors in the case's
    sigma mode, against the Pallas chain followed by the JAX package's
    ``ic_update``: the evaluation as above; the pose and the step within
    1e-6 (a 6x6 f32 solve in another order, from sums taken in another
    order)."""
    label = case[0]
    jargs, ref, targs = _case(pairs, case, pallas_refs)
    Tj, dj = jgn.ic_update(jargs[0], ref.H, ref.b, DAMPING, ref.n_valid)
    step = kernels.ic_irls_step(*targs, damping=DAMPING)
    _check(step.result, ref, f"{label} step vs pallas", 1e-6)
    np.testing.assert_allclose(step.delta.numpy(), np.asarray(dj), atol=1e-6, err_msg=label)
    np.testing.assert_allclose(step.T.numpy(), np.asarray(Tj), atol=1e-6, err_msg=label)
    assert np.abs(step.delta.numpy()).max() > 1e-4  # a real step was taken
    # The CPU step is the plain evaluation followed by ic_update, exactly.
    T_plain, d_plain = tgn.ic_update(targs[0], step.result.H, step.result.b, DAMPING,
                                     step.result.n_valid)
    assert torch.equal(step.T, T_plain) and torch.equal(step.delta, d_plain)


@pytest.mark.parametrize("geo", [True, False])
def test_ic_kernels_alone_match_pallas(pairs, geo):
    """Each IC kernel's plain version alone against its Pallas kernel on
    the same planes: ``ic_sigma_stats`` against ``sigma_stats`` (sums to
    1e-5 relative, count exact) and ``ic_normal_eq`` against ``normal_eq``
    (raw sums, the same tolerances as above; counts exact), at level 0 with
    the template stride."""
    T, kf_int, pts, kf_mask, jac, ci, cx, cm, il = _inputs(pairs["small"], SMALL, 0, 2)
    s2i, s2x = np.float32(0.012), np.float32(0.003)
    up, vp, rho, front = jwarp.transform_project(*pts, jnp.asarray(T), il)
    i_s, xi_s, mask_ok, inb = jwarp.sample_tracker_planes(jnp.stack([ci, cx, cm]), up, vp)
    valid = kf_mask * front * inb * mask_ok
    sw = jpk.sigma_stats(i_s, xi_s, rho, kf_int, valid, jnp.asarray(s2i), jnp.asarray(s2x), 5.0)
    targs = _to_torch(T, kf_int, pts, kf_mask, jac, ci, cx, cm, il)
    st = kernels.ic_sigma_stats(*targs[:4], *targs[5:], 5.0, torch.tensor(s2i), torch.tensor(s2x),
                                geo)
    np.testing.assert_allclose(float(st.swi), float(sw[0]), rtol=1e-5)
    np.testing.assert_allclose(float(st.swx), float(sw[1]), rtol=1e-5)
    assert float(st.n) == float(sw[2])
    n1 = max(float(st.n), 1.0)
    np.testing.assert_allclose(float(st.sigma2_int), float(sw[0]) / n1, rtol=1e-5)
    assert float(st.sigma2_xi) == (pytest.approx(float(sw[1]) / n1, rel=1e-5) if geo else s2x)

    H, bv, err, inl, nv, swi, swx = jpk.normal_eq(
        i_s, xi_s, rho, kf_int, valid, jnp.asarray(jac), jnp.asarray(s2i), jnp.asarray(s2x), 5.0,
        3.0, geo)
    res = kernels.ic_normal_eq(*targs, 5.0, torch.tensor(s2i), torch.tensor(s2x), geo, 3.0,
                               lagged=False)
    n = float(res.n_valid)
    assert n == float(nv) > 300
    np.testing.assert_allclose(res.H.numpy() * n, np.asarray(H), rtol=2e-4,
                               atol=1e-5 * np.abs(np.asarray(H)).max())
    np.testing.assert_allclose(res.b.numpy() * n, np.asarray(bv), rtol=2e-4,
                               atol=1e-5 * np.abs(np.asarray(bv)).max())
    np.testing.assert_allclose(float(res.error) * n, float(err), rtol=1e-4)
    assert round(float(res.inlier_frac) * n) == float(inl)
    # Without lagging, the scales used come back unchanged.
    assert (float(res.sigma2_int), float(res.sigma2_xi)) == (float(s2i), float(s2x))
    # ic_result (the IC SPMD tracker's evaluation) is the lagged pass packed.
    vec = kernels.ic_result(*targs, 5.0, torch.tensor(s2i), torch.tensor(s2x), geo, 3.0)
    lagged = tgn.normal_eq_plain(*targs, 5.0, torch.tensor(s2i), torch.tensor(s2x), geo, 3.0,
                                 True)
    assert torch.equal(vec, kernels.pack_result(lagged))


# ---------------------------------------------------------------------------
# Keyframe


@pytest.mark.parametrize("jac_dtype", ["f32", "bf16"])
def test_ic_keyframe_create_and_rebuild_match_jax(scene, jac_dtype):
    """IC create_device_keyframe, then rebuild_after_fusion from a perturbed
    fused depth (level 0 and the coarse levels rebuilt): masks, hits and
    counts exact; planes within 1e-6; the field within 1e-5 of its largest
    entry, plus one bfloat16 step at bf16 (see the field test)."""
    f0 = synthetic.render_frame(scene, SMALL, np.eye(4))
    pyr = j_preprocess_frame(jnp.asarray(f0[0]), jnp.asarray(f0[1]), 3)
    jd = jnp.bfloat16 if jac_dtype == "bf16" else jnp.float32
    fcfg = JFusionConfig()
    kj = jkeyframe.create_device_keyframe(pyr, SMALL, fcfg, jd, "ic")
    tpyr = ttracking.preprocess_frame(torch.from_numpy(f0[0]), torch.from_numpy(f0[1].astype(np.int32)), 3)
    kt = tkeyframe.create_device_keyframe(tpyr, Intrinsics(*SMALL), FusionConfig(), jac_dtype, "ic")

    def same(lt, lj):
        for a, b in zip(lt, lj):
            assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(lt.intensity.numpy(), np.asarray(lj.intensity), atol=1e-6)
        np.testing.assert_allclose(lt.xi.numpy(), np.asarray(lj.xi), atol=1e-6)
        np.testing.assert_array_equal(lt.mask.numpy(), np.asarray(lj.mask))
        ref = np.asarray(lj.jac.astype(jnp.float32))
        out = lt.jac.numpy()
        tol = (_bf16_step(out, ref) if jac_dtype == "bf16" else 0.0) + 1e-5 * np.abs(ref).max()
        _within(out, ref, tol)

    for lt, lj in zip(kt.levels, kj.levels):
        assert tuple(lt.jac.shape) == (12,) + tuple(lj.xi.shape)
        same(lt, lj)
    np.testing.assert_array_equal(kt.var.numpy(), np.asarray(kj.var))
    np.testing.assert_array_equal(kt.hits.numpy(), np.asarray(kj.hits))

    rng = np.random.default_rng(6)
    xi0 = np.asarray(kj.levels[0].xi) * np.float32(1.02)
    var0 = np.asarray(kj.var) * np.float32(0.5)
    mask0 = np.asarray(kj.mask_full)
    hits = np.asarray(kj.hits) + (rng.random(mask0.shape) < 0.3).astype(np.float32)
    hits[::7] = 1.0  # some unconfirmed pixels leave the template mask
    rj = jkeyframe.rebuild_after_fusion(kj, jnp.asarray(xi0), jnp.asarray(var0), jnp.asarray(mask0),
                                        SMALL, jd, "ic", 1, hits=jnp.asarray(hits),
                                        confirm_hits=fcfg.confirm_hits)
    rt = tkeyframe.rebuild_after_fusion(kt, _t(xi0), _t(var0), _t(mask0), _t(hits),
                                        Intrinsics(*SMALL), jac_dtype, "ic", 1,
                                        confirm_hits=fcfg.confirm_hits)
    assert rt.fused_count == int(rj.fused_count) == 1
    for lt, lj in zip(rt.levels, rj.levels):
        same(lt, lj)
    assert float(rt.levels[0].mask.sum()) < float(mask0.sum())


# ---------------------------------------------------------------------------
# Tracker, step and system


@pytest.fixture(scope="module")
def qvga_frames():
    """11 QVGA frames on a smooth orbit: the systems run the first 10 (fused
    frames and a switch); the 11th is the injected-state step."""
    scene = synthetic.make_scene(2)
    rng = np.random.default_rng(9)
    poses = synthetic.orbit_trajectory(40, trans_amp=0.3, rot_amp=0.08)[:11]
    frames = []
    for i, T in enumerate(poses):
        rgb, d16, _, _ = synthetic.render_frame(scene, QVGA, T, xi_noise_sigma=0.003, rng=rng)
        frames.append((_gray3(rgb), d16, i / 30.0))
    return frames, poses


@pytest.mark.parametrize("mode", ["lagged", "exact"])
def test_tracker_ic_matches_jax(qvga_frames, mode):
    """The JAX package's IC keyframe carried into the port by
    rgbid_tpu_torch.convert (12-plane bf16 leaves become exact float32) and
    the same packed frame: the final pose agrees to 1e-5 m / 1e-5 rad, as
    the ESM tracker test's (f32 sums in another order over 40 iterations)."""
    frames, _ = qvga_frames
    jcfg = JSlamConfig().override(**IC, **{"tracking.sigma_mode": mode})
    tcfg = jcfg.tracking
    kf = JProcessFrame(QVGA, jcfg).init_keyframe(jnp.asarray(j_pack(*frames[0][:2], jcfg)))
    packed3 = j_pack(*frames[3][:2], jcfg)
    gray, xi, mask = j_decode(jnp.asarray(packed3), jcfg)
    cur = j_preprocess(gray.astype(jnp.float32) / 255.0, xi, mask, tcfg.levels, False)
    intrs = tuple(level_intrinsics(QVGA, l) for l in range(tcfg.levels))
    T_init = np.array(jse3.exp(jnp.asarray(np.array([0.01, 0, 0.01, 0, 0.01, 0], np.float32))))
    ref = jax.jit(functools.partial(_track_impl, intrs=intrs, cfg=tcfg))(
        kf.levels, cur, jnp.asarray(T_init)
    )

    kf_np = jax.tree_util.tree_map(np.asarray, kf)
    tkf = convert.keyframe_from_reference(kf_np, "cpu")
    back = convert.keyframe_to_numpy(tkf)
    for lr, lb in zip(kf_np.levels, back.levels):
        assert lr.jac.dtype == jnp.bfloat16 and lb[3].shape[0] == 12
        np.testing.assert_array_equal(lb[3], np.asarray(lr.jac, np.float32))
    pcfg = port.SlamConfig().override(**IC, **{"tracking.sigma_mode": mode})
    tcur = frame_pyramid(torch.from_numpy(packed3), pcfg)
    assert all(l.stack7 is None for l in tcur)
    out = t_track(tkf.levels, tcur, torch.from_numpy(T_init),
                  tuple(Intrinsics(*i) for i in intrs), pcfg.tracking, pcfg.tracking.jac_dtype)
    D = np.linalg.inv(np.asarray(ref.T, np.float64)) @ out.T.numpy().astype(np.float64)
    assert np.linalg.norm(D[:3, 3]) < 1e-5
    assert np.linalg.norm(jse3.log(jnp.asarray(D, jnp.float32))[3:]) < 1e-5
    np.testing.assert_allclose(out.n_valid.numpy(), np.asarray(ref.n_valid), rtol=1e-5)
    np.testing.assert_allclose(float(out.overlap), float(ref.overlap), rtol=1e-5)
    np.testing.assert_allclose(float(out.sigma2_int), float(ref.sigma2_int), rtol=1e-3)
    assert float(np.linalg.norm(np.asarray(ref.T)[:3, 3])) > 0.02  # it really moved


@pytest.fixture(scope="module")
def both_systems(qvga_frames):
    frames, _ = qvga_frames
    js = JSlamSystem(QVGA, JSlamConfig().override(**IC))
    jposes = [js.process_frame(*f) for f in frames[:10]]
    ps = port.SlamSystem(Intrinsics(*QVGA), port.SlamConfig().override(**IC), device="cpu")
    pposes = [ps.process_frame(*f) for f in frames[:10]]
    return js, jposes, ps, pposes


def test_system_ic_matches_jax_per_frame(both_systems):
    """SlamSystem in IC lagged mode (consensus left at its default, which
    IC ignores) at QVGA over 10 frames: identical switch/lost flags and
    n_fused, per-frame world poses within 1e-4 m / 1e-4 rad (the ESM
    system test's bound)."""
    js, jposes, ps, pposes = both_systems
    assert ps.config.tracking.consensus and ps.config.tracking.sigma_mode == "lagged"
    for i, (a, b) in enumerate(zip(jposes, pposes)):
        sj, sp = js.stats[i], ps.stats[i]
        assert sj.get("switch") == sp.get("switch"), i
        assert sj.get("lost") == sp.get("lost"), i
        assert sj.get("n_fused") == sp.get("n_fused"), i
        D = np.linalg.inv(a) @ b
        assert np.linalg.norm(D[:3, 3]) < 1e-4, i
        assert np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)) < 1e-4, i
    flags = [s.get("switch") for s in ps.stats[1:]]
    assert any(flags) and not all(flags)  # both branches ran
    assert any(s.get("n_fused", 0) > 0 for s in ps.stats)


def test_step_ic_with_injected_state_matches_jax(qvga_frames, both_systems):
    """The JAX system's IC keyframe and motion state after 10 frames go into
    the port and both run frame 11: flags and n_fused equal; pose,
    diagnostics and the new state within 1e-5; the rebuilt field within
    1e-5 of its largest entry plus one bfloat16 step."""
    frames, _ = qvga_frames
    js, _, ps, _ = both_systems
    packed = j_pack(*frames[10][:2], js.config)
    jvec, jkf, jm = js._step(jnp.asarray(packed), js._kf_state, js._motion)
    jres = JStepResult.unpack(np.asarray(jvec), 4)
    kf_np = jax.tree_util.tree_map(np.asarray, js._kf_state)
    tm = convert.motion_from_reference(jax.tree_util.tree_map(np.asarray, js._motion), "cpu")
    tvec, tkf, tm2 = ps._step(torch.from_numpy(packed), convert.keyframe_from_reference(kf_np, "cpu"), tm)
    tres = StepResult.unpack(tvec, 4)
    assert (tres.switch, tres.lost, tres.n_fused) == (jres.switch, jres.lost, jres.n_fused)
    np.testing.assert_allclose(tres.T, jres.T, atol=1e-5)
    np.testing.assert_allclose(tres.n_valid, jres.n_valid, rtol=1e-5)
    np.testing.assert_allclose(tres.overlap, jres.overlap, rtol=1e-5)
    np.testing.assert_allclose(tm2.T_ck.numpy(), np.asarray(jm.T_ck), atol=1e-5)
    np.testing.assert_allclose(tkf.levels[0].xi.numpy(), np.asarray(jkf.levels[0].xi), atol=1e-5)
    ref = np.asarray(jkf.levels[0].jac.astype(jnp.float32))
    out = tkf.levels[0].jac.numpy()
    _within(out, ref, _bf16_step(out, ref) + 1e-5 * np.abs(ref).max())
    assert tkf.fused_count == int(jkf.fused_count)


def test_odometry_recipe_matches_jax():
    """The standalone recipe at QVGA (preprocess_frame, keyframe_pyramid
    with its IC default, Tracker with consensus at its default): pyramids
    within 1e-6, the f32 field within 1e-5 of its largest entry, per-frame
    poses within 1e-4 m / 1e-4 rad of the JAX package's, and the ATE under
    5 mm (the JAX package's recipe gives 0.44 mm)."""
    intr = QVGA
    cfg_kw = dict(levels=3, iters=(4, 8, 16), jacobian="ic")
    seq = synthetic.generate_sequence(n_frames=12, intr=intr, motion="orbit", trans_amp=0.18,
                                      rot_amp=0.05, xi_noise_sigma=0.003)
    jtracker = JTracker(intr, JTrackingConfig(**cfg_kw))
    ttracker = ttracking.Tracker(Intrinsics(*intr), TrackingConfig(**cfg_kw))

    def tpre(i):
        return ttracking.preprocess_frame(torch.from_numpy(seq.rgb[i]),
                                          torch.from_numpy(seq.depth[i].astype(np.int32)), 3)

    jpyr0 = j_preprocess_frame(jnp.asarray(seq.rgb[0]), jnp.asarray(seq.depth[0]), 3)
    tpyr0 = tpre(0)
    jkf, tkf = j_keyframe_pyramid(jpyr0, intr), ttracking.keyframe_pyramid(tpyr0, Intrinsics(*intr))
    for lj, lt in zip(jkf, tkf):
        np.testing.assert_allclose(lt.intensity.numpy(), np.asarray(lj.intensity), atol=1e-6)
        np.testing.assert_array_equal(lt.mask.numpy(), np.asarray(lj.mask))
        ref = np.asarray(lj.jac)
        _within(lt.jac.numpy(), ref, 1e-5 * np.abs(ref).max())
    Tj, Tt = jnp.eye(4), torch.eye(4)
    est = [np.eye(4)]
    for i in range(1, len(seq)):
        rj = jtracker.track(jkf, j_preprocess_frame(jnp.asarray(seq.rgb[i]), jnp.asarray(seq.depth[i]), 3), Tj)
        rt = ttracker.track(tkf, tpre(i), Tt)
        D = np.linalg.inv(np.asarray(rj.T, np.float64)) @ rt.T.numpy().astype(np.float64)
        assert np.linalg.norm(D[:3, 3]) < 1e-4, i
        assert np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)) < 1e-4, i
        Tj, Tt = rj.T, rt.T
        est.append(np.linalg.inv(rt.T.numpy().astype(np.float64)))
    gt = [np.linalg.inv(seq.gt_poses[0]) @ T for T in seq.gt_poses]
    assert chip_smoke.sequence_ate(gt, est) < 5e-3


def test_ic_config_constructs_and_esm_consensus_raises():
    """The IC configuration constructs with consensus left on (the JAX
    package runs consensus only in ESM mode). ESM with consensus, which
    raised until the consensus was ported, now constructs in SlamSystem and
    in Tracker; the default configuration, which raised for its back end
    until the port had its own ORB, constructs too, with the thread alive
    until ``finish()``."""
    intr = Intrinsics(*QVGA)
    slam = port.SlamSystem(intr, port.SlamConfig().override(**IC), device="cpu")
    assert slam.config.tracking.consensus and slam.config.tracking.jacobian == "ic"
    esm = port.SlamSystem(intr, port.SlamConfig().override(**{"backend.enabled": False}),
                          device="cpu")
    assert esm.config.tracking.consensus and esm.config.tracking.jacobian == "esm"
    assert ttracking.Tracker(intr, TrackingConfig(jacobian="esm")).cfg.consensus
    full = port.SlamSystem(intr, port.SlamConfig(), device="cpu")
    assert full.config.backend.enabled and full.backend.alive
    full.finish()
    assert not full.backend.alive and full.backend.errors == 0


@pytest.mark.parametrize("mode", ["lagged", "exact"])
def test_chip_smoke_scene_on_cpu_ic(mode):
    """chip_smoke's VGA sequence tracked by the port on the CPU under IC.
    This run fixes the IC ATE bound chip_smoke holds the card to: the bound
    must be at least twice this ATE."""
    frames, gt = chip_smoke.make_sequence()
    slam = port.SlamSystem(port.core.TUM_FR1, chip_smoke.ic_config(mode), device="cpu")
    for f in frames:
        slam.process_frame(*f)
    slam.finish()
    poses = slam.poses()
    ate = chip_smoke.sequence_ate(gt, poses)
    assert all(np.isfinite(T).all() for T in poses)
    assert sum(bool(s.get("switch")) for s in slam.stats) >= 1
    assert not any(s.get("lost") for s in slam.stats)
    assert 2.0 * ate <= chip_smoke.ATE_BOUND_M, ate
    assert len(slam.map_points()) > 0
