"""The ESM kernel's plain PyTorch version against the JAX package.

The same keyframe template and current-frame stack (rendered by the JAX
package's synthetic renderer) go through
``rgbid_tpu_torch.ops.kernels.esm_residuals_and_normal_eq`` on CPU tensors
(which runs the plain version) and through both JAX twins: the Pallas
kernel in interpret mode and the XLA function. Covers the 3/5/7-plane
stacks, the geometric channel on and off, the occlusion-gate cap, an odd
resolution, and the solver's no-op cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbid_tpu.core import se3 as jse3
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.camera import level_intrinsics
from rgbid_tpu.core.config import FusionConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.mapping.keyframe import create_device_keyframe
from rgbid_tpu.ops import gauss_newton as jgn
from rgbid_tpu.ops.pallas_kernels import esm_residuals_and_normal_eq_pallas
from rgbid_tpu.ops.warp import backproject_grid
from rgbid_tpu.tracking.frames import preprocess_frame
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.ops import gauss_newton as tgn
from rgbid_tpu_torch.ops import kernels

torch.set_num_threads(2)

SMALL = JIntrinsics(fx=103.4, fy=103.3, cx=63.7, cy=47.7, width=128, height=96)
ODD = JIntrinsics(fx=103.4, fy=103.3, cx=64.1, cy=48.3, width=129, height=97)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(0)


def _pair(scene, intr, geo_min):
    T1 = synthetic.orbit_trajectory(40, trans_amp=0.25, rot_amp=0.06)[2]
    f0 = synthetic.render_frame(scene, intr, np.eye(4))
    f1 = synthetic.render_frame(scene, intr, T1)
    pyr0 = preprocess_frame(jnp.asarray(f0[0]), jnp.asarray(f0[1]), 3, esm=True,
                            esm_min_level=1, esm_geo_min_level=geo_min)
    pyr1 = preprocess_frame(jnp.asarray(f1[0]), jnp.asarray(f1[1]), 3, esm=True,
                            esm_min_level=1, esm_geo_min_level=geo_min)
    kf = create_device_keyframe(pyr0, intr, FusionConfig(), jnp.bfloat16, "esm")
    return kf, pyr1, np.linalg.inv(T1).astype(np.float32)


# (label, intrinsics, esm_geo_min_level, level, template stride,
#  use_geometric, occlusion_gate, gate_cap)
CASES = [
    ("3-plane L0 stride2 cap", SMALL, 0, 0, 2, True, True, 0.10),
    ("3-plane L0 geo-off", SMALL, 0, 0, 1, False, True, 0.0),
    ("7-plane L1 gate", SMALL, 0, 1, 1, True, True, 0.0),
    ("7-plane L1 no-gate", SMALL, 0, 1, 2, True, False, 0.0),
    ("7-plane L2 geo-off", SMALL, 0, 2, 1, False, False, 0.0),
    ("5-plane L1 gate", SMALL, 2, 1, 1, True, True, 0.0),
    ("odd 7-plane L1 cap", ODD, 0, 1, 1, True, True, 0.10),
    ("odd 3-plane L0 stride2", ODD, 0, 0, 2, True, True, 0.10),
]


def _inputs(scene, intr, geo_min, level, stride):
    kf, cur, T = _pair(scene, intr, geo_min)
    kl, cl = kf.levels[level], cur[level]
    il = level_intrinsics(intr, level)
    s = stride
    kl_int, kl_xi, kl_mask = kl.intensity[::s, ::s], kl.xi[::s, ::s], kl.mask[::s, ::s]
    grads = kl.jac[:, ::s, ::s].astype(jnp.float32)
    bp = il if s == 1 else JIntrinsics(il.fx / s, il.fy / s, il.cx / s, il.cy / s,
                                       kl_xi.shape[1], kl_xi.shape[0])
    pts = backproject_grid(kl_xi, bp)
    return T, kl_int, pts, kl_mask, grads, cl.stack7, il


def _to_torch(T, kl_int, pts, kl_mask, grads, stack, il):
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return (t(T), t(kl_int), tuple(t(p) for p in pts), t(kl_mask), t(grads), t(stack),
            Intrinsics(*il))


def _check(port, ref, what):
    """H and b to 2e-4 of each entry plus 1e-5 of the largest entry (the
    sums over ~1e4 pixels are taken in another order); n_valid exact (the
    per-pixel arithmetic is the same f32 sequence); error, inlier fraction
    and the lagged sigmas to 1e-4 relative."""
    H, Hr = port.H.numpy(), np.asarray(ref.H)
    b, br = port.b.numpy(), np.asarray(ref.b)
    np.testing.assert_allclose(H, Hr, rtol=2e-4, atol=1e-5 * np.abs(Hr).max(), err_msg=what)
    np.testing.assert_allclose(b, br, rtol=2e-4, atol=1e-5 * np.abs(br).max(), err_msg=what)
    assert float(port.n_valid) == float(ref.n_valid), what
    for f in ("error", "inlier_frac", "sigma2_int", "sigma2_xi"):
        np.testing.assert_allclose(float(getattr(port, f)), float(getattr(ref, f)), rtol=1e-4,
                                   err_msg=f"{what} {f}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_esm_matches_pallas_and_xla(scene, case):
    label, intr, geo_min, level, stride, geo, gate, cap = case
    T, kl_int, pts, kl_mask, grads, stack, il = _inputs(scene, intr, geo_min, level, stride)
    assert stack.shape[0] == (3 if level == 0 else (5 if geo_min > level else 7))
    s2i, s2x = np.float32(0.01), np.float32(0.0025)
    jargs = (jnp.asarray(T), kl_int, pts, kl_mask, grads, stack, il, 5.0,
             jnp.asarray(s2i), jnp.asarray(s2x), geo, 3.0, gate, cap)
    ref_pallas = esm_residuals_and_normal_eq_pallas(*jargs[:-1], gate_cap=cap)
    ref_xla = jgn.esm_residuals_and_normal_eq(*jargs[:-1], gate_cap=cap)
    Tt, it, pt, mt, gt, st, ilt = _to_torch(T, kl_int, pts, kl_mask, grads, stack, il)
    port = kernels.esm_residuals_and_normal_eq(
        Tt, it, pt, mt, gt, st, ilt, 5.0, torch.tensor(s2i), torch.tensor(s2x), geo, 3.0,
        gate, gate_cap=cap,
    )
    assert float(port.n_valid) > 500
    _check(port, ref_pallas, f"{label} vs pallas")
    _check(port, ref_xla, f"{label} vs xla")
    if not geo:  # a disabled channel returns its incoming scale
        assert float(port.sigma2_xi) == float(s2x)


@pytest.mark.parametrize("which", ["singular", "few_valid", "ok"])
def test_ic_update_noop_cases_match_jax(which):
    """The update is suppressed (T only re-orthonormalized) when the
    Cholesky factorization fails or n_valid <= 100; otherwise both packages
    take the same step (1e-6: a 6x6 f32 solve in another order)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6)).astype(np.float32)
    Hm = {"singular": np.zeros((6, 6), np.float32),
          "few_valid": (A @ A.T + 6 * np.eye(6)).astype(np.float32),
          "ok": (A @ A.T + 6 * np.eye(6)).astype(np.float32)}[which]
    b = (0.01 * rng.standard_normal(6)).astype(np.float32)
    n_valid = np.float32(100.0 if which == "few_valid" else 5000.0)
    T = np.asarray(jse3.exp(jnp.asarray(np.array([0.1, 0.0, -0.05, 0.02, 0.01, -0.03], np.float32))))
    damping = 0.0 if which == "singular" else 1e-6
    Tj, dj = jgn.ic_update(jnp.asarray(T), jnp.asarray(Hm), jnp.asarray(b), damping, jnp.asarray(n_valid))
    Tt, dt = tgn.ic_update(torch.from_numpy(np.array(T)), torch.from_numpy(Hm), torch.from_numpy(b), damping,
                           torch.tensor(n_valid))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6)
    if which != "ok":
        assert not dt.any()
        np.testing.assert_allclose(Tt.numpy(), np.asarray(jse3.orthonormalize(jnp.asarray(T))), atol=1e-6)
    else:
        assert np.abs(dt.numpy()).max() > 1e-4
