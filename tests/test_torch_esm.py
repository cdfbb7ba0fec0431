"""The ESM kernel's plain PyTorch version against the JAX package.

The same keyframe template and current-frame stack (rendered by the JAX
package's synthetic renderer) go through
``rgbid_tpu_torch.ops.kernels.esm_residuals_and_normal_eq`` on CPU tensors
(which runs the plain version) and through both JAX twins: the Pallas
kernel in interpret mode and the XLA function. ``esm_irls_step`` (the
evaluation, the damped solve and the pose update of one iteration) is held
to the Pallas kernel followed by the JAX package's ``ic_update``. Covers the
3/5/7-plane stacks, the geometric channel on and off, the occlusion-gate
cap, an odd resolution, and the solver's no-op cases, in PyTorch and in the
kernels' own solve (``csrc/irls_solve.cuh``, built for the host).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbid_tpu.core import se3 as jse3
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.camera import level_intrinsics
from rgbid_tpu.core.config import FusionConfig, TrackingConfig
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
DAMPING = TrackingConfig().damping
CSRC = Path(__file__).resolve().parent.parent / "rgbid_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(0)


@pytest.fixture(scope="module")
def pallas_refs():
    """Pallas results (interpret mode) by case label, shared by the tests
    of this module that hold the port to them."""
    return {}


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


def _case(scene, case, pallas_refs):
    """The case's inputs (numpy), its JAX arguments and its Pallas result."""
    label, intr, geo_min, level, stride, geo, gate, cap = case
    inputs = _inputs(scene, intr, geo_min, level, stride)
    T, kl_int, pts, kl_mask, grads, stack, il = inputs
    s2i, s2x = np.float32(0.01), np.float32(0.0025)
    jargs = (jnp.asarray(T), kl_int, pts, kl_mask, grads, stack, il, 5.0,
             jnp.asarray(s2i), jnp.asarray(s2x), geo, 3.0, gate)
    if label not in pallas_refs:
        pallas_refs[label] = esm_residuals_and_normal_eq_pallas(*jargs, gate_cap=cap)
    targs = _to_torch(*inputs) + (5.0, torch.tensor(s2i), torch.tensor(s2x), geo, 3.0, gate, cap)
    return inputs, jargs, pallas_refs[label], targs


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_esm_matches_pallas_and_xla(scene, pallas_refs, case):
    label, intr, geo_min, level, stride, geo, gate, cap = case
    (T, kl_int, pts, kl_mask, grads, stack, il), jargs, ref_pallas, targs = _case(
        scene, case, pallas_refs)
    assert stack.shape[0] == (3 if level == 0 else (5 if geo_min > level else 7))
    ref_xla = jgn.esm_residuals_and_normal_eq(*jargs, gate_cap=cap)
    port = kernels.esm_residuals_and_normal_eq(*targs[:-1], gate_cap=cap)
    assert float(port.n_valid) > 500
    _check(port, ref_pallas, f"{label} vs pallas")
    _check(port, ref_xla, f"{label} vs xla")
    if not geo:  # a disabled channel returns its incoming scale
        assert float(port.sigma2_xi) == float(targs[9])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_esm_irls_step_matches_jax(scene, pallas_refs, case):
    """One IRLS iteration, ``esm_irls_step`` on CPU tensors, against the
    Pallas kernel followed by the JAX package's ``ic_update``: the
    evaluation as above; the pose and the step within 1e-6 (a 6x6 f32 solve
    in another order, from sums taken in another order)."""
    label = case[0]
    _, jargs, ref, targs = _case(scene, case, pallas_refs)
    Tj, dj = jgn.ic_update(jargs[0], ref.H, ref.b, DAMPING, ref.n_valid)
    step = kernels.esm_irls_step(*targs, damping=DAMPING)
    _check(step.result, ref, f"{label} step vs pallas")
    np.testing.assert_allclose(step.delta.numpy(), np.asarray(dj), atol=1e-6, err_msg=label)
    np.testing.assert_allclose(step.T.numpy(), np.asarray(Tj), atol=1e-6, err_msg=label)
    assert np.abs(step.delta.numpy()).max() > 1e-4  # a real step was taken
    # The CPU step is the plain evaluation followed by ic_update, exactly.
    T_plain, d_plain = tgn.ic_update(targs[0], step.result.H, step.result.b, DAMPING,
                                     step.result.n_valid)
    assert torch.equal(step.T, T_plain) and torch.equal(step.delta, d_plain)


SOLVE_CASES = ["singular", "few_valid", "nan_h", "ok", "taylor"]


def _solve_case(which):
    """(H, b, damping, n_valid, T) of a solver case: a zero H without
    damping (the factorization fails), n_valid at the limit of 100, a NaN
    in H, an ordinary step, and a step small enough for exp's Taylor
    branch (theta^2 < 1e-8)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6)).astype(np.float32)
    Hm = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    if which == "singular":
        Hm = np.zeros((6, 6), np.float32)
    elif which == "nan_h":
        Hm[2, 4] = Hm[4, 2] = np.nan
    b = (0.01 * rng.standard_normal(6)).astype(np.float32)
    if which == "taylor":
        b *= np.float32(1e-3)
    n_valid = np.float32(100.0 if which == "few_valid" else 5000.0)
    T = np.asarray(jse3.exp(jnp.asarray(np.array([0.1, 0.0, -0.05, 0.02, 0.01, -0.03], np.float32))))
    damping = 0.0 if which == "singular" else 1e-6
    return Hm, b, damping, n_valid, T


@pytest.mark.parametrize("which", SOLVE_CASES)
def test_ic_update_noop_cases_match_jax(which):
    """The update is suppressed (T only re-orthonormalized) when the
    Cholesky factorization fails, H holds a NaN or n_valid <= 100;
    otherwise both packages take the same step (1e-6: a 6x6 f32 solve in
    another order)."""
    Hm, b, damping, n_valid, T = _solve_case(which)
    Tj, dj = jgn.ic_update(jnp.asarray(T), jnp.asarray(Hm), jnp.asarray(b), damping, jnp.asarray(n_valid))
    Tt, dt = tgn.ic_update(torch.from_numpy(np.array(T)), torch.from_numpy(Hm), torch.from_numpy(b), damping,
                           torch.tensor(n_valid))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6)
    if which not in ("ok", "taylor"):
        assert not dt.any()
        np.testing.assert_allclose(Tt.numpy(), np.asarray(jse3.orthonormalize(jnp.asarray(T))), atol=1e-6)
    else:
        assert np.abs(dt.numpy()).max() > (1e-7 if which == "taylor" else 1e-4)


# The header's default min_valid (the fused kernels' call) and an explicit
# one (the solve launch's).
_SHIM = r"""
#include "irls_solve.cuh"
extern "C" void solve_update_c(const float* H, const float* b, float damping, float n_valid,
                               const float* T, float* T_out, float* delta) {
  irls::solve_update(H, b, damping, n_valid, T, T_out, delta);
}
extern "C" void solve_update_min_c(const float* H, const float* b, float damping,
                                   float n_valid, const float* T, float* T_out, float* delta,
                                   float min_valid) {
  irls::solve_update(H, b, damping, n_valid, T, T_out, delta, min_valid);
}
"""
# The solver cases again with min_valid -inf (the IC SPMD tracker's rule):
# the few-valid step is taken, the failed factorizations still hold.
ANY_COUNT = " min_valid -inf"
HOST_SOLVE_CASES = SOLVE_CASES + [c + ANY_COUNT for c in ("few_valid", "singular", "nan_h")]


@pytest.fixture(scope="module")
def host_solve(tmp_path_factory):
    """csrc/irls_solve.cuh, the kernels' solve and pose update, built for
    the host with a C++ compiler (FMA contraction off, as the card's build)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler (g++ or c++) on PATH to build csrc/irls_solve.cuh")
    work = tmp_path_factory.mktemp("irls_solve")
    (work / "shim.cpp").write_text(_SHIM)
    lib = work / "libirls_solve.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(work / "shim.cpp")],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    fn, fn_min = dll.solve_update_c, dll.solve_update_min_c
    fn.argtypes = [P, P, ctypes.c_float, ctypes.c_float, P, P, P]
    fn_min.argtypes = fn.argtypes + [ctypes.c_float]
    fn.restype = fn_min.restype = None
    return fn, fn_min


@pytest.mark.parametrize("which", HOST_SOLVE_CASES)
def test_kernel_solve_matches_ic_update(host_solve, which):
    """The kernels' 6x6 Cholesky solve, exp and orthonormalize (the header
    built for the host) against the port's ``ic_update``: delta and T
    within 1e-6 (a 6x6 f32 solve in another order); a suppressed update
    gives delta exactly 0. With min_valid -inf (both sides) a few-valid
    step is taken."""
    any_count = which.endswith(ANY_COUNT)
    Hm, b, damping, n_valid, T = _solve_case(which.removesuffix(ANY_COUNT))
    T = np.array(T, np.float32)
    T_out = np.zeros((4, 4), np.float32)
    delta = np.full(6, np.nan, np.float32)
    ptrs = (Hm.ctypes.data, b.ctypes.data, damping, n_valid, T.ctypes.data, T_out.ctypes.data,
            delta.ctypes.data)
    min_valid = float("-inf") if any_count else 100.0
    if any_count:
        host_solve[1](*ptrs, min_valid)
    else:
        host_solve[0](*ptrs)
    Tt, dt = tgn.ic_update(torch.from_numpy(T), torch.from_numpy(Hm), torch.from_numpy(b),
                           damping, torch.tensor(n_valid), min_valid)
    np.testing.assert_allclose(delta, dt.numpy(), atol=1e-6)
    np.testing.assert_allclose(T_out, Tt.numpy(), atol=1e-6)
    assert np.isfinite(T_out).all()
    if which in ("ok", "taylor", "few_valid" + ANY_COUNT):
        assert np.abs(delta).max() > (1e-7 if which == "taylor" else 1e-4)
    else:
        assert not delta.any()
