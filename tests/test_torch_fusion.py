"""The fusion kernel's plain PyTorch version against the JAX package.

A keyframe founded from one rendered frame and the next frame's inverse
depth go through ``rgbid_tpu_torch.mapping.fusion.fuse_core`` and
``fuse_frame`` on CPU tensors (the plain versions) and through
``rgbid_tpu.mapping.fusion._fuse_core`` / ``hole_guess`` +
``fuse_and_grow`` with ``fusion.kernel="pallas"`` (the Pallas kernel in
interpret mode) and ``"xla"``, with validity growth on and off, at an even
(120x160) and an odd (121x161) keyframe size. ``csrc/fusion_pixel.cuh``,
the kernel's per-pixel work, is built for the host and held to
``fuse_frame_plain`` over whole planes.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.config import FusionConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.mapping import fusion as jfusion
from rgbid_tpu.mapping.keyframe import create_device_keyframe
from rgbid_tpu.tracking.frames import preprocess_frame
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import FusionConfig as TFusionConfig
from rgbid_tpu_torch.mapping import fusion as tfusion
from rgbid_tpu_torch.ops import _build
from rgbid_tpu_torch.tracking.frames import KeyframeLevel

torch.set_num_threads(2)

INTR = JIntrinsics(fx=129.3, fy=129.1, cx=79.6, cy=59.6, width=160, height=120)
# Odd on both axes: the coarse levels' nearest-neighbour upsample is cropped
# or zero-padded to the keyframe's size.
ODD = JIntrinsics(fx=129.3, fy=129.1, cx=80.1, cy=60.2, width=161, height=121)
CSRC = Path(tfusion.__file__).resolve().parent.parent / "csrc"


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _state(intr):
    """Keyframe of frame 0 (with depth holes to grow into), frame 2 as the
    observation, the ground-truth pose and a small SPD covariance."""
    scene = synthetic.make_scene(1)
    poses = synthetic.orbit_trajectory(30, trans_amp=0.2, rot_amp=0.05)
    rng = np.random.default_rng(4)
    f0 = synthetic.render_frame(scene, intr, poses[0], xi_noise_sigma=0.004, rng=rng)
    f2 = synthetic.render_frame(scene, intr, poses[2], xi_noise_sigma=0.004, rng=rng)
    d0 = f0[1].copy()
    d0[rng.random(d0.shape) < 0.05] = 0
    d0[40:52, 60:80] = 0
    pyr0 = preprocess_frame(jnp.asarray(f0[0]), jnp.asarray(d0), 4, esm=True, esm_min_level=1)
    pyr2 = preprocess_frame(jnp.asarray(f2[0]), jnp.asarray(f2[1]), 4, esm=True, esm_min_level=1)
    kf = create_device_keyframe(pyr0, intr, FusionConfig(), jnp.bfloat16, "esm")
    T_ck = (np.linalg.inv(poses[2]) @ poses[0]).astype(np.float32)
    A = rng.standard_normal((6, 6)) * 1e-3
    cov = (A @ A.T + np.diag([4e-6] * 3 + [1e-6] * 3)).astype(np.float32)
    return kf, pyr2, T_ck, cov


@pytest.fixture(scope="module")
def state():
    return _state(INTR)


@pytest.fixture(scope="module")
def states(state):
    return {"120x160": (INTR,) + state, "121x161": (ODD,) + _state(ODD)}


def _tlevels(kf):
    return [KeyframeLevel(_t(l.intensity), _t(l.xi), _t(l.mask), _t(l.jac.astype(jnp.float32)))
            for l in kf.levels]


def _fuse_frame_args(kf, cur, T_ck, cov, intr, grow):
    """fuse_frame's arguments on CPU tensors: the keyframe levels, the
    tracker's covariance (the floor is added inside)."""
    return (_tlevels(kf), _t(kf.var), _t(kf.mask_full), _t(kf.hits), _t(cur[0].xi),
            _t(cur[0].mask), _t(T_ck), _t(cov), Intrinsics(*intr),
            dataclasses.replace(TFusionConfig(), grow_validity=grow))


@pytest.mark.parametrize("grow", [True, False])
@pytest.mark.parametrize("ref_kernel", ["pallas", "xla"])
def test_plain_fusion_matches_jax(state, grow, ref_kernel):
    """xi' and var' within 1e-6 relative (+1e-9 absolute): the per-pixel
    sequence is the same f32 arithmetic up to operation order, so a pixel
    near a gate threshold could in principle flip; masks and n_fused are
    required exact, which this input meets."""
    kf, cur, T_ck, cov = state
    cfg = dataclasses.replace(FusionConfig(), kernel=ref_kernel)
    guess, gmask = jfusion.hole_guess(kf.levels) if grow else (None, None)
    ref = jfusion._fuse_core(
        kf.levels[0].xi, kf.var, kf.mask_full, cur[0].xi, cur[0].mask, jnp.asarray(T_ck),
        jnp.asarray(cov), INTR, cfg, guess=guess, gmask=gmask,
    )
    tlevels = [KeyframeLevel(_t(l.intensity), _t(l.xi), _t(l.mask), _t(l.jac.astype(jnp.float32)))
               for l in kf.levels]
    tguess, tgmask = tfusion.hole_guess(tlevels) if grow else (None, None)
    if grow:
        np.testing.assert_array_equal(tguess.numpy(), np.asarray(guess))
        np.testing.assert_array_equal(tgmask.numpy(), np.asarray(gmask))
    out = tfusion.fuse_core(
        _t(kf.levels[0].xi), _t(kf.var), _t(kf.mask_full), _t(cur[0].xi), _t(cur[0].mask),
        _t(T_ck), _t(cov), Intrinsics(*INTR), FusionConfig(), tguess, tgmask,
    )
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert float(out[4]) == float(ref[4]) > 1000
    assert (float(out[3].sum()) > 0) == grow


def test_fuse_and_grow_hits_and_mask(state):
    """Hit counts (+1 per fuse, 1 for a claim) and the grown estimate mask
    equal the JAX package's exactly."""
    kf, cur, T_ck, cov = state
    cfg = FusionConfig()
    guess, gmask = jfusion.hole_guess(kf.levels)
    ref = jfusion.fuse_and_grow(
        kf.levels[0].xi, kf.var, kf.mask_full, kf.hits, cur[0].xi, cur[0].mask,
        jnp.asarray(T_ck), jnp.asarray(cov), INTR, cfg, guess=guess, gmask=gmask,
    )
    out = tfusion.fuse_and_grow(
        _t(kf.levels[0].xi), _t(kf.var), _t(kf.mask_full), _t(kf.hits), _t(cur[0].xi),
        _t(cur[0].mask), _t(T_ck), _t(cov), Intrinsics(*INTR), cfg, _t(guess), _t(gmask),
    )
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert float(out[4]) == float(ref[4])


@pytest.mark.parametrize("ref_kernel", ["pallas", "xla"])
@pytest.mark.parametrize("grow", [True, False])
@pytest.mark.parametrize("size", ["120x160", "121x161"])
def test_fuse_frame_matches_jax(states, size, grow, ref_kernel):
    """The one-call fusion step on CPU tensors against the JAX package's
    fusion step: the pose-noise floor added to the covariance (the same
    f32 add), ``hole_guess`` and ``fuse_and_grow``. Masks, hits and
    n_fused exact; xi' and var' within 1e-6 relative (+1e-9 absolute), the
    same f32 arithmetic up to operation order."""
    intr, kf, cur, T_ck, cov = states[size]
    jcfg = dataclasses.replace(FusionConfig(), kernel=ref_kernel, grow_validity=grow)
    floor = np.diag(np.array([jcfg.pose_trans_sigma**2] * 3 + [jcfg.pose_rot_sigma**2] * 3,
                             np.float32))
    guess, gmask = jfusion.hole_guess(kf.levels) if grow else (None, None)
    ref = jfusion.fuse_and_grow(
        kf.levels[0].xi, kf.var, kf.mask_full, kf.hits, cur[0].xi, cur[0].mask,
        jnp.asarray(T_ck), jnp.asarray(cov + floor), intr, jcfg, guess=guess, gmask=gmask,
    )
    out = tfusion.fuse_frame(*_fuse_frame_args(kf, cur, T_ck, cov, intr, grow))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert float(out[4]) == float(ref[4]) > 1000
    grown = float(out[2].sum() - _t(kf.mask_full).sum())
    assert (grown > 0) == grow


_FUSION_SHIM = r"""
#include "fusion_pixel.cuh"
extern "C" float fuse_planes_c(const FusionParams* p, const float* T, const float* cov,
                               const float* kf_xi, const float* kf_var, const float* kf_mask,
                               const float* kf_hits, const float* cur_xi, const float* cur_mask,
                               float* xi_out, float* var_out, float* mask_out, float* hits_out) {
  fusion::Pose q;
  fusion::load_pose(*p, T, cov, q);
  float n = 0.f;
  for (int i = 0; i < p->h * p->w; ++i) {
    const fusion::Out o = fusion::pixel(*p, q, i % p->w, i / p->w, kf_xi[i], kf_var[i],
                                        kf_mask[i], kf_hits[i], cur_xi, cur_mask);
    xi_out[i] = o.xi;
    var_out[i] = o.var;
    mask_out[i] = o.mask;
    hits_out[i] = o.hits;
    n += o.fuse;
  }
  return n;
}
"""


@pytest.fixture(scope="module")
def host_fusion(tmp_path_factory):
    """csrc/fusion_pixel.cuh, the fusion kernel's per-pixel work, built for
    the host with a C++ compiler (FMA contraction off, as the card's build),
    looped over every pixel of a plane."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler (g++ or c++) on PATH to build csrc/fusion_pixel.cuh")
    work = tmp_path_factory.mktemp("fusion_pixel")
    (work / "shim.cpp").write_text(_FUSION_SHIM)
    lib = work / "libfusion_pixel.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(work / "shim.cpp")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).fuse_planes_c
    fn.argtypes = [ctypes.POINTER(_build.FusionParams)] + [ctypes.c_void_p] * 12
    fn.restype = ctypes.c_float
    return fn


@pytest.mark.parametrize("grow", [True, False])
@pytest.mark.parametrize("size", ["120x160", "121x161"])
def test_kernel_fusion_pixel_matches_plain(states, host_fusion, size, grow):
    """The kernel's per-pixel work (hole guess, pose floor and T_kc
    included), built for the host, against ``fuse_frame_plain`` over whole
    planes, the covariance row-major or (odd size) column-major: masks,
    hits and n_fused exact, xi' within 1e-6 and var' within 1e-9 (the same
    operations in the same order)."""
    intr, kf, cur, T_ck, cov = states[size]
    args = _fuse_frame_args(kf, cur, T_ck, cov, intr, grow)
    levels, var, mask, hits, cur_xi, cur_mask, T, C, tintr, cfg = args
    if size == "121x161":  # the tracker's covariance is column-major
        C = C.T.contiguous().T
        args = args[:7] + (C,) + args[8:]
    ref = tfusion.fuse_frame_plain(*args)
    p = tfusion.fusion_params(levels, C, tintr, cfg)
    outs = [torch.empty_like(var) for _ in range(4)]
    n = host_fusion(ctypes.byref(p), *(x.data_ptr() for x in (T, C, levels[0].xi, var, mask,
                                                              hits, cur_xi, cur_mask, *outs)))
    assert np.abs(outs[0].numpy() - ref[0].numpy()).max() <= 1e-6
    assert np.abs(outs[1].numpy() - ref[1].numpy()).max() <= 1e-9
    np.testing.assert_array_equal(outs[2].numpy(), ref[2].numpy())
    np.testing.assert_array_equal(outs[3].numpy(), ref[3].numpy())
    assert n == float(ref[4]) > 1000


def test_plain_building_blocks_raise_off_cpu():
    """``fuse_core`` and ``fuse_and_grow`` are plain building blocks with no
    kernel of their own: off the CPU they raise and name ``fuse_frame``;
    ``fuse_frame`` has a kernel only for CUDA."""
    m = torch.zeros((4, 4), device="meta")
    cfg = TFusionConfig()
    intr = Intrinsics(fx=4.0, fy=4.0, cx=1.5, cy=1.5, width=4, height=4)
    eye = torch.eye(4, device="meta")
    cov = torch.zeros((6, 6), device="meta")
    with pytest.raises(ValueError, match="fuse_frame"):
        tfusion.fuse_core(m, m, m, m, m, eye, cov, intr, cfg)
    with pytest.raises(ValueError, match="fuse_frame"):
        tfusion.fuse_and_grow(m, m, m, m, m, m, eye, cov, intr, cfg)
    with pytest.raises(ValueError, match="no fusion kernel"):
        tfusion.fuse_frame([KeyframeLevel(m, m, m, m)], m, m, m, m, m, eye, cov, intr, cfg)
