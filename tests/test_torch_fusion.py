"""The fusion kernel's plain PyTorch version against the JAX package.

A keyframe founded from one rendered frame and the next frame's inverse
depth go through ``rgbid_tpu_torch.mapping.fusion.fuse_core`` on CPU
tensors (the plain version) and through ``rgbid_tpu.mapping.fusion.
_fuse_core`` with ``fusion.kernel="pallas"`` (the Pallas kernel in
interpret mode) and ``"xla"``, with validity growth on and off.
"""

import dataclasses

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
from rgbid_tpu_torch.mapping import fusion as tfusion
from rgbid_tpu_torch.tracking.frames import KeyframeLevel

torch.set_num_threads(2)

INTR = JIntrinsics(fx=129.3, fy=129.1, cx=79.6, cy=59.6, width=160, height=120)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def state():
    """Keyframe of frame 0 (with depth holes to grow into), frame 2 as the
    observation, the ground-truth pose and a small SPD covariance."""
    scene = synthetic.make_scene(1)
    poses = synthetic.orbit_trajectory(30, trans_amp=0.2, rot_amp=0.05)
    rng = np.random.default_rng(4)
    f0 = synthetic.render_frame(scene, INTR, poses[0], xi_noise_sigma=0.004, rng=rng)
    f2 = synthetic.render_frame(scene, INTR, poses[2], xi_noise_sigma=0.004, rng=rng)
    d0 = f0[1].copy()
    d0[rng.random(d0.shape) < 0.05] = 0
    d0[40:52, 60:80] = 0
    pyr0 = preprocess_frame(jnp.asarray(f0[0]), jnp.asarray(d0), 4, esm=True, esm_min_level=1)
    pyr2 = preprocess_frame(jnp.asarray(f2[0]), jnp.asarray(f2[1]), 4, esm=True, esm_min_level=1)
    kf = create_device_keyframe(pyr0, INTR, FusionConfig(), jnp.bfloat16, "esm")
    T_ck = (np.linalg.inv(poses[2]) @ poses[0]).astype(np.float32)
    A = rng.standard_normal((6, 6)) * 1e-3
    cov = (A @ A.T + np.diag([4e-6] * 3 + [1e-6] * 3)).astype(np.float32)
    return kf, pyr2, T_ck, cov


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
