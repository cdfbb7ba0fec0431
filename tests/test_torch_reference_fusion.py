"""The port's numpy fusion oracle against the JAX package's, and the
port's fusion functions against it.

``rgbid_tpu_torch/reference_cpu/fusion.py`` is a copy of
``rgbid_tpu/reference_cpu/fusion.py`` on the port's own intrinsics, config
and ``odometry``: on ``tests/test_fusion.py``'s inputs (its QVGA pair with
inverse-depth noise, a zero and a non-zero pose covariance, its outlier
frame and its hole-punched keyframe) ``fuse`` and ``fuse_grow`` return the
JAX module's arrays bit for bit. The port's ``fuse_inverse_depth``,
``fuse_core_plain`` and ``fuse_and_grow`` on CPU tensors (the kernel's
plain versions) are held to the port's oracle at ``tests/test_fusion.py``'s
tolerances: fused (and claimed) sets agree on more than 99.9% of the
pixels (a gate decision on the threshold may differ by float precision),
values within 5e-4 where both fused, variances rtol 2e-2, n_fused within
2e-3.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.config import FusionConfig as JFusionConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.reference_cpu import fusion as jref
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import FusionConfig
from rgbid_tpu_torch.mapping import fusion as tfusion
from rgbid_tpu_torch.reference_cpu import fusion as tref
from rgbid_tpu_torch.reference_cpu import odometry as odo

torch.set_num_threads(2)

INTR = Intrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
JINTR = JIntrinsics(*INTR)
FCFG, JFCFG = FusionConfig(), JFusionConfig()
COV = np.diag([1e-6, 1e-6, 1e-6, 1e-7, 1e-7, 1e-7])


@pytest.fixture(scope="module")
def setup():
    """``tests/test_fusion.py``'s fixture: frames 0 and 2 of the orbit with
    inverse-depth noise, and the relative pose."""
    scene = synthetic.make_scene(0)
    T1 = synthetic.orbit_trajectory(40, trans_amp=0.15, rot_amp=0.04)[2]
    rng = np.random.default_rng(7)
    f0 = synthetic.render_frame(scene, JINTR, np.eye(4), xi_noise_sigma=0.005, rng=rng)
    f1 = synthetic.render_frame(scene, JINTR, T1, xi_noise_sigma=0.005, rng=rng)
    return f0, f1, np.linalg.inv(T1)


def _punch_holes(depth_u16, frac=0.25, seed=3):
    """Blob dropout in a u16 depth image (invalid = 0), like the gauntlet's
    depth_holes scenario (``tests/test_fusion.py``'s helper)."""
    rng = np.random.default_rng(seed)
    h, w = depth_u16.shape
    out = depth_u16.copy()
    target = frac * h * w
    killed = 0
    while killed < target:
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(5, 25)
        yy, xx = np.ogrid[:h, :w]
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        killed += blob.sum()
        out[blob] = 0
    return out


def _np_hole_guess(xi0, mask0, levels=3):
    """The hole guess of the JAX package's device pyramid as numpy
    (``tests/test_fusion.py``'s helper)."""
    import jax.numpy as jnp

    from rgbid_tpu.mapping.fusion import hole_guess
    from rgbid_tpu.ops import image
    from rgbid_tpu.tracking.frames import KeyframeLevel

    xi_pyr, mask_pyr = image.build_pyramid(
        jnp.asarray(xi0), jnp.asarray(mask0, jnp.float32), levels
    )
    lvls = [
        KeyframeLevel(intensity=None, xi=x, mask=m, jac=None)
        for x, m in zip(xi_pyr, mask_pyr)
    ]
    g, gm = hole_guess(lvls)
    return np.asarray(g), np.asarray(gm)


def _kalman_inputs(setup, case):
    """(kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, pose_cov) of a
    Kalman-only case."""
    f0, f1, T_ck = setup
    kf_xi, kf_mask = odo.inverse_depth_from_u16(f0[1])
    kf_var = np.full_like(kf_xi, FCFG.sensor_sigma_xi**2)
    if case == "outlier":
        # An object appeared: identity pose, every inverse depth doubled.
        return kf_xi, kf_var, kf_mask, kf_xi * 2.0, kf_mask, np.eye(4), np.zeros((6, 6))
    cur_xi, cur_mask = odo.inverse_depth_from_u16(f1[1])
    cov = COV if case == "pose cov" else np.zeros((6, 6))
    return kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, cov


@pytest.fixture(scope="module")
def grow_inputs(setup):
    """(kf_xi, kf_var, kf_mask, kf_hits, cur_xi, cur_mask, T_ck, pose_cov,
    guess, gmask) of the hole-punched keyframe."""
    f0, f1, T_ck = setup
    kf_xi, kf_mask = odo.inverse_depth_from_u16(_punch_holes(f0[1]))
    cur_xi, cur_mask = odo.inverse_depth_from_u16(f1[1])
    kf_var = np.full_like(kf_xi, FCFG.sensor_sigma_xi**2)
    kf_hits = np.where(kf_mask, FCFG.confirm_hits, 0.0).astype(np.float32)
    guess, gmask = _np_hole_guess(kf_xi, kf_mask)
    return kf_xi, kf_var, kf_mask, kf_hits, cur_xi, cur_mask, T_ck, COV, guess, gmask


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y


@pytest.mark.parametrize("case", ["zero cov", "pose cov", "outlier"])
def test_fuse_bit_equal_to_jax_oracle(setup, case):
    a = _kalman_inputs(setup, case)
    port = tref.fuse(*a, INTR, FCFG)
    _equal(port, jref.fuse(*a, JINTR, JFCFG))
    if case == "outlier":
        assert port[3] < 0.01 * a[2].sum()  # nearly everything gated out


def test_fuse_grow_bit_equal_to_jax_oracle(grow_inputs):
    a = grow_inputs
    port = tref.fuse_grow(*a[:8], INTR, FCFG, *a[8:])
    _equal(port, jref.fuse_grow(*a[:8], JINTR, JFCFG, *a[8:]))
    assert port[5] > 1000  # claims happen


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _check_kalman(xi, var, n, ref, kf_xi):
    """``tests/test_fusion.py::test_device_matches_oracle``'s rules."""
    r_xi, r_var, _, r_n = ref
    changed_ref = r_xi != kf_xi
    changed = xi != kf_xi
    assert (changed_ref == changed).mean() > 0.999
    both = changed_ref & changed
    np.testing.assert_allclose(xi[both], r_xi[both], atol=5e-4)
    np.testing.assert_allclose(var[both], r_var[both], rtol=2e-2, atol=1e-9)
    assert abs(n - r_n) / max(r_n, 1) < 2e-3


@pytest.mark.parametrize("fn", ["fuse_inverse_depth", "fuse_core_plain"])
@pytest.mark.parametrize("case", ["zero cov", "pose cov"])
def test_port_kalman_step_matches_oracle(setup, fn, case):
    kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, cov = _kalman_inputs(setup, case)
    ref = tref.fuse(kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck, cov, INTR, FCFG)
    args = (_t(kf_xi), _t(kf_var), _t(kf_mask), _t(cur_xi), _t(cur_mask), _t(T_ck), _t(cov),
            INTR, FCFG)
    out = getattr(tfusion, fn)(*args)
    xi, var, n = out[0].numpy(), out[1].numpy(), float(out[-1])
    _check_kalman(xi, var, n, ref, kf_xi)
    if fn == "fuse_inverse_depth":
        assert out[2] is args[2]  # the mask comes back as given
    else:
        assert not out[3].any()  # no guess, no claim
    assert n > 0.5 * kf_mask.sum()


def test_port_fuse_and_grow_matches_oracle(grow_inputs):
    """``tests/test_fusion.py::test_fuse_and_grow_matches_oracle``'s rules:
    the grown mask, the claimed values and the hit counts agree with
    ``fuse_grow`` on more than 99.9% of the pixels, n_fused within 2e-3."""
    kf_xi, kf_var, kf_mask, kf_hits, cur_xi, cur_mask, T_ck, cov, guess, gmask = grow_inputs
    r_xi, _, r_mask, r_hits, r_nf, r_nc = tref.fuse_grow(*grow_inputs[:8], INTR, FCFG,
                                                         guess, gmask)
    xi, var, mask, hits, n = tfusion.fuse_and_grow(
        _t(kf_xi), _t(kf_var), _t(kf_mask), _t(kf_hits), _t(cur_xi), _t(cur_mask), _t(T_ck),
        _t(cov), INTR, FCFG, guess=_t(guess), gmask=_t(gmask))
    assert r_nc > 1000
    mask_b = mask.numpy() > 0.5
    assert (mask_b == r_mask).mean() > 0.999
    both = mask_b & r_mask & (~kf_mask)
    assert both.sum() > 1000
    assert (np.abs(xi.numpy()[both] - r_xi[both]) <= 5e-4).mean() > 0.999
    assert (hits.numpy() == r_hits).mean() > 0.999
    assert abs(float(n) - r_nf) / max(r_nf, 1) < 2e-3
