"""The IRLS early exit (``TrackingConfig.early_exit_tol`` and
``conv_skip_tol``) in the port against the JAX package.

The JAX package stops a level's loop once the previous step's norm is <=
tol, with a ``while_loop`` (early_exit_tol) or a ``cond`` inside its
``fori_loop`` (conv_skip_tol); the carry is the same either way. The port
has one mechanism: each IRLS step gets the previous step and the tolerance
and is skipped (the step equals the previous one) when the test holds; on
the card the launch returns at entry. Here, on CPU tensors:

- the tracker with ``early_exit_tol=1e-5`` in ESM, IC lagged and IC exact
  mode against the JAX package's, poses within the tracker test's 1e-5 m /
  1e-5 rad, with the exit firing (fewer iterations run than the budget);
- ``early_exit_tol`` and ``conv_skip_tol`` at the same tolerance give
  bit-equal results in the port;
- ``tol = 0`` gives the plain loop bit for bit;
- the step's skip decision: the kernels' float order, the float32
  tolerance, and a skipped step that is the previous one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.config import FusionConfig as JFusionConfig
from rgbid_tpu.core.config import TrackingConfig as JTrackingConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.mapping.keyframe import create_device_keyframe as j_keyframe
from rgbid_tpu.tracking import Tracker as JTracker
from rgbid_tpu.tracking.frames import preprocess_frame as j_preprocess
from rgbid_tpu_torch.core.camera import Intrinsics, level_intrinsics
from rgbid_tpu_torch.core.config import FusionConfig, TrackingConfig
from rgbid_tpu_torch.mapping.keyframe import create_device_keyframe
from rgbid_tpu_torch.ops import gauss_newton as tgn
from rgbid_tpu_torch.ops import kernels
from rgbid_tpu_torch.tracking.frames import preprocess_frame
from rgbid_tpu_torch.tracking.tracker import Tracker, _Pyramid

torch.set_num_threads(2)

QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
TOL = 1e-5
# A budget the finest level converges within: (10, 20, 40) from fine to
# coarse; the exit then fires at level 0 in every mode.
ITERS = (10, 20, 40)
MODES = [
    pytest.param("esm", {}, id="esm"),
    pytest.param("ic", {"sigma_mode": "lagged"}, id="ic-lagged"),
    pytest.param("ic", {"sigma_mode": "exact"}, id="ic-exact"),
]


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.make_scene(0)
    T1 = synthetic.orbit_trajectory(40, trans_amp=0.25, rot_amp=0.06)[2]
    return synthetic.render_frame(scene, QVGA, np.eye(4)), synthetic.render_frame(scene, QVGA, T1)


def _rotation_diff(D: np.ndarray) -> float:
    """sin of D's rotation angle from its skew part: at angles near 0 the
    trace's arccos reads the float32 poses' departure from orthonormality
    (~1e-8 on the diagonal gives ~3e-5 rad), not their rotation."""
    R = D[:3, :3]
    return 0.5 * float(np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]))


def _port_inputs(frames, mode):
    f0, f1 = frames
    esm = mode == "esm"
    p0, p1 = (preprocess_frame(torch.from_numpy(f[0]), torch.from_numpy(f[1].astype(np.int32)),
                               3, esm=esm) for f in (f0, f1))
    kf = create_device_keyframe(p0, Intrinsics(*QVGA), FusionConfig(), jacobian=mode)
    return kf, p1


def _track(frames, mode, extra, **knobs):
    """The port's tracker on the pair under ``knobs``: (result, iteration
    counts (launched, run) per level)."""
    kf, cur = _port_inputs(frames, mode)
    cfg = TrackingConfig(levels=3, iters=ITERS, jacobian=mode, **extra, **knobs)
    kernels.reset_iteration_counts("cpu")
    res = Tracker(Intrinsics(*QVGA), cfg).track(kf.levels, cur, torch.eye(4))
    return res, kernels.iteration_counts("cpu")


@pytest.mark.parametrize("mode,extra", MODES)
def test_early_exit_matches_jax(frames, mode, extra):
    """``early_exit_tol=1e-5`` in both packages on the same frames: the
    pose within 1e-5 m / 1e-5 rad (float32 sums in another order), and the
    port ran fewer iterations than its budget (the exit fired) while
    issuing all of them. In ESM the budget includes the consensus's masked
    reruns (levels 1 and 2) and its rescue pyramid (every level), which
    the tracker enqueues on every frame and the device runs only when a
    vote asks for them."""
    f0, f1 = frames
    esm = mode == "esm"
    p0 = j_preprocess(jnp.asarray(f0[0]), jnp.asarray(f0[1]), 3, esm=esm)
    p1 = j_preprocess(jnp.asarray(f1[0]), jnp.asarray(f1[1]), 3, esm=esm)
    kf = j_keyframe(p0, QVGA, JFusionConfig(), jacobian=mode)
    jcfg = JTrackingConfig(levels=3, iters=ITERS, jacobian=mode, early_exit_tol=TOL, **extra)
    jT = np.asarray(JTracker(QVGA, jcfg).track(kf.levels, p1, jnp.eye(4)).T, np.float64)
    res, (launched, run) = _track(frames, mode, extra, early_exit_tol=TOL)
    D = np.linalg.inv(jT) @ res.T.numpy().astype(np.float64)
    assert np.linalg.norm(D[:3, 3]) < 1e-5
    assert _rotation_diff(D) < 1e-5
    budget = np.array(ITERS) * (np.array([2, 3, 3]) if esm else 1)
    np.testing.assert_array_equal(launched[:3], budget)
    assert (run <= launched).all() and run.sum() < launched.sum(), (launched, run)


@pytest.mark.parametrize("mode,extra", MODES)
def test_early_exit_equals_conv_skip(frames, mode, extra):
    """One mechanism in the port: ``early_exit_tol`` and ``conv_skip_tol``
    at the same tolerance give the same pose, normal matrix, per-level
    errors and iteration counts, bit for bit."""
    a, ca = _track(frames, mode, extra, early_exit_tol=TOL)
    b, cb = _track(frames, mode, extra, conv_skip_tol=TOL)
    for f in ("T", "H", "errors", "inlier_frac", "n_valid", "sigma2_int", "sigma2_xi"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_array_equal(ca[1], cb[1])


@pytest.mark.parametrize("mode,extra", MODES)
def test_tol_zero_is_the_plain_loop(frames, mode, extra):
    """With both tolerances 0 every level's loop equals the loop written
    out without ``prev`` (the loop before the early exit), bit for bit, and
    every enqueued iteration runs."""
    kf, cur = _port_inputs(frames, mode)
    cfg = TrackingConfig(levels=3, iters=ITERS, jacobian=mode, **extra)
    intrs = tuple(level_intrinsics(Intrinsics(*QVGA), l) for l in range(3))
    pyr = _Pyramid(kf.levels, cur, intrs, cfg, "f32", torch.device("cpu"))
    T, s2i, s2x, H = torch.eye(4), pyr.s2i0, pyr.s2x0, pyr.eye6
    kernels.reset_iteration_counts("cpu")
    for level in (2, 1, 0):
        kl, pts = pyr.tmpl[level]
        cl, il = cur[level], intrs[level]
        got = pyr.run(level, T, s2i, s2x, H, kl.mask)
        for _ in range(pyr.n_iters(level)):
            if mode == "esm":
                gate_cap = cfg.occ_gate_cap if level <= cfg.occ_gate_cap_level else 0.0
                step = kernels.esm_irls_step(
                    T, kl.intensity, pts, kl.mask, kl.jac, cl.stack7, il, cfg.student_t_nu, s2i,
                    s2x, cfg.use_geometric, cfg.gate_sigmas, cfg.occlusion_gate, gate_cap,
                    damping=cfg.damping)
            else:
                step = kernels.ic_irls_step(
                    T, kl.intensity, pts, kl.mask, kl.jac, cl.intensity, cl.xi, cl.mask, il,
                    cfg.student_t_nu, s2i, s2x, cfg.sigma_iters, cfg.use_geometric,
                    cfg.gate_sigmas, cfg.sigma_mode, damping=cfg.damping)
            T, r = step.T, step.result
            s2i, s2x, H = r.sigma2_int, r.sigma2_xi, r.H
        want = (T, s2i, s2x, H, r.error, r.inlier_frac, r.n_valid)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), level
    launched, run = kernels.iteration_counts("cpu")
    np.testing.assert_array_equal(launched, run)
    np.testing.assert_array_equal(launched[:3], ITERS)


def test_step_norm_float_order():
    """``step_norm`` sums the squares from the first in float32, then takes
    the square root: the kernels' order (irls::converged)."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        d = (rng.standard_normal(6) * 10.0 ** rng.uniform(-8, -2)).astype(np.float32)
        s = d[0] * d[0]
        for k in range(1, 6):
            s = np.float32(s + d[k] * d[k])
        assert float(tgn.step_norm(torch.from_numpy(d))) == float(np.sqrt(s))


def test_skipped_step_is_the_previous_step():
    """A step whose previous step's norm is not above the float32 tolerance
    is that step (the plain version selects its output over the one it
    computed, as the kernel copies it), a larger one runs, and tol 0 never
    skips; each enqueued step counts in its slot, a skipped one not as run."""
    rng = np.random.default_rng(1)
    h, w = 24, 32
    xi = torch.from_numpy(rng.uniform(0.3, 1.0, (h, w)).astype(np.float32))
    intr = Intrinsics(fx=30.0, fy=30.0, cx=15.5, cy=11.5, width=w, height=h)
    pts = tgn.backproject_grid(xi, intr)
    mask = torch.ones((h, w))
    grads = torch.from_numpy(rng.standard_normal((4, h, w)).astype(np.float32))
    stack = torch.from_numpy(rng.uniform(0, 1, (3, h, w)).astype(np.float32))
    stack[2] = 1.0
    args = (torch.eye(4), stack[0].clone(), pts, mask, grads, stack, intr, 5.0,
            torch.tensor(0.01), torch.tensor(0.0025))
    tol32 = np.float32(TOL)
    prev = kernels.esm_irls_step(*args, damping=1e-6)

    def with_delta(d0):
        out = prev.out.clone()
        out[64:70] = torch.tensor([d0, 0, 0, 0, 0, 0])
        return kernels._irls_step(out)

    under, over = with_delta(tol32), with_delta(np.nextafter(tol32, np.float32(1)))
    kernels.reset_iteration_counts("cpu")
    skipped = kernels.esm_irls_step(*args, damping=1e-6, prev=under, tol=TOL, slot=0)
    assert torch.equal(skipped.out, under.out)
    ran = kernels.esm_irls_step(*args, damping=1e-6, prev=over, tol=TOL, slot=0)
    assert not torch.equal(ran.out, over.out) and torch.equal(ran.T, prev.T)
    not_skipped = kernels.esm_irls_step(*args, damping=1e-6, prev=under, tol=0.0, slot=1)
    assert not torch.equal(not_skipped.out, under.out)
    launched, run = kernels.iteration_counts("cpu")
    assert launched[:2].tolist() == [2, 1] and run[:2].tolist() == [1, 1]
