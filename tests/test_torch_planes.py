"""bfloat16 plane storage (``TrackingConfig.plane_dtype``) in the port
against the JAX package.

- The ESM gather stack that ``preprocess_frame`` stores in bfloat16: each
  package builds its own pyramid from the same frame, whose float32 planes
  differ by float noise (convolutions summed in another order), so the two
  bfloat16 stacks agree within one bfloat16 ulp; the port's equals its own
  float32 stack rounded to nearest even, bit for bit.
- One ESM IRLS step and the plain stratified reduction on the same
  bfloat16 arrays given to both packages (the JAX side through the Pallas
  kernel in interpret mode and ``ic_update``, and the XLA
  ``stratified_normal_eq``), in every type mix the tracker uses: the IRLS
  loop's (intensity, points and stack bf16), the vote's and the rescue
  evidence's (float32 intensity, bf16 points and stack), and those of the
  two ablation splits. Both widen each load to float32 first, so the
  tolerances are the float32 ones of ``tests/test_torch_esm.py`` and
  ``tests/test_torch_consensus.py``.
- The tracker under "bf16" against the JAX package's, as
  ``tests/test_tracker.py::test_bf16_plane_storage_matches_f32`` runs it.
- The kept difference: an unknown ``plane_dtype`` raises ValueError in the
  port (the JAX package runs it as "f32").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbid_tpu_torch as port
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.camera import level_intrinsics
from rgbid_tpu.core.config import FusionConfig as JFusionConfig
from rgbid_tpu.core.config import TrackingConfig as JTrackingConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.mapping.keyframe import create_device_keyframe as j_keyframe
from rgbid_tpu.ops import gauss_newton as jgn
from rgbid_tpu.ops.pallas_kernels import esm_residuals_and_normal_eq_pallas
from rgbid_tpu.ops.warp import backproject_grid
from rgbid_tpu.tracking import Tracker as JTracker
from rgbid_tpu.tracking import consensus as jcons
from rgbid_tpu.tracking.frames import preprocess_frame as j_preprocess
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import FusionConfig, TrackingConfig
from rgbid_tpu_torch.mapping.keyframe import create_device_keyframe
from rgbid_tpu_torch.ops import gauss_newton as tgn
from rgbid_tpu_torch.ops import kernels
from rgbid_tpu_torch.tracking import consensus as tcons
from rgbid_tpu_torch.tracking.frames import FrameLevel, preprocess_frame
from rgbid_tpu_torch.tracking.tracker import Tracker, plane_dtypes

torch.set_num_threads(2)

SMALL = JIntrinsics(fx=103.4, fy=103.3, cx=63.7, cy=47.7, width=128, height=96)
QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
DAMPING = JTrackingConfig().damping
BF = torch.bfloat16

# (label, template intensity, points, stack in bfloat16)
MIXES = [
    pytest.param(True, True, True, id="bf16-loop"),
    pytest.param(False, True, True, id="bf16-vote"),
    pytest.param(True, True, False, id="bf16-points-loop"),
    pytest.param(False, True, False, id="bf16-points-vote"),
    pytest.param(False, False, True, id="bf16-stack"),
]


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |a - b| in bfloat16 ulps of the larger magnitude."""
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(m > 0, 2.0 ** (np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7), 1.0)
    return float((np.abs(a - b) / ulp).max())


def test_preprocess_stack_bf16_matches_jax():
    """Every level's stack (3 planes at L0, 7 above) is bfloat16 in both
    packages, within 1 bf16 ulp of each other (their float32 planes differ
    by float noise, so a value on a rounding boundary may round apart), and
    the port's is its own float32 stack rounded to nearest even."""
    scene = synthetic.make_scene(0)
    rgb, d16, _, _ = synthetic.render_frame(scene, SMALL, np.eye(4))
    kw = dict(esm=True, esm_min_level=1)
    ref = j_preprocess(jnp.asarray(rgb), jnp.asarray(d16), 3, plane_dtype=jnp.bfloat16, **kw)
    t_rgb, t_d = torch.from_numpy(rgb), torch.from_numpy(d16.astype(np.int32))
    ours = preprocess_frame(t_rgb, t_d, 3, plane_dtype=BF, **kw)
    f32 = preprocess_frame(t_rgb, t_d, 3, **kw)
    for lvl in range(3):
        assert ours[lvl].stack7.dtype == BF and ref[lvl].stack7.dtype == jnp.bfloat16
        assert ours[lvl].stack7.shape == ref[lvl].stack7.shape == ((3 if lvl == 0 else 7),) + (
            SMALL.height >> lvl, SMALL.width >> lvl)
        a = ours[lvl].stack7.float().numpy()
        b = np.asarray(ref[lvl].stack7, np.float32)
        assert _bf16_ulps(a, b) <= 1.0, lvl
        assert torch.equal(f32[lvl].stack7.to(BF), ours[lvl].stack7)
        assert ours[lvl].intensity.dtype == torch.float32  # only the stack is stored bf16


@pytest.fixture(scope="module")
def small_pair():
    """A keyframe and a current pyramid at 128x96 (the JAX package's, bf16
    stacks), the pose between them."""
    scene = synthetic.make_scene(0)
    T1 = synthetic.orbit_trajectory(40, trans_amp=0.25, rot_amp=0.06)[2]
    f0 = synthetic.render_frame(scene, SMALL, np.eye(4))
    f1 = synthetic.render_frame(scene, SMALL, T1)
    kw = dict(esm=True, esm_min_level=1, plane_dtype=jnp.bfloat16)
    pyr0 = j_preprocess(jnp.asarray(f0[0]), jnp.asarray(f0[1]), 3, **kw)
    pyr1 = j_preprocess(jnp.asarray(f1[0]), jnp.asarray(f1[1]), 3, **kw)
    kf = j_keyframe(pyr0, SMALL, JFusionConfig(), jnp.bfloat16, "esm")
    return kf, pyr1, np.linalg.inv(T1).astype(np.float32)


def _level_inputs(pair, level, stride, mix):
    """The level's ESM arguments for both packages: the same arrays, the
    planes of ``mix`` in bfloat16 (the JAX package's rounding, carried into
    torch exactly: every bf16 value is a float32 value)."""
    int_bf, pts_bf, stack_bf = mix
    kf, cur, T = pair
    kl, cl = kf.levels[level], cur[level]
    il = level_intrinsics(SMALL, level)
    s = stride
    xi, mask = kl.xi[::s, ::s], kl.mask[::s, ::s]
    grads = kl.jac[:, ::s, ::s].astype(jnp.float32)
    bp = il if s == 1 else JIntrinsics(il.fx / s, il.fy / s, il.cx / s, il.cy / s, xi.shape[1],
                                       xi.shape[0])
    pts = backproject_grid(xi, bp)
    k_int = kl.intensity[::s, ::s]
    if int_bf:
        k_int = k_int.astype(jnp.bfloat16)
    if pts_bf:
        pts = tuple(p.astype(jnp.bfloat16) for p in pts)
    stack = cl.stack7 if stack_bf else cl.stack7.astype(jnp.float32)

    def t(a):
        x = torch.from_numpy(np.array(a, np.float32))
        return x.to(BF) if a.dtype == jnp.bfloat16 else x

    jargs = (jnp.asarray(T), k_int, pts, mask, grads, stack, il)
    targs = (torch.from_numpy(T), t(k_int), tuple(t(p) for p in pts), t(mask), t(grads), t(stack),
             Intrinsics(*il))
    return jargs, targs, xi


def _check(port_res, ref, what):
    """``tests/test_torch_esm.py``'s tolerances: H and b to 2e-4 of each
    entry plus 1e-5 of the largest entry, n_valid exact, error, inlier
    fraction and scales to 1e-4 relative."""
    H, Hr = port_res.H.numpy(), np.asarray(ref.H)
    b, br = port_res.b.numpy(), np.asarray(ref.b)
    np.testing.assert_allclose(H, Hr, rtol=2e-4, atol=1e-5 * np.abs(Hr).max(), err_msg=what)
    np.testing.assert_allclose(b, br, rtol=2e-4, atol=1e-5 * np.abs(br).max(), err_msg=what)
    assert float(port_res.n_valid) == float(ref.n_valid), what
    for f in ("error", "inlier_frac", "sigma2_int", "sigma2_xi"):
        np.testing.assert_allclose(float(getattr(port_res, f)), float(getattr(ref, f)),
                                   rtol=1e-4, err_msg=f"{what} {f}")


@pytest.mark.parametrize("int_bf,pts_bf,stack_bf", MIXES)
def test_esm_irls_step_bf16_matches_jax(small_pair, int_bf, pts_bf, stack_bf):
    """One ESM IRLS step at L1 (7-plane stack, stride 1, occlusion gate)
    on the same mixed bf16/f32 arrays: the port's step (its plain version
    on CPU tensors) against the Pallas kernel in interpret mode followed by
    the JAX package's ``ic_update``; the pose and the step within 1e-6
    plus 1e-4 of each entry (the 6x6 solve carries the sums' reordering
    times H's condition number: measured 1.05e-6, 2.2e-5 of the entry, in
    the "bf16-stack" mix)."""
    mix = (int_bf, pts_bf, stack_bf)
    jargs, targs, _ = _level_inputs(small_pair, 1, 1, mix)
    s2i, s2x = np.float32(0.01), np.float32(0.0025)
    ref = esm_residuals_and_normal_eq_pallas(*jargs, 5.0, jnp.asarray(s2i), jnp.asarray(s2x),
                                             True, 3.0, True)
    Tj, dj = jgn.ic_update(jargs[0], ref.H, ref.b, DAMPING, ref.n_valid)
    assert targs[1].dtype == (BF if int_bf else torch.float32)
    assert targs[2][0].dtype == (BF if pts_bf else torch.float32)
    assert targs[5].dtype == (BF if stack_bf else torch.float32)
    step = kernels.esm_irls_step(*targs, 5.0, torch.tensor(s2i), torch.tensor(s2x), True, 3.0,
                                 True, damping=DAMPING)
    _check(step.result, ref, str(mix))
    assert float(ref.n_valid) > 500
    np.testing.assert_allclose(step.delta.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(step.T.numpy(), np.asarray(Tj), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("int_bf,pts_bf,stack_bf", [m for m in MIXES if not m.values[0]])
def test_stratified_plain_bf16_matches_jax(small_pair, int_bf, pts_bf, stack_bf):
    """The vote's reduction (L1, template stride 2, K 6, init sigmas,
    occlusion gate on) on the same arrays in the vote's mixes (the float32
    template intensity): the plain version and the wrapper on CPU tensors
    against the JAX package's ``stratified_normal_eq``, with
    ``tests/test_torch_consensus.py``'s tolerances (n exact, H, G and b
    within 2e-4 of each entry plus 1e-5 of the stratum's largest, the
    error within 1e-4 relative)."""
    jargs, targs, xi = _level_inputs(small_pair, 1, 2, (int_bf, pts_bf, stack_bf))
    tc = JTrackingConfig()
    k = 6
    edges = tcons.stratum_edges(1.0 / 10.0, 1.0 / 0.3, k)
    s2i, s2x = np.float32(tc.init_sigma_int**2), np.float32(tc.init_sigma_xi**2)
    mask = jargs[3]
    strata = jcons.stratum_onehot(jnp.asarray(xi), mask, jnp.asarray(edges))
    ref = jgn.stratified_normal_eq(*jargs, tc.student_t_nu, s2i, s2x, strata, tc.use_geometric,
                                   tc.gate_sigmas, occlusion_gate=True)
    args = targs + (tc.student_t_nu, torch.tensor(s2i), torch.tensor(s2x))
    t_xi = torch.from_numpy(np.array(xi, np.float32))
    plain = tgn.stratified_normal_eq(*args, tcons.stratum_onehot(t_xi, targs[3],
                                                                 torch.from_numpy(edges)),
                                     tc.use_geometric, tc.gate_sigmas, True)
    wrapped = tgn.unpack_stratified(kernels.esm_stratified(*args, t_xi, edges, tc.use_geometric,
                                                           tc.gate_sigmas, True))
    Hr, br, nr, Gr, er = (np.asarray(a) for a in ref)
    for got in (plain, wrapped):
        Hk, bk, nk, Gk, ek = (a.numpy() for a in got)
        np.testing.assert_array_equal(nk, nr)
        for a, r, what in ((Hk, Hr, "H"), (Gk, Gr, "G"), (bk, br, "b")):
            scale = np.abs(r).reshape(k, -1).max(1).reshape((k,) + (1,) * (r.ndim - 1))
            assert np.all(np.abs(a - r) <= 2e-4 * np.abs(r) + 1e-5 * scale), what
        np.testing.assert_allclose(ek, er, rtol=1e-4)
    assert nr.sum() > 300 and (nr > 0).sum() >= 2


def test_tracker_bf16_matches_jax():
    """``tests/test_tracker.py``'s bf16 case (QVGA, 3 levels, iters (4, 8,
    16), ESM, no consensus) in both packages from the same keyframe and
    frame (the JAX package's pyramids carried into the port, bf16 stack
    included; the consensus on, as TrackingConfig has it): the poses agree
    within ``tests/test_torch_slice.py``'s per-frame 1e-4 m / 1e-4 rad
    (float32 sums in another order over 28 iterations and two votes:
    measured 1.5e-5 rad in f32), and each package's bf16 pose is within
    1 mm of its f32 pose, as the reference test requires."""
    scene = synthetic.make_scene(0)
    T1 = synthetic.orbit_trajectory(40, trans_amp=0.25, rot_amp=0.06)[2]
    f0 = synthetic.render_frame(scene, QVGA, np.eye(4))
    f1 = synthetic.render_frame(scene, QVGA, T1)
    poses = {}
    for pd in ("f32", "bf16"):
        dt = jnp.bfloat16 if pd == "bf16" else jnp.float32
        pyr0 = j_preprocess(jnp.asarray(f0[0]), jnp.asarray(f0[1]), 3, esm=True, plane_dtype=dt)
        pyr1 = j_preprocess(jnp.asarray(f1[0]), jnp.asarray(f1[1]), 3, esm=True, plane_dtype=dt)
        kf = j_keyframe(pyr0, QVGA, JFusionConfig(), jacobian="esm")
        jcfg = JTrackingConfig(levels=3, iters=(4, 8, 16), jacobian="esm", plane_dtype=pd)
        jT = np.asarray(JTracker(QVGA, jcfg).track(kf.levels, pyr1, jnp.eye(4)).T, np.float64)
        tcfg = TrackingConfig(levels=3, iters=(4, 8, 16), jacobian="esm", plane_dtype=pd)
        stack_dt = plane_dtypes(tcfg)[0]
        cur = tuple(FrameLevel(
            *(torch.from_numpy(np.array(x, np.float32)) for x in (l.intensity, l.xi, l.mask)),
            torch.from_numpy(np.array(l.stack7, np.float32)).to(stack_dt)) for l in pyr1)
        tkf = create_device_keyframe(
            tuple(FrameLevel(
                *(torch.from_numpy(np.array(x, np.float32)) for x in (l.intensity, l.xi, l.mask)))
                for l in pyr0),
            Intrinsics(*QVGA), FusionConfig(), jacobian="esm")
        tT = Tracker(Intrinsics(*QVGA), tcfg).track(tkf.levels, cur, torch.eye(4)).T
        D = np.linalg.inv(jT) @ tT.numpy().astype(np.float64)
        assert np.linalg.norm(D[:3, 3]) < 1e-4, pd
        assert np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)) < 1e-4, pd
        poses[pd] = (jT, tT.numpy().astype(np.float64))
    for i in (0, 1):
        d = np.linalg.inv(poses["f32"][i]) @ poses["bf16"][i]
        assert np.linalg.norm(d[:3, 3]) < 1e-3


def test_unknown_plane_dtype_raises():
    """The kept difference: the JAX package runs any other string as
    "f32"; the port refuses it where the config enters."""
    cfg = port.SlamConfig().override(**{"tracking.plane_dtype": "fp16", "backend.enabled": False})
    with pytest.raises(ValueError, match="plane_dtype"):
        port.SlamSystem(Intrinsics(*QVGA), cfg, device="cpu")
    with pytest.raises(ValueError, match="plane_dtype"):
        Tracker(Intrinsics(*QVGA), cfg.tracking)
