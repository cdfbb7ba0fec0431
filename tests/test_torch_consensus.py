"""The port's motion consensus against the JAX package.

``rgbid_tpu_torch.tracking.consensus`` (host numpy float32) against
``rgbid_tpu.tracking.consensus`` on the same per-stratum sums; the plain
stratified reduction against the JAX package's; the tracker with its
streak history injected; the whole per-frame step over the walking-mover
clip of ``tests/test_consensus.py`` with the JAX system's state injected
every frame; and the port's own runs of that clip, of a rigid clip and of
``chip_smoke.py``'s two sequences, which set the smoke's ATE bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import rgbid_tpu_torch as port
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.camera import level_intrinsics
from rgbid_tpu.core.config import FusionConfig
from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.core.config import TrackingConfig as JTrackingConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.eval import absolute_trajectory_error
from rgbid_tpu.mapping.keyframe import create_device_keyframe
from rgbid_tpu.ops import gauss_newton as jgn
from rgbid_tpu.ops.warp import backproject_grid
from rgbid_tpu.tracking import consensus as jcons
from rgbid_tpu.tracking.frames import preprocess_frame
from rgbid_tpu.tracking.step import MotionState as JMotionState
from rgbid_tpu.tracking.step import ProcessFrame as JProcessFrame
from rgbid_tpu.tracking.step import StepResult as JStepResult
from rgbid_tpu.tracking.step import pack_frame as j_pack
from rgbid_tpu.tracking.tracker import _track_impl
from rgbid_tpu_torch import convert
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.ops import gauss_newton as tgn
from rgbid_tpu_torch.ops import kernels
from rgbid_tpu_torch.tracking import consensus as tcons
from rgbid_tpu_torch.tracking.step import ProcessFrame, StepResult
from rgbid_tpu_torch.tracking.tracker import track as t_track

torch.set_num_threads(2)

K = 6
QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.5, cy=119.5, width=320, height=240)
# tests/test_consensus.py's system configuration (back end off, every-frame
# fusion), with the stratum range SlamSystem derives from the depth range.
MOVER_CFG = {"backend.enabled": False, "fusion.fuse_every": 1}


def _cfg(**extra):
    cfg = JSlamConfig().override(**{**MOVER_CFG, **extra})
    return cfg.override(**{"tracking.consensus_xi_min": 1.0 / cfg.max_depth,
                           "tracking.consensus_xi_max": 1.0 / cfg.min_depth})


# ---------------------------------------------------------------------------
# (1) analyze / decide on per-stratum sums


def _eye_stack(scales, nk):
    return np.stack([s * np.eye(6) for s in scales]).astype(np.float32) * nk[:, None, None]


def _fixture(name):
    """(Hk, bk, nk, Gk, ek, prev_counts) of tests/test_consensus.py's six
    synthetic cases, float32."""
    f32 = np.float32
    if name == "majority":
        nk = np.array([2000.0, 1500.0, 1800.0, 1700.0, 2500.0, 50.0], f32)
        d = np.zeros((K, 6), f32)
        d[0, 0], d[1, 1], d[2, 0], d[2, 2], d[3, 0], d[3, 1] = 2e-4, 3e-4, -2e-4, 1e-4, 1e-4, -1e-4
        d[4, 0], d[4, 1] = 0.02, 0.01
        Hk = _eye_stack([1e4, 1e4, 1e4, 1e4, 1e6, 1e2], nk)
        bk = np.einsum("kij,kj->ki", Hk, d).astype(f32)
        return Hk, bk, nk, _eye_stack([1e4] * K, nk), (0.1 * nk).astype(f32), np.full(K, 10.0, f32)
    if name == "static":
        rng = np.random.default_rng(0)
        nk = rng.uniform(500, 3000, K).astype(f32)
        d = rng.normal(0, 3e-4, (K, 6)).astype(f32)
        Hk = _eye_stack([1e4] * K, nk)
        bk = (np.einsum("kij,kj->ki", Hk / nk[:, None, None], d) * nk[:, None]).astype(f32)
        return Hk, bk, nk, _eye_stack([1e4] * K, nk), (0.1 * nk).astype(f32), np.full(K, 10.0, f32)
    if name == "error_outlier":
        nk = np.array([2000.0, 1800.0, 2200.0, 900.0, 0.0, 0.0], f32)
        n1 = np.maximum(nk, 1)
        ek = (np.array([0.1, 0.15, 0.12, 4.8, 0.0, 0.0], f32) * n1).astype(f32)
        return (_eye_stack([1e4] * K, n1), np.zeros((K, 6), f32), nk, _eye_stack([1e4] * K, n1),
                ek, np.full(K, 10.0, f32))
    if name == "hostage":
        nk = np.array([0.0, 4900.0, 3300.0, 1800.0, 0.0, 0.0], f32)
        ek = (np.array([0.0, 0.07, 0.9, 0.15, 0.0, 0.0], f32) * nk).astype(f32)
        return (_eye_stack([0.0, 2e3, 8e3, 2e5, 0.0, 0.0], nk), np.zeros((K, 6), f32), nk,
                _eye_stack([1e4] * K, nk), ek, np.array([0, 0, 0, 5.0, 0, 0], f32))
    if name == "two_voter":
        nk = np.array([0.0, 4700.0, 5300.0, 0.0, 0.0, 0.0], f32)
        d = np.zeros((K, 6), f32)
        d[1, 0], d[2, 0] = 0.02, -0.02
        Hk = _eye_stack([1e4] * K, nk)
        bk = (np.einsum("kij,kj->ki", Hk, d) / np.maximum(nk, 1.0)[:, None] * nk[:, None])
        return (Hk, bk.astype(f32), nk, _eye_stack([1e4] * K, nk), (0.1 * nk).astype(f32),
                np.full(K, 10.0, f32))
    if name == "dominance":
        nk = np.array([0.0, 4700.0, 3200.0, 2100.0, 0.0, 0.0], f32)
        return (_eye_stack([0.0, 4e3, 1e4, 3e4, 0.0, 0.0], nk), np.zeros((K, 6), f32), nk,
                _eye_stack([1e4] * K, nk), (0.1 * nk).astype(f32), np.full(K, 10.0, f32))
    raise KeyError(name)


def _random_sums(seed, even_voters=False, all_agree=False):
    """Seeded random per-stratum sums: SPD H and G with a wide but bounded
    eigenvalue spread, corrections of mixed size, errors around the
    outlier floor. ``even_voters``: four voting strata (an even count, the
    median's two-middle-values case); ``all_agree``: every stratum is
    converged (b = 0), so every hypothesis has the same support and the
    first index must win the argmax."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nk = rng.uniform(800, 4000, K).astype(f32)
    if even_voters:
        nk[[1, 4]] = rng.uniform(5, 20, 2).astype(f32)
    Hk, Gk = [], []
    for _ in range(K):
        Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        ev = np.exp(rng.uniform(np.log(1e2), np.log(1e5), 6))
        Hk.append(Q @ np.diag(ev) @ Q.T)
        Q2, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        Gk.append(Q2 @ np.diag(np.exp(rng.uniform(np.log(1e3), np.log(3e4), 6))) @ Q2.T)
    Hk = (np.stack(Hk) * nk[:, None, None]).astype(f32)
    Gk = (np.stack(Gk) * nk[:, None, None]).astype(f32)
    d = rng.normal(0, 2e-3, (K, 6))
    if all_agree:
        d[:] = 0.0
    else:
        d[rng.integers(K)] += rng.normal(0, 3e-2, 6)
    bk = np.einsum("kij,kj->ki", Hk, d).astype(f32)
    ek = (rng.uniform(0.05, 0.3, K) * nk).astype(f32)
    if not all_agree:
        ek[rng.integers(K)] = f32(rng.uniform(1.0, 5.0)) * nk[0]
    prev = rng.integers(0, 6, K).astype(f32)
    return Hk, bk, nk, Gk, ek, prev


CASES = ["majority", "static", "error_outlier", "hostage", "two_voter", "dominance"]
RANDOM = [(s, False, False) for s in range(8)] + [(100, True, False), (101, True, False),
                                                  (200, False, True)]


def _analyze_both(sums, tol=0.4, bscale=1.0):
    Hk, bk, nk, Gk, ek, prev = sums
    j = jcons.analyze(*(jnp.asarray(a) for a in (Hk, bk, nk, Gk, ek)), tol, 0.03,
                      baseline_scale=jnp.asarray(bscale, jnp.float32))
    t = tcons.analyze(Hk, bk, nk, Gk, ek, tol, 0.03, baseline_scale=np.float32(bscale))
    jd = jcons.decide(j, jnp.asarray(prev), jnp.asarray(nk), 0.03, 0.35, 3)
    td = tcons.decide(t, prev, nk, 0.03, 0.35, 3)
    return j, t, jd, td


def _same_verdict(j, t, jd, td, what):
    """Flags equal; deltas and info_share within 1e-5 relative (to the
    largest entry: a float32 eigensolve in another LAPACK routine's order)."""
    for f in ("excluded", "hostage", "dominant"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)), err_msg=f"{what} {f}")
    assert t.majority_ok == bool(j.majority_ok), what
    for f in ("deltas", "info_share"):
        ref = np.asarray(getattr(j, f))
        np.testing.assert_allclose(getattr(t, f), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30), err_msg=f"{what} {f}")
    np.testing.assert_array_equal(td.member, np.asarray(jd.member), err_msg=what)
    assert (td.triggered, td.rescue) == (bool(jd.triggered), bool(jd.rescue)), what
    np.testing.assert_allclose(td.excluded_frac, float(jd.excluded_frac), rtol=1e-6, err_msg=what)


@pytest.mark.parametrize("name", CASES)
def test_analyze_decide_fixtures_match_jax(name):
    j, t, jd, td = _analyze_both(_fixture(name))
    _same_verdict(j, t, jd, td, name)
    # Each fixture's point holds in the port too (tests/test_consensus.py).
    if name == "majority":
        assert td.triggered and td.member[4] == 0.0 and (td.member[:4] == 1.0).all()
    elif name == "static":
        assert not td.triggered
    elif name == "error_outlier":
        assert td.triggered and td.member[3] == 0.0
    elif name == "hostage":
        assert t.hostage[3] == 1.0 and t.hostage[1] == 0.0 and td.rescue
    elif name == "two_voter":
        assert not t.majority_ok and not t.excluded.any()
    elif name == "dominance":
        assert t.dominant[3] == 1.0 and t.dominant.sum() == 1.0


@pytest.mark.parametrize("seed,even,agree", RANDOM, ids=[f"seed{s}" for s, _, _ in RANDOM])
def test_analyze_decide_random_match_jax(seed, even, agree):
    sums = _random_sums(seed, even, agree)
    for bscale in (1.0, 1.7):
        j, t, jd, td = _analyze_both(sums, bscale=bscale)
        _same_verdict(j, t, jd, td, f"seed {seed} bscale {bscale}")
    nk = sums[2]
    voters = int((nk >= 0.03 * nk.sum()).sum())
    if even:
        assert voters % 2 == 0  # the median of an even count averages two
    if agree:
        assert t.majority_ok and not t.excluded.any() and not t.deltas.any()


def test_nanmedian_takes_the_mean_of_the_two_middle_values():
    """The median trap: torch.nanmedian gives the lower middle value, the
    JAX package (and numpy) the mean of the two; the port uses numpy's."""
    x = np.array([1.0, 2.0, 3.0, 4.0, np.nan], np.float32)
    assert float(jnp.nanmedian(jnp.asarray(x))) == 2.5
    assert float(tcons._nanmedian(x)) == 2.5
    assert float(torch.nanmedian(torch.from_numpy(x))) == 2.0
    assert float(tcons._nanmedian(np.full(3, np.nan, np.float32))) == 0.0


# ---------------------------------------------------------------------------
# (2) strata and member masks


def test_stratum_index_and_member_mask_match_jax():
    """xi at, just below and just above every edge, and outside the range:
    the same bins, the same one-hot partition, the same member mask (also
    through ``excluded_mask``, which the tracker uses)."""
    edges = tcons.stratum_edges(0.1, 3.4, K)
    np.testing.assert_array_equal(edges, np.asarray(jcons.stratum_edges(0.1, 3.4, K)))
    xs = [0.0, 0.05, 5.0]
    for e in edges:
        xs += [float(e), float(np.nextafter(e, np.float32(0))), float(np.nextafter(e, np.float32(9)))]
    xi = np.array(xs, np.float32).reshape(3, -1)
    mask = (np.arange(xi.size) % 5 != 0).astype(np.float32).reshape(xi.shape)
    je, te = jnp.asarray(edges), torch.from_numpy(edges)
    np.testing.assert_array_equal(tcons.stratum_index(torch.from_numpy(xi), te).numpy(),
                                  np.asarray(jcons.stratum_index(jnp.asarray(xi), je)))
    oh = tcons.stratum_onehot(torch.from_numpy(xi), torch.from_numpy(mask), te)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(jcons.stratum_onehot(jnp.asarray(xi),
                                                                             jnp.asarray(mask), je)))
    member = np.array([1, 0, 1, 1, 0, 1], np.float32)
    ref = np.asarray(jcons.member_mask(jnp.asarray(xi), jnp.asarray(mask), je, jnp.asarray(member)))
    got = tcons.member_mask(torch.from_numpy(xi), torch.from_numpy(mask), te, torch.from_numpy(member))
    np.testing.assert_array_equal(got.numpy(), ref)
    idx = tcons.stratum_index(torch.from_numpy(xi), te)
    np.testing.assert_array_equal(tcons.excluded_mask(idx, torch.from_numpy(mask), member).numpy(), ref)


# ---------------------------------------------------------------------------
# (3) the plain stratified reduction


@pytest.fixture(scope="module")
def qvga_pair():
    scene = synthetic.make_scene(0)
    T1 = synthetic.orbit_trajectory(40, trans_amp=0.25, rot_amp=0.06)[2]
    f0 = synthetic.render_frame(scene, QVGA, np.eye(4))
    f1 = synthetic.render_frame(scene, QVGA, T1)
    tc = JTrackingConfig()
    kw = dict(esm=True, esm_min_level=tc.esm_min_level, esm_geo_min_level=tc.esm_geo_min_level)
    pyr0 = preprocess_frame(jnp.asarray(f0[0]), jnp.asarray(f0[1]), 4, **kw)
    pyr1 = preprocess_frame(jnp.asarray(f1[0]), jnp.asarray(f1[1]), 4, **kw)
    kf = create_device_keyframe(pyr0, QVGA, FusionConfig(), jnp.bfloat16, "esm")
    return kf, pyr1, np.linalg.inv(T1).astype(np.float32)


@pytest.mark.parametrize("level", [1, 2])
def test_stratified_plain_matches_jax(qvga_pair, level):
    """The vote's reduction at QVGA L1 and L2 (template stride 2, fixed
    init sigmas, occlusion gate on, no cap), plain PyTorch and the
    ``esm_stratified`` wrapper on CPU tensors, against the JAX package's
    ``stratified_normal_eq``: n exact (0/1 sums), H, G and b within 2e-4
    of each entry plus 1e-5 of the stratum's largest entry (float32 sums in
    another order), the error within 1e-4 relative."""
    kf, cur, T = qvga_pair
    tc = JTrackingConfig()
    kl, cl = kf.levels[level], cur[level]
    il = level_intrinsics(QVGA, level)
    s = 2
    xi, mask = kl.xi[::s, ::s], kl.mask[::s, ::s]
    grads = kl.jac[:, ::s, ::s].astype(jnp.float32)
    pts = backproject_grid(xi, JIntrinsics(il.fx / s, il.fy / s, il.cx / s, il.cy / s,
                                           xi.shape[1], xi.shape[0]))
    edges = tcons.stratum_edges(1.0 / 10.0, 1.0 / 0.3, K)
    s2i, s2x = np.float32(tc.init_sigma_int**2), np.float32(tc.init_sigma_xi**2)
    strata = jcons.stratum_onehot(xi, mask, jnp.asarray(edges))
    ref = jgn.stratified_normal_eq(jnp.asarray(T), kl.intensity[::s, ::s], pts, mask, grads,
                                   cl.stack7, il, tc.student_t_nu, s2i, s2x, strata,
                                   tc.use_geometric, tc.gate_sigmas, occlusion_gate=True)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    args = (t(T), t(kl.intensity[::s, ::s]), tuple(t(p) for p in pts), t(mask), t(grads),
            t(cl.stack7), Intrinsics(*il), tc.student_t_nu, torch.tensor(s2i), torch.tensor(s2x))
    plain = tgn.stratified_normal_eq(*args, tcons.stratum_onehot(t(xi), t(mask), t(edges)),
                                     tc.use_geometric, tc.gate_sigmas, True)
    wrapped = tgn.unpack_stratified(kernels.esm_stratified(*args, t(xi), edges, tc.use_geometric,
                                                           tc.gate_sigmas, True))
    Hr, br, nr, Gr, er = (np.asarray(a) for a in ref)
    for got in (plain, wrapped):
        Hk, bk, nk, Gk, ek = (a.numpy() for a in got)
        np.testing.assert_array_equal(nk, nr)
        for a, r, what in ((Hk, Hr, "H"), (Gk, Gr, "G"), (bk, br, "b")):
            scale = np.abs(r).reshape(K, -1).max(1).reshape((K,) + (1,) * (r.ndim - 1))
            assert np.all(np.abs(a - r) <= 2e-4 * np.abs(r) + 1e-5 * scale), what
        np.testing.assert_allclose(ek, er, rtol=1e-4)
    assert (nr > 0).sum() >= 2 and nr.sum() > 500  # several populated strata


# ---------------------------------------------------------------------------
# (4) the tracker with its streak history injected


@pytest.fixture(scope="module")
def mover_clip():
    """tests/test_consensus.py's walking-mover clip: a near-field panel at
    1.4 m crossing at 0.015 m/frame, QVGA, 40 frames."""
    return synthetic.generate_sequence(
        n_frames=40, intr=QVGA, motion="orbit", trans_amp=0.25, rot_amp=0.08,
        xi_noise_sigma=0.005, moving_occluder=True, occluder_z=1.4, occluder_speed=0.015, seed=1,
    )


@pytest.fixture(scope="module")
def mover_packed(mover_clip):
    cfg = _cfg()
    return [j_pack(f.rgb, f.depth, cfg) for f in mover_clip.frames()]


@pytest.mark.parametrize("prev", [None, [0.0, 0.0, 1.0, 5.0, 0.0, 0.0]], ids=["cold", "ripe"])
def test_track_with_streaks_matches_jax(mover_packed, prev):
    """``track`` against the JAX package's ``_track_impl`` on the mover
    clip (keyframe frame 24, current frame 27, the panel in view), with no
    history (the persistence gates waived, counts from zero) and with a
    ripe streak on the panel's stratum whose neighbour has a live streak
    (the episode mask and its conditional dilation): pose within 1e-5,
    equal streak counts, rescue, applied-mask count and consensus_frac."""
    cfg = _cfg()
    tcfg = cfg.tracking
    jstep = JProcessFrame(QVGA, cfg)
    kf = jstep.init_keyframe(jnp.asarray(mover_packed[24]))
    from rgbid_tpu.tracking.step import decode_frame as j_decode
    from rgbid_tpu.tracking.frames import preprocess_planes as j_pre

    gray, xi, mask = j_decode(jnp.asarray(mover_packed[27]), cfg)
    cur = j_pre(gray.astype(jnp.float32) / 255.0, xi, mask, tcfg.levels, True,
                tcfg.esm_min_level, esm_geo_min_level=tcfg.esm_geo_min_level)
    intrs = tuple(level_intrinsics(QVGA, l) for l in range(tcfg.levels))
    fn = jax.jit(functools.partial(_track_impl, intrs=intrs, cfg=tcfg))
    T0 = np.eye(4, dtype=np.float32)
    if prev is None:
        ref = fn(kf.levels, cur, jnp.asarray(T0))
    else:
        ref = fn(kf.levels, cur, jnp.asarray(T0), cons_prev=jnp.asarray(prev, jnp.float32))
    pcfg = port.SlamConfig.from_json(cfg.to_json())
    from rgbid_tpu_torch.tracking.step import frame_pyramid

    tkf = convert.keyframe_from_reference(jax.tree_util.tree_map(np.asarray, kf), "cpu")
    out = t_track(tkf.levels, frame_pyramid(torch.from_numpy(mover_packed[27]), pcfg),
                  torch.from_numpy(T0), tuple(Intrinsics(*i) for i in intrs), pcfg.tracking,
                  pcfg.tracking.jac_dtype, cons_prev=None if prev is None else np.float32(prev))
    np.testing.assert_allclose(out.T.numpy(), np.asarray(ref.T), atol=1e-5)
    np.testing.assert_array_equal(out.cons_excluded, np.asarray(ref.cons_excluded))
    assert out.rescue == float(ref.rescue)
    assert float(out.kf_count) == float(ref.kf_count)
    np.testing.assert_allclose(out.consensus_frac, float(ref.consensus_frac), rtol=1e-6)
    assert out.cons_excluded.max() < 99  # the sentinel history never leaks
    if prev is not None:
        # Strata 2 and 3 start masked: fewer template pixels than cold.
        full = float(tkf.levels[0].mask[::2, ::2].sum())
        assert float(out.kf_count) < full


# ---------------------------------------------------------------------------
# (5) per-frame parity over the walking-mover clip


OPTIONS = {"tracking.div_rescue": True, "tracking.divergence_guard": True}


@pytest.mark.parametrize("options", [{}, OPTIONS], ids=["default", "div_rescue+guard"])
def test_step_per_frame_matches_jax_on_mover_clip(mover_packed, options):
    """Every frame of the walking-mover clip: the JAX package's per-frame
    step runs the clip; before each frame its keyframe and motion state
    (streak counts included) go into the port's step, and both run the
    frame. Equal switch, lost, guard and rescue flags, stress-flag counts,
    consensus_frac and new streak counts; pose within 1e-5. In the default
    configuration and with ``div_rescue`` and ``divergence_guard`` on (the
    guard then declares frames lost and the divergence rescue runs).
    Measured: every frame agrees (pose within 1e-6), so no frame is
    excused. The clip must exercise the consensus: streaks ripen and the
    mask acts."""
    cfg = _cfg(**options)
    jstep = JProcessFrame(QVGA, cfg)
    pstep = ProcessFrame(Intrinsics(*QVGA), port.SlamConfig.from_json(cfg.to_json()), "cpu")
    kf = jstep.init_keyframe(jnp.asarray(mover_packed[0]))
    m = JMotionState.initial(K)
    fracs, streaks, guards = [], [], 0
    for i in range(1, len(mover_packed)):
        jvec, kf2, m2 = jstep(jnp.asarray(mover_packed[i]), kf, m)
        jr = JStepResult.unpack(np.asarray(jvec), 4)
        tkf = convert.keyframe_from_reference(jax.tree_util.tree_map(np.asarray, kf), "cpu")
        tm = convert.motion_from_reference(jax.tree_util.tree_map(np.asarray, m), "cpu")
        tvec, _, tm2 = pstep(torch.from_numpy(mover_packed[i]), tkf, tm)
        tr = StepResult.unpack(tvec, 4)
        for f in ("switch", "lost", "rescue", "cons_flags", "cons_flags_persist", "guard_fired"):
            assert getattr(tr, f) == getattr(jr, f), (i, f)
        np.testing.assert_allclose(tr.consensus_frac, jr.consensus_frac, rtol=1e-6, err_msg=str(i))
        np.testing.assert_array_equal(tm2.cons_excluded, np.asarray(m2.cons_excluded), err_msg=str(i))
        np.testing.assert_allclose(tr.T, jr.T, atol=1e-5, err_msg=str(i))
        fracs.append(float(tr.consensus_frac))
        streaks.append(tm2.cons_excluded.max())
        guards += int(tr.guard_fired > 0.5)
        kf, m = kf2, m2
    assert max(fracs) > 0.05 and max(streaks) >= 3
    assert guards >= (1 if options else 0)


def test_convert_round_trips_streaks(mover_packed):
    """The motion state's streak counts survive the trip into the port and
    back (a host float32 array in the port)."""
    m = JMotionState.initial(K)._replace(cons_excluded=jnp.asarray([0, 1, 2, 7, 0, 3], jnp.float32))
    tm = convert.motion_from_reference(jax.tree_util.tree_map(np.asarray, m), "cpu")
    assert isinstance(tm.cons_excluded, np.ndarray) and tm.cons_excluded.dtype == np.float32
    back = convert.motion_to_numpy(tm)
    np.testing.assert_array_equal(back.cons_excluded, np.asarray(m.cons_excluded))
    np.testing.assert_array_equal(back.T_ck, np.asarray(m.T_ck))


# ---------------------------------------------------------------------------
# (5b) the front end's bookkeeping against the JAX system


def test_edges_reloc_planes_and_stats_match_jax_system(mover_clip):
    """The whole walking-mover clip through both systems, back end off
    (the JAX system's step is the program the per-frame test above has
    compiled: equal (intrinsics, config) share it). The clip has switches
    with and without consensus activity before them. Equal keyframe and
    edge counts; per edge the same ids and episode tag, ``T_rel`` within
    1e-5, ``information`` within 1e-4 of its largest entry (the two runs
    are independent, so their poses differ by ~1e-6 and the covariance's
    inverse amplifies that; measured 2.4e-7 and 1.1e-5); per keyframe the
    ``reloc_planes`` keys and shapes, ``intensity0_u8`` bitwise, the
    coarse xi within 1e-4 (measured 3.6e-5), the coarse intensity within
    1e-6 (it never changes under fusion and differs by the blur's summation
    order, 2e-7), at most 2 mask pixels apart (measured 0); and the
    ``relocalized`` key in every tracked frame's record."""
    from rgbid_tpu.system import SlamSystem as JSlamSystem

    frames = list(mover_clip.frames())
    jslam = JSlamSystem(QVGA, JSlamConfig().override(**MOVER_CFG))
    for f in frames:
        jslam.process_frame(f.rgb, f.depth, f.timestamp)
    jslam.finish()
    tslam = _port_run(frames, MOVER_CFG)
    assert tslam.config.to_json() == jslam.config.to_json()
    jk, tk = jslam.manager.keyframes, tslam.manager.keyframes
    je, te = jslam.manager.edges, tslam.manager.edges
    assert len(tk) == len(jk) >= 3 and len(te) == len(je) == len(tk) - 1
    assert {e.episode for e in te} == {True, False}
    scale = tslam.config.backend.episode_info_scale
    for a, b in zip(te, je):
        assert (a.from_id, a.to_id, a.episode) == (b.from_id, b.to_id, b.episode)
        np.testing.assert_allclose(a.T_rel, b.T_rel, rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.information, b.information, rtol=0,
                                   atol=1e-4 * np.abs(b.information).max())
    # An episode edge is softer than a clean one by about the configured scale.
    soft = np.mean([np.trace(e.information) for e in te if e.episode])
    stiff = np.mean([np.trace(e.information) for e in te if not e.episode])
    assert soft < 100 * scale * stiff
    for a, b in zip(tk, jk):
        assert set(a.reloc_planes) == set(b.reloc_planes)
        np.testing.assert_array_equal(a.reloc_planes["intensity0_u8"],
                                      b.reloc_planes["intensity0_u8"])
        np.testing.assert_allclose(a.reloc_planes["intensity"], b.reloc_planes["intensity"],
                                   rtol=0, atol=1e-6)
        assert a.reloc_planes["xi"].shape == b.reloc_planes["xi"].shape == (60, 80)
        differ = a.reloc_planes["mask"] != b.reloc_planes["mask"]
        assert differ.sum() <= 2
        np.testing.assert_allclose(np.where(differ, 0, a.reloc_planes["xi"]),
                                   np.where(differ, 0, b.reloc_planes["xi"]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(a.T_wk, b.T_wk, atol=1e-5)
    for a, b in zip(tslam.stats[1:], jslam.stats[1:]):
        assert a["relocalized"] is False and b["relocalized"] is False
        assert a["kf_id"] == b["kf_id"] and a["switch"] == b["switch"]


# ---------------------------------------------------------------------------
# (6) the port's own runs


def _port_run(frames, cfg_overrides, intr=QVGA):
    cfg = port.SlamConfig().override(**cfg_overrides)
    slam = port.SlamSystem(Intrinsics(*intr), cfg, device="cpu")
    for f in frames:
        slam.process_frame(f.rgb, f.depth, f.timestamp)
    slam.finish()
    return slam


def test_port_consensus_rejects_walking_mover(mover_clip):
    """The port's own CPU run of the walking-mover clip: the consensus
    fires while the panel dominates and the ATE stays under the JAX test's
    25 mm (tests/test_consensus.py)."""
    slam = _port_run(list(mover_clip.frames()), MOVER_CFG)
    gt0 = np.linalg.inv(mover_clip.gt_poses[0])
    ate = absolute_trajectory_error([gt0 @ T for T in mover_clip.gt_poses], slam.poses())["rmse"]
    assert max(s.get("consensus_frac", 0.0) for s in slam.stats) > 0.05
    assert not any(s.get("lost") for s in slam.stats)
    assert ate < 0.025, ate


def test_port_consensus_silent_on_rigid_clip():
    """tests/test_consensus.py's rigid clip: the consensus never acts, and
    the poses equal the consensus-off run's exactly (the votes read, but
    change nothing)."""
    seq = synthetic.generate_sequence(n_frames=16, intr=QVGA, motion="orbit", trans_amp=0.25,
                                      rot_amp=0.08, xi_noise_sigma=0.005, seed=2)
    frames = list(seq.frames())
    on = _port_run(frames, MOVER_CFG)
    off = _port_run(frames, {**MOVER_CFG, "tracking.consensus": False})
    assert max(s.get("consensus_frac", 0.0) for s in on.stats) == 0.0
    assert on.tracker_counts == {"rerun_iters": 0, "rescues": 0}
    for a, b in zip(on.poses(), off.poses()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (7) chip_smoke's sequences with the default configuration


@pytest.mark.parametrize("scene", ["rigid", "mover"])
def test_chip_smoke_default_config_on_cpu(scene):
    """chip_smoke.py's VGA sequences tracked by the port on the CPU with
    ``SlamConfig()`` (back end off). These runs fix the ATE bounds the
    smoke holds the card to: each bound is at least twice this ATE. The
    rigid run stays silent (the consensus-off ATE, 0.14 mm); on the mover
    the consensus fires."""
    if scene == "rigid":
        frames, gt = chip_smoke.make_sequence()
        bound = chip_smoke.ATE_BOUND_M
    else:
        frames, gt = chip_smoke.make_mover_sequence()
        bound = chip_smoke.MOVER_ATE_BOUND_M
    slam = port.SlamSystem(port.core.TUM_FR1, chip_smoke.default_config(), device="cpu")
    for f in frames:
        slam.process_frame(*f)
    slam.finish()
    ate = chip_smoke.sequence_ate(gt, slam.poses())
    fracs = [s.get("consensus_frac", 0.0) for s in slam.stats]
    assert all(np.isfinite(T).all() for T in slam.poses())
    assert not any(s.get("lost") for s in slam.stats)
    assert 2.0 * ate <= bound, ate
    if scene == "rigid":
        assert max(fracs) == 0.0
    else:
        assert chip_smoke.consensus_fired(slam.stats), fracs
