"""The port's row-sharded tracker and sharded scorer on torch.distributed.

Counterpart of ``tests/test_parallel.py:168-410`` (the production tracker,
its strided and consensus cases and the attack probe's accept path under
``shard_map``, and the sharded scorer): here over gloo, 2 and 4 CPU ranks
started by ``parallel/launch.py::run_ranks``, each rank one process with
one thread. The ranks import no JAX: this module imports it only inside
the test that needs it.

Tolerances, sharded against the one-process port tracker (the JAX test's):
T within 2e-5 (5e-5 under the consensus), n_valid rtol 1e-6, overlap
rtol 1e-5, the streak counts equal. H: rtol 2e-4, and atol 1e-5 max |H|
(the smoke's rule for kernel sums) where the JAX test has 1e-6: H is a
per-pixel mean under Student-t weights of scale 1/sigma^2 (max |H| about
5.8e6 here), so the JAX test's 1e-6 is no slack at all on its
cancellation entries, whose float32 noise moves with the last bit of the
pose. Every rank's result is the same bits as every other's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import SlamConfig, TrackingConfig
from rgbid_tpu_torch.datasets import synthetic
from rgbid_tpu_torch.parallel.launch import run_ranks

PAIR_INTR = Intrinsics(fx=110.0, fy=110.0, cx=63.5, cy=127.5, width=128, height=256)
PROBE_INTR = Intrinsics(fx=258.6, fy=258.2, cx=159.5, cy=127.5, width=320, height=256)
RELOC_INTR = Intrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)


def _production_cfg(**kw):
    return TrackingConfig(levels=3, iters=(2, 4, 8), jacobian="esm", **kw)


def _probe_cfg(**kw):
    return dataclasses.replace(SlamConfig().override(**{"tracking.attack_probe": True}).tracking,
                               **kw)


def _cases(frames):
    """(name, intrinsics, config, template frame, current frame, T_init,
    T tolerance) of the four tracker cases."""
    pair, mover, probe = frames["pair"], frames["mover"], frames["probe"]
    return [
        ("production", PAIR_INTR, _production_cfg(), pair[0], pair[1], np.eye(4), 2e-5),
        ("strided", PAIR_INTR, _production_cfg(template_stride=(2, 2, 1)), pair[0], pair[1],
         np.eye(4), 2e-5),
        ("consensus", PAIR_INTR, _production_cfg(consensus=True, consensus_persist=1),
         mover[0], mover[1], np.eye(4), 5e-5),
        ("probe", PROBE_INTR, _probe_cfg(), probe[0], probe[1], frames["probe_T"], 5e-5),
    ]


def _pyramids(intr, cfg, f0, f1):
    from rgbid_tpu_torch.tracking.frames import keyframe_pyramid, preprocess_frame

    def pre(f):
        return preprocess_frame(torch.from_numpy(f[0]), torch.from_numpy(f[1].astype(np.int32)),
                                cfg.levels, esm=True)

    return keyframe_pyramid(pre(f0), intr, jacobian="esm"), pre(f1)


def _one_process(frames, **over):
    """Every case through the one-process port tracker (zero streak
    history, as the sharded tracker's default)."""
    from rgbid_tpu_torch.tracking.tracker import Tracker

    out = {}
    for name, intr, cfg, f0, f1, T0, _ in _cases(frames):
        cfg = dataclasses.replace(cfg, **over)
        kf, cur = _pyramids(intr, cfg, f0, f1)
        out[name] = Tracker(intr, cfg).track(kf, cur, torch.from_numpy(T0).float(),
                                             np.zeros((cfg.consensus_bins,), np.float32))
    return out


def _reloc_planes(frames):
    from rgbid_tpu_torch.reference_cpu import odometry as odo

    def planes(f):
        p = odo.preprocess_frame(f[0], f[1], 2)
        return {"intensity": p.intensity[1], "xi": p.xi[1], "mask": p.mask[1].astype(np.float32)}

    p0, p1, p2 = (planes(f) for f in frames["reloc"])
    # Three distinct pairs: (p0 -> p1), (p1 -> p0), (p0 -> a farther view).
    return [p0, p1, p0], [p1, p0, p2]


def _rank_main(rank, world, device, frames):
    """One rank: the four cases through ShardedTracker, the refusals, and
    the sharded scorer against the whole batch scored here."""
    from rgbid_tpu_torch.backend.relocalization import RelocScorer
    from rgbid_tpu_torch.parallel import ShardedTracker, make_mesh, shard_reloc_batch

    mesh = make_mesh(world, "sp")
    out = {"rank": mesh.get_local_rank()}
    for name, intr, cfg, f0, f1, T0, _ in _cases(frames):
        kf, cur = _pyramids(intr, cfg, f0, f1)
        st = ShardedTracker(mesh, intr, cfg)
        out[name] = st.track(kf, cur, torch.from_numpy(T0).float())
        out[name + "_allreduces"] = st.allreduces
    refused = {}
    bad = {
        # 250 rows: level 0 splits in 2 but not in 4, level 1 (125) in neither.
        "height": (Intrinsics(110.0, 110.0, 63.5, 124.5, 128, 250),
                   _production_cfg(template_stride=(1, 1, 1))),
        # Level 1 bands of 64 or 32 rows; stride 3 divides neither.
        "stride": (PAIR_INTR, _production_cfg(template_stride=(1, 3, 1))),
        "ic": (PAIR_INTR, dataclasses.replace(_production_cfg(), jacobian="ic")),
    }
    for key, (intr, cfg) in bad.items():
        try:
            ShardedTracker(mesh, intr, cfg)
            refused[key] = None
        except ValueError as e:
            refused[key] = str(e)
    out["refused"] = refused
    try:
        make_mesh(world + 1)
        out["mesh_refused"] = False
    except ValueError:
        out["mesh_refused"] = True
    cfg = SlamConfig().override(**{"tracking.levels": 3, "backend.reloc_level": 1,
                                   "backend.reloc_iters": 16})
    temps, curs = _reloc_planes(frames)
    scorer = RelocScorer(RELOC_INTR, cfg, "cpu")
    out["reloc_sharded"] = shard_reloc_batch(scorer, mesh, temps, curs)
    out["reloc_whole"] = scorer.score_pairs(temps, curs)
    return out


def _raise_on_rank_one(rank, world, device):
    if rank == 1:
        raise ValueError("rank one refuses")
    import torch.distributed as dist

    dist.barrier()
    return rank


@pytest.fixture(scope="module")
def frames():
    """The test_parallel.py clips, rendered once by the port's renderer (the
    JAX package's sequences: no Kinect artifacts)."""
    pair = synthetic.generate_sequence(n_frames=2, intr=PAIR_INTR, motion="orbit",
                                       trans_amp=0.12, rot_amp=0.04, seed=6)
    mover = synthetic.generate_sequence(n_frames=26, intr=PAIR_INTR, motion="orbit",
                                        trans_amp=0.12, rot_amp=0.04, moving_occluder=True,
                                        occluder_z=1.4, occluder_speed=0.067, seed=6)
    probe = synthetic.generate_sequence(n_frames=60, intr=PROBE_INTR, motion="orbit",
                                        trans_amp=0.25, rot_amp=0.08, xi_noise_sigma=0.005,
                                        moving_occluder=True, occluder_z=1.4, seed=3)
    scene = synthetic.make_scene(0)
    orbit = synthetic.orbit_trajectory(40, trans_amp=0.2, rot_amp=0.05)
    reloc = [synthetic.render_frame(scene, RELOC_INTR, T) for T in (np.eye(4), orbit[3],
                                                                   orbit[6])]

    def two(seq, i):
        return [(seq.rgb[j], seq.depth[j]) for j in (i, i + 1)]

    return {
        "pair": two(pair, 0),
        "mover": two(mover, 24),
        "probe": two(probe, 24),
        # The f23 -> f24 motion as the constant-velocity prior of f25.
        "probe_T": np.linalg.inv(probe.gt_poses[24]) @ probe.gt_poses[23],
        "pair_gt": np.linalg.inv(pair.gt_poses[1]) @ pair.gt_poses[0],
        "reloc": [(f[0], f[1]) for f in reloc],
    }


@pytest.fixture(scope="module")
def single(frames):
    return _one_process(frames)


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request, frames):
    return request.param, run_ranks(_rank_main, request.param, "gloo", "cpu", frames)


def _same_bits(a, b) -> bool:
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            return False
    return True


@pytest.mark.parametrize("case", ["production", "strided", "consensus", "probe"])
def test_sharded_tracker_matches_one_process(ranks, single, frames, case):
    world, results = ranks
    tol = {c[0]: c[-1] for c in _cases(frames)}[case]
    r1 = single[case]
    assert [r["rank"] for r in results] == list(range(world))
    for r in results[1:]:
        assert _same_bits(r[case], results[0][case]), f"rank {r['rank']} differs from rank 0"
    rn = results[0][case]
    np.testing.assert_allclose(rn.T.numpy(), r1.T.numpy(), atol=tol)
    H1 = r1.H.numpy()
    np.testing.assert_allclose(rn.H.numpy(), H1, rtol=2e-4, atol=1e-5 * np.abs(H1).max())
    np.testing.assert_allclose(rn.n_valid.numpy(), r1.n_valid.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(rn.overlap), float(r1.overlap), rtol=1e-5)
    np.testing.assert_array_equal(rn.cons_excluded, r1.cons_excluded)
    np.testing.assert_allclose(rn.consensus_frac, r1.consensus_frac, rtol=1e-5)
    assert rn.rescue == r1.rescue
    # Two all-reduces per IRLS iteration, the affine sums and kf_count at
    # least.
    assert results[0][case + "_allreduces"] >= 2 * sum(_cases(frames)[0][2].iters) + 2
    if case in ("production", "strided"):
        err = np.linalg.norm(rn.T.numpy()[:3, 3] - frames["pair_gt"][:3, 3])
        assert err < 5e-3, err


def test_consensus_and_probe_cases_exercise_their_paths(single, frames):
    """The consensus case flags the panel's stratum, and the attack probe
    fires and is accepted (the streak moves to a stratum the run without the
    probe does not flag, and the pose moves by more than 2 mm): the
    branches the sharded cases must take identically are taken."""
    assert single["consensus"].cons_excluded.max() > 0
    off = _one_process(frames, attack_probe=False)["probe"]
    on = single["probe"]
    assert on.cons_excluded.max() >= 1.0
    assert np.argmax(on.cons_excluded) != np.argmax(off.cons_excluded)
    assert np.linalg.norm((on.T - off.T).numpy()[:3, 3]) * 1e3 > 2.0


def test_sharded_reloc_equals_score_pairs(ranks):
    """Each pair's row bit for bit equal to ``score_pairs`` on the whole
    batch; the padding never shows; distinct pairs give distinct poses."""
    world, results = ranks
    for r in results:
        sharded, whole = r["reloc_sharded"], r["reloc_whole"]
        for f in range(len(whole)):
            assert sharded[f].shape == whole[f].shape
            np.testing.assert_array_equal(sharded[f], whole[f])
    Ts = results[0]["reloc_sharded"].T
    assert np.abs(Ts[0] - Ts[1]).max() > 1e-3 and np.abs(Ts[0] - Ts[2]).max() > 1e-3


def test_refusals_raise_value_error(ranks):
    """A level height the mesh does not divide, a band the stride does not
    divide, IC, and a mesh larger than the group."""
    world, results = ranks
    for r in results:
        refused = r["refused"]
        assert "not divisible by mesh size" in refused["height"]
        assert "not divisible by template_stride" in refused["stride"]
        assert "ESM" in refused["ic"]
        assert r["mesh_refused"]


def test_run_ranks_raises_a_rank_exception():
    with pytest.raises(ValueError, match="rank one refuses"):
        run_ranks(_raise_on_rank_one, 2, "gloo", "cpu")


SOLVE_CASES = {
    # case: (seed, n_valid, min_valid or None for the default, steps)
    "tracked": (0, 5000.0, None, True),
    "few valid": (1, 50.0, None, False),
    "not positive definite": (2, 5000.0, None, False),
    # The IC SPMD tracker's rule: any finite delta steps.
    "few valid, min_valid -inf": (1, 50.0, float("-inf"), True),
    "not positive definite, min_valid -inf": (2, 5000.0, float("-inf"), False),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_irls_solve_step_plain_equals_ic_update(case):
    """``irls_solve_step`` on the CPU is ``ic_update`` on the unpacked
    result, the same bits, in the fused layout, with the default
    ``min_valid`` (100) and with -inf, where only the factorization and
    finiteness hold the step; under the early exit it is ``prev``, bit for
    bit."""
    from rgbid_tpu_torch.ops import gauss_newton, kernels

    seed, n_valid, min_valid, steps = SOLVE_CASES[case]
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((6, 6)).astype(np.float32)
    H = A @ A.T + np.eye(6, dtype=np.float32)
    if "not positive definite" in case:
        H[0, 0] = -5.0
    res = gauss_newton.IrlsResult(
        torch.from_numpy(H), torch.from_numpy(rng.standard_normal(6).astype(np.float32) * 1e-2),
        torch.tensor(0.01), torch.tensor(0.002), torch.tensor(0.3), torch.tensor(n_valid),
        torch.tensor(0.9))
    T = torch.from_numpy(np.linalg.qr(rng.standard_normal((4, 4)))[0].astype(np.float32))
    T[3] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    vec = kernels.pack_result(res)
    kw = {} if min_valid is None else {"min_valid": min_valid}
    step = kernels.irls_solve_step(T, vec, 1e-4, **kw)
    T_ref, d_ref = gauss_newton.ic_update(T, res.H, res.b, 1e-4, res.n_valid, *kw.values())
    assert torch.equal(step.T, T_ref) and torch.equal(step.delta, d_ref)
    assert all(torch.equal(a, b) for a, b in zip(step.result, res))
    assert bool(step.delta.any()) == steps
    again = kernels.irls_solve_step(T, vec, 1e-4, prev=step, tol=1e3, **kw)
    assert torch.equal(again.out, step.out)


def test_allreduce_irls_one_rank_is_identity():
    """With one rank the weights are n / n = 1: the result comes back bit
    for bit (what makes the split iteration equal the fused one there)."""
    from rgbid_tpu_torch.ops import kernels

    v = torch.from_numpy(np.random.default_rng(3).standard_normal(48).astype(np.float32))
    v[42:44] = v[42:44].abs()
    v[45] = 12345.0
    v[47] = 0.0
    assert torch.equal(kernels.allreduce_irls(v, lambda t: t), v)
    # Two equal bands of n each: the mean is the band's, n doubles.
    two = kernels.allreduce_irls(v, lambda t: 2 * t)
    assert float(two[45]) == 2 * 12345.0
    np.testing.assert_allclose(two[:45].numpy(), v[:45].numpy(), rtol=1e-6)


def test_one_process_port_matches_jax_tracker(frames, single):
    """The one-process port tracker, the oracle of the sharded cases, on the
    production pair against the JAX package's ``Tracker`` (one compile):
    pose within 1e-4 m and 1e-4 rad, n_valid and overlap as the JAX test's
    sharded-versus-single tolerances."""
    import jax.numpy as jnp

    from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
    from rgbid_tpu.core.config import TrackingConfig as JTrackingConfig
    from rgbid_tpu.tracking.frames import keyframe_pyramid as j_kf
    from rgbid_tpu.tracking.frames import preprocess_frame as j_pre
    from rgbid_tpu.tracking.tracker import Tracker as JTracker

    intr = JIntrinsics(*PAIR_INTR)
    (rgb0, d0), (rgb1, d1) = frames["pair"]
    jkf = j_kf(j_pre(jnp.asarray(rgb0), jnp.asarray(d0), 3, esm=True), intr, jacobian="esm")
    jcur = j_pre(jnp.asarray(rgb1), jnp.asarray(d1), 3, esm=True)
    jcfg = JTrackingConfig(levels=3, iters=(2, 4, 8), jacobian="esm", kernel="xla")
    ref = JTracker(intr, jcfg).track(jkf, jcur, jnp.eye(4, dtype=jnp.float32),
                                     cons_prev=jnp.zeros((jcfg.consensus_bins,), jnp.float32))
    r1 = single["production"]
    D = np.linalg.inv(np.asarray(ref.T, np.float64)) @ r1.T.numpy().astype(np.float64)
    assert np.linalg.norm(D[:3, 3]) < 1e-4
    assert np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)) < 1e-4
    np.testing.assert_allclose(r1.n_valid.numpy(), np.asarray(ref.n_valid), rtol=1e-6)
    np.testing.assert_allclose(float(r1.overlap), float(ref.overlap), rtol=1e-5)
    np.testing.assert_array_equal(r1.cons_excluded, np.asarray(ref.cons_excluded))
