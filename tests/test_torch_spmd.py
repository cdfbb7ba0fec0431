"""The port's ``SpmdTracker`` on torch.distributed against the JAX package's.

Counterpart of ``tests/test_parallel.py:28-98``: the level-1 pair (QVGA,
120 x 160) of that file, its planes and IC Jacobian field made once with
the JAX package and handed to both trackers as numpy arrays. The port runs
over gloo on 1 and 4 CPU ranks (one spawn each, ``parallel/launch.py``),
the JAX tracker on 1 and 8 virtual devices. The ranks import no JAX: this
module imports it only inside fixtures and tests.

Tolerances: one iteration, T within 1e-5 and the scales within rtol 1e-4
of JAX on one device (the same sums taken in another order); ten
iterations, T within 5e-4, the JAX test's own tolerance for 1 against 8
devices, for each of the port's 1 and 4 ranks against each of JAX's 1 and
8 devices. Every rank returns the same bits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rgbid_tpu_torch.core.camera import Intrinsics, level_intrinsics
from rgbid_tpu_torch.parallel.launch import run_ranks
from rgbid_tpu_torch.reference_cpu import se3_np

INTR = Intrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
# Level 1: 120 x 160, 120 rows = 4 x 30 = 8 x 15.
INTR_L1 = level_intrinsics(INTR, 1)
# The JAX test's start: ~3 cm off ground truth.
START_TWIST = np.array([0.02, -0.015, 0.01, 0.008, -0.006, 0.01])
FEW = 90  # keyframe pixels left in the few-valid case
WORLDS = (1, 4)


def _tensors(planes, mask):
    t = {k: torch.from_numpy(v) for k, v in planes.items()}
    return (t["kf_int"], t["kf_xi"], torch.from_numpy(mask), t["jac"], t["cur_int"],
            t["cur_xi"], t["cur_mask"])


def _rank_main(rank, world, device, planes):
    """One rank: the cases through SpmdTracker, each with its all-reduce
    count, and the refusals."""
    from rgbid_tpu_torch.parallel import SpmdTracker, make_mesh

    mesh = make_mesh(world, "sp")
    args = _tensors(planes, planes["kf_mask"])
    few = _tensors(planes, planes["few_mask"])
    eye = torch.eye(4)
    start = torch.from_numpy(planes["T_start"])
    out = {"rank": mesh.get_local_rank()}
    for name, a, T0, iters in (("one", args, eye, 1), ("ten", args, eye, 10),
                               ("gt", args, start, 25), ("few", few, start, 1)):
        tr = SpmdTracker(mesh, INTR_L1)
        out[name] = tr.track(*a, T0, iters=iters)
        out[name + "_allreduces"] = tr.allreduces
    refused = {}
    odd = Intrinsics(INTR_L1.fx, INTR_L1.fy, INTR_L1.cx, INTR_L1.cy, 160, 122)
    try:
        SpmdTracker(mesh, odd)
        refused["height"] = None
    except ValueError as e:
        refused["height"] = str(e)
    try:
        SpmdTracker(mesh, INTR_L1).track(*(x[..., :80] for x in args), eye, iters=1)
        refused["shape"] = None
    except ValueError as e:
        refused["shape"] = str(e)
    out["refused"] = refused
    return out


@pytest.fixture(scope="module")
def planes():
    """The JAX test's level-1 pair, its IC field from the JAX package, the
    3 cm start and a mask with FEW keyframe pixels spread over the rows."""
    import jax.numpy as jnp

    from rgbid_tpu.datasets import synthetic
    from rgbid_tpu.ops import gauss_newton, image
    from rgbid_tpu.reference_cpu import odometry as odo

    scene = synthetic.make_scene(0)
    T1 = synthetic.orbit_trajectory(40, trans_amp=0.2, rot_amp=0.05)[3]
    f0 = synthetic.render_frame(scene, INTR, np.eye(4))
    f1 = synthetic.render_frame(scene, INTR, T1)
    p0 = odo.preprocess_frame(f0[0], f0[1], 2)
    p1 = odo.preprocess_frame(f1[0], f1[1], 2)
    T_gt = np.linalg.inv(T1)
    kf_int = jnp.asarray(p0.intensity[1])
    kf_xi = jnp.asarray(p0.xi[1])
    kf_mask = jnp.asarray(p0.mask[1], jnp.float32)
    gx_i, gy_i = image.gradients(kf_int, jnp.ones_like(kf_mask))
    gx_x, gy_x = image.gradients(kf_xi, kf_mask)
    jac = gauss_newton.template_jacobians(gx_i, gy_i, gx_x, gy_x, kf_xi, kf_mask, INTR_L1)
    mask = np.array(kf_mask)
    few = np.zeros_like(mask)
    idx = np.flatnonzero(mask)
    few.reshape(-1)[idx[np.linspace(0, len(idx) - 1, FEW).astype(int)]] = 1.0
    f32 = np.float32
    return {
        "kf_int": np.array(kf_int, f32), "kf_xi": np.array(kf_xi, f32), "kf_mask": mask,
        "jac": np.array(jac, f32), "cur_int": np.array(p1.intensity[1], f32),
        "cur_xi": np.array(p1.xi[1], f32), "cur_mask": np.array(p1.mask[1], f32),
        "few_mask": few, "T_gt": T_gt,
        "T_start": (se3_np.exp(START_TWIST) @ T_gt).astype(f32),
    }


@pytest.fixture(scope="module")
def jax_results(planes):
    """JAX ``SpmdTracker`` on 1 device (one and ten iterations, the
    few-valid pair) and on 8 (ten iterations)."""
    import jax.numpy as jnp

    from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
    from rgbid_tpu.parallel import SpmdTracker as JSpmdTracker
    from rgbid_tpu.parallel import make_mesh as j_make_mesh

    intr = JIntrinsics(*INTR_L1)

    def run(tr, mask, T0, iters):
        p = {k: jnp.asarray(v) for k, v in planes.items() if k not in ("T_gt",)}
        out = tr.track(p["kf_int"], p["kf_xi"], jnp.asarray(mask), p["jac"], p["cur_int"],
                       p["cur_xi"], p["cur_mask"], jnp.asarray(T0, jnp.float32), iters=iters)
        return tuple(np.asarray(x) for x in out)

    one, eight = JSpmdTracker(j_make_mesh(1, "sp"), intr), JSpmdTracker(j_make_mesh(8, "sp"), intr)
    eye = np.eye(4, dtype=np.float32)
    return {
        ("one", 1): run(one, planes["kf_mask"], eye, 1),
        ("ten", 1): run(one, planes["kf_mask"], eye, 10),
        ("ten", 8): run(eight, planes["kf_mask"], eye, 10),
        ("few", 1): run(one, planes["few_mask"], planes["T_start"], 1),
    }


@pytest.fixture(scope="module", params=WORLDS, ids=[f"{w} rank(s)" for w in WORLDS])
def ranks(request, planes):
    world = request.param
    return world, run_ranks(_rank_main, world, "gloo", "cpu", planes)


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_every_rank_returns_the_same_bits(ranks):
    world, results = ranks
    assert [r["rank"] for r in results] == list(range(world))
    for r in results[1:]:
        for case in ("one", "ten", "gt", "few"):
            assert _same_bits(r[case], results[0][case]), (case, r["rank"])


def test_one_iteration_matches_jax(ranks, jax_results):
    """Sigma step, normal equations and solve of one iteration, against
    the JAX tracker on one device."""
    world, results = ranks
    T, s2i, s2x = results[0]["one"]
    jT, js2i, js2x = jax_results[("one", 1)]
    np.testing.assert_allclose(T.numpy(), jT, atol=1e-5)
    np.testing.assert_allclose(float(s2i), float(js2i), rtol=1e-4)
    np.testing.assert_allclose(float(s2x), float(js2x), rtol=1e-4)
    # Three all-reduces an iteration: the scale's sums, then allreduce_irls.
    assert results[0]["one_allreduces"] == 3 and results[0]["ten_allreduces"] == 30


@pytest.mark.parametrize("jax_devices", [1, 8])
def test_ten_iterations_match_jax(ranks, jax_results, jax_devices):
    world, results = ranks
    T = results[0]["ten"][0].numpy()
    np.testing.assert_allclose(T, jax_results[("ten", jax_devices)][0], atol=5e-4)


def test_converges_to_ground_truth(ranks, planes):
    """The JAX test's 25 iterations from ~3 cm off: within 3e-3 of ground
    truth (the norm of the log), and the intensity scale below 0.01."""
    world, results = ranks
    T, s2i, _ = results[0]["gt"]
    err = se3_np.log(se3_np.inv(planes["T_gt"]) @ T.numpy().astype(np.float64))
    assert np.linalg.norm(err) < 3e-3
    assert float(s2i) < 0.01
    assert results[0]["gt_allreduces"] == 75


def test_few_valid_pixels_step_as_jax(ranks, jax_results, planes):
    """With at most 100 valid pixels the JAX tracker still steps (any
    finite delta); so does the port (``min_valid=-inf``), where
    ``ic_update``'s default would have held the pose."""
    from rgbid_tpu_torch.ops import kernels

    world, results = ranks
    T0 = planes["T_start"]
    T, _, _ = results[0]["few"]
    jT = jax_results[("few", 1)][0]
    jax_moved = np.abs(jT - se3_np.orthonormalize(T0.astype(np.float64))).max() > 1e-6
    assert jax_moved
    assert np.abs(T.numpy() - T0).max() > 1e-6
    np.testing.assert_allclose(T.numpy(), jT, atol=1e-4)
    # The same iteration in this process with ic_update's rule (n_valid >
    # 100) holds still. One thread, as a rank has: the CPU sums' order
    # depends on the thread count.
    from rgbid_tpu_torch.ops.warp import backproject_grid

    args = _tensors(planes, planes["few_mask"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pts = backproject_grid(args[1], INTR_L1)
        Tt = torch.from_numpy(T0)
        s2 = torch.tensor(0.01), torch.tensor(0.0025)
        st = kernels.ic_sigma_stats(Tt, args[0], pts, args[2], *args[4:], INTR_L1, 5.0, *s2)
        n = torch.clamp(st.n, min=1.0)
        res = kernels.ic_result(Tt, args[0], pts, args[2], args[3], *args[4:], INTR_L1, 5.0,
                                torch.clamp(st.swi / n, min=1e-12),
                                torch.clamp(st.swx / n, min=1e-12))
        held = kernels.irls_solve_step(Tt, res, 1e-6)
        stepped = kernels.irls_solve_step(Tt, res, 1e-6, min_valid=float("-inf"))
    finally:
        torch.set_num_threads(threads)
    assert 6 < float(res[45]) <= 100
    assert not bool(held.delta.any()) and bool(stepped.delta.any())
    if world == 1:
        assert torch.equal(stepped.T, T)


def test_refusals_raise_value_error(ranks):
    """A height the mesh does not divide (at 4 ranks: 122 rows), and planes
    of another size than the level's."""
    world, results = ranks
    for r in results:
        if world == 4:
            assert "not divisible by mesh size" in r["refused"]["height"]
        else:
            assert r["refused"]["height"] is None
        assert "must be the level's" in r["refused"]["shape"]
