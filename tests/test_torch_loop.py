"""The port's ``SlamSystem`` with the back end on, on the CPU.

The port has no ORB extractor yet, so ``backend.enabled=True`` raises at
construction. These tests lift that the way a later ORB port will: they put
the JAX package's OpenCV extractor in the place of
``rgbid_tpu_torch.backend.features.extract_orb`` and set the flag
``check_supported`` reads (``features.SUPPORTED``). Everything else is the
port's own: the thread, deferred finalization, the BoW database, the scorer
on ``esm_irls_step``'s plain version, the pose graph, the publication of
corrected poses and relocalization.

The clips, configurations and assertions are those of
``tests/test_loop_closure.py`` and ``tests/test_relocalization_recovery.py``
(which run the JAX package), plus what the port adds: the thread's error
count stays 0 and the thread is dead after ``finish()``.
"""

import time

import numpy as np
import pytest
import torch

import rgbid_tpu_torch as port
from rgbid_tpu.backend.features import extract_orb as cv2_extract_orb
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.datasets import synthetic
from rgbid_tpu_torch.backend import features
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.eval import absolute_trajectory_error
from rgbid_tpu_torch.reference_cpu import se3_np
from rgbid_tpu_torch.tracking.step import pack_frame

torch.set_num_threads(2)

QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
INTR = Intrinsics(*QVGA)


@pytest.fixture(scope="module")
def orb_lifted():
    """OpenCV's ORB in the port's extractor's place, for this module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(features, "extract_orb", cv2_extract_orb)
    mp.setattr(features, "SUPPORTED", True)
    yield
    mp.undo()


LOOP_CFG = {
    "tracking.levels": 3,
    "tracking.iters": (4, 8, 16),
    "keyframe.max_translation": 0.12,
    "keyframe.max_rotation": 0.12,
    "keyframe.min_overlap": 0.80,
    "backend.enabled": True,
    "backend.min_keyframe_gap": 5,
    "backend.reloc_level": 1,
    "backend.reloc_iters": 16,
    "backend.min_score": 0.05,
}


@pytest.fixture(scope="module")
def run(orb_lifted):
    """tests/test_loop_closure.py's clip: a closed loop with noisy depth
    that revisits its start, keyframe thresholds tight enough for the BoW
    temporal gap."""
    seq = synthetic.generate_sequence(n_frames=40, intr=QVGA, motion="loop", radius=0.5,
                                      rot_amp=0.15, xi_noise_sigma=0.004, seed=2)
    slam = port.SlamSystem(INTR, port.SlamConfig().override(**LOOP_CFG), device="cpu")
    for f in seq.frames():
        slam.process_frame(f.rgb, f.depth, f.timestamp)
    slam.finish()
    return seq, slam


def test_back_end_raises_at_construction_without_orb():
    """Runs before the module's ORB lift is set up (it asks for no fixture)."""
    assert not features.SUPPORTED
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #3"):
        port.SlamSystem(INTR, port.SlamConfig().override(**LOOP_CFG), device="cpu")


def test_loop_closures_found(run):
    _, slam = run
    assert slam.backend is not None
    assert slam.backend.num_loop_closures >= 1
    for e in slam.backend._loop_edges:
        assert e["to_id"] - e["from_id"] >= 5
        assert np.all(np.isfinite(e["T_rel"]))


def test_thread_healthy_and_dead_after_finish(run):
    _, slam = run
    assert slam.backend.errors == 0
    assert not slam.backend.alive
    assert slam.backend._queue.empty()


def test_pose_graph_ran_and_reduced_error(run):
    _, slam = run
    res = slam.backend.last_result
    assert res is not None, "pose graph never ran"
    assert res["final_error"] <= res["initial_error"] + 1e-12


def test_trajectory_still_accurate_after_optimization(run):
    seq, slam = run
    gt0 = np.linalg.inv(seq.gt_poses[0])
    ate = absolute_trajectory_error([gt0 @ T for T in seq.gt_poses], slam.poses())
    assert ate["rmse"] < 0.012


def test_backend_stats_and_deferred_finalize(run):
    """One BoW query per keyframe; every keyframe was finalized (all but
    the last by the thread, from the retained device state), one packed
    read each; the scorer read once per call and launched no kernel on the
    CPU."""
    _, slam = run
    lc = slam.backend.loop_closer
    kfs = slam.manager.keyframes
    assert lc.n_queries == len(kfs)
    assert lc.n_accepted <= lc.n_candidates
    for kf in kfs:
        assert kf.cloud is not None and len(kf.cloud) > 1000
        assert kf.reloc_planes is not None and kf.descriptors is not None and kf.bow
    assert slam.manager.host_reads == len(kfs)
    assert len(slam.manager.edges) == len(kfs) - 1
    sc = lc.scorer
    assert sc.host_reads >= 1 and sc.launches == 0
    assert sc.irls_steps == 3 * 16 * lc.n_candidates
    assert slam.host_reads == slam._step.host_reads + len(kfs) + sc.host_reads


def test_midrun_pose_publication(run):
    """Corrected poses are applied live (consume-once), not only at finish:
    an injected update rebases the active keyframe and the recorded
    trajectory on the next frame."""
    seq, slam = run
    active = slam.manager.active
    old_T = active.T_wk.copy()
    corr = se3_np.exp(np.array([0.05, -0.02, 0.01, 0.0, 0.01, 0.0]))
    with slam.backend._lock:
        slam.backend._optimized = {active.kf_id: corr @ old_T}
    traj_before = slam.poses()[-1].copy()
    slam.process_frame(seq.rgb[-1], seq.depth[-1], 99.0)
    np.testing.assert_allclose(active.T_wk, corr @ old_T, atol=1e-12)
    assert not slam.backend.has_updates()
    np.testing.assert_allclose(slam.poses()[-2], corr @ traj_before, atol=1e-9)


def test_optimize_tolerates_concurrent_keyframe_append(run):
    """An edge referencing a keyframe appended after the pose snapshot is
    dropped, not passed to the solver."""
    _, slam = run
    backend = slam.backend
    n = len(slam.manager.keyframes)
    bogus = {"from_id": n - 1, "to_id": n + 5, "T_rel": np.eye(4), "information": np.eye(6)}
    backend._loop_edges.append(bogus)
    try:
        backend._optimize()  # must not raise
        assert backend.has_updates()
    finally:
        backend._loop_edges.remove(bogus)
        backend.take_updates()


def test_thread_counts_a_swallowed_exception(orb_lifted, monkeypatch):
    """An exception in the per-keyframe work does not kill the thread; it
    is counted, the queue keeps draining and ``finish`` returns."""
    cfg = port.SlamConfig().override(**LOOP_CFG)
    seq = synthetic.generate_sequence(n_frames=2, intr=QVGA, motion="orbit", seed=1)
    slam = port.SlamSystem(INTR, cfg, device="cpu")
    slam.process_frame(seq.rgb[0], seq.depth[0], 0.0)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(slam.backend.loop_closer, "process_keyframe", boom)
    slam.finish()
    assert slam.backend.errors == 1 and not slam.backend.alive
    # reset() replaces the thread and clears the count.
    monkeypatch.undo()
    old = slam.backend
    slam.reset()
    assert slam.backend is not old and slam.backend.alive and slam.backend.errors == 0
    assert slam.manager.keyframes == [] and slam.stats == []
    slam.finish()
    assert not slam.backend.alive


def test_relocalizes_after_sensor_dropout(orb_lifted):
    """tests/test_relocalization_recovery.py on the port: keyframes enter
    the BoW database, a sensor dropout loses tracking, and the recovery
    path finds the pose of an early view within 3 cm, founds a keyframe
    there, resumes tracking and leaves its loop edge in the graph."""
    cfg = port.SlamConfig().override(**{
        "tracking.levels": 3,
        "tracking.iters": (4, 8, 16),
        "keyframe.max_translation": 0.12,
        "keyframe.max_rotation": 0.12,
        "backend.enabled": True,
        "backend.min_keyframe_gap": 3,
        "backend.reloc_level": 1,
        "backend.reloc_iters": 16,
        "backend.min_score": 0.02,
        "backend.reloc_after_lost": 2,
    })
    seq = synthetic.generate_sequence(n_frames=16, intr=QVGA, motion="orbit", trans_amp=0.35,
                                      rot_amp=0.1, xi_noise_sigma=0.003, seed=2)
    slam = port.SlamSystem(INTR, cfg, device="cpu")
    for i in range(12):
        slam.process_frame(seq.rgb[i], seq.depth[i], seq.timestamps[i])
    n_kfs_before = len(slam.manager.keyframes)
    assert n_kfs_before >= 3
    deadline = time.time() + 60
    while time.time() < deadline and slam.backend.loop_closer.n_queries < n_kfs_before - 1:
        time.sleep(0.05)
    assert slam.backend.loop_closer.n_queries == n_kfs_before - 1

    # Sensor dropout (all-invalid depth + noise image) -> lost; the noise
    # frames find no candidate, so nothing relocalizes yet.
    rng = np.random.default_rng(0)
    noise_rgb = rng.integers(0, 255, seq.rgb[0].shape, dtype=np.uint8)
    zero_depth = np.zeros_like(seq.depth[0])
    for k in range(3):
        slam.process_frame(noise_rgb, zero_depth, 1.0 + 0.03 * k)
    assert slam.stats[-1]["lost"]
    assert slam.stats[-1]["relocalized"] is False
    assert slam._lost_count == 3

    # The recovery path, driven with a frame showing an early view.
    packed = torch.from_numpy(pack_frame(seq.rgb[2], seq.depth[2], slam.config))
    T_back = slam._try_relocalize(seq.rgb[2], seq.depth[2], 2.0, packed)
    assert T_back is not None
    gt = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses[2]
    err = np.linalg.norm(T_back[:3, 3] - gt[:3, 3])
    assert err < 0.03, err
    assert len(slam.manager.keyframes) == n_kfs_before + 1
    T_next = slam.process_frame(seq.rgb[3], seq.depth[3], 2.1)
    assert not slam.stats[-1]["lost"]
    gt3 = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses[3]
    assert np.linalg.norm(T_next[:3, 3] - gt3[:3, 3]) < 0.03
    slam.finish()
    assert slam.backend.num_loop_closures >= 1
    assert slam.backend.errors == 0 and not slam.backend.alive


# ---------------------------------------------------------------------------
# The bookkeeping the front end keeps with the back end off


@pytest.fixture(scope="module")
def frontend_run():
    """tests/test_system_frontend.py's clip on the port, back end off."""
    cfg = port.SlamConfig().override(**{
        "tracking.levels": 3, "tracking.iters": (4, 8, 16), "keyframe.max_translation": 0.12,
        "keyframe.max_rotation": 0.12, "backend.enabled": False})
    seq = synthetic.generate_sequence(n_frames=20, intr=QVGA, motion="orbit", trans_amp=0.3,
                                      rot_amp=0.08, xi_noise_sigma=0.003, seed=3)
    slam = port.SlamSystem(INTR, cfg, device="cpu")
    for f in seq.frames():
        slam.process_frame(f.rgb, f.depth, f.timestamp)
    slam.finish()
    return seq, slam


def test_keyframes_created_and_finalized(frontend_run):
    _, slam = frontend_run
    kfs = slam.manager.keyframes
    assert slam.backend is None and len(kfs) >= 2
    for kf in kfs:
        assert kf.cloud is not None and len(kf.cloud) > 1000
        assert kf.reloc_planes is not None
    assert len(slam.manager.edges) == len(kfs) - 1
    for e in slam.manager.edges:
        assert e.to_id == e.from_id + 1
        assert np.all(np.isfinite(e.information))
    assert slam.manager.host_reads == len(kfs)  # one packed read per finalize


def test_stats_carry_relocalized_and_edges_follow_switches(frontend_run):
    _, slam = frontend_run
    assert all(s["relocalized"] is False for s in slam.stats[1:])
    switches = [s for s in slam.stats if s.get("switch")]
    assert len(switches) == len(slam.manager.edges)
    # T_rel = inv(T_ck) of the switch frame: chaining the edges gives the
    # keyframe poses.
    T = np.eye(4)
    for e, kf in zip(slam.manager.edges, slam.manager.keyframes[1:]):
        T = T @ e.T_rel
        np.testing.assert_allclose(T, kf.T_wk, atol=1e-9)


# ---------------------------------------------------------------------------
# chip_smoke.py's loop run, on the CPU


def test_chip_smoke_loop_on_cpu():
    """``chip_smoke.py``'s loop sequence (VGA, a closed path) tracked by the
    port on the CPU with the smoke's configuration, then ``close_loop`` with
    the scorer on the CPU: what the smoke then asks of the card. This run
    fixes the smoke's bounds: the ATE stays under half of LOOP_ATE_BOUND_M,
    and the pose graph moves the keyframe ATE by less than half of
    LOOP_PG_MARGIN_M."""
    import chip_smoke

    frames, gt = chip_smoke.make_loop_sequence()
    np.testing.assert_allclose(gt[-1], gt[0], atol=1e-12)  # the path closes
    slam = port.SlamSystem(port.core.TUM_FR1, chip_smoke.loop_config(), device="cpu")
    for f in frames:
        slam.process_frame(*f)
    slam.finish()
    kfs = slam.manager.keyframes
    assert len(kfs) >= chip_smoke.LOOP_MIN_KEYFRAMES
    assert len(slam.manager.edges) == len(kfs) - 1
    assert not any(s.get("lost") for s in slam.stats)
    assert 2.0 * chip_smoke.sequence_ate(gt, slam.poses()) <= chip_smoke.LOOP_ATE_BOUND_M
    out = chip_smoke.close_loop(slam, gt, "cpu")
    assert out["accepted"], out["margins"]
    assert out["finite"] and out["reads"] == 1 and out["launches"] == 0
    assert out["n_edges"] == len(kfs)
    assert out["final_error"] <= out["initial_error"] + 1e-12
    assert out["edge_err"] < 2e-3
    assert 2.0 * abs(out["ate_after"] - out["ate_before"]) <= chip_smoke.LOOP_PG_MARGIN_M, out
