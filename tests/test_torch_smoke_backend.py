"""``chip_smoke.py``'s back-end-on runs, on the CPU.

The smoke's ``[backend]`` and ``[reloc]`` phases drive ``SlamConfig()`` as
shipped (back end on) on the card. These tests drive the same sequences and
configurations through the port on the CPU, where every wrapper runs its
plain version, and fix the bounds the smoke holds the card to: each bound
must be at least twice what the CPU run shows.
"""

import time

import numpy as np
import torch

import chip_smoke
import rgbid_tpu_torch as port

torch.set_num_threads(2)


def test_chip_smoke_backend_on_cpu():
    """The loop sequence with every gate of the back end at its default: a
    loop closure found through BoW (``LoopCloser.process_keyframe``), its
    edge against ground truth, the pose graph, the thread's bookkeeping."""
    frames, gt = chip_smoke.make_loop_sequence()
    cfg = chip_smoke.backend_config()
    assert cfg.backend == port.SlamConfig().backend and cfg.backend.enabled
    slam = port.SlamSystem(port.core.TUM_FR1, cfg, device="cpu")
    for f in frames:
        slam.process_frame(*f)
    slam.finish()
    be, lc, kfs = slam.backend, slam.backend.loop_closer, slam.manager.keyframes
    assert be.errors == 0 and not be.alive and be._queue.empty()
    assert len(kfs) >= chip_smoke.LOOP_MIN_KEYFRAMES and lc.n_queries == len(kfs)
    assert be.num_loop_closures >= 1 and lc.n_accepted == be.num_loop_closures
    idx = {kf.kf_id: int(round(kf.timestamp * 30.0)) for kf in kfs}
    for e in be._loop_edges:
        assert e["to_id"] - e["from_id"] >= cfg.backend.min_keyframe_gap
        T_gt = np.linalg.inv(gt[idx[e["from_id"]]]) @ gt[idx[e["to_id"]]]
        assert 2.0 * np.abs(e["T_rel"] - T_gt)[:3, 3].max() <= chip_smoke.LOOP_EDGE_TOL_M
    assert be.finalized == len(kfs) - 1 and slam.manager.host_reads == len(kfs)
    assert all(kf.cloud is not None and kf.descriptors is not None for kf in kfs)
    res = be.last_result
    assert res is not None and res["final_error"] <= res["initial_error"] + 1e-12
    assert 2.0 * chip_smoke.sequence_ate(gt, slam.poses()) <= chip_smoke.LOOP_ATE_BOUND_M
    # Every part of a keyframe event was timed, once per event.
    t = be.timings
    assert len(t["orb"]) == len(t["bow"]) == len(kfs) and len(t["finalize"]) == len(kfs) - 1
    assert len(t["score_pairs"]) == lc.scorer.host_reads and len(t["optimize"]) >= 1
    # The front end's records do not depend on the thread: the same run
    # with the back end off decides the same on every frame (a prefix with
    # four keyframe switches is enough here; the card's run compares all).
    off = port.SlamSystem(port.core.TUM_FR1, chip_smoke.loop_config(), device="cpu")
    for f in frames[:20]:
        off.process_frame(*f)
    off.finish()
    assert sum(bool(r.get("switch")) for r in off.stats) >= 3
    assert chip_smoke._frame_records(off.stats) == chip_smoke._frame_records(slam.stats)[:20]


def test_chip_smoke_reloc_on_cpu():
    """The relocalization run: the sweep, the dropout, then ``process_frame``
    itself relocalizes on the frame the tracker cannot place."""
    frames, gt, i_reloc = chip_smoke.make_reloc_sequence()
    assert i_reloc == chip_smoke.RELOC_FRAMES + 3 and len(frames) == i_reloc + 3
    slam = port.SlamSystem(port.core.TUM_FR1, port.SlamConfig(), device="cpu")
    for f in frames[:chip_smoke.RELOC_FRAMES]:
        slam.process_frame(*f)
    n_kf = len(slam.manager.keyframes)
    assert n_kf >= 3 and not any(s.get("lost") for s in slam.stats)
    # Wait until the thread has put the sweep's keyframes into the database.
    deadline = time.time() + 120
    while slam.backend.loop_closer.n_queries < n_kf - 1 and time.time() < deadline:
        time.sleep(0.05)
    assert slam.backend.loop_closer.n_queries == n_kf - 1
    for f in frames[chip_smoke.RELOC_FRAMES:]:
        slam.process_frame(*f)
    slam.finish()
    stats, be = slam.stats, slam.backend
    assert [i for i, s in enumerate(stats) if s.get("lost")] == list(
        range(chip_smoke.RELOC_FRAMES, i_reloc + 1))
    assert [i for i, s in enumerate(stats) if s.get("relocalized")] == [i_reloc]
    new = slam.manager.keyframes[stats[i_reloc]["kf_id"]]
    assert new.timestamp == frames[i_reloc][2]
    T_gt = np.linalg.inv(gt[0]) @ gt[i_reloc]
    assert 2.0 * np.linalg.norm(new.T_wk[:3, 3] - T_gt[:3, 3]) <= chip_smoke.RELOC_POSE_TOL_M
    for i in (i_reloc + 1, i_reloc + 2):
        err = np.linalg.norm(slam.poses()[i][:3, 3] - (np.linalg.inv(gt[0]) @ gt[i])[:3, 3])
        assert not stats[i]["lost"] and 2.0 * err <= chip_smoke.RELOC_POSE_TOL_M
    assert [e["to_id"] for e in be._loop_edges].count(new.kf_id) == 1
    assert be.errors == 0 and not be.alive
