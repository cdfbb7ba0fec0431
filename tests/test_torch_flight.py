"""Flights in the port: the per-frame step with every branch on the device.

Per setting of the branches the tracker and the step predicate (the six
that used to be checked by hand), the port's step against the JAX
package's on the walking-mover clip of ``tests/test_consensus.py``, with
the JAX state injected into the port before every frame; ``feed`` in
flights against the ``process_frame`` loop (bit for bit) and against the
JAX package's ``feed``; pose-graph updates applied only at a flight's
start; a relocalization inside a flight replaying the rest of it; and the
step making no host read (a dispatch mode that fails on every operator
that reads a tensor's value back).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import rgbid_tpu_torch as port
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.system import SlamSystem as JSlamSystem
from rgbid_tpu.tracking.step import MotionState as JMotionState
from rgbid_tpu.tracking.step import ProcessFrame as JProcessFrame
from rgbid_tpu.tracking.step import StepResult as JStepResult
from rgbid_tpu.tracking.step import pack_frame as j_pack
from rgbid_tpu_torch import convert
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.tracking.step import MotionState, ProcessFrame, StepResult, pack_frame

torch.set_num_threads(2)

K = 6
QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.5, cy=119.5, width=320, height=240)
MOVER_CFG = {"backend.enabled": False, "fusion.fuse_every": 1}

# The branch settings, each a case of the per-frame parity test.
SETTINGS = {
    "attack_probe_off": {"tracking.attack_probe": False},
    "rescue_refound_off": {"tracking.rescue_refound": False},
    "fusion_off": {"fusion.enabled": False},
    "gate_and_affine_off": {"tracking.occlusion_gate": False,
                            "tracking.affine_illumination": False},
    "geometric_off": {"tracking.use_geometric": False},
    "grow_off_fuse_every_3": {"fusion.grow_validity": False, "fusion.fuse_every": 3},
}


def _cfg(**extra):
    cfg = JSlamConfig().override(**{**MOVER_CFG, **extra})
    return cfg.override(**{"tracking.consensus_xi_min": 1.0 / cfg.max_depth,
                           "tracking.consensus_xi_max": 1.0 / cfg.min_depth})


@pytest.fixture(scope="module")
def mover_clip():
    """tests/test_consensus.py's walking-mover clip: a near-field panel at
    1.4 m crossing at 0.015 m/frame, QVGA, 40 frames."""
    return synthetic.generate_sequence(
        n_frames=40, intr=QVGA, motion="orbit", trans_amp=0.25, rot_amp=0.08,
        xi_noise_sigma=0.005, moving_occluder=True, occluder_z=1.4, occluder_speed=0.015, seed=1,
    )


@pytest.fixture(scope="module")
def rigid_clip():
    return synthetic.generate_sequence(n_frames=17, intr=QVGA, motion="orbit", trans_amp=0.18,
                                       rot_amp=0.05, xi_noise_sigma=0.003, seed=2)


# ---------------------------------------------------------------------------
# (1) the branch settings against the JAX step, frame by frame


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_step_branches_match_jax_per_frame(mover_clip, setting):
    """One JAX system per setting runs the clip; before each frame its
    keyframe and motion state go into the port's step, and both run the
    frame: equal switch, lost, guard and rescue flags, stress-flag counts,
    whether the frame fused, the fusion count of the next keyframe state
    and the new streak counts; consensus_frac within 1e-6 relative, the
    pose within 1e-5 (the per-frame test of tests/test_torch_consensus.py,
    whose measured agreement is 1e-6)."""
    cfg = _cfg(**SETTINGS[setting])
    packed = [j_pack(f.rgb, f.depth, cfg) for f in mover_clip.frames()]
    jstep = JProcessFrame(QVGA, cfg)
    pstep = ProcessFrame(Intrinsics(*QVGA), port.SlamConfig.from_json(cfg.to_json()), "cpu")
    kf = jstep.init_keyframe(jnp.asarray(packed[0]))
    m = JMotionState.initial(K)
    switches = fused = 0
    for i in range(1, len(packed)):
        jvec, kf2, m2 = jstep(jnp.asarray(packed[i]), kf, m)
        jr = JStepResult.unpack(np.asarray(jvec), 4)
        tkf = convert.keyframe_from_reference(jax.tree_util.tree_map(np.asarray, kf), "cpu")
        tm = convert.motion_from_reference(jax.tree_util.tree_map(np.asarray, m), "cpu")
        tvec, tkf2, tm2 = pstep(torch.from_numpy(packed[i]), tkf, tm)
        tr = StepResult.unpack(tvec, 4)
        for f in ("switch", "lost", "rescue", "cons_flags", "cons_flags_persist", "guard_fired"):
            assert getattr(tr, f) == getattr(jr, f), (i, f)
        assert (tr.n_fused > 0) == (jr.n_fused > 0), i
        assert int(tkf2.fused_count) == int(kf2.fused_count), i
        np.testing.assert_allclose(tr.consensus_frac, jr.consensus_frac, rtol=1e-6, err_msg=str(i))
        np.testing.assert_array_equal(tm2.cons_excluded.numpy(), np.asarray(m2.cons_excluded),
                                      err_msg=str(i))
        np.testing.assert_allclose(tr.T, jr.T, atol=1e-5, err_msg=str(i))
        switches += int(tr.switch > 0.5)
        fused += int(tr.n_fused > 0)
        kf, m = kf2, m2
    assert switches >= 1
    assert fused == 0 if setting == "fusion_off" else fused >= 3


# ---------------------------------------------------------------------------
# (2) feed in flights


def _records(stats):
    return [{k: v for k, v in rec.items() if k != "ms"} for rec in stats]


def _loop(frames, over):
    slam = port.SlamSystem(Intrinsics(*QVGA), port.SlamConfig().override(**over), device="cpu")
    for f in frames:
        slam.process_frame(f.rgb, f.depth, f.timestamp)
    slam.finish()
    return slam


@pytest.fixture(scope="module")
def loops(mover_clip, rigid_clip):
    return {name: _loop(list(clip.frames()), MOVER_CFG)
            for name, clip in (("mover", mover_clip), ("rigid", rigid_clip))}


@pytest.mark.parametrize("clip,depth", [("mover", 4), ("mover", 8), ("rigid", 4), ("rigid", 8)])
def test_feed_equals_process_frame_loop(mover_clip, rigid_clip, loops, clip, depth):
    """``feed(flight_depth=k)`` against the ``process_frame`` loop on the
    same system configuration: poses, per-frame records, keyframes, edges
    and consensus counts equal bit for bit, and one host read per flight
    plus one per finalize."""
    frames = list((mover_clip if clip == "mover" else rigid_clip).frames())
    ref = loops[clip]
    slam = port.SlamSystem(Intrinsics(*QVGA), port.SlamConfig().override(**MOVER_CFG),
                           device="cpu")
    poses = slam.feed(frames, flight_depth=depth)
    slam.finish()
    assert all(np.array_equal(a, b) for a, b in zip(poses, ref.poses()))
    assert _records(slam.stats) == _records(ref.stats)
    assert slam.tracker_counts == ref.tracker_counts
    assert [kf.T_wk.tolist() for kf in slam.manager.keyframes] == [
        kf.T_wk.tolist() for kf in ref.manager.keyframes]
    for a, b in zip(slam.manager.keyframes, ref.manager.keyframes):
        for k in ("intensity", "xi", "mask"):
            np.testing.assert_array_equal(a.reloc_planes[k], b.reloc_planes[k])
    tracked = len(frames) - 1
    flights = -(-tracked // depth)
    assert slam._step.host_reads == flights
    assert slam.host_reads == flights + slam.manager.host_reads
    assert ref._step.host_reads == tracked
    if clip == "mover":
        assert max(r["consensus_frac"] for r in slam.stats[1:]) > 0.05


def test_feed_matches_jax_feed(mover_clip):
    """The port's ``feed`` against the JAX package's at the same
    ``pipeline_depth`` (8), back end off: switch and lost equal per frame,
    world poses within the whole-system bound of tests/test_torch_slice.py
    (1e-4 m / 1e-4 rad)."""
    frames = list(mover_clip.frames())
    over = {**MOVER_CFG, "pipeline_depth": 8}
    js = JSlamSystem(QVGA, JSlamConfig().override(**over))
    jposes = js.feed(frames)
    ps = port.SlamSystem(Intrinsics(*QVGA), port.SlamConfig().override(**over), device="cpu")
    pposes = ps.feed(frames)
    assert len(jposes) == len(pposes) == len(frames)
    for i, (a, b) in enumerate(zip(jposes, pposes)):
        sj, sp = js.stats[i], ps.stats[i]
        assert sj.get("switch") == sp.get("switch") and sj.get("lost") == sp.get("lost"), i
        D = np.linalg.inv(a) @ b
        assert np.linalg.norm(D[:3, 3]) < 1e-4, i
        assert np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)) < 1e-4, i
    assert sum(bool(s.get("switch")) for s in ps.stats) >= 2


class _StubBackend:
    """A back end with no thread: it publishes one pose update when the
    front end has dispatched ``publish_at`` frames, and records when the
    front end takes it; relocalization is stubbed by the system."""

    def __init__(self, slam, publish_at: int):
        self.slam, self.publish_at = slam, publish_at
        self.taken_at = []
        self.submitted = []

    def has_updates(self) -> bool:
        return self.slam._dispatches >= self.publish_at and not self.taken_at

    def take_updates(self):
        self.taken_at.append(len(self.slam.stats))
        T = np.eye(4)
        T[0, 3] = 0.01
        return {0: T}

    def submit(self, kf, retired=None):
        self.submitted.append(kf.kf_id)

    def finish(self):
        pass

    def add_external_loop_edge(self, edge):
        pass


class _CountingSystem(port.SlamSystem):
    """Counts its dispatches."""

    _dispatches = 0

    def _dispatch(self, *a, **k):
        self._dispatches += 1
        return super()._dispatch(*a, **k)


def test_pose_update_applied_at_the_next_flight(rigid_clip):
    """An update published while the second flight of 4 is in flight
    (after the sixth dispatch) is taken at the start of the third flight,
    when 9 frames (the bootstrap and two flights) are recorded, and moves
    the recorded trajectory of keyframe 0's frames; a process_frame loop
    takes it before the very next frame."""
    frames = list(rigid_clip.frames())[:13]
    over = {"backend.enabled": False, "keyframe.max_translation": 10.0,
            "keyframe.max_rotation": 10.0, "keyframe.min_overlap": 0.0,
            "keyframe.max_pose_sigma": 10.0}
    slam = _CountingSystem(Intrinsics(*QVGA), port.SlamConfig().override(**over), device="cpu")
    slam.backend = _StubBackend(slam, publish_at=6)
    slam.feed(frames, flight_depth=4)
    assert slam.backend.taken_at == [9]
    assert len(slam.manager.keyframes) == 1
    loop = _CountingSystem(Intrinsics(*QVGA), port.SlamConfig().override(**over), device="cpu")
    loop.backend = _StubBackend(loop, publish_at=6)
    for f in frames:
        loop.process_frame(f.rgb, f.depth, f.timestamp)
    assert loop.backend.taken_at == [7]
    # Every frame rode keyframe 0, so the update moved the whole recorded
    # trajectory by the same correction.
    np.testing.assert_allclose(slam.poses()[0][0, 3], 0.01, atol=1e-12)


def test_relocalization_in_flight_replays_the_rest(rigid_clip):
    """A dropout frame (no depth: lost) in the middle of a flight of 8,
    with the back end's relocalization stubbed to succeed once (it founds a
    keyframe, as the real one does, here from the last good frame): the
    frames after it in the flight are discarded and dispatched again
    against the new state, and the run equals a process_frame loop bit for
    bit."""
    frames = [(f.rgb, f.depth.copy(), f.timestamp) for f in rigid_clip.frames()][:14]
    frames[5] = (frames[5][0], np.zeros_like(frames[5][1]), frames[5][2])
    over = {"backend.enabled": False, "backend.reloc_after_lost": 1}

    def run(flight_depth):
        slam = _CountingSystem(Intrinsics(*QVGA), port.SlamConfig().override(**over),
                               device="cpu")
        slam.backend = _StubBackend(slam, publish_at=10**9)
        good = frames[4]

        def reloc(rgb, depth, t, packed):
            # Once, from the last good frame's upload, at the lost frame's
            # pose estimate (the keyframe's).
            if any(r.get("relocalized") for r in slam.stats):
                return None
            T_wc = slam.T_wk.copy()
            up = slam._upload(pack_frame(good[0], good[1], slam.config))
            slam._found_keyframe(up, t, T_wc, good[0], good[1])
            return T_wc

        slam._try_relocalize = reloc
        if flight_depth:
            poses = slam.feed(frames, flight_depth=flight_depth)
        else:
            poses = [slam.process_frame(*f) for f in frames]
        return slam, poses

    flight, fposes = run(8)
    loop, lposes = run(0)
    assert [r.get("relocalized") for r in flight.stats] == [r.get("relocalized")
                                                             for r in loop.stats]
    assert sum(bool(r.get("relocalized")) for r in flight.stats) == 1
    assert all(np.array_equal(a, b) for a, b in zip(fposes, lposes))
    assert _records(flight.stats) == _records(loop.stats)
    # 13 tracked frames, the flight of 8 holding the lost frame 5: frames
    # 6..8 dispatched twice.
    assert flight._dispatches == 13 + 3
    # One read for the first flight, one per replayed frame, one for the
    # second flight.
    assert flight._step.host_reads == 1 + 3 + 1
    # The flight log counts each frame once: the replayed frames add their
    # dispatches, reads and handling to their flight's row.
    rows = flight.flights()
    assert list(rows["frames"]) == [1, 8, 5]
    assert list(rows["dispatch_n"]) == [1, 8 + 3, 5]
    assert list(rows["wait_n"]) == [0, 1 + 3, 1]
    assert list(rows["handle_n"]) == [1, 8, 5]


# ---------------------------------------------------------------------------
# (3) no host read in the step


class _NoRead(TorchDispatchMode):
    """Fails on every operator that brings a tensor's value to the host."""

    READS = {"_local_scalar_dense", "nonzero", "is_nonzero"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.READS:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("over", [{}, {"tracking.div_rescue": True,
                                       "tracking.divergence_guard": True,
                                       "tracking.early_exit_tol": 1e-5,
                                       "fusion.fuse_every": 3}],
                         ids=["default", "div_rescue+guard+early_exit"])
def test_step_makes_no_host_read(mover_clip, over):
    """``ProcessFrame.__call__`` over the mover clip's frames 20-27 (the
    consensus active: votes, reruns, the rescue pyramid enqueued) under a
    dispatch mode that fails on ``aten._local_scalar_dense``,
    ``aten.nonzero`` and ``aten.is_nonzero``: silent."""
    cfg = port.SlamConfig().override(**{**MOVER_CFG, **over})
    frames = list(mover_clip.frames())
    step = ProcessFrame(Intrinsics(*QVGA), cfg, "cpu", retire=(2, 2))
    kf = step.init_keyframe(torch.from_numpy(pack_frame(frames[18].rgb, frames[18].depth, cfg)))
    m = MotionState.initial("cpu", K)
    vecs = []
    for f in frames[20:28]:
        packed = torch.from_numpy(pack_frame(f.rgb, f.depth, cfg))
        with _NoRead():
            vec, kf, m = step(packed, kf, m)
        vecs.append(vec)
    res = [StepResult.unpack(v, 4) for v in vecs]
    assert all(np.isfinite(r.T).all() for r in res)
    assert step.host_reads == 0
