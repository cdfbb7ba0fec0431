"""The port's snapshot / resume (``rgbid_tpu_torch/utils/snapshot.py``):
``tests/test_cli_and_snapshot.py``'s two snapshot tests against the port,
the file's keys, shapes and dtypes against the JAX package's file for the
same run configuration, the keyframe-state leaf order against
``jax.tree_util.tree_flatten`` of the JAX package's state, and a snapshot
moved between the packages in both directions: each then tracks the
remaining frames within the per-frame tolerance of
``tests/test_torch_slice.py::test_system_matches_jax_per_frame`` (1e-4 m,
1e-4 rad) of the run that was not interrupted."""

import json

import jax
import numpy as np
import pytest
import torch

import rgbid_tpu_torch as port
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.system import SlamSystem as JSlamSystem
from rgbid_tpu.utils import snapshot as jsnapshot
from rgbid_tpu_torch import convert
from rgbid_tpu_torch.datasets import synthetic
from rgbid_tpu_torch.utils import snapshot

torch.set_num_threads(2)

QVGA = port.Intrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
SMALL = {"tracking.levels": 3, "tracking.iters": (4, 8, 16), "backend.enabled": False}
N_FRAMES, SAVE_AT = 12, 8


def _pose_close(a, b, i):
    D = np.linalg.inv(a) @ b
    assert np.linalg.norm(D[:3, 3]) < 1e-4, i
    assert np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)) < 1e-4, i


@pytest.fixture(scope="module")
def orbit():
    return synthetic.generate_sequence(n_frames=N_FRAMES, intr=QVGA, motion="orbit",
                                       trans_amp=0.3, rot_amp=0.08, seed=4)


def _frame(seq, i):
    return seq.rgb[i], seq.depth[i], seq.timestamps[i]


def test_snapshot_roundtrip(tmp_path, orbit):
    """Saved after 8 frames and restored on the CPU: the bookkeeping equal,
    and the remaining frames tracked to the poses and per-frame records of
    the run that goes on, bit for bit (the JAX package's test asks 1e-5)."""
    cfg = port.SlamConfig().override(**SMALL)
    slam = port.SlamSystem(QVGA, cfg, device="cpu")
    for i in range(SAVE_AT):
        slam.process_frame(*_frame(orbit, i))
    path = str(tmp_path / "state.npz")
    snapshot.save(slam, path)
    slam2 = snapshot.restore(path, device="cpu")

    assert slam2._frame_count == slam._frame_count
    assert len(slam2.manager.keyframes) == len(slam.manager.keyframes)
    assert slam2.config.config_hash() == slam.config.config_hash()
    np.testing.assert_array_equal(slam2._motion.T_ck.numpy(), slam._motion.T_ck.numpy())
    np.testing.assert_array_equal(slam2._motion.delta.numpy(), slam._motion.delta.numpy())
    np.testing.assert_array_equal(slam2._motion.cons_excluded, slam._motion.cons_excluded)
    np.testing.assert_array_equal(slam2._kf_state.levels[0].xi.numpy(),
                                  slam._kf_state.levels[0].xi.numpy())
    for i in range(SAVE_AT, N_FRAMES):
        Ta = slam.process_frame(*_frame(orbit, i))
        Tb = slam2.process_frame(*_frame(orbit, i))
        np.testing.assert_array_equal(Ta, Tb)
    drop_ms = lambda recs: [{k: v for k, v in r.items() if k != "ms"} for r in recs]  # noqa: E731
    assert drop_ms(slam2.stats) == drop_ms(slam.stats)


def test_snapshot_restores_backend_state(tmp_path):
    """A restored run keeps its loop edges and a queryable BoW database:
    keyframes from before the snapshot stay matchable after the resume."""
    cfg = port.SlamConfig().override(**{
        "tracking.levels": 3, "tracking.iters": (4, 8, 16),
        "keyframe.max_translation": 0.08, "backend.min_keyframe_gap": 4,
    })
    seq = synthetic.generate_sequence(n_frames=22, intr=QVGA, motion="loop", radius=0.45,
                                      rot_amp=0.1, seed=7)
    slam = port.SlamSystem(QVGA, cfg, device="cpu")
    for i in range(22):
        slam.process_frame(*_frame(seq, i))
    slam.finish()
    assert slam.backend.errors == 0
    assert slam.backend.num_loop_closures > 0
    n_db = len(slam.backend.loop_closer.db.entries)
    assert n_db > 0

    path = str(tmp_path / "state.npz")
    snapshot.save(slam, path)
    slam2 = snapshot.restore(path, device="cpu")

    assert len(slam2.backend._loop_edges) == len(slam.backend._loop_edges)
    for e0, e1 in zip(slam.backend._loop_edges, slam2.backend._loop_edges):
        assert (e0["from_id"], e0["to_id"]) == (e1["from_id"], e1["to_id"])
        np.testing.assert_array_equal(e0["T_rel"], e1["T_rel"])
        np.testing.assert_array_equal(e0["information"], e1["information"])
    assert len(slam2.backend.loop_closer.db.entries) == n_db
    for kf, kf2 in zip(slam.manager.keyframes, slam2.manager.keyframes):
        if kf.descriptors is not None and len(kf.descriptors) > 0:
            assert kf.kf_id in slam2.backend.loop_closer.db.entries
            assert kf.kf_id in slam2.backend._processed
            assert kf2.bow == slam.backend.loop_closer.db.entries[kf.kf_id]
    slam2.finish()
    assert slam2.backend.errors == 0


# ---------------------------------------------------------------------------
# Between the packages


@pytest.fixture(scope="module")
def jax_run(orbit, tmp_path_factory):
    """The JAX package over the whole orbit under SMALL (default tracker:
    ESM with the motion consensus), with its snapshot after frame 8."""
    js = JSlamSystem(JIntrinsics(*QVGA), JSlamConfig().override(**SMALL))
    poses = []
    path = str(tmp_path_factory.mktemp("jax_snap") / "jax.npz")
    for i in range(N_FRAMES):
        if i == SAVE_AT:
            jsnapshot.save(js, path)
        poses.append(js.process_frame(*_frame(orbit, i)))
    return js, poses, path


@pytest.fixture(scope="module")
def port_run(orbit, tmp_path_factory):
    """The port over the same orbit and configuration on the CPU, with its
    snapshot after frame 8."""
    ps = port.SlamSystem(QVGA, port.SlamConfig().override(**SMALL), device="cpu")
    poses = []
    path = str(tmp_path_factory.mktemp("port_snap") / "port.npz")
    for i in range(N_FRAMES):
        if i == SAVE_AT:
            snapshot.save(ps, path)
        poses.append(ps.process_frame(*_frame(orbit, i)))
    return ps, poses, path


def test_file_layout_equals_jax(jax_run, port_run):
    """The same keys, dtypes and shapes (a keyframe cloud's point count
    aside, which rounding at the sigma gate may move by a point), the same
    meta keys, per-frame record keys and config hash."""
    zj, zp = np.load(jax_run[2]), np.load(port_run[2])
    assert sorted(zj.files) == sorted(zp.files)
    for k in zj.files:
        assert zj[k].dtype == zp[k].dtype, k
        if k.endswith("_cloud"):
            assert zj[k].shape[1:] == zp[k].shape[1:], k
        elif k != "meta_json":
            assert zj[k].shape == zp[k].shape, k
    mj = json.loads(bytes(zj["meta_json"].tobytes()).decode())
    mp = json.loads(bytes(zp["meta_json"].tobytes()).decode())
    assert sorted(mj) == sorted(mp)
    assert mj["config_hash"] == mp["config_hash"] and mj["config"] == mp["config"]
    assert [sorted(r) for r in mj["stats"]] == [sorted(r) for r in mp["stats"]]
    assert mj["kf_state_n_leaves"] == mp["kf_state_n_leaves"] == 4 * 3 + 4


def test_kf_state_leaf_order_is_the_jax_pytree(jax_run):
    """The port's written-out order (``snapshot.kf_state_leaves``) of the JAX
    state carried into the port equals ``tree_flatten`` of the JAX state,
    leaf for leaf and bit for bit (bfloat16 leaves widened to float32)."""
    js = jax_run[0]
    leaves = jax.tree_util.tree_leaves(js._kf_state)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(js._kf_state)]
    levels = range(len(js._kf_state.levels))
    names = [f".levels[{l}].{f}" for l in levels for f in snapshot.LEVEL_FIELDS]
    assert paths == names + ["." + f for f in snapshot.KF_STATE_FIELDS], paths
    host = jax.tree_util.tree_map(np.asarray, js._kf_state)
    ours = snapshot.kf_state_leaves(convert.keyframe_from_reference(host, "cpu"))
    assert len(ours) == len(leaves)
    for a, b in zip(ours, leaves):
        b = np.asarray(b.astype(np.float32) if b.dtype == jax.numpy.bfloat16 else b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_jax_snapshot_resumes_in_the_port(jax_run, orbit):
    """A JAX snapshot restored by the port tracks the remaining frames
    within 1e-4 m / 1e-4 rad of the JAX run, with equal switch, lost and
    n_fused; the restored state equals the file's."""
    js, jposes, path = jax_run
    ps = snapshot.restore(path, device="cpu")
    z = np.load(path)
    np.testing.assert_array_equal(ps._motion.T_ck.numpy(), z["T_ck"])
    np.testing.assert_array_equal(ps._kf_state.var.numpy(), z[f"kfstate_{4 * 3}"])
    assert ps._frame_count == SAVE_AT and len(ps.poses()) == SAVE_AT
    for i in range(SAVE_AT, N_FRAMES):
        T = ps.process_frame(*_frame(orbit, i))
        _pose_close(jposes[i], T, i)
        sj, sp = js.stats[i], ps.stats[i]
        for key in ("switch", "lost", "n_fused"):
            assert sj.get(key) == sp.get(key), (i, key)


def test_port_snapshot_resumes_in_jax(port_run, orbit):
    """A port snapshot restored by the JAX package tracks the remaining
    frames within 1e-4 m / 1e-4 rad of the port's run, with equal switch,
    lost and n_fused."""
    ps, pposes, path = port_run
    js = jsnapshot.restore(path)
    assert js._frame_count == SAVE_AT
    for i in range(SAVE_AT, N_FRAMES):
        T = js.process_frame(*_frame(orbit, i))
        _pose_close(pposes[i], T, i)
        sj, sp = js.stats[i], ps.stats[i]
        for key in ("switch", "lost", "n_fused"):
            assert sj.get(key) == sp.get(key), (i, key)
