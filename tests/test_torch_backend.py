"""The port's back-end modules against the JAX package, on the CPU.

Same inputs, made from a numpy seed, through ``rgbid_tpu`` and through
``rgbid_tpu_torch``: the gray rule and ``pack_frame``; the copied host
modules (batched SE(3), the pose graph in its three methods, the Hamming
kernel, the BoW database, the packaged vocabularies); ``RelocScorer`` (the
port runs ``esm_irls_step``'s plain version here, the JAX package its
``jit(vmap)`` program); and the retained-state property deferred
finalization rests on.

Tolerances, and why:
- pose graph: 1e-9 on poses, 1e-9 relative on the errors. float64 and the
  same code, so the two agree to rounding; the native method is built from
  the same source with other flags (no ``-march=native``), which moves the
  last bits only.
- BoW scores: 1e-12 (the same float64 arithmetic on the same words).
- scorer: the port and the JAX program run the same float32 math in another
  order (per-pixel sums against XLA's reductions, 36 chained iterations).
  Measured on the revisit pairs, reloc levels 1 and 2: T within 3e-7; H
  (against its largest entry), error and the two sigmas within 3e-5
  relative on the two nearer revisits and 8.7e-4 on the farthest (the
  rendered depth has no noise, so sigma_xi sits at 5e-5 and a pixel that
  crosses a gate moves the sums); n_valid and the inlier share equal. Held
  to T 1e-5 absolute, the rest 2e-3 relative, n_valid and the inlier share
  within 2 pixels. The unrelated pair does not converge, so its sums are
  not comparable (H differs by 4%): it is held to the same ``accept``
  decision, a finite T within 1e-4 and sigma_int within 1e-2 relative (the
  gate that rejects it, by a margin of -0.07 on a limit of 0.06).
"""

import pathlib

import numpy as np
import pytest
import torch

import rgbid_tpu_torch as port
from rgbid_tpu.backend import place_recognition as jpr
from rgbid_tpu.backend import pose_graph as jpg
from rgbid_tpu.backend import se3_batch as jsb
from rgbid_tpu.backend.features import extract_orb as cv2_extract_orb
from rgbid_tpu.backend.relocalization import RelocScorer as JRelocScorer
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.reference_cpu import odometry as jodo
from rgbid_tpu.tracking.step import pack_frame as j_pack
from rgbid_tpu_torch import native
from rgbid_tpu_torch.backend import features, loop_closure
from rgbid_tpu_torch.backend import place_recognition as tpr
from rgbid_tpu_torch.backend import pose_graph as tpg
from rgbid_tpu_torch.backend import se3_batch as tsb
from rgbid_tpu_torch.backend.relocalization import RelocScorer, _level_up
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.mapping.manager import KeyframeManager
from rgbid_tpu_torch.reference_cpu import odometry as todo
from rgbid_tpu_torch.reference_cpu import se3_np
from rgbid_tpu_torch.tracking.step import MotionState, ProcessFrame, StepResult, gray_from_rgb
from rgbid_tpu_torch.tracking.step import pack_frame as t_pack

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)


# ---------------------------------------------------------------------------
# (1) gray and pack_frame


@pytest.mark.parametrize("shape", [(480, 640), (240, 320), (481, 641)],
                         ids=["vga", "qvga", "odd"])
def test_pack_frame_bitwise_equals_jax(shape):
    """Seeded random frames: the port's upload buffer is the JAX package's,
    byte for byte (its gray plane is OpenCV's RGB2GRAY there)."""
    rng = np.random.default_rng(shape[0])
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    depth = rng.integers(0, 65536, shape, dtype=np.uint16)
    np.testing.assert_array_equal(t_pack(rgb, depth, port.SlamConfig()),
                                  j_pack(rgb, depth, JSlamConfig()))


def test_gray_rule_on_saturated_and_extreme_colours():
    """Every combination of the channel values where a fixed-point rule
    could round otherwise, and all-white / all-black frames."""
    import cv2

    vals = np.array([0, 1, 2, 3, 127, 128, 129, 253, 254, 255], np.uint8)
    grid = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(10, 100, 3)
    for img in (np.ascontiguousarray(grid), np.full((16, 24, 3), 255, np.uint8),
                np.zeros((16, 24, 3), np.uint8)):
        np.testing.assert_array_equal(gray_from_rgb(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    g = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert gray_from_rgb(g) is g  # a 2-D input is already gray


# ---------------------------------------------------------------------------
# (2) copied numpy modules


@pytest.mark.parametrize("fn", ["hat_b", "exp_b", "log_b", "inv_b", "adjoint_b", "jl_inv_b",
                                "jr_inv_b"])
def test_se3_batch_copy_matches_jax_package(fn):
    rng = np.random.default_rng(3)
    xi = rng.normal(scale=0.7, size=(9, 6))
    xi[0] = 0.0  # the small-angle branch
    xi[1, 3:] *= 1e-9
    if fn == "hat_b":
        x = xi[:, :3]
    elif fn in ("exp_b", "jl_inv_b", "jr_inv_b"):
        x = xi
    else:
        x = jsb.exp_b(xi)
    np.testing.assert_array_equal(getattr(tsb, fn)(x), getattr(jsb, fn)(x))


def test_odometry_copy_preprocess_matches_jax_package():
    """The lost frame's host preprocess (``_try_relocalize``) is the JAX
    package's, bit for bit."""
    seq = synthetic.generate_sequence(n_frames=1, intr=QVGA, motion="orbit", seed=4)
    a = todo.preprocess_frame(seq.rgb[0], seq.depth[0], 3, 5000.0, 0.3, 10.0)
    b = jodo.preprocess_frame(seq.rgb[0], seq.depth[0], 3, 5000.0, 0.3, 10.0)
    for l in range(3):
        np.testing.assert_array_equal(a.intensity[l], b.intensity[l])
        np.testing.assert_array_equal(a.xi[l], b.xi[l])
        np.testing.assert_array_equal(a.mask[l], b.mask[l])


@pytest.mark.parametrize("name", ["vocab_b8l4.npz", "vocab_b8l3.npz"])
def test_packaged_vocabularies_are_byte_equal(name):
    a = (REPO / "rgbid_tpu_torch" / "data" / name).read_bytes()
    assert a == (REPO / "rgbid_tpu" / "data" / name).read_bytes()
    assert tpr.resolve_vocab_path("builtin") == str(REPO / "rgbid_tpu_torch" / "data"
                                                    / "vocab_b8l4.npz")


# ---------------------------------------------------------------------------
# (3) pose graph


def _chain_with_drift(n=12, drift=0.02, seed=0):
    """tests/test_backend.py's loop trajectory with drifted odometry."""
    rng = np.random.default_rng(seed)
    gt, rels = [np.eye(4)], []
    for _ in range(n - 1):
        d = np.array([0.3, 0.0, 0.1, 0.0, 0.25, 0.0]) + rng.normal(scale=0.01, size=6)
        rels.append(se3_np.exp(d))
        gt.append(gt[-1] @ rels[-1])
    noisy = [se3_np.exp(rng.normal(scale=drift, size=6) * [1, 1, 1, 0.3, 0.3, 0.3]) @ R
             for R in rels]
    return gt, rels, noisy


def _graph(kind):
    """(poses, [(from, to, T_rel, info, robust)], gt) of three scenarios of
    tests/test_backend.py: a drifting chain closed by one exact loop edge,
    an exact chain with a wrong robust loop edge, and the episode graph at
    production information scales (two corrupted soft robust edges, two
    exact loop edges)."""
    if kind == "loop":
        gt, _, noisy = _chain_with_drift()
        n = len(gt)
        poses = [np.eye(4)]
        for R in noisy:
            poses.append(poses[-1] @ R)
        edges = [(i, i + 1, noisy[i], np.eye(6) * 1e2, False) for i in range(n - 1)]
        edges.append((0, n - 1, se3_np.inv(gt[0]) @ gt[-1], np.eye(6) * 1e6, True))
        return poses, edges, gt
    if kind == "outlier":
        gt, rels, _ = _chain_with_drift()
        n = len(gt)
        edges = [(i, i + 1, rels[i], np.eye(6) * 1e4, False) for i in range(n - 1)]
        bogus = se3_np.exp(np.array([1.5, -2.0, 0.7, 0.4, 0.2, -0.5]))
        edges.append((0, n - 1, bogus, np.eye(6) * 1e2, True))
        return gt, edges, gt
    rng = np.random.default_rng(7)
    n = 9
    gt = [np.eye(4)]
    for _ in range(n - 1):
        d = np.array([0.25, 0.0, 0.08, 0.0, 0.2, 0.0]) + rng.normal(scale=0.01, size=6)
        gt.append(gt[-1] @ se3_np.exp(d))
    drag = se3_np.exp(np.array([0.13, -0.1, 0.08, 0.02, -0.015, 0.01]))
    clean_info = {0: 4e9, 1: 2e7, 7: 1e9}
    poses, edges = [np.eye(4)], []
    for i in range(n - 1):
        m = se3_np.inv(gt[i]) @ gt[i + 1]
        if i in (4, 5):
            m = m @ drag
        if 2 <= i <= 6:
            edges.append((i, i + 1, m, np.eye(6) * 1e9 * 1e-4, True))
        else:
            edges.append((i, i + 1, m, np.eye(6) * clean_info[i], False))
        poses.append(poses[-1] @ m)
    for a, b in ((0, 7), (1, 8)):
        edges.append((a, b, se3_np.inv(gt[a]) @ gt[b], np.eye(6) * 1e9, True))
    return poses, edges, gt


def _assert_same_result(out, ref):
    assert out["iterations"] == ref["iterations"]
    for key in ("initial_error", "final_error"):
        assert abs(out[key] - ref[key]) <= 1e-9 * max(abs(ref[key]), 1.0), key
    for a, b in zip(out["poses"], ref["poses"]):
        np.testing.assert_allclose(a, b, atol=1e-9)


@pytest.mark.parametrize("method", ["sparse", "dense_fd", "native"])
@pytest.mark.parametrize("kind", ["loop", "outlier", "episode"])
def test_optimize_pose_graph_matches_jax(kind, method):
    poses, edges, gt = _graph(kind)
    iters = 40 if kind == "episode" else 20
    out = tpg.optimize_pose_graph(poses, [tpg.GraphEdge(*e) for e in edges], iterations=iters,
                                  method=method)
    ref = jpg.optimize_pose_graph(poses, [jpg.GraphEdge(*e) for e in edges], iterations=iters,
                                  method=method)
    _assert_same_result(out, ref)
    assert out["final_error"] <= out["initial_error"] + 1e-12
    post = [np.linalg.norm(p[:3, 3] - g[:3, 3]) for p, g in zip(out["poses"], gt)]
    if kind == "loop":  # the loop edge reclaims the drifted tail
        assert post[-1] < 0.2 * np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3])
    elif kind == "outlier":  # Huber: the wrong edge moves nothing far
        assert max(post) < 0.08
    else:  # the clean chain is spared, the revisit nodes reclaimed
        assert max(post[:3]) < 0.01 and max(post[7:]) < 0.01, post


def test_pose_graph_class_matches_jax():
    """``PoseGraph.optimize`` (the back-end thread's call: sparse, the
    configured iterations and damping) on the episode graph."""
    poses, edges, _ = _graph("episode")
    b = port.SlamConfig().backend
    t, j = tpg.PoseGraph(b.pg_iterations, b.pg_damping), jpg.PoseGraph(b.pg_iterations,
                                                                       b.pg_damping)
    for e in edges:
        t.add_edge(*e)
        j.add_edge(*e)
    _assert_same_result(t.optimize(poses), j.optimize(poses))


def test_native_method_raises_when_the_library_cannot_be_built(monkeypatch):
    """No quiet switch to the numpy loop: without a toolchain (and with no
    library loaded) ``method="native"`` raises."""
    poses, edges, _ = _graph("loop")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: REPO / "build" / "absent" / "lib.so")
    monkeypatch.setattr(native, "toolchain", lambda: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tpg.optimize_pose_graph(poses, [tpg.GraphEdge(*e) for e in edges], method="native")
    assert tpr.hamming_backend() == "numpy"


# ---------------------------------------------------------------------------
# (4) Hamming distances and the BoW database


def test_hamming_native_equals_numpy_and_builds_under_build():
    if native.toolchain() is None:
        pytest.skip("no g++ on this machine: hamming_distances runs numpy")
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (70, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (130, 32), dtype=np.uint8)
    b[1] = a[0]
    before = {p for p in (REPO / "rgbid_tpu_torch").rglob("*") if "__pycache__" not in p.parts}
    assert tpr.hamming_backend() == "native"
    d = tpr.hamming_distances(a, b)
    np.testing.assert_array_equal(d, native.hamming_batch(a, b))
    np.testing.assert_array_equal(d, tpr.hamming_distances_numpy(a, b))
    np.testing.assert_array_equal(d, jpr.hamming_distances(a, b))
    assert d[0, 1] == 0 and d.dtype == np.int32
    assert tpr.hamming_distances(a[:0], b).shape == (0, 130)
    # The library lands under build/, and nothing new inside the package.
    lib = native.library_path()
    assert lib.exists() and lib.parent == REPO / "build" / "rgbid_tpu_torch"
    after = {p for p in (REPO / "rgbid_tpu_torch").rglob("*") if "__pycache__" not in p.parts}
    assert after == before
    assert not list((REPO / "rgbid_tpu_torch").rglob("*.so"))


@pytest.fixture(scope="module")
def revisit_descs():
    """ORB descriptors (OpenCV, through the JAX package's extractor) of the
    two-pass revisit views of tests/test_vocabulary.py, at 160x120, 26
    views a pass, and of tests/test_backend.py's five QVGA views."""
    intr = JIntrinsics(fx=129.3, fy=129.1, cx=79.6, cy=59.8, width=160, height=120)
    poses = synthetic.loopy_trajectory(26, radius=0.45, rot_amp=0.12)
    seq = synthetic.generate_sequence(n_frames=52, intr=intr, motion=poses + poses, seed=7)
    two_pass = [cv2_extract_orb(gray_from_rgb(rgb), 300)[1] for rgb in seq.rgb]
    scene = synthetic.make_scene(0)
    views = synthetic.loopy_trajectory(20, radius=0.4, rot_amp=0.12)
    five = []
    for v in (0, 4, 8, 12, 19):
        _, _, gray, _ = synthetic.render_frame(scene, QVGA, views[v])
        five.append(cv2_extract_orb(np.clip(gray * 255, 0, 255).astype(np.uint8), 400)[1])
    return two_pass, five


BOW_CASES = {
    # The defaults of BackendConfig: the packaged vocabulary, sqrt tf, the
    # relative-score gate.
    "builtin": dict(min_score=0.02, min_gap=8, max_candidates=4, vocab_path="builtin",
                    tf_mode="sqrt", rel_score=0.65),
    # Trained in the run: the flat vocabulary first, then the tree, retrained
    # as the corpus quadruples (at 300, then 1200 of ~1400 descriptors).
    "in_run": dict(min_score=0.02, min_gap=8, max_candidates=4, train_after=300),
    "builtin_b8l3_linear": dict(min_score=0.0, min_gap=8, max_candidates=6, tf_mode="linear",
                                vocab_path=str(REPO / "rgbid_tpu_torch" / "data"
                                               / "vocab_b8l3.npz")),
}


@pytest.mark.parametrize("case", list(BOW_CASES))
def test_bow_database_matches_jax(revisit_descs, case):
    """The same inserts and queries through both databases: the same
    candidate ids in the same order, scores within 1e-12, the same word
    counts, and the vocabulary retrained at the same moments."""
    descs, _ = revisit_descs
    kw = dict(BOW_CASES[case])
    jkw = dict(kw)
    if case == "builtin_b8l3_linear":
        jkw["vocab_path"] = str(REPO / "rgbid_tpu" / "data" / "vocab_b8l3.npz")
    t, j = tpr.BowDatabase(**kw), jpr.BowDatabase(**jkw)
    n_hits = 0
    for i, d in enumerate(descs):
        a, b = t.query(i, d), j.query(i, d)
        assert [c for c, _ in a] == [c for c, _ in b], i
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=1e-12)
        n_hits += bool(a)
        t.insert(i, d)
        j.insert(i, d)
        assert t.entries[i] == j.entries[i]
        assert t.vocab.trained == j.vocab.trained
    assert n_hits >= 10  # the second pass finds the first
    if case == "in_run":
        assert t.vocab.trained and t._next_train == j._next_train
        np.testing.assert_array_equal(t.vocab.words, j.vocab.words)


def test_bow_same_place_scores_higher(revisit_descs):
    """tests/test_backend.py's revisit: view 19 is back near view 0."""
    _, five = revisit_descs
    t = tpr.BowDatabase(min_score=0.0, min_gap=2, max_candidates=10)
    j = jpr.BowDatabase(min_score=0.0, min_gap=2, max_candidates=10)
    for i, d in enumerate(five[:-1]):
        t.insert(i, d)
        j.insert(i, d)
    a, b = t.query(10, five[-1]), j.query(10, five[-1])
    assert [c for c, _ in a] == [c for c, _ in b] and a[0][0] == 0
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=1e-12)


def test_extract_orb_is_unported_and_the_system_refuses_the_back_end():
    """Without an ORB extractor the default configuration raises at
    construction, from ``SlamSystem.__init__`` and not from inside the
    back-end thread, naming the ROADMAP item."""
    assert not features.SUPPORTED
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #3"):
        features.extract_orb(np.zeros((48, 64), np.uint8))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #3"):
        port.SlamSystem(Intrinsics(*QVGA), port.SlamConfig(), device="cpu")


# ---------------------------------------------------------------------------
# (5) RelocScorer


def _planes(scene, T_wc, level):
    rgb, d16, _, _ = synthetic.render_frame(scene, QVGA, T_wc)
    pyr = jodo.preprocess_frame(rgb, d16, level + 1)
    return {"intensity": pyr.intensity[level], "xi": pyr.xi[level],
            "mask": pyr.mask[level].astype(np.float32)}


@pytest.fixture(scope="module", params=[1, 2], ids=["reloc_level1", "reloc_level2"])
def scorers(request):
    """Both scorers at one reloc level, and four pairs: three revisits of
    growing offset (tests/test_backend.py's) and an unrelated pair (another
    scene). One JAX compile per level: its program is padded to
    ``max_candidates`` whatever the batch."""
    level = request.param
    over = {"tracking.levels": 3, "backend.reloc_level": level, "backend.reloc_iters": 12}
    jscorer = JRelocScorer(QVGA, JSlamConfig().override(**over))
    tscorer = RelocScorer(Intrinsics(*QVGA), port.SlamConfig().override(**over), "cpu")
    scene, other = synthetic.make_scene(0), synthetic.make_scene(99)
    orbit = synthetic.orbit_trajectory(40, trans_amp=0.2, rot_amp=0.06)
    t0 = _planes(scene, np.eye(4), level)
    temps, curs, gts = [], [], []
    for k in range(3):
        temps.append(t0)
        curs.append(_planes(scene, orbit[3 + 2 * k], level))
        gts.append(np.linalg.inv(orbit[3 + 2 * k]))
    temps.append(t0)
    curs.append(_planes(other, np.eye(4), level))
    return level, jscorer, tscorer, temps, curs, gts


def _assert_scores_match(t, j, k, n_pixels):
    """Pair ``k`` of two results, a converged (revisit) pair."""
    np.testing.assert_allclose(t.T[k], j.T[k], rtol=0, atol=1e-5)
    for name in ("H", "error", "sigma_int", "sigma_xi"):
        a, b = getattr(t, name)[k], getattr(j, name)[k]
        # H is held against its largest entry, a scalar against itself.
        assert np.abs(a - b).max() <= 2e-3 * np.abs(b).max(), (name, k, a, b)
    assert abs(t.n_valid[k] - j.n_valid[k]) <= 2.0
    assert abs(t.inlier_frac[k] - j.inlier_frac[k]) <= 2.0 / (0.2 * n_pixels)


@pytest.mark.parametrize("batch", [1, 3, 4], ids=["batch1", "batch3", "with_unrelated"])
def test_reloc_scorer_matches_jax(scorers, batch):
    level, jscorer, tscorer, temps, curs, gts = scorers
    t = tscorer.score_pairs(temps[:batch], curs[:batch])
    j = jscorer.score_pairs(temps[:batch], curs[:batch])
    h, w = tscorer.intr_l.height, tscorer.intr_l.width
    assert t.T.shape == (batch, 4, 4) and t.H.shape == (batch, 6, 6)
    for k in range(batch):
        assert tscorer.accept(t, k) == jscorer.accept(j, k), (k, tscorer.margins(t, k))
        assert tscorer.accept(t, k) == (k < 3)
    for k in range(min(batch, 3)):  # the revisits: equal sums, and the true pose
        _assert_scores_match(t, j, k, h * w)
        err = se3_np.log(se3_np.inv(gts[k]) @ np.asarray(t.T[k], np.float64))
        assert np.linalg.norm(err) < 1.2e-2, (k, err)
    if batch == 4:  # the unrelated pair: rejected by the photometric scale
        assert np.isfinite(t.T[3]).all()
        np.testing.assert_allclose(t.T[3], j.T[3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(t.sigma_int[3], j.sigma_int[3], rtol=1e-2)
        assert tscorer.margins(t, 3)["sigma_int"] < -0.03


def test_reloc_scorer_counts_and_batch_independence(scorers):
    """3 x reloc_iters IRLS steps per pair and one read per call; no kernel
    launch on the CPU; and a pair's result is bit-identical whether it is
    scored alone or with others (the port pads nothing)."""
    level, _, tscorer, temps, curs, _ = scorers
    steps0, reads0 = tscorer.irls_steps, tscorer.host_reads
    together = tscorer.score_pairs(temps, curs)
    assert tscorer.irls_steps - steps0 == 3 * 12 * 4
    assert tscorer.host_reads - reads0 == 1 and tscorer.launches == 0
    for k in range(4):
        alone = tscorer.score_pairs([temps[k]], [curs[k]])
        for a, b in zip(alone, together):
            np.testing.assert_array_equal(a[0], b[k])
    # An initial pose is used: starting at the answer stays there.
    T_init = [np.asarray(together.T[1], np.float32)]
    warm = tscorer.score_pairs([temps[1]], [curs[1]], T_init)
    np.testing.assert_allclose(warm.T[0], together.T[1], atol=2e-4)


def test_level_up_matches_jax_on_odd_sizes():
    from rgbid_tpu.backend.relocalization import _level_up as j_level_up

    for w, h in ((641, 481), (161, 121), (40, 30)):
        a = _level_up(Intrinsics(100.0, 101.0, 50.5, 40.25, w, h))
        b = j_level_up(JIntrinsics(100.0, 101.0, 50.5, 40.25, w, h))
        assert tuple(a) == tuple(b)


def test_loop_edge_is_the_jax_package_construction():
    """``loop_edge`` builds what ``LoopCloser.process_keyframe`` of the JAX
    package builds from a scorer result."""
    rng = np.random.default_rng(8)
    T = se3_np.exp(rng.normal(scale=0.2, size=6)).astype(np.float32)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    res = port.backend.relocalization.RelocResult(
        T=T[None], H=(A @ A.T)[None], error=np.ones(1, np.float32),
        inlier_frac=np.ones(1, np.float32), n_valid=np.array([1234.0], np.float32),
        sigma_int=np.ones(1, np.float32), sigma_xi=np.ones(1, np.float32))
    e = loop_closure.loop_edge(res, 0, 2, 9)
    T_qc = se3_np.orthonormalize(np.asarray(T, np.float64))
    H = np.asarray(res.H[0], np.float64) * 1234.0
    assert (e["from_id"], e["to_id"]) == (2, 9)
    np.testing.assert_array_equal(e["T_rel"], se3_np.inv(T_qc))
    np.testing.assert_array_equal(e["information"], 0.5 * (H + H.T))


# ---------------------------------------------------------------------------
# (6) retained state: deferred finalization reads a retired state late


def test_finalize_of_a_retired_state_three_frames_late_is_unchanged():
    """With a back end the retiring keyframe's device state is finalized on
    another thread after the front end has moved on. Torch tensors are
    mutable, so nothing the later frames run (fusion, template rebuild,
    masks, hits, a new keyframe) may write into the retired state in place:
    finalizing it at once and again three frames later gives the same
    cloud and the same reloc planes, bit for bit, and every tensor of the
    state is unchanged. (Keeping the fused planes in buffers that are
    reused from frame to frame, the usual way to save allocations, fails
    this test.)"""
    intr = Intrinsics(*QVGA)
    cfg = port.SlamConfig().override(**{
        "backend.enabled": False, "fusion.fuse_every": 1, "keyframe.max_translation": 0.12,
        "keyframe.max_rotation": 0.12})
    # The first 12 frames of a 40-frame orbit: the keyframe founded at
    # frame 2 is fused twice and retires at frame 5; frames 6 to 8 fuse,
    # switch and fuse again.
    seq = synthetic.generate_sequence(n_frames=40, intr=QVGA, motion="orbit", trans_amp=0.3,
                                      rot_amp=0.08, xi_noise_sigma=0.003, seed=3)
    step = ProcessFrame(intr, cfg, "cpu")
    packed = [torch.from_numpy(t_pack(f.rgb, f.depth, cfg)) for f in list(seq.frames())[:12]]
    kf = step.init_keyframe(packed[0])
    motion = MotionState.initial("cpu", cfg.tracking.consensus_bins)
    manager = KeyframeManager(intr, reloc_level=cfg.backend.reloc_level)
    retired, snapshot, at_once, later = None, None, None, []
    for i in range(1, len(packed)):
        prev = kf
        vec, kf, motion = step(packed[i], prev, motion)
        res = StepResult.unpack(vec, cfg.tracking.levels)
        if retired is None and res.switch > 0.5 and prev.fused_count >= 2:
            retired = prev
            snapshot = [t.clone() for t in _state_tensors(prev)]
            at_once = manager.finalize(manager.new_keyframe(0.0, np.eye(4), seq.rgb[0]), prev)
        elif retired is not None:
            later.append("switch" if res.switch > 0.5 else "fuse" if res.n_fused > 0 else "other")
            if len(later) == 3:
                break
    assert retired is not None and "switch" in later and "fuse" in later, later
    late = manager.finalize(manager.new_keyframe(0.0, np.eye(4), seq.rgb[0]), retired)
    for a, b in zip(_state_tensors(retired), snapshot):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(late.cloud, at_once.cloud)
    assert len(late.cloud) > 1000 and manager.host_reads == 2
    for key, plane in at_once.reloc_planes.items():
        np.testing.assert_array_equal(late.reloc_planes[key], plane)


def _state_tensors(state):
    out = [state.var, state.hits, state.mask_full]
    for lvl in state.levels:
        out += [t for t in lvl if isinstance(t, torch.Tensor)]
    return out
