"""The port's slice (tracking + fusion + keyframe lifecycle) against the JAX
package, plus the port's import hygiene and the chip_smoke scene on CPU.

Slice configuration: ``SlamConfig()`` with ``tracking.consensus`` and
``backend.enabled`` off, the ESM path without the motion consensus
(``tests/test_torch_consensus.py`` holds the default configuration).
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import rgbid_tpu_torch as port
from rgbid_tpu.core import se3 as jse3
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.camera import level_intrinsics
from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.system import SlamSystem as JSlamSystem
from rgbid_tpu.tracking.frames import preprocess_planes as j_preprocess
from rgbid_tpu.tracking.step import ProcessFrame as JProcessFrame
from rgbid_tpu.tracking.step import StepResult as JStepResult
from rgbid_tpu.tracking.step import decode_frame as j_decode
from rgbid_tpu.tracking.step import pack_frame as j_pack
from rgbid_tpu.tracking.tracker import _track_impl
from rgbid_tpu_torch import convert
from rgbid_tpu_torch.tracking.step import StepResult, frame_pyramid
from rgbid_tpu_torch.tracking.tracker import track as t_track

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
SLICE = {"tracking.consensus": False, "backend.enabled": False}


def _gray3(rgb):
    """Gray replicated to 3 channels: both packages then see the same luma
    (the port converts with numpy, the JAX package with OpenCV when present)."""
    return np.repeat(rgb.mean(-1, keepdims=True).astype(np.uint8), 3, -1)


@pytest.fixture(scope="module")
def qvga_frames():
    """11 QVGA frames on a smooth orbit: the systems run the first 10 (a few
    fused frames, then switches); the 11th is the injected-state step."""
    scene = synthetic.make_scene(2)
    rng = np.random.default_rng(9)
    poses = synthetic.orbit_trajectory(40, trans_amp=0.3, rot_amp=0.08)[:11]
    frames = []
    for i, T in enumerate(poses):
        rgb, d16, _, _ = synthetic.render_frame(scene, QVGA, T, xi_noise_sigma=0.003, rng=rng)
        frames.append((_gray3(rgb), d16, i / 30.0))
    return frames, poses


def test_tracker_slice_matches_jax(qvga_frames):
    """The same keyframe (carried into the port by rgbid_tpu_torch.convert)
    and the same packed frame: the final pose agrees to 1e-5 m / 1e-5 rad.
    40 IRLS iterations of f32 sums over ~2e4 pixels in another order
    (measured ~2e-7)."""
    frames, _ = qvga_frames
    jcfg = JSlamConfig().override(**SLICE)
    tcfg = jcfg.tracking
    jstep = JProcessFrame(QVGA, jcfg)
    packed0 = j_pack(*frames[0][:2], jcfg)
    packed3 = j_pack(*frames[3][:2], jcfg)
    kf = jstep.init_keyframe(jnp.asarray(packed0))
    gray, xi, mask = j_decode(jnp.asarray(packed3), jcfg)
    cur = j_preprocess(gray.astype(jnp.float32) / 255.0, xi, mask, tcfg.levels, True,
                       tcfg.esm_min_level, esm_geo_min_level=tcfg.esm_geo_min_level)
    intrs = tuple(level_intrinsics(QVGA, l) for l in range(tcfg.levels))
    T_init = np.array(jse3.exp(jnp.asarray(np.array([0.01, 0, 0.01, 0, 0.01, 0], np.float32))))
    ref = jax.jit(functools.partial(_track_impl, intrs=intrs, cfg=tcfg))(
        kf.levels, cur, jnp.asarray(T_init)
    )

    kf_np = jax.tree_util.tree_map(np.asarray, kf)
    tkf = convert.keyframe_from_reference(kf_np, "cpu")
    back = convert.keyframe_to_numpy(tkf)
    for lr, lb in zip(kf_np.levels, back.levels):
        np.testing.assert_array_equal(lb[3], np.asarray(lr.jac, np.float32))
    np.testing.assert_array_equal(back.var, kf_np.var)
    pcfg = port.SlamConfig().override(**SLICE)
    tcur = frame_pyramid(torch.from_numpy(packed3), pcfg)
    out = t_track(tkf.levels, tcur, torch.from_numpy(T_init), tuple(port.Intrinsics(*i) for i in intrs),
                  pcfg.tracking, pcfg.tracking.jac_dtype)
    D = np.linalg.inv(np.asarray(ref.T, np.float64)) @ out.T.numpy().astype(np.float64)
    assert np.linalg.norm(D[:3, 3]) < 1e-5
    assert np.linalg.norm(jse3.log(jnp.asarray(D, jnp.float32))[3:]) < 1e-5
    np.testing.assert_allclose(out.n_valid.numpy(), np.asarray(ref.n_valid), rtol=1e-5)
    np.testing.assert_allclose(float(out.overlap), float(ref.overlap), rtol=1e-5)
    assert float(np.linalg.norm(np.asarray(ref.T)[:3, 3])) > 0.02  # it really moved


@pytest.fixture(scope="module")
def both_systems(qvga_frames):
    frames, _ = qvga_frames
    js = JSlamSystem(QVGA, JSlamConfig().override(**SLICE))
    jposes = [js.process_frame(*f) for f in frames[:10]]
    ps = port.SlamSystem(port.Intrinsics(*QVGA), port.SlamConfig().override(**SLICE), device="cpu")
    pposes = [ps.process_frame(*f) for f in frames[:10]]
    return js, jposes, ps, pposes


def test_system_matches_jax_per_frame(both_systems):
    """Whole SlamSystem at QVGA over 10 frames: identical switch/lost flags
    and n_fused, per-frame world poses within 1e-4 m / 1e-4 rad. Measured
    ~1e-6: float32 reductions in another order; the bound leaves room for
    that to accumulate across keyframe switches without hiding a real
    divergence (a wrong branch moves the pose by millimetres)."""
    js, jposes, ps, pposes = both_systems
    assert len(jposes) == len(pposes) == 10
    for i, (a, b) in enumerate(zip(jposes, pposes)):
        sj, sp = js.stats[i], ps.stats[i]
        assert sj.get("switch") == sp.get("switch"), i
        assert sj.get("lost") == sp.get("lost"), i
        assert sj.get("n_fused") == sp.get("n_fused"), i
        D = np.linalg.inv(a) @ b
        assert np.linalg.norm(D[:3, 3]) < 1e-4, i
        assert np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)) < 1e-4, i
    flags = [s.get("switch") for s in ps.stats[1:]]
    assert any(flags) and not all(flags)  # both branches ran
    assert any(s.get("n_fused", 0) > 0 for s in ps.stats)


def test_step_with_injected_state_matches_jax(qvga_frames, both_systems):
    """Per-frame parity with the reference's state injected: the JAX
    system's keyframe and motion state after 10 frames go into the port
    (rgbid_tpu_torch.convert) and both run frame 11. Flags and n_fused
    equal; pose, covariance-free diagnostics and the new state within
    1e-5 (the tracker test's f32 reduction-order bound)."""
    frames, _ = qvga_frames
    js, _, ps, _ = both_systems
    packed = j_pack(*frames[10][:2], js.config)
    jvec, jkf, jm = js._step(jnp.asarray(packed), js._kf_state, js._motion)
    jres = JStepResult.unpack(np.asarray(jvec), 4)
    kf_np = jax.tree_util.tree_map(np.asarray, js._kf_state)
    m_np = jax.tree_util.tree_map(np.asarray, js._motion)
    tm = convert.motion_from_reference(m_np, "cpu")
    back = convert.motion_to_numpy(tm)
    np.testing.assert_array_equal(back.T_ck, m_np.T_ck)
    np.testing.assert_array_equal(back.delta, m_np.delta)
    np.testing.assert_array_equal(back.cons_excluded, m_np.cons_excluded)
    tvec, tkf, tm2 = ps._step(torch.from_numpy(packed), convert.keyframe_from_reference(kf_np, "cpu"), tm)
    tres = StepResult.unpack(tvec, 4)
    assert (tres.switch, tres.lost, tres.n_fused) == (jres.switch, jres.lost, jres.n_fused)
    np.testing.assert_allclose(tres.T, jres.T, atol=1e-5)
    np.testing.assert_allclose(tres.n_valid, jres.n_valid, rtol=1e-5)
    np.testing.assert_allclose(tres.overlap, jres.overlap, rtol=1e-5)
    np.testing.assert_allclose(tm2.T_ck.numpy(), np.asarray(jm.T_ck), atol=1e-5)
    np.testing.assert_array_equal(tm2.cons_excluded, np.asarray(jm.cons_excluded))
    np.testing.assert_allclose(tkf.levels[0].xi.numpy(), np.asarray(jkf.levels[0].xi), atol=1e-5)
    assert tkf.fused_count == int(jkf.fused_count)


def test_system_finish_map_and_trajectory(both_systems, tmp_path):
    """finish() finalizes the active keyframe; the map, trajectory and
    their files come out like the JAX package's."""
    js, _, ps, _ = both_systems
    js.finish()
    ps.finish()
    assert len(ps.manager.keyframes) == len(js.manager.keyframes)
    pm, jm = ps.map_points(), js.map_points()
    assert pm.shape[1] == 6 and np.isfinite(pm).all()
    assert abs(len(pm) - len(jm)) <= 0.01 * len(jm)
    ps.save_trajectory(str(tmp_path / "t.txt"))
    ps.save_map(str(tmp_path / "m.ply"))
    assert len((tmp_path / "t.txt").read_text().splitlines()) == 1 + 10  # header + rows
    assert (tmp_path / "m.ply").stat().st_size > 1000
    assert len(ps.trajectory()) == 10 and len(ps.poses()) == 10


def test_port_imports_no_jax_or_cv2():
    """A fresh process imports the port, tracks a frame on the CPU,
    imports chip_smoke and every module of the port (the renderer, the
    gauntlet, the seed sweep, the vocabulary builder, the utilities and the
    command line), renders a short sequence, writes it as a TUM directory
    with the port's PNG encoder, reads it back through the TUM reader (with
    the fr1 undistortion) and the live source, saves and restores a
    snapshot, draws both plots, renders a live-viewer panel, imports the
    multi-rank modules (``SpmdTracker`` too), runs the numpy fusion
    oracle and imports the subpackages' re-exports (``datasets``'
    readers, ``core``'s and ``ops``' submodules), without loading jax,
    cv2 or matplotlib,
    and without loading any module from a file of the JAX package
    (``rgbid_tpu/``); the port's config is the JAX package's (same hash)."""
    code = (
        "import sys, pathlib, numpy as np\n"
        "import rgbid_tpu_torch as port, chip_smoke\n"
        "intr = port.Intrinsics(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)\n"
        "frames, _ = chip_smoke.make_sequence(intr, n=2)\n"
        "slam = port.SlamSystem(intr, chip_smoke.slice_config(), device='cpu')\n"
        "poses = [slam.process_frame(*f) for f in frames]\n"
        "slam.finish()\n"
        "assert np.isfinite(poses[-1]).all() and len(slam.map_points()) > 0\n"
        "assert len(slam.manager.edges) == len(slam.manager.keyframes) - 1\n"
        "import rgbid_tpu_torch.backend.loop_closure, rgbid_tpu_torch.backend.features\n"
        "import rgbid_tpu_torch.reference_cpu.odometry, rgbid_tpu_torch.native\n"
        "from rgbid_tpu_torch.backend import BowDatabase, PoseGraph, RelocScorer\n"
        "from rgbid_tpu_torch.backend.place_recognition import hamming_distances\n"
        "db = BowDatabase(vocab_path='builtin')\n"
        "rng = np.random.default_rng(0)\n"
        "d = rng.integers(0, 256, (40, 32), dtype=np.uint8)\n"
        "db.insert(0, d); assert db.query(99, d)[0][0] == 0\n"
        "assert hamming_distances(d, d).trace() == 0\n"
        "kfs = slam.manager.keyframes\n"
        "sc = RelocScorer(intr, chip_smoke.slice_config(), 'cpu')\n"
        "res = sc.score_pairs([kfs[0].reloc_planes], [kfs[0].reloc_planes])\n"
        "assert np.isfinite(res.T).all() and sc.host_reads == 1\n"
        "import rgbid_tpu_torch.datasets._cv, rgbid_tpu_torch.eval.gauntlet\n"
        "import rgbid_tpu_torch.eval.seed_sweep, rgbid_tpu_torch.backend.build_vocab\n"
        "import rgbid_tpu_torch.utils, rgbid_tpu_torch.cli\n"
        "from rgbid_tpu_torch.datasets import synthetic\n"
        "seq = synthetic.generate_sequence(n_frames=2, intr=intr, kinect_artifacts=1.0,\n"
        "                                  depth_hole_frac=0.1)\n"
        "assert seq.rgb[1].shape == (48, 64, 3) and (seq.depth[1] > 0).mean() > 0.5\n"
        "import tempfile, os\n"
        "from rgbid_tpu_torch.datasets import png, tum, live\n"
        "from rgbid_tpu_torch.utils import snapshot\n"
        "d = tempfile.mkdtemp()\n"
        "for sub in ('rgb', 'depth'): os.makedirs(os.path.join(d, sub))\n"
        "for n, (rgb, dep, t) in enumerate(frames):\n"
        "    png.write(os.path.join(d, f'rgb/{n}.png'), rgb)\n"
        "    png.write(os.path.join(d, f'depth/{n}.png'), dep)\n"
        "open(os.path.join(d, 'rgb.txt'), 'w').write('0.0 rgb/0.png\\n0.1 rgb/1.png\\n')\n"
        "open(os.path.join(d, 'depth.txt'), 'w').write('0.0 depth/0.png\\n0.1 depth/1.png\\n')\n"
        "ts = tum.TumSequence(d, distortion=tum.TUM_DISTORTION['freiburg1'])\n"
        "assert len(ts) == 2 and ts[1].depth.dtype == np.uint16 and ts.undistort\n"
        "assert len(list(live.LiveSource(d, idle_timeout=0.05).frames())) == 2\n"
        "snapshot.save(slam, os.path.join(d, 's.npz'))\n"
        "assert snapshot.restore(os.path.join(d, 's.npz'), device='cpu')._frame_count == 2\n"
        "from rgbid_tpu_torch.utils import viz, raster, live_view\n"
        "import rgbid_tpu_torch.parallel, rgbid_tpu_torch.parallel.launch\n"
        "from rgbid_tpu_torch.parallel import SpmdTracker\n"
        "from rgbid_tpu_torch.reference_cpu import fusion as fusion_ref\n"
        "from rgbid_tpu_torch.datasets import LiveSource, TumSequence, load_calibration\n"
        "from rgbid_tpu_torch.core import camera, config, se3\n"
        "from rgbid_tpu_torch.ops import gauss_newton, image, warp\n"
        "assert se3.to_quaternion(se3.identity()[:3, :3])[3] == 1 and warp.bilinear_sample\n"
        "xi0 = np.full((48, 64), 0.5, np.float32); m0 = np.ones((48, 64), bool)\n"
        "out = fusion_ref.fuse(xi0, np.full_like(xi0, 1e-4), m0, xi0, m0, np.eye(4),\n"
        "                      np.zeros((6, 6)), intr, port.SlamConfig().fusion)\n"
        "assert 0.9 * m0.sum() < out[3] <= m0.sum()\n"
        "viz.plot_trajectory([('est', poses)], os.path.join(d, 't.png'), keyframe_poses=poses)\n"
        "viz.plot_map_topdown(slam.map_points(), os.path.join(d, 'm.png'))\n"
        "lv = live_view.LiveViewer(os.path.join(d, 'live'))\n"
        "lv.publish({'rgb': frames[0][0], 'depth': frames[0][1], 'poses': poses,\n"
        "            'kf_poses': poses[:1], 'cloud': slam.map_points()})\n"
        "lv.close(); assert lv.rendered == 1 and lv.errors == 0\n"
        "ref = pathlib.Path('rgbid_tpu').resolve()\n"
        "files = [getattr(m, '__file__', None) for m in list(sys.modules.values())]\n"
        "ours = [f for f in files if f and pathlib.Path(f).resolve().is_relative_to(ref)]\n"
        "print(port.SlamConfig().config_hash(), 'jax' in sys.modules, 'cv2' in sys.modules,\n"
        "      'matplotlib' in sys.modules, len(ours), sum(f is not None for f in files))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    h, has_jax, has_cv2, has_mpl, n_ref, n_files = out.stdout.split()
    assert (has_jax, has_cv2, has_mpl) == ("False", "False", "False")
    assert n_ref == "0" and int(n_files) > 50, out.stdout
    assert h == JSlamConfig().config_hash()


@pytest.mark.parametrize("preset", [None, "default", "sandbox", "real-v5e"])
def test_config_copy_matches_jax(preset):
    """The port's copy of the config module gives the JAX package's JSON
    and hash, for the default and for every preset name
    ``SlamConfig.preset`` accepts, and reads the JAX package's JSON back."""
    if preset is None:
        jc, pc = JSlamConfig(), port.SlamConfig()
    else:
        jc, pc = JSlamConfig.preset(preset), port.SlamConfig.preset(preset)
    assert pc.to_json() == jc.to_json()
    assert pc.config_hash() == jc.config_hash()
    assert port.SlamConfig.from_json(jc.to_json()) == pc
    with pytest.raises(KeyError):
        port.SlamConfig.preset("no-such-preset")


def test_chip_smoke_scene_on_cpu():
    """chip_smoke's VGA sequence tracked by the port on the CPU. This run
    fixes the ATE bound chip_smoke holds the card to: the bound must be at
    least twice this ATE (measured 0.14 mm; bound 5 mm)."""
    frames, gt = chip_smoke.make_sequence()
    slam = port.SlamSystem(port.core.TUM_FR1, chip_smoke.slice_config(), device="cpu")
    for f in frames:
        slam.process_frame(*f)
    slam.finish()
    poses = slam.poses()
    ate = chip_smoke.sequence_ate(gt, poses)
    assert all(np.isfinite(T).all() for T in poses)
    assert sum(bool(s.get("switch")) for s in slam.stats) >= 1
    assert not any(s.get("lost") for s in slam.stats)
    assert 2.0 * ate <= chip_smoke.ATE_BOUND_M, ate
    assert len(slam.map_points()) > 0


@pytest.mark.parametrize(
    "override",
    [
        pytest.param({"depth_codec": "u16h"}, id="depth_codec=u16h"),
        {"tracking.plane_dtype": "bf16"},
        {"depth_codec": "u12"},
        {"tracking.early_exit_tol": 1e-5},
        {"tracking.conv_skip_tol": 1e-5},
    ],
    ids=lambda o: next(iter(o)),
)
def test_storage_codec_and_exit_settings_run(qvga_frames, override):
    """The settings of ROADMAP Queue 1 #7 each build a SlamSystem on the
    CPU that tracks two frames: the first founds the keyframe, the second
    is tracked and fused (finite pose, no loss, within 3 mm of the pose
    under the default settings: bf16 planes move it 1.1 mm here, the
    others less)."""
    frames, _ = qvga_frames
    poses = {}
    for name, over in (("default", {}), ("knob", override)):
        cfg = port.SlamConfig().override(**{**SLICE, **over})
        slam = port.SlamSystem(port.Intrinsics(*QVGA), cfg, device="cpu")
        poses[name] = [slam.process_frame(*f) for f in frames[:2]]
        assert not slam.stats[1]["lost"] and slam.stats[1]["n_fused"] > 0
    assert np.isfinite(poses["knob"][1]).all()
    assert np.linalg.norm(poses["knob"][1][:3, 3] - poses["default"][1][:3, 3]) < 3e-3


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py covers this device")
    with pytest.raises(RuntimeError, match="cuda"):
        port.SlamSystem(port.Intrinsics(*QVGA), port.SlamConfig().override(**SLICE), device="cuda")
