"""The port's gauntlet runner and seed sweep against the JAX package's, and
the reduced-size robustness tests of ``tests/test_gauntlet.py`` on the port.

The runner: ``scenarios(n)`` equal to the JAX one's, ``run_scenario``'s row
with the JAX one's keys, and the seed sweep's calls to ``gauntlet.main``
equal to the JAX one's (the port adds ``--device``). The robustness tests
are those of ``tests/test_gauntlet.py`` at the same size (QVGA, 36 or 24
frames), seed and bounds, on the CPU, with one system per configuration
hash shared through ``reset()`` as there; the VGA guard is in
``tests/test_torch_gauntlet_vga.py``.
"""

import numpy as np
import pytest
import torch

from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.eval import gauntlet as jgauntlet
from rgbid_tpu.eval import seed_sweep as jsweep
from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import SlamConfig
from rgbid_tpu_torch.datasets import synthetic
from rgbid_tpu_torch.eval import absolute_trajectory_error, gauntlet, seed_sweep
from rgbid_tpu_torch.system import SlamSystem

torch.set_num_threads(2)

INTR = Intrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)


@pytest.mark.parametrize("n", [36, 60])
def test_scenarios_equal_jax(n):
    assert gauntlet.scenarios(n) == jgauntlet.scenarios(n)


def test_run_scenario_row_keys_match_jax():
    """The revisit row (the one with a pre-finish ATE) at a tiny size,
    back end on, through both runners: the same keys, the same frame count,
    and finite numbers."""
    name, kw, over = [s for s in gauntlet.scenarios(8) if s[0] == "mover_then_revisit"][0]
    size = dict(fx=0.808 * 80, fy=1.076 * 60, cx=39.5, cy=29.5, width=80, height=60)
    base = {"tracking.levels": 2, "tracking.iters": (4, 8), "tracking.template_stride": (1, 1)}
    ours = gauntlet.run_scenario(name, kw, over, 8, Intrinsics(**size), base, {}, device="cpu")
    theirs = jgauntlet.run_scenario(name, kw, over, 8, JIntrinsics(**size), base, {})
    assert list(ours) == list(theirs)
    assert ours["frames"] == theirs["frames"] == 12
    assert all(np.isfinite(v) for k, v in ours.items() if k != "scenario")


def test_seed_sweep_calls_match_jax(monkeypatch):
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jgauntlet, "main", lambda argv: calls["jax"].append(argv) or [])
    monkeypatch.setattr(gauntlet, "main", lambda argv: calls["port"].append(argv) or [])
    argv = ["--frames", "12", "--seeds", "3,5", "--res", "160x120"]
    jsweep.main(argv)
    seed_sweep.main(argv + ["--device", "cpu"])
    assert len(calls["port"]) == len(calls["jax"]) == 4
    for ours, theirs in zip(calls["port"], calls["jax"]):
        assert ours == theirs + ["--device", "cpu"]


# The CPU tests of tests/test_gauntlet.py, on the port. One system per
# configuration hash, shared across this module's tests through reset().
_SYSTEMS: dict = {}


def _run(seq_kwargs, n_frames=36, **cfg_over):
    cfg = SlamConfig().override(**{"backend.enabled": False, **cfg_over})
    seq = synthetic.generate_sequence(
        n_frames=n_frames, intr=INTR, seed=3, xi_noise_sigma=0.005, **seq_kwargs
    )
    key = cfg.config_hash()
    slam = _SYSTEMS.get(key)
    if slam is None:
        slam = SlamSystem(INTR, cfg, device="cpu")
        _SYSTEMS[key] = slam
    else:
        slam.reset()
    slam.feed(list(seq.frames()))
    slam.finish()
    gt0 = np.linalg.inv(seq.gt_poses[0])
    ate = absolute_trajectory_error([gt0 @ T for T in seq.gt_poses], slam.poses())
    return seq, slam, ate["rmse"]


def test_exposure_drift_survived():
    """18% gain + bias drift: affine illumination compensation keeps the
    run in the low single digits (bound of tests/test_gauntlet.py)."""
    _, slam, ate = _run(dict(motion="orbit", trans_amp=0.25, rot_amp=0.08,
                             exposure_drift=0.18))
    assert ate < 0.008, ate
    assert not any(s.get("lost") for s in slam.stats)


def test_exposure_drift_needs_affine():
    """Negative control: the same clip with compensation off is measurably
    worse."""
    _, _, ate_on = _run(dict(motion="orbit", trans_amp=0.25, rot_amp=0.08,
                             exposure_drift=0.18), n_frames=24)
    _, _, ate_off = _run(dict(motion="orbit", trans_amp=0.25, rot_amp=0.08,
                              exposure_drift=0.18), n_frames=24,
                         **{"tracking.affine_illumination": False})
    assert ate_off > 2.0 * ate_on, (ate_off, ate_on)


def test_depth_holes_no_keyframe_thrash():
    """25% blob dropout per frame: no keyframe every frame, single-digit
    accuracy."""
    _, slam, ate = _run(dict(motion="orbit", trans_amp=0.25, rot_amp=0.08,
                             depth_hole_frac=0.25))
    assert ate < 0.008, ate
    assert len(slam.manager.keyframes) <= 12
    assert not any(s.get("lost") for s in slam.stats)


def test_mid_field_moving_occluder():
    """A textured panel sweeping at mid depth: robust weighting and the
    occlusion gate keep tracking on the static scene."""
    _, slam, ate = _run(dict(motion="orbit", trans_amp=0.25, rot_amp=0.08,
                             moving_occluder=True, occluder_z=2.6))
    assert ate < 0.012, ate
    assert not any(s.get("lost") for s in slam.stats)


def test_handheld_jitter():
    _, slam, ate = _run(dict(motion="handheld", trans_amp=0.3, rot_amp=0.1,
                             jitter_trans=0.006, jitter_rot=0.004))
    assert ate < 0.009, ate
    assert not any(s.get("lost") for s in slam.stats)


def test_kinect_sensor_model():
    """Full-severity Kinect-class sensor model (motion blur, disparity
    quantization, edge dropout, speckle)."""
    _, slam, ate = _run(dict(motion="orbit", trans_amp=0.25, rot_amp=0.08,
                             kinect_artifacts=1.0))
    assert ate < 0.008, ate
    assert not any(s.get("lost") for s in slam.stats)
