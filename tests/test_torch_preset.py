"""``SlamConfig.preset("real-v5e")`` end to end in the port against the JAX
package, and the CPU runs that set ``chip_smoke.py``'s ``[preset]`` bounds.

The preset flips the u12 upload codec, the early exit (1e-5), bf16 planes
and the stacked gather (which the port accepts and ignores: its kernels
gather per thread), with the back end on as the preset leaves it.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import rgbid_tpu_torch as port
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.core.config import SlamConfig as JSlamConfig
from rgbid_tpu.datasets import synthetic
from rgbid_tpu.eval import absolute_trajectory_error
from rgbid_tpu.system import SlamSystem as JSlamSystem
from rgbid_tpu_torch.ops import kernels

torch.set_num_threads(2)

QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
# tests/test_preset.py's clip: the preset at 3 levels, iters (3, 6, 12).
CLIP = {"tracking.levels": 3, "tracking.iters": (3, 6, 12), "pipeline_depth": 4}


def test_preset_flips_match_the_smoke():
    """chip_smoke's PRESET_FLIPS are exactly what the preset changes."""
    assert port.SlamConfig().override(**chip_smoke.PRESET_FLIPS) == port.SlamConfig.preset(
        "real-v5e")


def test_preset_system_matches_jax():
    """``tests/test_preset.py``'s clip (QVGA, 10 frames, orbit) through
    ``SlamSystem`` in both packages under the preset, back end on: the same
    keyframe decisions (switch, lost, n_fused) frame by frame, the world
    poses within ``tests/test_torch_slice.py``'s per-frame 1e-4 m / 1e-4
    rad (measured 4e-6 m), ATE < 5 mm in both (the reference test's bound);
    the port enqueued at least the budget's iterations at every level (the
    consensus's reruns add some) and ran at most that many."""
    seq = synthetic.generate_sequence(n_frames=10, intr=QVGA, motion="orbit", trans_amp=0.15,
                                      rot_amp=0.04, xi_noise_sigma=0.003)
    frames = list(seq.frames())
    gt0 = np.linalg.inv(seq.gt_poses[0])
    gt = [gt0 @ T for T in seq.gt_poses]
    js = JSlamSystem(QVGA, JSlamConfig.preset("real-v5e").override(**CLIP))
    js.feed(frames)
    js.finish()
    ps = port.SlamSystem(port.Intrinsics(*QVGA), port.SlamConfig.preset("real-v5e").override(
        **CLIP), device="cpu")
    kernels.reset_iteration_counts("cpu")
    for f in frames:
        ps.process_frame(f.rgb, f.depth, f.timestamp)
    ps.finish()
    assert ps.backend.errors == 0
    for i, (a, b) in enumerate(zip(js.poses(), ps.poses())):
        sj, sp = js.stats[i], ps.stats[i]
        for key in ("switch", "lost", "n_fused"):
            assert sj.get(key) == sp.get(key), (i, key)
        D = np.linalg.inv(a) @ b
        assert np.linalg.norm(D[:3, 3]) < 1e-4, i
        R = D[:3, :3]
        assert 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) < 1e-4
    for slam in (js, ps):
        assert absolute_trajectory_error(gt, slam.poses())["rmse"] < 5e-3
    launched, run = kernels.iteration_counts("cpu")
    assert (launched[:3] >= np.array([3, 6, 12]) * 9).all(), launched
    assert (run <= launched).all()


@pytest.mark.parametrize("label", list(chip_smoke.PRESET_RUNS))
def test_chip_smoke_preset_on_cpu(label):
    """The runs of chip_smoke's ``[preset]`` phase on the CPU (VGA, the
    smoke's own sequences): no loss, and an ATE of at most half the bound
    the smoke holds the card to (``PRESET_ATE_BOUND_M``, max(2 x this ATE,
    5 mm))."""
    cfg, kind, _ = chip_smoke.PRESET_RUNS[label]
    frames, gt = chip_smoke.SEQUENCES[kind]()
    slam = port.SlamSystem(chip_smoke.TUM_FR1, cfg(), device="cpu")
    for f in frames:
        slam.process_frame(*f)
    slam.finish()
    ate = chip_smoke.sequence_ate(gt, slam.poses())
    assert not any(s.get("lost") for s in slam.stats)
    assert 2.0 * ate <= chip_smoke.PRESET_ATE_BOUND_M[label], ate
    if slam.backend is not None:
        assert slam.backend.errors == 0 and slam.backend.num_loop_closures >= 1
