"""``tests/test_gauntlet.py::test_vga_judged_resolution_guard`` on the port
(CPU): the kinect_sensor row at 640x480 with the default 4-level
configuration, back end off, 24 frames, under the same bound. A file of its
own, so that the test runner's per-file scheduling spreads it from the QVGA
tests in ``tests/test_torch_gauntlet.py``."""

import numpy as np
import torch

from rgbid_tpu_torch.core.camera import Intrinsics
from rgbid_tpu_torch.core.config import SlamConfig
from rgbid_tpu_torch.datasets import synthetic
from rgbid_tpu_torch.eval import absolute_trajectory_error
from rgbid_tpu_torch.system import SlamSystem

torch.set_num_threads(2)

VGA = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def test_vga_judged_resolution_guard():
    cfg = SlamConfig().override(**{"backend.enabled": False})
    seq = synthetic.generate_sequence(
        n_frames=24, intr=VGA, seed=3, xi_noise_sigma=0.005,
        motion="orbit", trans_amp=0.25, rot_amp=0.08, kinect_artifacts=1.0,
    )
    slam = SlamSystem(VGA, cfg, device="cpu")
    slam.feed(list(seq.frames()))
    slam.finish()
    gt0 = np.linalg.inv(seq.gt_poses[0])
    ate = absolute_trajectory_error(
        [gt0 @ T for T in seq.gt_poses], slam.poses()
    )["rmse"]
    assert ate < 0.006, ate
    assert not any(s.get("lost") for s in slam.stats)
