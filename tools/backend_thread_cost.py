#!/usr/bin/env python3
"""What the back-end thread costs the front end, in ms/frame, on the CPU.

    JAX_PLATFORMS=cpu python tools/backend_thread_cost.py [--frames 40] [--repeats 3]

Runs the loop clip of tests/test_torch_loop.py (QVGA, 40 frames, the JAX
package's synthetic renderer) through ``rgbid_tpu_torch.SlamSystem`` on the
CPU with the back end off and on, in turns, and prints the front end's
median and mean ms per frame (``stats[i]["ms"]``: upload, step, reads and
bookkeeping of ``process_frame``; the thread's own work is not in it) and
the wall time of ``finish()``. The back end runs the port's own numpy ORB;
the clip comes from the JAX package's renderer, so this script imports
``rgbid_tpu`` (and with it cv2) and runs only where they are installed. The
back end holds the GIL in its pure-Python parts (``BowDatabase.query``) and
between the array operations of the ORB, which is what this measures.

These are host CPU times of a machine without a GPU. They say nothing
about the card; chip_smoke.py's ``[backend]`` phase makes the same
comparison there.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import rgbid_tpu_torch as port  # noqa: E402
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbid_tpu.datasets import synthetic  # noqa: E402

QVGA = JIntrinsics(fx=258.6, fy=258.2, cx=159.3, cy=127.6, width=320, height=240)
CFG = {
    "tracking.levels": 3, "tracking.iters": (4, 8, 16), "keyframe.max_translation": 0.12,
    "keyframe.max_rotation": 0.12, "keyframe.min_overlap": 0.80, "backend.min_keyframe_gap": 5,
    "backend.reloc_level": 1, "backend.reloc_iters": 16, "backend.min_score": 0.05,
}


def run(frames, backend: bool):
    cfg = port.SlamConfig().override(**{**CFG, "backend.enabled": backend})
    slam = port.SlamSystem(port.Intrinsics(*QVGA), cfg, device="cpu")
    for f in frames:
        slam.process_frame(f.rgb, f.depth, f.timestamp)
    t0 = time.perf_counter()
    slam.finish()
    finish_ms = (time.perf_counter() - t0) * 1e3
    ms = np.array([s["ms"] for s in slam.stats[1:]])
    closures = slam.backend.num_loop_closures if backend else 0
    errors = slam.backend.errors if backend else 0
    return float(np.median(ms)), float(ms.mean()), finish_ms, len(slam.manager.keyframes), \
        closures, errors


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    seq = synthetic.generate_sequence(n_frames=args.frames, intr=QVGA, motion="loop", radius=0.5,
                                      rot_amp=0.15, xi_noise_sigma=0.004, seed=2)
    frames = list(seq.frames())
    run(frames[:6], False)  # warm-up
    rows = {False: [], True: []}
    for _ in range(args.repeats):
        for backend in (False, True, True, False):
            rows[backend].append(run(frames, backend))
    for backend, name in ((False, "back end off"), (True, "back end on")):
        r = np.array(rows[backend])
        print(f"{name}: front end median ms/frame {np.median(r[:, 0]):.2f} (runs "
              f"{np.round(r[:, 0], 2).tolist()}), mean {r[:, 1].mean():.2f}, finish() "
              f"{np.median(r[:, 2]):.1f} ms, keyframes {int(r[0, 3])}, loop closures "
              f"{int(r[0, 4])}, thread errors {int(r[:, 5].sum())}")
    off, on = np.median(np.array(rows[False])[:, 1]), np.median(np.array(rows[True])[:, 1])
    print(f"thread's cost to the front end: {on - off:+.2f} ms/frame in the mean "
          f"({args.frames} QVGA frames, CPU, {args.threads} torch threads)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
