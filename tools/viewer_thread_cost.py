#!/usr/bin/env python3
"""What a render beside the front end costs it, in ms/frame, on the card.

    python tools/viewer_thread_cost.py [--rounds 2]

Runs chip_smoke.py's rigid sequence (36 VGA frames, ``SlamConfig()`` with
the back end off) through ``SlamSystem`` on the card while one background
load runs, in turns, and prints the median ms/frame over frames 5..35 for
each load:

- none;
- ``LiveViewer._render`` of one VGA snapshot in a loop, in a thread (what
  ``viz.enabled`` adds), and its ``compose`` alone (the panes and the map
  in numpy, no PNG);
- ``zlib.compress`` of a 1280 x 1600 x 3 panel's bytes at level 1 (the
  PNG encoder's core), in a thread and in a process;
- pure Python arithmetic, in a thread and in a process.

A load in another process competes for the host's cores only; a load in a
thread competes for the interpreter lock too. The front end hands the lock
over at every kernel launch and host read, so a thread that holds it
between those points delays every one of them by up to the switch
interval (5 ms). Needs the card; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from rgbid_tpu_torch.utils import live_view  # noqa: E402

PANEL_BYTES = 1600 * 1280 * 3
LOADS = ("none", "render thread", "compose thread", "zlib thread", "zlib process",
         "python thread", "python process", "none")


def _python(ev) -> None:
    while not ev.is_set():
        x = 0
        for i in range(100000):
            x += i


def _zlib(ev) -> None:
    data = np.random.default_rng(0).integers(0, 255, (PANEL_BYTES,), dtype=np.uint8).tobytes()
    while not ev.is_set():
        zlib.compress(data, 1)


def _snapshot(frames, cfg):
    """A VGA snapshot as ``SlamSystem._publish_viz`` makes it, after 12
    frames of the sequence (the cloud of the finalized keyframes)."""
    slam = cs.port.SlamSystem(cs.TUM_FR1, cfg, device="cuda")
    cs._run_sequence(slam, frames[:12])
    act = slam.manager.active
    rgb, depth, _ = frames[11]
    return {"rgb": rgb, "depth": depth, "frame": 11, "n_keyframes": len(slam.manager.keyframes),
            "kf_rgb": act.rgb, "kf_depth": frames[0][1], "kf_id": act.kf_id,
            "poses": slam.poses(), "kf_poses": [k.T_wk for k in slam.manager.keyframes],
            "cloud": slam.map_points()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    _, smi = cs.phase_device()
    cs.phase_build()
    frames, _ = cs.make_sequence()
    cfg = cs.default_config()
    slam = cs.port.SlamSystem(cs.TUM_FR1, cfg, device="cuda")
    cs._run_sequence(slam, frames[:6])  # warm-up
    snap = _snapshot(frames, cfg)
    viewer = live_view.LiveViewer(os.path.join(cs.SMOKE_BUILD, "viewer_thread_cost"))
    panel = viewer.compose(snap)
    data = np.random.default_rng(0).integers(0, 255, (PANEL_BYTES,), dtype=np.uint8).tobytes()
    print(f"[viewer-cost] snapshot: cloud {len(snap['cloud'])} points, panel {panel.shape}")

    def in_thread(kind, ev):
        while not ev.is_set():
            if kind == "render thread":
                viewer._render(snap)
            elif kind == "compose thread":
                viewer.compose(snap)
            elif kind == "zlib thread":
                zlib.compress(data, 1)
            else:
                _python(ev)

    ctx = mp.get_context("spawn")
    for rnd in range(args.rounds):
        for kind in LOADS:
            process = kind.endswith("process")
            ev = ctx.Event() if process else threading.Event()
            worker = None
            if process:
                worker = ctx.Process(target=_zlib if kind.startswith("zlib") else _python,
                                     args=(ev,))
            elif kind != "none":
                worker = threading.Thread(target=in_thread, args=(kind, ev))
            if worker is not None:
                worker.start()
                time.sleep(1.0)
            slam.reset()
            _, ms = cs._run_sequence(slam, frames)
            ev.set()
            if worker is not None:
                worker.join()
            print(f"[viewer-cost] round {rnd} {kind}: ms/frame median {np.median(ms[5:]):.2f} "
                  f"(frames 5..{len(frames) - 1}); {smi}", flush=True)
    viewer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
