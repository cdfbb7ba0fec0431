"""Per-stage decomposition of the steady-state flight.

Counterpart of ``rgbid_tpu/eval/profile_flight.py``: a sequence of
production ``SlamSystem`` runs in one process, each differing from the
default configuration by one subtractive lever (``VARIANTS``, the JAX
package's list), timed at flight granularity through ``feed``. The marginal
of each lever against the in-process baseline is that stage's cost; the
two baseline runs bracket the drift. Where the JAX script counts the
StableHLO ops of its per-frame program, this one counts, with
``torch.profiler`` over one steady-state flight, the kernels per tracked
frame on a card (``DeviceType.CUDA`` events; the captured graph's launches)
or the operators per tracked frame on the CPU.

Protocol: every variant runs the same pre-rendered frames (an orbit clip,
xi_noise 0.003); a warm-up of one bootstrap frame and one full flight
(kernel builds, the graph's capture), then ``--flights`` timed flights of
``pipeline_depth`` frames, each ended by its own read; the mean and the
median flight's ms/frame, the keyframes and the lost frames (which a lever
must not change) per variant.

Usage:
  python -m rgbid_tpu_torch.eval.profile_flight [--flights 4] [--res 640x480]
      [--depth 32] [--only base,no_consensus] [--out FILE] [--device cpu]

Writes one JSON line per variant (to ``--out`` when given, else stdout);
the summary table goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

VARIANTS = [
    # (name, overrides, what the marginal vs base measures)
    ("base", {}, "production defaults (bracketing baseline)"),
    ("coarse_iters_-10", {"tracking.iters": (2, 6, 12, 10)},
     "10 IRLS iterations at level 3 (80x60)"),
    ("l2_iters_-6", {"tracking.iters": (2, 6, 6, 20)}, "6 IRLS iterations at level 2 (160x120)"),
    ("l1_iters_-3", {"tracking.iters": (2, 3, 12, 20)}, "3 IRLS iterations at level 1 (320x240)"),
    ("l0_iters_-1", {"tracking.iters": (1, 6, 12, 20)}, "1 IRLS iteration at level 0 (640x480)"),
    ("no_consensus", {"tracking.consensus": False},
     "both stratified vote passes + probe/rescue machinery"),
    ("no_attack_probe", {"tracking.attack_probe": False},
     "the attack-probe increment over plain consensus"),
    ("no_fusion", {"fusion.enabled": False},
     "inverse-depth fusion + template rebuild (amortized /fuse_every)"),
    ("no_occ_gate", {"tracking.occlusion_gate": False}, "the occlusion gate's in-kernel ops"),
    ("base_repeat", {}, "tenancy-drift bracket (same config as base)"),
    # --- follow-up pass (run with --only) ---
    ("floor", {"tracking.iters": (1, 1, 1, 1), "tracking.consensus": False,
               "fusion.enabled": False},
     "program floor: upload+decode+preprocess+4 min-iters+switch+readback"),
    ("sched_1_8_12_20", {"tracking.iters": (1, 8, 12, 20)},
     "candidate: 1 L0 iter, +2 L1 (L0 costs ~8 ms/iter, L1 ~1.1)"),
    ("sched_1_8_16_24", {"tracking.iters": (1, 8, 16, 24)},
     "candidate: budget pushed coarse-ward where iterations are ~free"),
    ("floor_l1", {"tracking.levels": 1, "tracking.iters": (1,), "tracking.consensus": False,
                  "fusion.enabled": False},
     "floor minus levels 1-3: isolates the coarse pyramid+gradient preprocess and the 3 tiny "
     "per-level loop machineries"),
]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiled_per_frame(slam, frames) -> dict:
    """One flight under torch.profiler: events per tracked frame, by name
    (the twelve largest counts) and in total. On a card the events are the
    device kernels (the graph's launches and the memory copies); on the
    CPU the operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = slam.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    _sync(slam.device)
    with profile(activities=acts) as prof:
        slam.feed(frames)
        _sync(slam.device)
    hist: dict = {}
    for ev in prof.key_averages():
        if cuda and ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if not cuda and not ev.key.startswith("aten::"):
            continue
        hist[ev.key] = hist.get(ev.key, 0) + ev.count
    n = max(len(frames), 1)
    top = sorted(hist.items(), key=lambda kv: -kv[1])[:12]
    return {"kind": "cuda kernels" if cuda else "cpu operators",
            "total": round(sum(hist.values()) / n, 2),
            "top": {k: round(v / n, 2) for k, v in top}}


def run_variant(name, overrides, frames, intr, n_warmup, n_flights, base_cfg, device):
    import numpy as np

    from ..system import SlamSystem

    cfg = base_cfg.override(**overrides) if overrides else base_cfg
    depth = cfg.pipeline_depth
    slam = SlamSystem(intr, cfg, device=device)
    t_c0 = time.perf_counter()
    slam.feed(frames[:n_warmup])  # bootstrap + one full flight (builds, capture)
    warmup_s = time.perf_counter() - t_c0
    timed = frames[n_warmup:n_warmup + n_flights * depth]
    flight_ms = []
    t0 = time.perf_counter()
    for i in range(0, len(timed), depth):
        f0 = time.perf_counter()
        slam.feed(timed[i:i + depth])
        flight_ms.append((time.perf_counter() - f0) * 1e3)
    elapsed = time.perf_counter() - t0
    prof = _profiled_per_frame(slam, timed[:depth])
    n_kf = len(slam.manager.keyframes)
    lost = sum(1 for s in slam.stats if s.get("lost"))
    slam.finish()
    return {
        "variant": name,
        "overrides": {k: list(v) if isinstance(v, tuple) else v for k, v in overrides.items()},
        "mean_ms_per_frame": elapsed * 1e3 / max(len(timed), 1),
        "median_flight_ms_per_frame": float(np.median(flight_ms)) / depth,
        "flight_ms": flight_ms,
        "keyframes": n_kf,
        "lost": lost,
        "warmup_s": warmup_s,
        "graph_replays": slam._step.replays,
        "graph_nodes": slam._step.graph_nodes,
        "events_per_frame": prof,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flights", type=int, default=4)
    ap.add_argument("--res", default="640x480")
    ap.add_argument("--depth", type=int, default=0, help="pipeline_depth (0: the config's)")
    ap.add_argument("--out", default="")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..core.camera import Intrinsics
    from ..core.config import SlamConfig
    from ..datasets import synthetic
    from ..system import _resolve_device

    device = _resolve_device(args.device)
    w, h = (int(x) for x in args.res.split("x"))
    s = w / 640.0
    intr = Intrinsics(fx=525.0 * s, fy=525.0 * s, cx=319.5 * s, cy=239.5 * s, width=w, height=h)
    base_cfg = SlamConfig()
    if args.depth:
        base_cfg = base_cfg.override(pipeline_depth=args.depth)
    depth = base_cfg.pipeline_depth
    n_warmup = depth + 1
    n_frames = n_warmup + args.flights * depth
    print(f"profile: rendering {n_frames} frames at {w}x{h}...", file=sys.stderr)
    seq = synthetic.generate_sequence(n_frames=n_frames, intr=intr, motion="orbit",
                                      trans_amp=0.15, rot_amp=0.04, xi_noise_sigma=0.003)
    frames = list(seq.frames())
    only = {x.strip() for x in args.only.split(",") if x.strip()}
    results = []
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        for name, ov, what in VARIANTS:
            if only and name not in only:
                continue
            print(f"profile: === {name} ({what}) ===", file=sys.stderr)
            rec = run_variant(name, ov, frames, intr, n_warmup, args.flights, base_cfg, device)
            rec["what"] = what
            results.append(rec)
            out.write(json.dumps(rec) + "\n")
            out.flush()
    finally:
        if out is not sys.stdout:
            out.close()
    base_rows = [r for r in results if r["variant"].startswith("base")]
    base_ms = (sum(r["mean_ms_per_frame"] for r in base_rows) / len(base_rows)
               if base_rows else float("nan"))
    print("\nvariant                mean ms  median ms  d_mean vs base  events/frame",
          file=sys.stderr)
    for r in results:
        print(f"{r['variant']:22s} {r['mean_ms_per_frame']:8.3f}  "
              f"{r['median_flight_ms_per_frame']:8.3f}  "
              f"{r['mean_ms_per_frame'] - base_ms:+14.3f}  {r['events_per_frame']['total']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
