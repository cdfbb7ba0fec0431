"""Command-line runner (the port's copy of ``rgbid_tpu/cli.py``).

    python -m rgbid_tpu_torch --synthetic 60 --out-dir /tmp/run
    python -m rgbid_tpu_torch --synthetic 40 --set backend.enabled=false --device cpu

Outputs: TUM-format trajectory, PLY map, JSONL per-frame log, and (with
ground truth) ATE/RPE metrics printed as JSON. The system runs on
``--device`` (the card by default). The synthetic source is the only one
ported: ``--tum``, ``--live``, ``--calib``, ``--live-idle``, ``--resume``,
``--snapshot``, ``--viz`` and ``--live-viz`` need modules that read or
write through OpenCV or the JAX package's snapshot format, and raise
``NotImplementedError`` before any work is done.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

# The options whose modules are not ported yet: (attribute, flag).
UNPORTED = (
    ("tum", "--tum"),
    ("live", "--live"),
    ("calib", "--calib"),
    ("live_idle", "--live-idle"),
    ("resume", "--resume"),
    ("snapshot", "--snapshot"),
    ("viz", "--viz"),
    ("live_viz", "--live-viz"),
)


def _parse_set(values):
    out = {}
    for kv in values or []:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rgbid_tpu_torch", description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--tum", metavar="DIR", help="TUM RGB-D sequence directory (not ported)")
    src.add_argument("--live", metavar="DIR", help="follow a growing TUM-format directory (not ported)")
    src.add_argument("--synthetic", type=int, metavar="N", help="render N synthetic frames")
    ap.add_argument("--live-idle", type=float, default=None,
                    help="seconds without new frames before a --live stream ends (not ported)")
    ap.add_argument("--motion", default="orbit", choices=["orbit", "loop", "static"])
    ap.add_argument("--config", metavar="JSON", help="config file (JSON)")
    ap.add_argument(
        "--preset",
        default=None,
        choices=["default", "sandbox", "real-v5e"],
        help="named config preset (SlamConfig.preset); --config/--set apply on top",
    )
    ap.add_argument("--calib", metavar="FILE", help="camera calibration file (not ported)")
    ap.add_argument(
        "--intrinsics",
        metavar="fx,fy,cx,cy[,w,h]",
        help="override camera intrinsics (default: the synthetic VGA camera)",
    )
    ap.add_argument("--set", action="append", metavar="KEY=VAL", help="config override (dotted)")
    ap.add_argument("--out-dir", default=None, help="write trajectory/map/log here")
    ap.add_argument("--snapshot", default=None, help="write a full-state snapshot here (not ported)")
    ap.add_argument("--resume", default=None, help="resume from a snapshot file (not ported)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--eval", action="store_true", help="print ATE/RPE vs ground truth")
    ap.add_argument("--voxel", type=float, default=0.01, help="map voxel downsample (m)")
    ap.add_argument("--map-format", default="ply", choices=["ply", "pcd"], help="map export format")
    ap.add_argument("--viz", action="store_true", help="write trajectory/map PNGs (not ported)")
    ap.add_argument("--live-viz", metavar="DIR", default=None, help="live 3-pane viewer (not ported)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    for attr, flag in UNPORTED:
        if getattr(args, attr) not in (None, False):
            raise NotImplementedError(
                f"rgbid_tpu_torch does not run {flag} yet (ROADMAP Queue 1 #8)")

    from .core.camera import DEFAULT, Intrinsics
    from .core.config import SlamConfig
    from .datasets import prefetch_frames
    from .datasets import synthetic as synth
    from .eval import absolute_trajectory_error, relative_pose_error
    from .system import SlamSystem
    from .utils.logging import JsonlLogger
    from .utils.profiling import StageTimer

    cfg = SlamConfig.preset(args.preset) if args.preset else SlamConfig()
    if args.config:
        with open(args.config) as f:
            cfg = SlamConfig.from_json(f.read())
    overrides = _parse_set(args.set)
    if overrides:
        cfg = cfg.override(**{k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items()})

    # Frame source.
    intr = DEFAULT
    if args.intrinsics:
        vals = [float(x) for x in args.intrinsics.split(",")]
        if len(vals) == 4:
            vals += [640, 480]
        intr = Intrinsics(vals[0], vals[1], vals[2], vals[3], int(vals[4]), int(vals[5]))
    sseq = synth.generate_sequence(
        n_frames=args.synthetic, intr=intr, motion=args.motion, xi_noise_sigma=0.003
    )
    frames = sseq.frames()
    gt_poses = sseq.gt_poses

    slam = SlamSystem(intr, cfg, device=args.device)

    out_dir = args.out_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        logger = JsonlLogger(os.path.join(out_dir, "frames.jsonl"))
        logger.header(cfg, intr)
    else:
        logger = JsonlLogger(None)

    # Ingestion: a background thread produces frames (prefetch_frames) while
    # the main thread feeds them in chunks of config.pipeline_depth. The
    # port's feed() processes one frame at a time, so the depth only sizes
    # the chunks.
    if args.max_frames is not None:
        frames = itertools.islice(frames, args.max_frames)

    timer = StageTimer()
    t_start = time.perf_counter()
    n = 0
    logged = 0

    def _log_new():
        nonlocal logged, n
        traj = slam.trajectory()
        for i in range(logged, len(slam.stats)):
            rec = dict(slam.stats[i])
            rec["type"] = "frame"
            rec["T_wc"] = traj[i][1].tolist()
            logger.write(rec)
            if not args.quiet and n % 10 == 0:
                print(
                    f"frame {n:5d} kf={rec['kf_id']:3d} "
                    f"overlap={rec.get('overlap', 1):.2f} "
                    f"lost={int(rec.get('lost', False))}",
                    file=sys.stderr,
                )
            n += 1
        logged = len(slam.stats)

    chunk = []
    with timer.stage("frames"):
        for f in prefetch_frames(frames, depth=cfg.pipeline_depth + 2):
            chunk.append(f)
            if len(chunk) >= cfg.pipeline_depth:
                slam.feed(chunk)
                _log_new()
                chunk = []
        if chunk:
            slam.feed(chunk)
            _log_new()
    with timer.stage("finish"):
        slam.finish()
        _log_new()
    wall = time.perf_counter() - t_start

    result = {
        "frames": n,
        "keyframes": len(slam.manager.keyframes),
        "loop_closures": slam.backend.num_loop_closures if slam.backend else 0,
        "lost_frames": int(sum(r.get("lost", 0) for r in slam.stats)),
        "wall_s": round(wall, 2),
        "fps": round(n / wall, 2),
        "config_hash": cfg.config_hash(),
    }

    if out_dir:
        slam.save_trajectory(os.path.join(out_dir, "trajectory.txt"))
        slam.save_map(os.path.join(out_dir, f"map.{args.map_format}"), voxel=args.voxel)
        result["out_dir"] = out_dir

    if args.eval:
        est = slam.poses()
        gt0 = np.linalg.inv(gt_poses[0])
        gt = [gt0 @ T for T in gt_poses][: len(est)]
        result["ate"] = absolute_trajectory_error(gt, est)
        result["rpe"] = relative_pose_error(gt, est)

    logger.write({"type": "result", **result})
    logger.close()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
