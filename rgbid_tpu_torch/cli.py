"""Command-line runner (the port's copy of ``rgbid_tpu/cli.py``).

    python -m rgbid_tpu_torch --synthetic 60 --out-dir /tmp/run
    python -m rgbid_tpu_torch --tum /data/rgbd_dataset_freiburg1_desk --eval
    python -m rgbid_tpu_torch --live /data/capture --live-idle 5
    python -m rgbid_tpu_torch --tum DIR --snapshot state.npz
    python -m rgbid_tpu_torch --tum DIR --resume state.npz --device cpu

Outputs: TUM-format trajectory, PLY map, JSONL per-frame log, and (with
ground truth: the synthetic sequence's, or a TUM directory's
groundtruth.txt associated by timestamp) ATE/RPE metrics printed as JSON.
The system runs on ``--device`` (the card by default). ``--snapshot``
writes the JAX package's snapshot format and ``--resume`` reads it, from
either package. ``--viz`` writes ``trajectory.png`` and ``map_topdown.png``
into ``--out-dir``; ``--live-viz DIR`` turns the live viewer on
(``viz.enabled``), which keeps ``DIR/live.png`` up to date while it runs.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

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
    src.add_argument("--tum", metavar="DIR", help="TUM RGB-D sequence directory")
    src.add_argument(
        "--live",
        metavar="DIR",
        help="live capture: follow a growing TUM-format directory (the layout every "
        "headless RGB-D capture daemon writes) and track frames as they arrive; the "
        "stream ends after --live-idle seconds without new frames",
    )
    src.add_argument("--synthetic", type=int, metavar="N", help="render N synthetic frames")
    ap.add_argument("--live-idle", type=float, default=10.0,
                    help="seconds without new frames before a --live stream ends")
    ap.add_argument("--motion", default="orbit", choices=["orbit", "loop", "static"])
    ap.add_argument("--config", metavar="JSON", help="config file (JSON)")
    ap.add_argument(
        "--preset",
        default=None,
        choices=["default", "sandbox", "real-v5e"],
        help="named config preset (SlamConfig.preset); --config/--set apply on top",
    )
    ap.add_argument(
        "--calib",
        metavar="FILE",
        help="camera calibration file (fx fy cx cy [w h] [k1 k2 p1 p2 k3]); a "
        "calibration.txt inside the TUM directory is picked up automatically",
    )
    ap.add_argument(
        "--intrinsics",
        metavar="fx,fy,cx,cy[,w,h]",
        help="override camera intrinsics (defaults: TUM per-sequence / synthetic)",
    )
    ap.add_argument("--set", action="append", metavar="KEY=VAL", help="config override (dotted)")
    ap.add_argument("--out-dir", default=None, help="write trajectory/map/log here")
    ap.add_argument("--snapshot", default=None, help="write a full-state snapshot here")
    ap.add_argument("--resume", default=None, help="resume from a snapshot file")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--eval", action="store_true", help="print ATE/RPE vs ground truth")
    ap.add_argument("--voxel", type=float, default=0.01, help="map voxel downsample (m)")
    ap.add_argument("--map-format", default="ply", choices=["ply", "pcd"], help="map export format")
    ap.add_argument("--viz", action="store_true", help="write trajectory/map PNGs")
    ap.add_argument(
        "--live-viz",
        metavar="DIR",
        default=None,
        help="live 3-pane viewer: periodically write DIR/live.png while running",
    )
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    from .core.camera import DEFAULT, Intrinsics
    from .core.config import SlamConfig
    from .datasets import prefetch_frames
    from .datasets import synthetic as synth
    from .eval import absolute_trajectory_error, relative_pose_error
    from .eval.metrics import associate_trajectories, trajectory_from_tum_rows
    from .system import SlamSystem
    from .utils.logging import JsonlLogger
    from .utils.profiling import flight_summary

    cfg = SlamConfig.preset(args.preset) if args.preset else SlamConfig()
    if args.config:
        with open(args.config) as f:
            cfg = SlamConfig.from_json(f.read())
    overrides = _parse_set(args.set)
    if overrides:
        cfg = cfg.override(**{k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items()})
    if args.live_viz:
        cfg = cfg.override(**{"viz.enabled": True, "viz.out_dir": args.live_viz})

    # Frame source.
    gt_poses, seq = None, None
    custom_intr = None
    if args.intrinsics:
        vals = [float(x) for x in args.intrinsics.split(",")]
        if len(vals) == 4:
            vals += [640, 480]
        custom_intr = Intrinsics(vals[0], vals[1], vals[2], vals[3], int(vals[4]), int(vals[5]))
    if args.tum:
        from .datasets.tum import TumSequence

        seq = TumSequence(args.tum, intrinsics=custom_intr, calib_file=args.calib)
        intr = seq.intrinsics
        frames = seq.frames()
    elif args.live:
        from .datasets.live import LiveSource

        live = LiveSource(args.live, idle_timeout=args.live_idle, intrinsics=custom_intr,
                          calib_file=args.calib)
        intr = live.intrinsics
        frames = live.frames()
    else:
        intr = custom_intr or DEFAULT
        sseq = synth.generate_sequence(
            n_frames=args.synthetic, intr=intr, motion=args.motion, xi_noise_sigma=0.003
        )
        frames = sseq.frames()
        gt_poses = sseq.gt_poses

    if args.resume:
        from .utils import snapshot

        slam = snapshot.restore(args.resume, cfg, device=args.device)
    else:
        slam = SlamSystem(intr, cfg, device=args.device)

    out_dir = args.out_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        logger = JsonlLogger(os.path.join(out_dir, "frames.jsonl"))
        logger.header(cfg, intr)
    else:
        logger = JsonlLogger(None)

    # Ingestion: a background thread reads frames (prefetch_frames) while
    # the main thread feeds them in chunks of config.pipeline_depth: each
    # chunk is one flight (feed dispatches its frames, then reads their
    # results back once).
    if args.max_frames is not None:
        frames = itertools.islice(frames, args.max_frames)

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
    for f in prefetch_frames(frames, depth=cfg.pipeline_depth + 2):
        chunk.append(f)
        if len(chunk) >= cfg.pipeline_depth:
            slam.feed(chunk)
            _log_new()
            chunk = []
    if chunk:
        slam.feed(chunk)
        _log_new()
    slam.finish()
    _log_new()
    wall = time.perf_counter() - t_start
    flights = flight_summary(slam.flights())

    result = {
        "frames": n,
        "keyframes": len(slam.manager.keyframes),
        "loop_closures": slam.backend.num_loop_closures if slam.backend else 0,
        "lost_frames": int(sum(r.get("lost", 0) for r in slam.stats)),
        "wall_s": round(wall, 2),
        "fps": round(n / wall, 2),
        # The operator's view of the host path: microseconds a frame in each
        # span of the flight log, and the card's idle share of the flights.
        "host_us_per_frame": {k: round(v, 1) for k, v in flights["us_per_frame"].items()},
        "device_idle_pct": flights["device_idle_pct"],
        "config_hash": cfg.config_hash(),
    }

    if out_dir:
        slam.save_trajectory(os.path.join(out_dir, "trajectory.txt"))
        slam.save_map(os.path.join(out_dir, f"map.{args.map_format}"), voxel=args.voxel)
        result["out_dir"] = out_dir
        if args.viz:
            from .utils import viz

            trajs = [("estimate", slam.poses())]
            if gt_poses is not None:
                gt0 = np.linalg.inv(gt_poses[0])
                trajs.append(("ground truth", [gt0 @ T for T in gt_poses]))
            viz.plot_trajectory(trajs, os.path.join(out_dir, "trajectory.png"),
                                keyframe_poses=[kf.T_wk for kf in slam.manager.keyframes])
            cloud = slam.map_points(voxel=args.voxel)
            if len(cloud):
                viz.plot_map_topdown(cloud, os.path.join(out_dir, "map_topdown.png"))

    if args.snapshot:
        from .utils import snapshot

        snapshot.save(slam, args.snapshot)
        result["snapshot"] = args.snapshot

    if args.eval:
        est = slam.poses()
        if gt_poses is not None:
            gt0 = np.linalg.inv(gt_poses[0])
            gt = [gt0 @ T for T in gt_poses][: len(est)]
            result["ate"] = absolute_trajectory_error(gt, est)
            result["rpe"] = relative_pose_error(gt, est)
        elif seq is not None and seq.groundtruth is not None:
            ts_est = np.asarray([t for t, _ in slam.trajectory()])
            ts_gt, gt_all = trajectory_from_tum_rows(seq.groundtruth)
            matches = associate_trajectories(ts_est, ts_gt)
            gt = [gt_all[j] for _, j in matches]
            est_m = [est[i] for i, _ in matches]
            result["ate"] = absolute_trajectory_error(gt, est_m)
            result["rpe"] = relative_pose_error(gt, est_m)

    logger.write({"type": "result", **result})
    logger.close()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
