"""Mover-row seed sweep (the port's copy of ``rgbid_tpu/eval/seed_sweep.py``).

Every headline mover number through round 4 was seed 3 (the recorded
gauntlet protocol), the attack probe's acceptance thresholds
(probe_margin=0.9, the minority-cap candidate pool, the info-density
argmax) were calibrated on those same seed-3 clips, and the one off-seed
clip ever run (seed-1 walking, test_consensus) exposed a real wrong-way
probe acceptance.  A different seed is an independent scene draw —
geometry, textures, mover texture, AND noise — so the sweep is the
validation that the thresholds generalise.

Also adjudicates the round-5 profiler's candidate iteration schedule
(1,8,12,20) (−5.7 ms/frame = 16.3 fps, but −70% on both near-mover rows
at seed 3): each seed runs under BOTH schedules so the accuracy cost is
measured as a per-seed distribution, not a single draw.

    python -m rgbid_tpu_torch.eval.seed_sweep [--frames 60] [--res 320x240]
        [--seeds 3,1,2,5] [--schedules "2,6,12,20;1,8,12,20"] [--device cuda|cpu]

One process; the gauntlet runner reuses one system per configuration and
schedule within each seed's call.
"""

from __future__ import annotations

import argparse
import json

from . import gauntlet

MOVER_ROWS = "moving_occluder_near,moving_occluder_near_walking,fr3_walking_standin"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--res", default="320x240")
    ap.add_argument("--seeds", default="3,1,2,5")
    ap.add_argument("--schedules", default="2,6,12,20;1,8,12,20")
    ap.add_argument("--only", default=MOVER_ROWS)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    out = []
    for sched in args.schedules.split(";"):
        for seed in args.seeds.split(","):
            rows = gauntlet.main(
                [
                    "--frames", str(args.frames),
                    "--res", args.res,
                    "--only", args.only,
                    "--seed", seed,
                    "--json",
                    "--set", f"tracking.iters=[{sched}]",
                    "--device", args.device,
                ]
            )
            for r in rows:
                r["iters"] = sched
                out.append(r)
                print("SWEEP " + json.dumps(r), flush=True)
    return out


if __name__ == "__main__":
    main()
