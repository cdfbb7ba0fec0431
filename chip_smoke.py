#!/usr/bin/env python3
"""On-card smoke test of rgbid_tpu_torch (the PyTorch/CUDA port).

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this repository around it; exits non-zero
otherwise. Phases, each printing its own lines:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds csrc/*.cu from this checkout (timed);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, with the stated tolerances. The
   fused IRLS kernels (one launch = evaluation, 6x6 solve and pose update;
   in IC exact mode the Student-t scale phases too) are held to the plain
   evaluation followed by ``ic_update``, in every layout, in a few-valid
   case (the update suppressed) and in a rerun (bit-identical); the scale
   step alone, the one-launch fusion step (480x640 and 641x481, growth
   on and off) and the consensus vote's stratified reduction (VGA and the
   odd camera: the vote's L2 and L1 layouts, K 1 and 16, strata scrambled
   pixel by pixel with one stratum empty, and L0, where some threads take
   two pixels; analyze/decide on both sums where K is 6) are
   held to their plain versions and rerun, and the fusion kernel again as
   ``fuse_inverse_depth`` runs it (growth off, no pose-noise floor; the
   mask it writes equal to its input). The ESM kernel again with
   bfloat16 planes in every mix the tracker uses (``BF16_MIXES``: the
   IRLS loop's, the vote's and the rescue evidence's under
   ``plane_dtype`` "bf16", and the two ablation splits') at every level's
   layout and at the odd camera's L1 and L0, and the stratified kernel at
   L2 and L1 in the vote's mixes, each against its plain version on the
   same bf16 tensors and rerun; then the early exit in the ESM step, the
   IC lagged step and the IC exact step at sigma_iters 2 and 3 (whose grid
   barriers a block leaving alone would deadlock): a previous step just
   under the tolerance leaves the output equal to it bit for bit and the
   workspace as found, one just over runs; SpmdTracker's two evaluations,
   ``ic_result`` (the lagged IC launch's result vector) against the plain
   lagged pass and ``ic_sigma_stats`` against ``sigma_stats_plain``, at
   its layouts (VGA L0 whole and its 240- and 120-row bands); then the
   solve alone
   (``irls_solve_step``, csrc/irls_solve.cu, the row-sharded trackers'
   end of an iteration) against ``ic_update`` on a tracked, a few-valid and
   a non-positive-definite result, the last two again with ``min_valid``
   -inf (SpmdTracker's rule: a few-valid step is taken), the split step
   (result-only launch,
   ``allreduce_irls`` over one rank, the solve) bit-equal to the fused
   ``esm_irls_step`` at every level's layout, and its early exit; then the
   consensus vote kernel (``csrc/consensus_vote.cu``) against its plain
   version on the CPU on the consensus test's six synthetic cases and
   seeded random sums and on the stratified kernel's VGA L2 / L1 sums (K 1,
   6, 16), from a fresh state and one with a stratum out: member vectors,
   state, rerun word and decision words equal, deltas within 1e-6 of the
   largest; and the predicate word ``go`` of the ESM step at every level
   and of fusion at 480x640 and 641x481: held (0) the output is ``hold`` /
   the input planes bit for bit, 1 the launch without the word; and the
   fusion kernel against the numpy oracle (``reference_cpu/fusion.py``) at
   tests/test_fusion.py's rules on a noisy VGA pair: ``fuse_inverse_depth``
   against ``fuse``, ``fuse_frame`` with growth on a hole-punched keyframe
   against ``fuse_grow``;
   Then [api]: the JAX package's smaller public functions (``core.se3``'s
   identity, from_rt, transform_points and quaternions, ``core.camera``'s
   pixel grid and pinhole maps, ``ops.warp.bilinear_sample``,
   ``ops.image.build_pyramids_multi``, ``tracking.step.unpack_frame``) on
   the card at VGA against the same calls on the CPU, each once under
   set_sync_debug_mode("error"), and µs a call;
4. main paths: SlamSystem over synthetic VGA sequences with known ground
   truth, five times, and a sixth over a closed loop (item 6): the ESM configuration with the consensus off, the
   default configuration (``SlamConfig()``, back end off: ESM with the
   motion consensus) on the rigid sequence and on a mover sequence (a
   near panel crossing at walking speed), then the inverse-compositional
   (IC) configuration with lagged and then exact Student-t scales. Each
   run checks the launch counts of the captured step, one replay per
   tracked frame (one IRLS launch per iteration, and under the consensus
   the masked reruns' and the rescue pyramid's, always enqueued, two
   stratified and two vote launches; one fusion launch; the scale phases
   inside the IC exact launches), the IRLS launches that ran on the device
   (40 per tracked frame plus the rerun iterations plus 42 per rescue, as
   the result vectors report them), keyframe switches, lost frames, finite
   poses, its ATE bound, that the consensus fired on the mover, host reads
   (one per tracked frame plus the finalizes) against the syncs PyTorch
   reports, and run-to-run bit-identity, and prints ms/frame. Then
   [flight]: the default configuration on the rigid, mover and loop
   sequences and IC lagged, each as ``feed(flight_depth=32)`` and as a
   ``process_frame`` loop (poses and records bit-equal, one read per
   flight, one replay per tracked frame, every dispatch silent under
   set_sync_debug_mode("error")), ms/frame of both and kernels per tracked
   frame, and a relocalization inside a flight on the reloc sequence with
   the back end on;
5. times: each kernel and its plain version, with CUDA events and with
   torch.profiler (the kernel's device time both ways: the profiler's
   kernel durations, and CUDA events around calls run back to back behind
   a spin), beside the least time the card could take (bytes over
   3.35 TB/s, or operations over 67 TFLOP/s f32); the ESM kernel at every
   pyramid level's layout (and with bf16 planes), the stratified reduction
   at L2 and L1 (f32 and the vote's bf16 mix), the IC step lagged and
   exact, and a skipped (early-exit) ESM launch. Then torch.profiler over
   tracked frames of a default-configuration run and of a preset run:
   device ops per frame (fused and not) and the largest of them, and the
   kernels each upload codec's decode launches. Profiling runs last,
   because it slows later launches.
6. the back end's own functions on the card. The ESM step at the
   six layouts ``RelocScorer`` gives it (VGA and 641x481 with ``reloc_level``
   2), against its plain version, in phase 3 and timed in phase 5. The
   scorer on the card against the scorer on the CPU on a revisit, an
   adjacent and an unrelated pair: the same ``accept``, the pose within a
   stated tolerance, the margins to every gate, exactly 3 x ``reloc_iters``
   launches per pair in the scorer's own count, one read per call. The loop
   run: the default configuration with tight keyframe limits over a closed
   path, checked like every main-path run (and in every run: an odometry
   edge per switch, reloc planes on every keyframe, one read per finalize);
   then (last keyframe, keyframe 0) verified by the scorer, the loop edge
   built as ``LoopCloser`` builds it, and ``PoseGraph.optimize`` over the
   run's edges plus that one: final <= initial error, finite poses, and
   the keyframe ATE no worse than before by more than 1 mm.
7. [orb]: the port's numpy ORB on the loop sequence's first, third-last and
   last frame at VGA: keypoints per octave, host ms per call, and the
   Hamming distance of each descriptor's best match in the other view (the
   last frame shows the first frame's image again: distance 0).
8. [backend]: ``SlamConfig()`` as shipped, back end on (tight keyframe
   limits, every gate of the back end at its default), over the loop
   sequence, in turns with the same configuration with the back end off.
   The thread runs beside the front end on the same stream and workspace:
   it finalizes retired keyframes, extracts ORB, queries and feeds the BoW
   database, verifies candidates with the scorer and optimizes the pose
   graph. Checks: no exception swallowed, the thread dead and its queue
   empty after ``finish()``; at least one loop closure found through
   ``LoopCloser.process_keyframe``, each edge within 5 mm of ground truth;
   the pose graph ran and did not raise its error; the ATE bounds; every
   keyframe finalized, all but the last by the thread; reads = syncs with
   every part named; per-frame launch counts those of the back-end-off
   run and the scorer's 3 x ``reloc_iters`` per pair in its own count; and
   the per-frame records of every run, on or off, equal bit for bit.
   Prints the front end's ms/frame on against off, ``finish()``'s wait,
   the thread's ms per keyframe event by part, and where the time of one
   ``score_pairs`` call goes.
9. [reloc]: ``SlamConfig()`` over a sweep that turns away from the start
   view, three dropout frames (noise image, no depth), then the start view
   again in a frame the tracker cannot place: ``process_frame`` itself
   relocalizes against the BoW database (a record with ``relocalized``
   true, a new keyframe within 40 mm of ground truth, an external loop
   edge) and tracks on.

10. [gauntlet]: the port's gauntlet runner (``eval/gauntlet.py``, the
   port's numpy renderer) on three rows of the reference's battery at VGA,
   60 frames, seed 3, ``SlamConfig()`` as shipped (back end on):
   kinect_sensor (motion blur, median, dilation and speckle in the
   renderer), depth_holes (the cubic blob) and mover_then_revisit (90
   frames: the back end must reclaim a mover episode through the pose
   graph). Each row must fall inside the reference's recorded envelope
   (``VGA_RECORDED_MM``) with no loss, finite poses, no exception in the
   thread and exact launch counts; the revisit row must end below 0.6 x the
   odometry's ATE (the same row with the back end off, which its pre-finish
   ATE must equal or undercut) with at least one loop closure. Prints each
   row and the renderer's host ms per frame.
11. [cli]: ``python -m rgbid_tpu_torch --synthetic 40 --max-frames 16
   --eval`` in-process on the card, default configuration: 16 frames, no
   loss, ATE under 10 mm, the trajectory, the map and the JSONL log (a
   header, 16 frame records, a result).

12. [preset]: ``SlamConfig.preset("real-v5e")`` (the u12 codec, the early
   exit, bf16 planes) on the rigid and mover sequences and, back end on,
   on the loop sequence; u12 and u16h alone on the rigid sequence; each
   beside the same run without the knobs in this call: ATE bounds, no loss,
   exact launch counts (the host enqueues the whole budget), the device's
   count of IRLS iterations run per level (at most those enqueued), reads =
   syncs with the step's fixed reads per frame those of the run without
   the knobs, and run-to-run bit-identity. Then the gauntlet's
   kinect_sensor at VGA under the preset's flips. [knobs]: ms/frame of
   SlamConfig(), each knob alone and the preset, in alternating rounds.
   [codecs]: bytes, pack_frame's host us in its native pass and on its
   numpy path (bytes equal, both counters), the upload's host ms and the
   host-to-device copy's device ms per codec.

13. [tum]: the rigid sequence written as a TUM RGB-D directory with the
   port's PNG encoder (rgb/, depth/, the two indexes with the depth stamps
   jittered by up to 10 ms, groundtruth.txt, calibration.txt), then
   ``python -m rgbid_tpu_torch --tum DIR --eval`` in-process on the card
   (``SlamConfig()``, back end off): poses bit-equal to the same frames
   through ``process_frame`` in memory (PNG is lossless), 0 lost, the ATE
   against groundtruth.txt inside the rigid bound, the launch counts equal
   and exact; then ``fuse_inverse_depth`` on the run's last state (one
   fusion launch, growth off). Prints the host ms of a VGA pair's decode
   (native and numpy unfilter, Paeth and Sub rows), of the fr1
   undistortion, and ms/frame of --tum against the run in memory.
14. [live]: a writer thread grows a TUM directory, 20 QVGA frames, while
   ``LiveSource`` streams it through ``SlamSystem`` on the card: every
   frame delivered once, in order, bit-equal, and the stream ends on its
   idle timeout; exact launch counts.
15. [snapshot]: back end off, the rigid sequence saved after 18 frames,
   restored on the card and run to the end: per-frame records and poses
   bit-equal to the uninterrupted run. Back end on, the loop sequence
   saved after ``finish()`` and restored: loop edges and BoW entries
   equal, no thread error after ``finish()`` on either.

16. [viz]: ``SlamConfig()`` (back end off) over the rigid sequence with
   the live viewer on (every 3rd frame, the map pane every snapshot) and
   off: poses and records bit-equal, host reads and launches per frame
   equal, no render error, every published snapshot rendered or dropped,
   live.png decoded by the port's PNG reader; the host ms per render. Then
   ``--viz --live-viz`` through the command line: trajectory.png,
   map_topdown.png and live.png decode.
17. [spmd]: the kernels are built here before any rank starts; then the
   VGA frame pair under ``SlamConfig()``'s tracking settings (4 levels,
   strides (2, 2, 1, 1), the consensus on) through ``ShardedTracker`` on 1
   rank over NCCL (bit-equal to ``Tracker``), and 2 and 4 ranks over gloo,
   every rank on this card (within tests/test_torch_parallel.py's
   tolerances of ``Tracker``); every rank's result the same bits, exact
   launch counts per rank (one solve launch per IRLS iteration); ms per
   tracked pair beside ``Tracker``'s and the all-reduces per pair. At 1
   and 2 ranks ``shard_reloc_batch`` equals ``score_pairs`` pair by pair.
   In the same ranks, ``SpmdTracker`` (the JAX package's single-level IC
   tracker) on the VGA pair at level 0 (480 rows in bands of 480 / ranks),
   25 iterations from a perturbed ground truth: every rank the same bits,
   per rank exactly 25 launches each of ``ic_sigma_stats``, ``ic_normal_eq``
   (``ic_result``) and ``irls_solve_step`` and 75 all-reduces, 1 rank
   within 5e-4 of the same run on the CPU (one gloo rank, the plain
   versions), 2 and 4 ranks within 5e-4 of 1 rank (T; the scales s2i and
   s2x within rtol 1e-4), the error to ground truth under max(2 x the CPU
   run's, 3e-3 / 5: the test's floor scaled as the twist is), no host read
   under NCCL (``set_sync_debug_mode("error")``); ms per iteration.
   A rank that fails ends the run with its exception.

Phases 4, 8-11, [preset] and 13-17 each drive the main path with the launch
counts set to 0 just before and read just after. The second-to-last line is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}. Imports
no JAX and no OpenCV: phases 4-9 render their scenes here with numpy and
scipy, phases 10 and 11 with the port's renderer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch
from scipy import ndimage

import rgbid_tpu_torch as port
from rgbid_tpu_torch import cli, native
from rgbid_tpu_torch.core import se3
from rgbid_tpu_torch.core.camera import TUM_FR1, Intrinsics
from rgbid_tpu_torch.backend import orb
from rgbid_tpu_torch.backend.features import extract_orb
from rgbid_tpu_torch.backend.loop_closure import loop_edge
from rgbid_tpu_torch.backend.pose_graph import PoseGraph
from rgbid_tpu_torch.backend.relocalization import SCORER_DAMPING, RelocScorer, mini_pyramid
from rgbid_tpu_torch.datasets import _cv, live, png, synthetic, tum
from rgbid_tpu_torch.eval import absolute_trajectory_error, gauntlet
from rgbid_tpu_torch.mapping import fusion
from rgbid_tpu_torch.mapping.export import _quat_from_R
from rgbid_tpu_torch.ops import _build, gauss_newton, kernels
from rgbid_tpu_torch.ops.gauss_newton import ic_update
from rgbid_tpu_torch.ops.image import build_pyramid
from rgbid_tpu_torch.ops.warp import backproject_grid
from rgbid_tpu_torch.reference_cpu import fusion as fusion_ref
from rgbid_tpu_torch.reference_cpu import odometry, se3_np
from rgbid_tpu_torch.tracking import consensus
from rgbid_tpu_torch.tracking.step import ProcessFrame, decode_frame, frame_pyramid, gray_from_rgb
from rgbid_tpu_torch.tracking.step import pack_frame
from rgbid_tpu_torch.parallel import ShardedTracker, SpmdTracker, make_mesh, shard_reloc_batch
from rgbid_tpu_torch.parallel.launch import run_ranks
from rgbid_tpu_torch.tracking.tracker import Tracker, template_level
from rgbid_tpu_torch.utils import live_view, snapshot

N_FRAMES = 36
# ATE bound of every main-path run on the rigid sequence: max(2 x the CPU
# run's ATE, 5 mm). The port tracks this same sequence on the CPU in
# tests/test_torch_slice.py::test_chip_smoke_scene_on_cpu (ESM, 0.14 mm),
# tests/test_torch_ic.py::test_chip_smoke_scene_on_cpu_ic (IC, lagged and
# exact) and tests/test_torch_consensus.py::test_chip_smoke_default_config_on_cpu
# (the default configuration), and asserts each ATE stays under half of
# this bound.
ATE_BOUND_M = 5e-3
# The mover sequence's bound, by the same rule: the default configuration
# tracks it on the CPU to 31.8 mm (consensus off: 45.3 mm), and
# test_chip_smoke_default_config_on_cpu asserts that stays under half of
# this bound.
MOVER_ATE_BOUND_M = 0.065
# The loop sequence (a closed path that returns to its start) and what the
# back end's functions must make of it. The default configuration tracks it
# on the CPU in tests/test_torch_loop.py::test_chip_smoke_loop_on_cpu, which
# holds the run's ATE to half of LOOP_ATE_BOUND_M and the change of the
# keyframe ATE under the pose graph to half of LOOP_PG_MARGIN_M.
LOOP_FRAMES = 48
LOOP_ATE_BOUND_M = 5e-3
LOOP_MIN_KEYFRAMES = 6
LOOP_PG_MARGIN_M = 1e-3
# The back-end-on run: a loop edge found through BoW against ground truth
# (the CPU run's one edge, keyframe 0 to 11, lies within 0.3 mm), and the
# relocalized keyframe's position against ground truth. The CPU run
# (tests/test_torch_smoke_backend.py::test_chip_smoke_reloc_on_cpu) recovers the pose
# within 12 mm (the next two frames within 15 mm) from a frame with depth on its left 45% only, at the scorer's
# 160x120; that test holds it to half of this bound.
LOOP_EDGE_TOL_M = 5e-3
RELOC_FRAMES = 34
RELOC_POSE_TOL_M = 40e-3
# The reference's recorded VGA gauntlet table: tests/test_gauntlet.py,
# _VGA_RECORDED_MM (60 frames a row, seed 3, back end on; recorded on a
# TPU). Only the ATE envelopes carry over: (recorded ATE mm, factor), bound
# max(recorded x factor, 1.5 mm). The revisit row must also reclaim: post
# below GAUNTLET_RECLAIM x the odometry's ATE (tests/test_gauntlet.py holds
# it to the pre-finish ATE; phase_gauntlet says why the smoke does not).
VGA_RECORDED_MM = {
    "easy_orbit": (0.80, 1.8),
    "handheld_jitter": (2.62, 1.8),
    "large_motion": (3.33, 2.0),
    "exposure_drift": (3.64, 1.8),
    "depth_holes": (2.38, 1.8),
    "moving_occluder_mid": (4.96, 1.8),
    "moving_occluder_near": (9.44, 3.0),
    "moving_occluder_near_walking": (27.9, 2.0),
    "mover_then_revisit": (18.1, 3.0),
    "two_movers": (19.7, 3.0),
    "kinect_sensor": (1.63, 2.5),
    "fr3_walking_standin": (4.98, 3.0),
    "combined_endurance": (2.39, 1.8),
}
GAUNTLET_RECLAIM = 0.6
GAUNTLET_ROWS = ("kinect_sensor", "depth_holes", "mover_then_revisit")
GAUNTLET_FRAMES = 60
GAUNTLET_SEED = 3
CLI_MAX_ATE_M = 0.01
# Scorer on the card against the scorer on the CPU: the pose of a pair that
# both accept. One IRLS step agrees with its plain version within 1e-6, and
# 36 chained steps on a converging pair contract that difference (measured
# on the card: 1.5e-8, PERF.md section 6).
SCORER_POSE_TOL = 1e-5

# ---------------------------------------------------------------------------
# Synthetic scene: textured planes ray-cast in closed form (numpy + scipy).


def _texture(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """Band-limited multi-octave noise in [0.15, 0.85]."""
    tex = np.zeros((size, size), np.float64)
    amp = 1.0
    for res in (8, 16, 32, 64):
        tex += amp * ndimage.zoom(rng.standard_normal((res, res)), size / res, order=3)
        amp *= 0.55
    tex -= tex.min()
    tex /= max(tex.max(), 1e-9)
    return 0.15 + 0.7 * tex


def make_scene(seed: int = 0):
    """A room corner (back wall, side wall, floor) and a tilted panel
    1.5-4 m in front of the origin; each rect is (p0, eu, ev, texture, tint)."""
    rng = np.random.default_rng(seed)
    rects = [
        ([-4.0, -3.0, 4.0], [8.0, 0, 0], [0, 6.0, 0], [1.0, 0.95, 0.9]),
        ([-2.5, -3.0, 1.0], [0, 0, 3.0], [0, 6.0, 0], [0.9, 1.0, 0.95]),
        ([-4.0, 1.8, 1.0], [8.0, 0, 0], [0, 0, 3.0], [0.95, 0.95, 1.0]),
        ([-0.9, -0.8, 2.0], [1.5, 0.1, 0.45], [0.05, 1.5, -0.1], [1.0, 1.0, 0.85]),
    ]
    return [
        (np.array(p0, float), np.array(eu, float), np.array(ev, float), _texture(rng),
         np.array(tint, float))
        for p0, eu, ev, tint in rects
    ]


def render(scene, intr: Intrinsics, T_wc: np.ndarray, rng, xi_noise: float = 0.002):
    """Ray-cast one frame from camera-to-world pose T_wc.

    Returns (rgb u8 (H, W, 3), depth u16 (H, W), depth_scale 5000) with
    inverse-depth noise and a few rectangular sensor dropouts."""
    h, w = intr.height, intr.width
    u, v = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    d_cam = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, np.ones_like(u)], -1)
    R, o = T_wc[:3, :3], T_wc[:3, 3]
    d_w = d_cam @ R.T
    depth = np.full((h, w), np.inf)
    col = np.zeros((h, w, 3))
    for p0, eu, ev, tex, tint in scene:
        n = np.cross(eu, ev)
        n /= np.linalg.norm(n)
        denom = d_w @ n
        ok = np.abs(denom) > 1e-9
        t = np.where(ok, ((p0 - o) @ n) / np.where(ok, denom, 1.0), np.inf)
        hit_p = o + d_w * np.where(np.isfinite(t), t, 0.0)[..., None]
        rel = hit_p - p0
        g11, g12, g22 = eu @ eu, eu @ ev, ev @ ev
        r1, r2 = rel @ eu, rel @ ev
        det = g11 * g22 - g12 * g12
        a = np.nan_to_num((g22 * r1 - g12 * r2) / det, nan=-1.0, posinf=-1.0, neginf=-1.0)
        b = np.nan_to_num((g11 * r2 - g12 * r1) / det, nan=-1.0, posinf=-1.0, neginf=-1.0)
        inside = (t > 0.05) & np.isfinite(t) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        inside &= t < depth
        if not inside.any():
            continue
        ts = tex.shape[0] - 1
        val = ndimage.map_coordinates(tex, [b[inside] * ts, a[inside] * ts], order=1)
        depth[inside] = t[inside]
        col[inside] = val[:, None] * tint[None, :]
    hit = np.isfinite(depth)
    xi = np.where(hit, 1.0 / np.where(hit, depth, 1.0), 0.0)
    xi = xi + rng.normal(0.0, xi_noise, xi.shape) * hit
    d = np.where(hit & (xi > 1e-3), 1.0 / np.maximum(xi, 1e-3), 0.0)
    for _ in range(3):  # sensor dropout patches
        r0, c0 = rng.integers(0, h - 24), rng.integers(0, w - 32)
        d[r0 : r0 + rng.integers(6, 24), c0 : c0 + rng.integers(8, 32)] = 0.0
    depth_u16 = np.clip(np.round(d * 5000.0), 0, 65535).astype(np.uint16)
    rgb_u8 = np.clip(col * 255.0, 0, 255).astype(np.uint8)
    return rgb_u8, depth_u16


def _rot(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def camera_path(n: int):
    """Smooth sideways-and-forward sweep: ~0.5 m over the sequence, so the
    keyframe's 0.25 m translation limit forces at least one switch."""
    poses = []
    for i in range(n):
        s = i / max(n - 1, 1)
        T = np.eye(4)
        T[:3, :3] = _rot(0.03 * np.sin(2 * np.pi * s), -0.12 * s, 0.02 * np.sin(np.pi * s))
        T[:3, 3] = [0.45 * s, 0.06 * np.sin(2 * np.pi * s), 0.2 * s]
        poses.append(T)
    return poses


def make_sequence(intr: Intrinsics = TUM_FR1, n: int = N_FRAMES, seed: int = 0):
    """Frames [(rgb, depth, t)] and camera-to-world ground truth."""
    scene = make_scene(seed)
    rng = np.random.default_rng(seed + 1)
    gt = camera_path(n)
    frames = [(*render(scene, intr, T, rng), i / 30.0) for i, T in enumerate(gt)]
    return frames, gt


def make_mover_sequence(intr: Intrinsics = TUM_FR1, n: int = N_FRAMES, seed: int = 0):
    """The rigid sequence's scene and camera path with a textured
    fronto-parallel panel (0.5 x 0.7 m) 1.4 m in front of the start,
    moving along +x at walking speed, 0.015 m/frame (0.45 m/s at 30 Hz),
    with the camera: it covers ~15% of the image and pulls the pose
    toward its own motion."""
    scene = make_scene(seed)
    rng = np.random.default_rng(seed + 1)
    tex = _texture(np.random.default_rng(seed + 7))
    gt = camera_path(n)
    frames = []
    for i, T in enumerate(gt):
        panel = (np.array([-0.6 + 0.015 * i, -0.45, 1.4]), np.array([0.5, 0.0, 0.0]),
                 np.array([0.0, 0.7, 0.0]), tex, np.array([1.0, 0.9, 0.8]))
        frames.append((*render(scene + [panel], intr, T, rng), i / 30.0))
    return frames, gt


def loop_path(n: int):
    """A closed path: out to the side and forward, back to the start pose
    (the last pose equals the first), ~0.9 m long, so the keyframe limits of
    ``loop_config`` force a chain of keyframes around it."""
    poses = []
    for i in range(n):
        a = 2.0 * np.pi * i / max(n - 1, 1)
        T = np.eye(4)
        T[:3, :3] = _rot(0.03 * np.sin(a), -0.10 * np.sin(a), 0.02 * np.sin(2.0 * a))
        T[:3, 3] = [0.22 * np.sin(a), 0.06 * (1.0 - np.cos(a)), 0.12 * (1.0 - np.cos(a))]
        poses.append(T)
    return poses


def make_loop_sequence(intr: Intrinsics = TUM_FR1, n: int = LOOP_FRAMES, seed: int = 0):
    """The rigid sequence's scene (or, with another seed, the same room
    with other textures) seen from ``loop_path``."""
    scene = make_scene(seed)
    rng = np.random.default_rng(seed + 1)
    gt = loop_path(n)
    frames = [(*render(scene, intr, T, rng), i / 30.0) for i, T in enumerate(gt)]
    return frames, gt


def reloc_path(n: int):
    """A sweep that turns away from the start view: 1.3 rad of yaw toward
    the side wall and past its end, so the last keyframes see the wall on
    the right of the image and nothing on the left."""
    poses = []
    for i in range(n):
        s = i / max(n - 1, 1)
        T = np.eye(4)
        T[:3, :3] = _rot(0.02 * np.sin(2.0 * np.pi * s), -1.3 * s, 0.0)
        T[:3, 3] = [0.05 * s, 0.0, 0.05 * s]
        poses.append(T)
    return poses


def make_reloc_sequence(intr: Intrinsics = TUM_FR1, n: int = RELOC_FRAMES, seed: int = 0):
    """Frames and camera-to-world ground truth (None on dropout frames) of
    the relocalization run: ``reloc_path``; three dropout frames (a noise
    image without depth); the view of frame 2 again, with depth on the left
    45% of the image only, so that the keyframe that was active before the
    dropout (valid on its right) shares no valid pixel with it and the
    tracker reports the frame lost, while keyframe 0 still covers it; then
    the views of frames 3 and 4, whole. Returns (frames, gt, index of the
    frame that must relocalize)."""
    scene = make_scene(seed)
    rng = np.random.default_rng(seed + 1)
    path = reloc_path(n)
    frames = [render(scene, intr, T, rng) for T in path]
    gt = list(path)
    noise = np.random.default_rng(seed + 2).integers(0, 255, frames[0][0].shape, dtype=np.uint8)
    frames += [(noise, np.zeros_like(frames[0][1]))] * 3
    gt += [None] * 3
    i_reloc = len(frames)
    for k in (2, 3, 4):
        rgb, depth = render(scene, intr, path[k], rng)
        if k == 2:
            depth[:, int(0.45 * intr.width):] = 0
        frames.append((rgb, depth))
        gt.append(path[k])
    return [(rgb, depth, i / 30.0) for i, (rgb, depth) in enumerate(frames)], gt, i_reloc


def loop_config():
    """The default configuration (back end off) with keyframe limits tight
    enough for a chain of keyframes around the loop."""
    return default_config().override(
        **{"keyframe.max_translation": 0.08, "keyframe.max_rotation": 0.08}
    )


def backend_config():
    """``loop_config`` with the back end on, as ``SlamConfig()`` ships it:
    every gate of the back end at its default."""
    return loop_config().override(**{"backend.enabled": True})


def slice_config():
    """The ESM configuration with the motion consensus off."""
    return port.SlamConfig().override(
        **{"tracking.consensus": False, "backend.enabled": False}
    )


def default_config():
    """``SlamConfig()`` with the back end off: ESM with the motion
    consensus, the attack probe and rescue refounding."""
    return port.SlamConfig().override(**{"backend.enabled": False})


def consensus_fired(stats) -> bool:
    """The consensus acted on some frame: a consensus_frac above 5%, or a
    stratum flagged persistently."""
    return (max(s.get("consensus_frac", 0.0) for s in stats) > 0.05
            or any(s.get("cons_flags_persist", 0) > 0 for s in stats))


def ic_config(sigma_mode: str):
    """The inverse-compositional configuration (consensus left at its
    default: the JAX package runs it only in ESM mode)."""
    return port.SlamConfig().override(
        **{"tracking.jacobian": "ic", "backend.enabled": False, "tracking.sigma_mode": sigma_mode}
    )


def sequence_ate(gt, est) -> float:
    gt0 = np.linalg.inv(gt[0])
    return absolute_trajectory_error([gt0 @ T for T in gt], est)["rmse"]


# ---------------------------------------------------------------------------
# Phases


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[device] {name}; count {torch.cuda.device_count()}")
    print(smi)
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    lib = _build.library()
    wall = time.perf_counter() - t0
    print(f"[build] {lib.path.name}: nvcc {lib.build_s:.2f} s, load+build {wall:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build] {line.strip()}")
    return wall


def _time_ms(fn, reps: int = 50) -> float:
    """Median ms per call: CUDA events around `reps` back-to-back calls,
    five rounds after a warm-up (host launch cost included, as the main
    path pays it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        rounds.append(a.elapsed_time(b) / reps)
    return float(np.median(rounds))


def _device_ms(fn, reps: int = 20) -> float:
    """Device time per call: the summed duration of the GPU
    kernels `reps` calls launch, from torch.profiler, over `reps`. A
    profiler window that records no device activity (it happens, rarely) is
    taken again, up to three times; then the time comes from CUDA events,
    launch cost included, and a line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    print("[times] torch.profiler recorded no device time in three windows: CUDA events instead")
    return _time_ms(fn, reps)


def _event_device_ms(fn, reps: int = 50) -> float:
    """Device time per call from CUDA events, median of five rounds: a
    spin kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues ``reps`` calls, so they run back to back and the events time
    the device (the gaps between launches included), not the host's launch
    rate. A round whose spin ended before the host had enqueued every call
    is taken again with a spin twice as long."""
    fn()
    torch.cuda.synchronize()
    cycles, rounds = 20_000_000, []
    while len(rounds) < 5:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        if host_ms >= 0.8 * s.elapsed_time(a):
            cycles *= 2
            continue
        rounds.append(a.elapsed_time(b) / reps)
    return float(np.median(rounds))


def _scaled_err(k: torch.Tensor, p: torch.Tensor):
    """(max |k - p|, max |k - p| / (2e-4 |p| + 1e-5 max|p|)): the second
    is <= 1 when every entry is inside the tolerance."""
    d = (k - p).abs()
    tol = 2e-4 * p.abs() + 1e-5 * p.abs().max().clamp(min=1e-30)
    return float(d.max()), float((d / tol).max())


def _frame_pair(intr: Intrinsics, cfg, geo_min: int = 0, device="cuda"):
    """Keyframe + current pyramid on the card (or ``device``) from two
    frames of the scene (ESM or IC templates, as ``cfg`` says), and the
    ground-truth relative pose as the linearization point."""
    scene = make_scene(0)
    rng = np.random.default_rng(5)
    gt = camera_path(N_FRAMES)
    f0 = render(scene, intr, gt[0], rng)
    f1 = render(scene, intr, gt[3], rng)
    cfg = cfg.override(**{"tracking.esm_geo_min_level": geo_min})
    step = ProcessFrame(intr, cfg, device)
    kf = step.init_keyframe(torch.from_numpy(pack_frame(*f0)).to(device))
    cur = frame_pyramid(torch.from_numpy(pack_frame(*f1)).to(device), cfg)
    T = torch.from_numpy(np.linalg.inv(gt[3]) @ gt[0]).float().to(device)
    return kf, cur, T, step.intrs


ODD_INTR = Intrinsics(fx=517.3, fy=516.5, cx=319.6, cy=239.8, width=641, height=481)


# The card's published peaks (H100 SXM data sheet, 700 W): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float64 outside the tensor cores, the same data sheet (the vote kernel's
# eigensolve).
F64_FLOPS = 34e12
# Operations per template (or, for fusion, level-0) pixel, counted from the
# kernels' sources: projection 25, corners 10, gather and mask 7 per plane
# + 3, residuals and weights ~26, Jacobians ~89 (ESM), the 32 sums ~180.
# Each kernel is bytes-bound by more than 4x, so the counts only need to be
# close.
# The stratified reduction: the ESM point (~200), its 50 masked terms
# (~275), the stratum test (~7 compares) and the pixel's share of its
# warp's group sums (~4).
FLOPS_PER_PIXEL = {"esm": 385, "ic_normal": 256, "ic_sigma": 79, "fusion": 220,
                   "esm_stratified": 486}
# The solve alone, per launch: the damped 6x6 Cholesky and its two
# triangular solves (~150), the SE(3) exp (~90), T . exp (112) and two
# Newton polar iterations (~250).
SOLVE_FLOPS = 600


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _bound(args, outs, flops: float):
    """(bound ms, what bounds it, bytes): each input tensor read once, each
    output written once, against the operations on these inputs."""
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(args))
    nbytes += sum(t.numel() * t.element_size() for t in _tensors(outs))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def _step_errs(ks, Tp, dp):
    """(max |T' - T'_plain|, max |delta - delta_plain|) of a fused step."""
    return float((ks.T - Tp).abs().max()), float((ks.delta - dp).abs().max())


def _flat(step):
    return (step.T, step.delta) + tuple(step.result)


def _fused_extras(name: str, step, chain, result_only, args, few_args):
    """The few-valid case (<= 100 valid pixels: delta exactly 0, T' =
    orthonormalize(T) within 1e-6, as the plain chain) and a rerun of the
    same inputs (bit-identical, and the result-only wrapper's output equal
    to the step's result)."""
    T = args[0]
    ks = step(few_args)
    p, Tp, dp = chain(few_args)
    torch.cuda.synchronize()
    n = float(ks.result.n_valid)
    d_orth = float((ks.T - se3.orthonormalize(T)).abs().max())
    dT, dd = _step_errs(ks, Tp, dp)
    few_ok = (n <= 100 and n == float(p.n_valid) and not bool(ks.delta.any())
              and d_orth <= 1e-6 and dT <= 1e-6)
    print(f"[kernels] {name} few-valid: n_valid {int(n)} (plain {int(p.n_valid)}) delta zero "
          f"{not bool(ks.delta.any())} T' vs orthonormalize(T) max|d| {d_orth:.1e}, vs plain "
          f"chain {dT:.1e} (tol 1e-6) {'OK' if few_ok else 'FAIL'}")
    a, b, r = step(args), step(args), result_only(args)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    same_result = all(torch.equal(x, y) for x, y in zip(a.result, r))
    print(f"[kernels] {name} rerun bit-identical {same}, result-only wrapper equal {same_result} "
          f"{'OK' if same and same_result else 'FAIL'}")
    return few_ok and same and same_result


def _few_valid(mask: torch.Tensor, keep: int = 80) -> torch.Tensor:
    """The template mask with only its first ``keep`` valid pixels left."""
    few = torch.zeros_like(mask)
    idx = mask.flatten().nonzero()[:keep, 0]
    few.view(-1)[idx] = 1.0
    return few


def _spread_valid(mask: torch.Tensor, keep: int = 90) -> torch.Tensor:
    """The template mask with ``keep`` of its valid pixels left, evenly
    spaced over them (a well-posed few-valid system: ``_few_valid``'s
    first pixels lie in a few rows, and their 6x6 system is near
    singular)."""
    few = torch.zeros_like(mask)
    idx = mask.flatten().nonzero()[:, 0]
    few.view(-1)[idx[torch.linspace(0, len(idx) - 1, keep, device=idx.device).long()]] = 1.0
    return few


def _rel(a, b) -> float:
    return float((a - b).abs() / b.abs().clamp(min=1e-30))


def _esm_chain(a, damping: float):
    """The plain version of one fused ESM step: the plain evaluation, then
    ``ic_update``. Returns (result, T', delta)."""
    p = kernels.esm_residuals_and_normal_eq_plain(*a)
    return (p,) + ic_update(a[0], p.H, p.b, damping, p.n_valid)


def _esm_case(label: str, args, damping: float):
    """One layout of the fused ESM step against its plain chain: H and b
    within ``_scaled_err`` <= 1, counts exact (the kernel rounds every
    per-pixel step like the plain version: same operation order, no FMA
    contraction), error and scales within 1e-4 relative, T' and delta
    within 1e-6. Returns (good, max |d|, max share of tolerance, max pose
    error)."""
    ks = kernels.esm_irls_step(*args, damping=damping)
    k = ks.result
    p, Tp, dp = _esm_chain(args, damping)
    torch.cuda.synchronize()
    eH, sH = _scaled_err(k.H, p.H)
    eb, sb = _scaled_err(k.b, p.b)
    exact = bool(k.n_valid == p.n_valid) and bool(k.inlier_frac == p.inlier_frac)
    scal = max(_rel(k.error, p.error), _rel(k.sigma2_int, p.sigma2_int),
               _rel(k.sigma2_xi, p.sigma2_xi))
    dT, dd = _step_errs(ks, Tp, dp)
    good = sH <= 1.0 and sb <= 1.0 and exact and scal <= 1e-4 and dT <= 1e-6 and dd <= 1e-6
    print(f"[kernels] esm {label}: template {tuple(args[3].shape)} stack "
          f"{tuple(args[5].shape)} n_valid {int(k.n_valid)} (plain {int(p.n_valid)}) "
          f"H max|d| {eH:.3e} ({sH:.2f} of tol) b max|d| {eb:.3e} ({sb:.2f} of tol) "
          f"err/sigma rel {scal:.1e} (tol 1e-4) T' max|d| {dT:.1e} delta max|d| {dd:.1e} "
          f"(tol 1e-6) {'OK' if good else 'FAIL'}")
    return good, max(eH, eb), max(sH, sb), max(dT, dd)


def phase_kernels(cfg):
    """Each kernel vs its plain version at the main path's shapes."""
    tc = cfg.tracking
    ok = True
    records = {}
    vga = _frame_pair(TUM_FR1, cfg)
    five = _frame_pair(TUM_FR1, cfg, geo_min=2)
    odd = _frame_pair(ODD_INTR, cfg)
    s2i = torch.full((), 0.01, device="cuda")
    s2x = torch.full((), 0.0025, device="cuda")
    cases = [
        # (label, inputs, level, use_geometric, occlusion_gate, gate_cap)
        ("L0 3-plane geo gate cap", vga, 0, True, True, tc.occ_gate_cap),
        ("L0 3-plane geo off", vga, 0, False, True, tc.occ_gate_cap),
        ("L1 7-plane geo gate", vga, 1, True, True, 0.0),
        ("L1 7-plane no gate", vga, 1, True, False, 0.0),
        ("L2 7-plane geo gate", vga, 2, True, True, 0.0),
        ("L3 7-plane geo gate", vga, 3, True, True, 0.0),
        ("L3 7-plane geo off", vga, 3, False, False, 0.0),
        ("L1 5-plane geo gate", five, 1, True, True, 0.0),
        ("odd L0 3-plane cap", odd, 0, True, True, tc.occ_gate_cap),
        ("odd L1 7-plane gate", odd, 1, True, True, 0.0),
    ]
    strides = tuple(tc.template_stride) + (1,) * tc.levels
    damping = tc.damping

    def step(a):
        return kernels.esm_irls_step(*a, damping=damping)

    def chain(a):
        return _esm_chain(a, damping)

    esm_abs, esm_scaled, esm_pose = 0.0, 0.0, 0.0
    for label, (kf, cur, T, intrs), lvl, geo, gate, cap in cases:
        kl, pts = template_level(kf.levels[lvl], intrs[lvl], strides[lvl])
        args = (T, kl.intensity, pts, kl.mask, kl.jac, cur[lvl].stack7, intrs[lvl],
                tc.student_t_nu, s2i, s2x, geo, tc.gate_sigmas, gate, cap)
        good, e_abs, e_scaled, e_pose = _esm_case(label, args, damping)
        ok &= good
        esm_abs, esm_scaled = max(esm_abs, e_abs), max(esm_scaled, e_scaled)
        esm_pose = max(esm_pose, e_pose)

    # The level-0 layout of the main path (20 of the 40 launches per frame).
    kf, cur, T, intrs = vga
    kl, pts = template_level(kf.levels[0], intrs[0], strides[0])
    l0 = (T, kl.intensity, pts, kl.mask, kl.jac, cur[0].stack7, intrs[0], tc.student_t_nu,
          s2i, s2x, True, tc.gate_sigmas, True, tc.occ_gate_cap)
    few = l0[:3] + (_few_valid(kl.mask),) + l0[4:]
    ok &= _fused_extras("esm L0", step, chain,
                        lambda a: kernels.esm_residuals_and_normal_eq(*a), l0, few)
    records["esm"] = dict(
        name="esm_normal_eq", route="cuda", source="rgbid_tpu_torch/csrc/esm_normal_eq.cu",
        replaces="rgbid_tpu/ops/pallas_kernels.py:455", max_abs_err=esm_abs,
        max_err_of_tol=esm_scaled, max_pose_err=esm_pose,
    )
    # Every level's layout as the main path runs it, coarse to fine.
    timing = []
    for lvl in range(tc.levels - 1, -1, -1):
        kl, pts = template_level(kf.levels[lvl], intrs[lvl], strides[lvl])
        cap = tc.occ_gate_cap if lvl <= tc.occ_gate_cap_level else 0.0
        a = (T, kl.intensity, pts, kl.mask, kl.jac, cur[lvl].stack7, intrs[lvl],
             tc.student_t_nu, s2i, s2x, tc.use_geometric, tc.gate_sigmas, tc.occlusion_gate, cap)
        timing.append(("esm", f"L{lvl}", step, lambda a: chain(a)[1:], a,
                       FLOPS_PER_PIXEL["esm"] * kl.mask.numel(),
                       f"template {tuple(kl.mask.shape)}, stack {tuple(cur[lvl].stack7.shape)}",
                       a))

    # Fusion, one launch (hole guess, pose floor, Kalman update, hits and
    # mask): the keyframe of frame 0 fused with frame 3, at 480x640 and at
    # the odd 641x481, growth on and off, against the plain composition.
    # The covariance is SPD and not diagonal; the tracker's comes out
    # column-major (cholesky_solve), the layout of the odd-size cases.
    fcfg = cfg.fusion
    A = np.random.default_rng(7).standard_normal((6, 6)) * 1e-3
    cov = torch.from_numpy(A @ A.T + np.diag([4e-6, 4e-6, 9e-6, 1e-6, 1e-6, 4e-6])).float().cuda()
    fus_abs = 0.0
    for size, (kf, cur, T, intrs), C in (("480x640", vga, cov),
                                         ("641x481", odd, cov.T.contiguous().T)):
        for label, grow in (("growth on", True), ("growth off", False)):
            args = (kf.levels, kf.var, kf.mask_full, kf.hits, cur[0].xi, cur[0].mask, T, C,
                    intrs[0], dataclasses.replace(fcfg, grow_validity=grow))
            k, k2 = fusion.fuse_frame(*args), fusion.fuse_frame(*args)
            p = fusion.fuse_frame_plain(*args)
            torch.cuda.synchronize()
            e_xi = float((k[0] - p[0]).abs().max())
            e_var = float((k[1] - p[1]).abs().max())
            masks_eq = bool(torch.equal(k[2], p[2])) and bool(torch.equal(k[3], p[3]))
            n_eq = float(k[4]) == float(p[4])
            same = all(torch.equal(a, b) for a, b in zip(k, k2))
            good = masks_eq and n_eq and e_xi <= 1e-6 and e_var <= 1e-9 and same
            ok &= good
            fus_abs = max(fus_abs, e_xi, e_var)
            grown = int((k[2] - kf.mask_full).sum())
            print(f"[kernels] fusion {label} {size}: n_fused {int(k[4])} (plain {int(p[4])}) "
                  f"claims {grown} xi max|d| {e_xi:.3e} (tol 1e-6) var max|d| {e_var:.3e} "
                  f"(tol 1e-9) mask and hits equal {masks_eq}, rerun bit-identical {same} "
                  f"{'OK' if good else 'FAIL'}")
    # fuse_inverse_depth: the same kernel with growth off and a zero pose
    # floor (the covariance as given), against fuse_core_plain with no
    # guess; the mask comes back as the input, and the kernel's own mask
    # plane equals it bit for bit.
    for size, (kf, cur, T, intrs), C in (("480x640", vga, cov),
                                         ("641x481", odd, cov.T.contiguous().T)):
        args = (kf.levels[0].xi, kf.var, kf.mask_full, cur[0].xi, cur[0].mask, T, C, intrs[0],
                fcfg)
        k, k2 = fusion.fuse_inverse_depth(*args), fusion.fuse_inverse_depth(*args)
        p = fusion.fuse_core_plain(*args)
        raw = fusion._fuse_frame_cuda((fusion._Level0(args[0]),), kf.var, kf.mask_full,
                                      torch.zeros_like(kf.var), cur[0].xi, cur[0].mask, T, C,
                                      intrs[0], fcfg, grow=False, floor=False)
        torch.cuda.synchronize()
        e_xi = float((k[0] - p[0]).abs().max())
        e_var = float((k[1] - p[1]).abs().max())
        mask_eq = k[2] is kf.mask_full and bool(torch.equal(raw[2], kf.mask_full))
        n_eq = float(k[3]) == float(p[4])
        same = all(torch.equal(a, b) for a, b in zip(k, k2))
        good = mask_eq and n_eq and e_xi <= 1e-6 and e_var <= 1e-9 and same
        ok &= good
        fus_abs = max(fus_abs, e_xi, e_var)
        print(f"[kernels] fuse_inverse_depth (growth off, no floor) {size}: n_fused {int(k[3])} "
              f"(plain {int(p[4])}) xi max|d| {e_xi:.3e} (tol 1e-6) var max|d| {e_var:.3e} "
              f"(tol 1e-9) mask returned and written equal {mask_eq}, rerun bit-identical "
              f"{same} {'OK' if good else 'FAIL'}")
    records["fusion"] = dict(
        name="fusion", route="cuda", source="rgbid_tpu_torch/csrc/fusion.cu",
        replaces="rgbid_tpu/ops/pallas_kernels.py:294", max_abs_err=fus_abs,
    )
    kf, cur, T, intrs = vga
    fargs = (kf.levels, kf.var, kf.mask_full, kf.hits, cur[0].xi, cur[0].mask, T, cov, intrs[0],
             fcfg)
    # What the kernel must read: six level-0 planes, the coarse inverse
    # depth the hole guess reads, the pose and the covariance.
    reads = (kf.levels[0].xi, kf.var, kf.mask_full, kf.hits, cur[0].xi, cur[0].mask, T, cov,
             *(lv.xi for lv in kf.levels[1:]))
    timing.append(("fusion", "480x640", lambda a: fusion.fuse_frame(*a),
                   lambda a: fusion.fuse_frame_plain(*a), fargs,
                   FLOPS_PER_PIXEL["fusion"] * kf.levels[0].xi.numel(), "480x640, growth on",
                   reads))
    # fuse_inverse_depth reads the five level-0 planes, the pose and the
    # covariance, and returns xi', var' and n_fused (the mask it returns is
    # its input; its hits and mask planes are scratch).
    iargs = (kf.levels[0].xi, kf.var, kf.mask_full, cur[0].xi, cur[0].mask, T, cov, intrs[0],
             fcfg)
    timing.append(("fusion", "kalman-only 480x640",
                   lambda a: (lambda r: (r[0], r[1], r[3]))(fusion.fuse_inverse_depth(*a)),
                   lambda a: fusion.fuse_core_plain(*a), iargs,
                   FLOPS_PER_PIXEL["fusion"] * kf.levels[0].xi.numel(),
                   "480x640, fuse_inverse_depth: growth off, no floor", iargs[:7]))
    return ok, records, timing


def _scorer_level_args(intr: Intrinsics, cfg, scorer: RelocScorer):
    """What the scorer gives the ESM kernel at its three levels, on the
    card: frames 0 and 3 of the loop sequence, their planes at the reloc
    level from the per-frame pyramid, then the scorer's own mini-pyramid
    and ``level_args``. T is the ground-truth relative pose."""
    scene = make_scene(0)
    rng = np.random.default_rng(5)
    gt = loop_path(LOOP_FRAMES)
    sets = []
    for T_wc in (gt[0], gt[3]):
        lvl = frame_pyramid(torch.from_numpy(pack_frame(*render(scene, intr, T_wc, rng))).cuda(),
                            cfg)[scorer.level]
        sets.append(mini_pyramid(torch.stack([lvl.intensity, lvl.xi, lvl.mask])))
    T = torch.from_numpy(np.linalg.inv(gt[3]) @ gt[0]).float().cuda()
    s2i = torch.full((), 0.01, device="cuda")
    s2x = torch.full((), 0.0025, device="cuda")
    tc = cfg.tracking
    out = []
    for l in (2, 1, 0):  # coarse to fine, as the scorer runs them
        intr_l = scorer.intrs[l]
        a = scorer.level_args(sets[0][l], sets[1][l], intr_l)
        out.append((T, *a, intr_l, tc.student_t_nu, s2i, s2x, True, 3.0, True, 0.0))
    return out


def phase_scorer_layouts(records):
    """The fused ESM step at the layouts ``RelocScorer`` gives it (template
    and stack of one size, 7 planes, stride 1, float32 gradients, the
    occlusion gate on, no cap, damping 1e-6): VGA with ``reloc_level`` 2
    (160x120, 80x60, 40x30) and the odd 641x481 camera's three, against the
    plain evaluation plus ``ic_update``, with a rerun (bit-identical). The
    VGA layouts are timed under the ESM kernel's record."""
    cfg = default_config()
    ok, timing = True, []
    rec = records["esm"]

    def step(a):
        return kernels.esm_irls_step(*a, damping=SCORER_DAMPING)

    for cam, intr in (("VGA", TUM_FR1), ("odd", ODD_INTR)):
        scorer = RelocScorer(intr, cfg, "cuda")
        for a in _scorer_level_args(intr, cfg, scorer):
            h, w = a[1].shape
            good, e_abs, e_scaled, e_pose = _esm_case(f"scorer {cam} {w}x{h} 7-plane gate", a,
                                                      SCORER_DAMPING)
            x, y = step(a), step(a)
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for p, q in zip(_flat(x), _flat(y)))
            print(f"[kernels] esm scorer {cam} {w}x{h} rerun bit-identical {same} "
                  f"{'OK' if same else 'FAIL'}")
            ok &= good and same
            rec["max_abs_err"] = max(rec["max_abs_err"], e_abs)
            rec["max_err_of_tol"] = max(rec["max_err_of_tol"], e_scaled)
            rec["max_pose_err"] = max(rec["max_pose_err"], e_pose)
            if cam == "VGA":
                timing.append(("esm", f"reloc {w}x{h}", step,
                               lambda a: _esm_chain(a, SCORER_DAMPING)[1:], a,
                               FLOPS_PER_PIXEL["esm"] * h * w,
                               f"template {(h, w)}, stack {tuple(a[5].shape)}", a))
    return ok, timing


def _stratified_plain(a):
    """The stratified kernel's plain version on the same arguments: the
    one-hot strata from the template inverse depth, then ``stratified_sums``."""
    xi, edges = a[10], a[11]
    strata = consensus.stratum_onehot(xi, a[3], torch.from_numpy(edges).to(xi.device))
    return gauss_newton.stratified_sums(*a[:10], strata, *a[12:])


def _stratified_compare(a, lvl: int, tc, intr_l):
    """The stratified kernel on ``a`` (twice) against its plain version:
    per stratum H, G and b within _scaled_err <= 1, n exact, the error
    within 1e-4 relative, the rerun bit-identical, and at K 6 analyze +
    decide giving the same flags on both sums. Returns (good, max |d|,
    max share of tolerance, text, kernel sums, plain sums) (host arrays)."""
    K = len(a[11]) - 1
    k, k2, p = kernels.esm_stratified(*a), kernels.esm_stratified(*a), _stratified_plain(a)
    torch.cuda.synchronize()
    kh, ph = k.cpu().numpy(), p.cpu().numpy()
    ku, pu = gauss_newton.unpack_stratified(k), gauss_newton.unpack_stratified(p)
    e_abs, scaled = 0.0, 0.0
    for i in (0, 1, 3):  # H, b, G: per stratum
        for j in range(K):
            ea, es = _scaled_err(ku[i][j], pu[i][j])
            e_abs, scaled = max(e_abs, ea), max(scaled, es)
    n_exact = bool(torch.equal(ku[2], pu[2]))
    err_rel = float(((ku[4] - pu[4]).abs() / pu[4].abs().clamp(min=1e-30)).max())
    same = bool(torch.equal(k, k2))
    good = scaled <= 1.0 and n_exact and err_rel <= 1e-4 and same
    text = (f"n per stratum {ph[:, 27].astype(int).tolist()} H/b/G {scaled:.2f} of tol, n exact "
            f"{n_exact}, err rel {err_rel:.1e} (tol 1e-4), rerun bit-identical {same}")
    if K == 6:
        flags = np.array_equal(_verdicts(kh, lvl, tc, intr_l), _verdicts(ph, lvl, tc, intr_l))
        good &= flags
        text += f", analyze/decide flags equal {flags}"
    return good, e_abs, scaled, text, kh, ph


def _verdicts(sums, level: int, tc, intr_l):
    """analyze + decide (the plain version, on the CPU) on one vote's
    (K, 50) host sums, under a cold and a ripe history: the flags the
    tracker would act on."""
    Hk, bk, nk, Gk, ek = gauss_newton.unpack_stratified(torch.from_numpy(sums))
    tol = tc.consensus_tol * (intr_l.fx * 2.0**level / tc.consensus_ref_fx)
    v = consensus.analyze(Hk, bk, nk, Gk, ek, tol, tc.consensus_min_frac,
                          tc.consensus_err_ratio, tc.consensus_err_floor)
    out = [v.excluded, v.hostage, v.dominant, v.majority_ok.float()]
    for hist in (torch.zeros_like(nk), torch.full_like(nk, 5.0)):
        d = consensus.decide(v, hist, nk, tc.consensus_trigger_frac, tc.consensus_max_frac,
                             tc.consensus_persist)
        out += [d.member, d.triggered.float(), d.rescue.float()]
    return torch.cat([x.reshape(-1) for x in out]).numpy()


# The consensus's synthetic cases (tests/test_consensus.py's six) and seeded
# random sums, (Hk, bk, nk, Gk, ek, prev_counts) float32 each, K strata:
# tests/test_torch_consensus.py holds analyze / decide to the JAX package on
# them, and [kernels] holds the vote kernel to its plain version.
CONSENSUS_K = 6


def _eye_stack(scales, nk):
    return np.stack([s * np.eye(6) for s in scales]).astype(np.float32) * nk[:, None, None]


def consensus_fixture(name):
    """(Hk, bk, nk, Gk, ek, prev_counts) of tests/test_consensus.py's six
    synthetic cases, float32."""
    f32, K = np.float32, CONSENSUS_K
    if name == "majority":
        nk = np.array([2000.0, 1500.0, 1800.0, 1700.0, 2500.0, 50.0], f32)
        d = np.zeros((K, 6), f32)
        d[0, 0], d[1, 1], d[2, 0], d[2, 2], d[3, 0], d[3, 1] = 2e-4, 3e-4, -2e-4, 1e-4, 1e-4, -1e-4
        d[4, 0], d[4, 1] = 0.02, 0.01
        Hk = _eye_stack([1e4, 1e4, 1e4, 1e4, 1e6, 1e2], nk)
        bk = np.einsum("kij,kj->ki", Hk, d).astype(f32)
        return Hk, bk, nk, _eye_stack([1e4] * K, nk), (0.1 * nk).astype(f32), np.full(K, 10.0, f32)
    if name == "static":
        rng = np.random.default_rng(0)
        nk = rng.uniform(500, 3000, K).astype(f32)
        d = rng.normal(0, 3e-4, (K, 6)).astype(f32)
        Hk = _eye_stack([1e4] * K, nk)
        bk = (np.einsum("kij,kj->ki", Hk / nk[:, None, None], d) * nk[:, None]).astype(f32)
        return Hk, bk, nk, _eye_stack([1e4] * K, nk), (0.1 * nk).astype(f32), np.full(K, 10.0, f32)
    if name == "error_outlier":
        nk = np.array([2000.0, 1800.0, 2200.0, 900.0, 0.0, 0.0], f32)
        n1 = np.maximum(nk, 1)
        ek = (np.array([0.1, 0.15, 0.12, 4.8, 0.0, 0.0], f32) * n1).astype(f32)
        return (_eye_stack([1e4] * K, n1), np.zeros((K, 6), f32), nk, _eye_stack([1e4] * K, n1),
                ek, np.full(K, 10.0, f32))
    if name == "hostage":
        nk = np.array([0.0, 4900.0, 3300.0, 1800.0, 0.0, 0.0], f32)
        ek = (np.array([0.0, 0.07, 0.9, 0.15, 0.0, 0.0], f32) * nk).astype(f32)
        return (_eye_stack([0.0, 2e3, 8e3, 2e5, 0.0, 0.0], nk), np.zeros((K, 6), f32), nk,
                _eye_stack([1e4] * K, nk), ek, np.array([0, 0, 0, 5.0, 0, 0], f32))
    if name == "two_voter":
        nk = np.array([0.0, 4700.0, 5300.0, 0.0, 0.0, 0.0], f32)
        d = np.zeros((K, 6), f32)
        d[1, 0], d[2, 0] = 0.02, -0.02
        Hk = _eye_stack([1e4] * K, nk)
        bk = (np.einsum("kij,kj->ki", Hk, d) / np.maximum(nk, 1.0)[:, None] * nk[:, None])
        return (Hk, bk.astype(f32), nk, _eye_stack([1e4] * K, nk), (0.1 * nk).astype(f32),
                np.full(K, 10.0, f32))
    if name == "dominance":
        nk = np.array([0.0, 4700.0, 3200.0, 2100.0, 0.0, 0.0], f32)
        return (_eye_stack([0.0, 4e3, 1e4, 3e4, 0.0, 0.0], nk), np.zeros((K, 6), f32), nk,
                _eye_stack([1e4] * K, nk), (0.1 * nk).astype(f32), np.full(K, 10.0, f32))
    raise KeyError(name)


def consensus_random_sums(seed, even_voters=False, all_agree=False, k=CONSENSUS_K):
    """Seeded random per-stratum sums of ``k`` strata: SPD H and G with a
    wide but bounded eigenvalue spread, corrections of mixed size, errors
    around the outlier floor. ``even_voters``: four voting strata of six
    (an even count, the median's two-middle-values case); ``all_agree``:
    every stratum is converged (b = 0), so every hypothesis has the same
    support and the first index must win the argmax."""
    rng = np.random.default_rng(seed)
    f32, K = np.float32, k
    nk = rng.uniform(800, 4000, K).astype(f32)
    if even_voters:
        nk[[1, 4]] = rng.uniform(5, 20, 2).astype(f32)
    Hk, Gk = [], []
    for _ in range(K):
        Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        ev = np.exp(rng.uniform(np.log(1e2), np.log(1e5), 6))
        Hk.append(Q @ np.diag(ev) @ Q.T)
        Q2, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        Gk.append(Q2 @ np.diag(np.exp(rng.uniform(np.log(1e3), np.log(3e4), 6))) @ Q2.T)
    Hk = (np.stack(Hk) * nk[:, None, None]).astype(f32)
    Gk = (np.stack(Gk) * nk[:, None, None]).astype(f32)
    d = rng.normal(0, 2e-3, (K, 6))
    if all_agree:
        d[:] = 0.0
    else:
        d[rng.integers(K)] += rng.normal(0, 3e-2, 6)
    bk = np.einsum("kij,kj->ki", Hk, d).astype(f32)
    ek = (rng.uniform(0.05, 0.3, K) * nk).astype(f32)
    if not all_agree:
        ek[rng.integers(K)] = f32(rng.uniform(1.0, 5.0)) * nk[0]
    prev = rng.integers(0, 6, K).astype(f32)
    return Hk, bk, nk, Gk, ek, prev


CONSENSUS_CASES = ["majority", "static", "error_outlier", "hostage", "two_voter", "dominance"]
CONSENSUS_RANDOM = [(s, False, False) for s in range(8)] + [(100, True, False), (101, True, False),
                                                  (200, False, True)]


def consensus_edge_sums(name):
    """(Hk, bk, nk, Gk, ek, prev_counts) of the vote's edge cases, float32:
    ``k<K>`` seeded random sums of K strata (the vote kernel's groups of
    four strata a warp and its rows of eight pairs end at K 4, 8, 12 and
    16); ``zero_pixels`` a stratum with no pixel (all its sums 0);
    ``apq_zero`` a stratum whose H[0][1], the first rotation's pivot, is 0
    at entry; ``tied_medians`` equal per-pixel errors among the voters, +0
    and -0 among them, around the middle of both medians; ``tied_support``
    a stratum equal to the first one, so two hypotheses share the best
    support; ``nan_h``, ``inf_g``, ``inf_err``, ``nan_err``, ``inf_nk``,
    ``nan_nk`` a NaN or an infinity in one stratum's sums (under ``nan_h``
    every information share is NaN, the attack probe fires, and its
    argmax must land on the first NaN, stratum 2)."""
    f32 = np.float32
    if name.startswith("k"):
        k = int(name[1:])
        return consensus_random_sums(300 + k, k=k)
    Hk, bk, nk, Gk, ek, prev = consensus_random_sums(
        {"zero_pixels": 3, "tied_medians": 5, "tied_support": 6, "nan_h": 10}.get(name, 4),
        k=8 if name == "tied_medians" else CONSENSUS_K)
    if name == "zero_pixels":
        Hk[2], bk[2], nk[2], Gk[2], ek[2] = 0.0, 0.0, 0.0, 0.0, 0.0
    elif name == "apq_zero":
        Hk[1, 0, 1] = Hk[1, 1, 0] = 0.0
    elif name == "tied_medians":
        nk[:] = f32(2500.0)
        nk[6:] = f32(40.0), f32(30.0)  # two non-voters
        per_pixel = np.array([0.5, 0.5, 0.0, -0.0, 0.5, 1.7, 0.9, 0.9], f32)
        ek[:] = per_pixel * nk
        ek[3] = f32(-0.0)
    elif name == "tied_support":
        for a in (Hk, bk, nk, Gk, ek):
            a[3] = a[0]
    elif name == "nan_h":
        Hk[2, 0, 0] = np.nan
    elif name == "inf_g":
        Gk[4, 1, 1] = np.inf
    elif name == "inf_err":
        ek[1] = np.inf
    elif name == "nan_err":
        ek[5] = np.nan
    elif name == "inf_nk":
        nk[3] = np.inf
    elif name == "nan_nk":
        nk[0] = np.nan
    else:
        raise KeyError(name)
    return Hk, bk, nk, Gk, ek, prev


# The edge cases held to the JAX package on the CPU (tier-1) and, with the
# rest of K 1..16 and the NaN / Inf sums, the vote kernel to vote_plain on
# the card.
CONSENSUS_EDGE_CPU = ["k1", "k5", "k11", "k16", "zero_pixels", "tied_medians"]
CONSENSUS_EDGE = ([f"k{k}" for k in range(1, 17)]
                  + ["zero_pixels", "apq_zero", "tied_medians", "tied_support"]
                  + ["nan_h", "inf_g", "inf_err", "nan_err", "inf_nk", "nan_nk"])




def scrambled_xi(shape, edges: np.ndarray, empty: int, seed: int, odd_values: bool) -> np.ndarray:
    """Inverse depths that put the strata pixel by pixel at random (so that
    every 32 neighbouring pixels hold many strata), each inside its bin,
    with stratum ``empty`` left out; ``odd_values`` adds NaN (above every
    edge: the last stratum), values below the first edge (the first) and
    above the last edge (the last)."""
    rng = np.random.default_rng(seed)
    k = len(edges) - 1
    pick = rng.choice([j for j in range(k) if j != empty], size=shape)
    mid = np.sqrt(edges[:-1] * edges[1:]).astype(np.float32)
    xi = mid[pick]
    if odd_values:
        spots = rng.random(shape)
        xi[spots < 0.03] = np.nan
        xi[(spots >= 0.03) & (spots < 0.06)] = edges[0] * np.float32(0.5)
        xi[(spots >= 0.06) & (spots < 0.09)] = edges[-1] * np.float32(2.0)
    return xi


# The stratified kernel's layouts: (level, K, strata). "depth" takes the
# strata from the template inverse depth as the vote does; "scrambled"
# from scrambled_xi, stratum 2 empty (at K 16 with NaN and out-of-range
# values). L2 and L1 at K 6 are the vote's own; K 1 and 16 are the ends of
# what the kernel takes; the scrambled layouts give every warp many
# strata; L0 (240x320 template pixels) would take 19 clusters, more than
# the workspace's 16 rows, so some threads take two pixels.
STRATIFIED_LAYOUTS = [(2, 6, "depth"), (1, 6, "depth"), (2, 1, "depth"), (1, 16, "depth"),
                      (2, 6, "scrambled"), (1, 16, "scrambled"), (0, 6, "depth")]
EMPTY_STRATUM = 2


def phase_stratified():
    """The consensus vote's stratified kernel against its plain version at
    STRATIFIED_LAYOUTS (template stride as the default configuration,
    VGA and the odd 641x481 camera; the mover sequence's frames 0 and 3,
    so that the panel fills a stratum): per stratum, H, G and b within
    _scaled_err <= 1, n exact, the error within 1e-4 relative, a rerun
    bit-identical, the empty stratum's n 0, and at K 6 analyze + decide
    giving the same flags on the kernel's sums as on the plain ones. The
    vote's own layouts (VGA, L2 and L1, K 6) are timed."""
    cfg = default_config()
    tc = cfg.tracking
    strides = tuple(tc.template_stride) + (1,) * tc.levels
    s2i = torch.full((), tc.init_sigma_int**2, device="cuda")
    s2x = torch.full((), tc.init_sigma_xi**2, device="cuda")
    ok, e_abs, e_scaled = True, 0.0, 0.0
    timing, vote_sums = [], []
    for cam, intr in (("VGA", TUM_FR1), ("odd", ODD_INTR)):
        frames, gt = make_mover_sequence(intr, n=4)
        step = ProcessFrame(intr, cfg, "cuda")
        kf = step.init_keyframe(torch.from_numpy(pack_frame(*frames[0][:2])).cuda())
        cur = frame_pyramid(torch.from_numpy(pack_frame(*frames[3][:2])).cuda(), cfg)
        T = torch.from_numpy(np.linalg.inv(gt[3]) @ gt[0]).float().cuda()
        for lvl, K, strata_from in STRATIFIED_LAYOUTS:
            edges = consensus.stratum_edges(1.0 / cfg.max_depth, 1.0 / cfg.min_depth, K)
            kl, pts = template_level(kf.levels[lvl], step.intrs[lvl], strides[lvl])
            xi = kl.xi
            if strata_from == "scrambled":
                xi = torch.from_numpy(scrambled_xi(tuple(xi.shape), edges, EMPTY_STRATUM,
                                                   10 * lvl + K, K == 16)).cuda()
            a = (T, kl.intensity, pts, kl.mask, kl.jac, cur[lvl].stack7, step.intrs[lvl],
                 tc.student_t_nu, s2i, s2x, xi, edges, tc.use_geometric, tc.gate_sigmas, True)
            good, ea, scaled, text, kh, ph = _stratified_compare(a, lvl, tc, step.intrs[lvl])
            e_abs, e_scaled = max(e_abs, ea), max(e_scaled, scaled)
            if strata_from == "scrambled":
                empty = float(kh[EMPTY_STRATUM, 27]) == 0.0 and int((ph[:, 27] > 0).sum()) == K - 1
                good &= empty
                text += f", stratum {EMPTY_STRATUM} empty {empty}"
            ok &= good
            if cam == "VGA" and lvl in (1, 2):
                vote_sums.append((lvl, K, strata_from, kh, step.intrs[lvl]))
            print(f"[kernels] esm_stratified {cam} L{lvl} K {K} {strata_from}: template "
                  f"{tuple(kl.mask.shape)} stack {tuple(cur[lvl].stack7.shape)} {text} "
                  f"{'OK' if good else 'FAIL'}")
            if cam == "VGA" and K == 6 and strata_from == "depth" and lvl in (2, 1):
                timing.append(("esm_stratified", f"L{lvl}", lambda a: kernels.esm_stratified(*a),
                               _stratified_plain, a,
                               FLOPS_PER_PIXEL["esm_stratified"] * kl.mask.numel(),
                               f"template {tuple(kl.mask.shape)}, stack "
                               f"{tuple(cur[lvl].stack7.shape)}, K {K}", a))
    record = dict(name="esm_stratified", route="cuda",
                  source="rgbid_tpu_torch/csrc/esm_stratified.cu",
                  replaces="rgbid_tpu/ops/gauss_newton.py:434 (XLA, no Pallas kernel)",
                  max_abs_err=e_abs, max_err_of_tol=e_scaled)
    # Timed coarse to fine like the main path: L2, then L1. The VGA vote
    # layouts' kernel sums go to the vote kernel's check.
    return ok, {"esm_stratified": record}, timing, vote_sums


def phase_ic_kernels():
    """The two IC kernels vs their plain versions at the IC path's shapes:
    the fused normal-equation step (lagged: evaluation, solve and pose
    update in one launch) against ``normal_eq_plain`` + ``ic_update``, and
    the scale step alone (one launch, and a rerun), with the same scales in
    (VGA L0-L3 with the template stride, the geometric channel on and off,
    the field bf16-rounded and f32, the odd 641x481 camera); then the
    exact-mode step (scale phases and the normal pass in one cooperative
    launch) at sigma_iters 1, 2 and 3 with a rerun of each, the few-valid
    case and a rerun."""
    cfg = ic_config("lagged")
    tc = cfg.tracking
    ok = True
    vga = _frame_pair(TUM_FR1, cfg)  # jac_dtype "bf16": bf16-rounded field
    vga32 = _frame_pair(TUM_FR1, cfg.override(**{"tracking.jac_dtype": "f32"}))
    odd = _frame_pair(ODD_INTR, cfg)
    s2i = torch.full((), 0.01, device="cuda")
    s2x = torch.full((), 0.0025, device="cuda")
    strides = tuple(tc.template_stride) + (1,) * tc.levels
    damping = tc.damping
    cases = [
        # (label, inputs, level, use_geometric)
        ("L0 bf16 geo", vga, 0, True),
        ("L0 bf16 geo off", vga, 0, False),
        ("L1 bf16 geo", vga, 1, True),
        ("L2 bf16 geo", vga, 2, True),
        ("L3 bf16 geo", vga, 3, True),
        ("L3 bf16 geo off", vga, 3, False),
        ("L0 f32 geo", vga32, 0, True),
        ("L1 f32 geo off", vga32, 1, False),
        ("odd L0 bf16 geo", odd, 0, True),
        ("odd L1 bf16 geo", odd, 1, True),
    ]

    def level_args(inputs, lvl, mask=None):
        kf, cur, T, intrs = inputs
        kl, pts = template_level(kf.levels[lvl], intrs[lvl], strides[lvl])
        cl = cur[lvl]
        return (T, kl.intensity, pts, kl.mask if mask is None else mask, kl.jac, cl.intensity,
                cl.xi, cl.mask, intrs[lvl], tc.student_t_nu)

    # One argument tuple for the step, the chain and the result-only wrapper:
    # level_args + (s2i, s2x, sigma_iters, use_geometric, gate_sigmas, mode).
    def step(a):
        return kernels.ic_irls_step(*a, damping=damping)

    def chain(a):
        p = gauss_newton.residuals_and_normal_eq(*a)
        return (p,) + ic_update(a[0], p.H, p.b, damping, p.n_valid)

    n_abs, n_scaled, s_abs, pose = 0.0, 0.0, 0.0, 0.0
    for label, inputs, lvl, geo in cases:
        a = level_args(inputs, lvl)
        T = a[0]
        # The fused normal-equation step alone, lagged, the same scales in:
        # counts exact.
        ks = step(a + (s2i, s2x, 1, geo, tc.gate_sigmas, "lagged"))
        k = ks.result
        p = gauss_newton.normal_eq_plain(*a, s2i, s2x, geo, tc.gate_sigmas, True)
        Tp, dp = ic_update(T, p.H, p.b, damping, p.n_valid)
        # Scale step alone: sums to 1e-5 relative, count exact, rerun
        # bit-identical.
        kss = kernels.ic_sigma_stats(*a[:4], *a[5:], s2i, s2x, geo)
        kss2 = kernels.ic_sigma_stats(*a[:4], *a[5:], s2i, s2x, geo)
        ps = gauss_newton.sigma_stats_plain(*a[:4], *a[5:], s2i, s2x, geo)
        torch.cuda.synchronize()
        eH, sH = _scaled_err(k.H, p.H)
        eb, sb = _scaled_err(k.b, p.b)
        exact = bool(k.n_valid == p.n_valid) and bool(k.inlier_frac == p.inlier_frac)
        scal = max(_rel(k.error, p.error), _rel(k.sigma2_int, p.sigma2_int),
                   _rel(k.sigma2_xi, p.sigma2_xi))
        dT, dd = _step_errs(ks, Tp, dp)
        s_rel = max(_rel(kss.swi, ps.swi), _rel(kss.swx, ps.swx),
                    _rel(kss.sigma2_int, ps.sigma2_int), _rel(kss.sigma2_xi, ps.sigma2_xi))
        s_exact = (bool(kss.n == ps.n) and bool(kss.n == k.n_valid)
                   and all(torch.equal(x, y) for x, y in zip(kss, kss2)))
        good = (sH <= 1.0 and sb <= 1.0 and exact and scal <= 1e-4 and dT <= 1e-6
                and dd <= 1e-6 and s_rel <= 1e-5 and s_exact)
        ok &= good
        n_abs, n_scaled, pose = max(n_abs, eH, eb), max(n_scaled, sH, sb), max(pose, dT, dd)
        s_abs = max(s_abs, *(float((x - y).abs()) for x, y in zip(kss, ps)))
        print(f"[kernels] ic {label}: template {tuple(a[3].shape)} field {tuple(a[4].shape)} "
              f"planes {tuple(a[5].shape)} n_valid {int(k.n_valid)} (plain {int(p.n_valid)}) "
              f"H max|d| {eH:.3e} ({sH:.2f} of tol) b max|d| {eb:.3e} ({sb:.2f} of tol) "
              f"err/sigma rel {scal:.1e} (tol 1e-4) T' max|d| {dT:.1e} delta max|d| {dd:.1e} "
              f"(tol 1e-6); scale step alone sums/scales rel {s_rel:.1e} (tol 1e-5) count exact "
              f"and rerun bit-identical {s_exact} {'OK' if good else 'FAIL'}")

    # The exact-mode step: k scale phases, each weighting with the scales
    # the previous one produced, then the normal pass, in one cooperative
    # launch. The scale comes out of a reduction taken in another order
    # than the plain version's, so a pixel on the inlier gate may flip:
    # inlier fraction within 2 pixels.
    for label, inputs, lvl, geo, iters in (("L0 bf16 geo", vga, 0, True, 1),
                                           ("L0 bf16 geo", vga, 0, True, 2),
                                           ("L0 bf16 geo", vga, 0, True, 3),
                                           ("L1 bf16 geo off", vga, 1, False, 2),
                                           ("odd L1 bf16 geo", odd, 1, True, 1)):
        a = level_args(inputs, lvl) + (s2i, s2x, iters, geo, tc.gate_sigmas, "exact")
        ks, ks2 = step(a), step(a)
        k = ks.result
        p, Tp, dp = chain(a)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(_flat(ks), _flat(ks2)))
        eH, sH = _scaled_err(k.H, p.H)
        eb, sb = _scaled_err(k.b, p.b)
        n = float(p.n_valid)
        d_inl = float((k.inlier_frac - p.inlier_frac).abs())
        scal = max(_rel(k.error, p.error), _rel(k.sigma2_int, p.sigma2_int),
                   _rel(k.sigma2_xi, p.sigma2_xi))
        dT, dd = _step_errs(ks, Tp, dp)
        good = (sH <= 1.0 and sb <= 1.0 and bool(k.n_valid == p.n_valid)
                and d_inl <= 2.0 / max(n, 1.0) and scal <= 1e-4 and dT <= 1e-6 and dd <= 1e-6
                and same)
        ok &= good
        n_abs, n_scaled, pose = max(n_abs, eH, eb), max(n_scaled, sH, sb), max(pose, dT, dd)
        print(f"[kernels] ic exact step {label} sigma_iters {iters}: n_valid {int(k.n_valid)} "
              f"(plain {int(n)}) H {sH:.2f} of tol, b {sb:.2f} of tol, inlier_frac |d| "
              f"{d_inl:.1e} (tol 2 pixels = {2.0 / max(n, 1.0):.1e}) err/sigma rel {scal:.1e} "
              f"(tol 1e-4) T' max|d| {dT:.1e} delta max|d| {dd:.1e} (tol 1e-6), rerun "
              f"bit-identical {same} {'OK' if good else 'FAIL'}")

    l0 = level_args(vga, 0)
    # SpmdTracker's two launches, ic_sigma_stats and ic_result, at its
    # layouts: the whole VGA L0 template (one rank), the second of two
    # bands (rows 240-479) and the third of four (rows 240-359), each
    # backprojected with its global rows, from its start pose.
    planes, _, T_start = spmd_ic_pair()
    ki, kx, km, kj, ci, cx, cm = (t.cuda() for t in planes)
    T_start = T_start.cuda()
    tail_r = (tc.student_t_nu, s2i, s2x, True, tc.gate_sigmas)
    whole = (T_start, ki, backproject_grid(kx, TUM_FR1), km, kj, ci, cx, cm, TUM_FR1) + tail_r

    def band(b0, b1):
        return (T_start, ki[b0:b1].contiguous(),
                backproject_grid(kx[b0:b1].contiguous(), TUM_FR1, row_offset=b0),
                km[b0:b1].contiguous(), kj[:, b0:b1].contiguous(), ci, cx, cm,
                TUM_FR1) + tail_r

    for label, r_args in (("VGA L0 480x640", whole), ("VGA L0 band rows 240-479", band(240, 480)),
                          ("VGA L0 band rows 240-359", band(240, 360))):
        kr = kernels.unpack_result(kernels.ic_result(*r_args))
        pr = gauss_newton.normal_eq_plain(*r_args, True)
        # The scale step alone on the same inputs, under the rule above.
        sig_args = r_args[:4] + r_args[5:12] + (True,)
        kss = kernels.ic_sigma_stats(*sig_args)
        kss2 = kernels.ic_sigma_stats(*sig_args)
        ps = gauss_newton.sigma_stats_plain(*sig_args)
        torch.cuda.synchronize()
        eH, sH = _scaled_err(kr.H, pr.H)
        eb, sb = _scaled_err(kr.b, pr.b)
        exact = bool(kr.n_valid == pr.n_valid) and bool(kr.inlier_frac == pr.inlier_frac)
        scal = max(_rel(kr.error, pr.error), _rel(kr.sigma2_int, pr.sigma2_int),
                   _rel(kr.sigma2_xi, pr.sigma2_xi))
        s_rel = max(_rel(kss.swi, ps.swi), _rel(kss.swx, ps.swx),
                    _rel(kss.sigma2_int, ps.sigma2_int), _rel(kss.sigma2_xi, ps.sigma2_xi))
        s_exact = (bool(kss.n == ps.n) and bool(kss.n == kr.n_valid)
                   and all(torch.equal(x, y) for x, y in zip(kss, kss2)))
        good = sH <= 1.0 and sb <= 1.0 and exact and scal <= 1e-4 and s_rel <= 1e-5 and s_exact
        ok &= good
        n_abs, n_scaled = max(n_abs, eH, eb), max(n_scaled, sH, sb)
        s_abs = max(s_abs, *(float((x - y).abs()) for x, y in zip(kss, ps)))
        print(f"[kernels] ic_result {label} (lagged, the result vector, f32 field): n_valid "
              f"{int(kr.n_valid)} (plain {int(pr.n_valid)}) H max|d| {eH:.3e} ({sH:.2f} of tol) "
              f"b max|d| {eb:.3e} ({sb:.2f} of tol) err/sigma rel {scal:.1e} (tol 1e-4); "
              f"ic_sigma_stats on the same inputs: sums/scales rel {s_rel:.1e} (tol 1e-5) count "
              f"exact and rerun bit-identical {s_exact} {'OK' if good else 'FAIL'}")
    few = level_args(vga, 0, _few_valid(l0[3]))
    tail = (s2i, s2x, 1, True, tc.gate_sigmas)
    ok &= _fused_extras("ic L0 lagged", step, chain,
                        lambda a: kernels.residuals_and_normal_eq(*a),
                        l0 + tail + ("lagged",), few + tail + ("lagged",))
    ok &= _fused_extras("ic L0 exact", step, chain,
                        lambda a: kernels.residuals_and_normal_eq(*a),
                        l0 + tail + ("exact",), few + tail + ("exact",))

    records = {
        "ic_normal": dict(
            name="ic_normal_eq", route="cuda", source="rgbid_tpu_torch/csrc/ic_normal_eq.cu",
            replaces="rgbid_tpu/ops/pallas_kernels.py:131", max_abs_err=n_abs,
            max_err_of_tol=n_scaled, max_pose_err=pose,
        ),
        "ic_sigma": dict(
            name="ic_sigma_stats", route="cuda", source="rgbid_tpu_torch/csrc/ic_normal_eq.cu",
            replaces="rgbid_tpu/ops/pallas_kernels.py:84", max_abs_err=s_abs,
        ),
    }
    # Timed at the level-0 layout (20 of the 40 IRLS iterations per frame):
    # the exact step (sigma_iters as configured, 1), the lagged step, and
    # one scale step alone. The exact step reads what the lagged one reads.
    n0 = l0[1].numel()
    shape = (f"template {tuple(l0[1].shape)}, field {tuple(l0[4].shape)}, planes "
             f"{tuple(l0[5].shape)}")
    exact, lagged = l0 + tail + ("exact",), l0 + tail + ("lagged",)
    sigma_args = l0[:4] + l0[5:] + (s2i, s2x, True)
    timing = [
        ("ic_normal", "L0 exact", step, lambda a: chain(a)[1:], exact,
         (FLOPS_PER_PIXEL["ic_normal"] + tail[2] * FLOPS_PER_PIXEL["ic_sigma"]) * n0,
         shape + f", sigma_iters {tail[2]}", exact),
        # ic_result at SpmdTracker's one-rank layout: the lagged launch at
        # damping 0, its result part read.
        ("ic_normal", "ic_result L0 480x640", lambda a: kernels.ic_result(*a),
         lambda a: kernels.pack_result(gauss_newton.normal_eq_plain(*a, True)), whole,
         FLOPS_PER_PIXEL["ic_normal"] * whole[1].numel(),
         f"template {tuple(whole[1].shape)}, field {tuple(whole[4].shape)}, planes "
         f"{tuple(whole[5].shape)}", whole[:12]),
        ("ic_normal", "L0", step, lambda a: chain(a)[1:], lagged,
         FLOPS_PER_PIXEL["ic_normal"] * n0, shape, lagged),
        ("ic_sigma", "L0", lambda a: kernels.ic_sigma_stats(*a),
         lambda a: gauss_newton.sigma_stats_plain(*a), sigma_args,
         FLOPS_PER_PIXEL["ic_sigma"] * n0, f"template {tuple(l0[1].shape)}, planes "
         f"{tuple(l0[5].shape)}", sigma_args),
    ]
    # The scale step alone at SpmdTracker's one-rank layout (its standalone
    # launches on the main path).
    ws_args = whole[:4] + whole[5:12] + (True,)
    timing.append(("ic_sigma", "L0 480x640", lambda a: kernels.ic_sigma_stats(*a),
                   lambda a: gauss_newton.sigma_stats_plain(*a), ws_args,
                   FLOPS_PER_PIXEL["ic_sigma"] * whole[1].numel(),
                   f"template {tuple(whole[1].shape)}, planes {tuple(whole[5].shape)}",
                   ws_args))
    return ok, records, timing


# The plane-type mixes of the ESM kernel: (label, template intensity,
# points, current stack bfloat16), each as the tracker runs it under
# TrackingConfig.plane_dtype: "bf16" in the IRLS loop, then at the vote and
# the rescue's level-0 evidence (the float32 intensity with the bf16 points);
# the two ablation splits likewise.
BF16_MIXES = [
    ("bf16 loop", True, True, True),
    ("bf16 vote", False, True, True),
    ("bf16-points loop", True, True, False),
    ("bf16-points vote", False, True, False),
    ("bf16-stack", False, False, True),
]


def _bf16_args(args, mix):
    """ESM (or stratified) arguments with the planes of ``mix`` stored
    bfloat16, rounded to nearest even as the tracker and the frame stack
    store them."""
    _, int_bf, pts_bf, stack_bf = mix
    bf = torch.bfloat16
    a = list(args)
    if int_bf:
        a[1] = a[1].to(bf)
    if pts_bf:
        a[2] = tuple(p.to(bf) for p in a[2])
    if stack_bf:
        a[5] = a[5].to(bf)
    return tuple(a)


def phase_bf16_kernels(records):
    """The ESM kernel with bfloat16 planes against its plain chain on the
    same bfloat16 tensors (``_esm_case``'s tolerances: the plain version
    widens every load to float32 as the kernel does), in every mix of
    BF16_MIXES, at every level's layout of the main path (VGA, the template
    stride as configured) and at L1 and L0 of the odd 641x481 camera (a
    plane's start is not 4-byte aligned there), each with a rerun
    (bit-identical); then the stratified kernel at the vote's L2 and L1
    layouts (K 6, VGA and odd) in the vote's mixes (float32 intensity).
    Timed: "bf16 loop" at every level, the vote's mix at L2 and L1."""
    cfg = default_config()
    tc = cfg.tracking
    strides = tuple(tc.template_stride) + (1,) * tc.levels
    damping = tc.damping
    s2i = torch.full((), 0.01, device="cuda")
    s2x = torch.full((), 0.0025, device="cuda")
    v2i = torch.full((), tc.init_sigma_int**2, device="cuda")
    v2x = torch.full((), tc.init_sigma_xi**2, device="cuda")
    rec, srec = records["esm"], records["esm_stratified"]
    ok, timing = True, []

    def step(a):
        return kernels.esm_irls_step(*a, damping=damping)

    for cam, intr, levels in (("VGA", TUM_FR1, range(tc.levels - 1, -1, -1)),
                              ("odd", ODD_INTR, (1, 0))):
        kf, cur, T, intrs = _frame_pair(intr, cfg)
        for lvl in levels:
            kl, pts = template_level(kf.levels[lvl], intrs[lvl], strides[lvl])
            cap = tc.occ_gate_cap if lvl <= tc.occ_gate_cap_level else 0.0
            base = (T, kl.intensity, pts, kl.mask, kl.jac, cur[lvl].stack7, intrs[lvl],
                    tc.student_t_nu, s2i, s2x, tc.use_geometric, tc.gate_sigmas,
                    tc.occlusion_gate, cap)
            for mix in BF16_MIXES:
                a = _bf16_args(base, mix)
                good, e_abs, e_scaled, e_pose = _esm_case(f"{cam} L{lvl} {mix[0]}", a, damping)
                x, y = step(a), step(a)
                torch.cuda.synchronize()
                same = all(torch.equal(p, q) for p, q in zip(_flat(x), _flat(y)))
                if not same:
                    print(f"[kernels] esm {cam} L{lvl} {mix[0]} rerun bit-identical False FAIL")
                ok &= good and same
                rec["max_abs_err"] = max(rec["max_abs_err"], e_abs)
                rec["max_err_of_tol"] = max(rec["max_err_of_tol"], e_scaled)
                rec["max_pose_err"] = max(rec["max_pose_err"], e_pose)
                if cam == "VGA" and mix[0] == "bf16 loop":
                    timing.append(("esm", f"bf16 L{lvl}", step, lambda a: _esm_chain(a, damping)[1:],
                                   a, FLOPS_PER_PIXEL["esm"] * kl.mask.numel(),
                                   f"template {tuple(kl.mask.shape)}, stack "
                                   f"{tuple(cur[lvl].stack7.shape)}, intensity, points and stack "
                                   f"bf16", a))
            if lvl not in (2, 1):
                continue
            K = 6
            edges = consensus.stratum_edges(1.0 / cfg.max_depth, 1.0 / cfg.min_depth, K)
            vote = (T, kl.intensity, pts, kl.mask, kl.jac, cur[lvl].stack7, intrs[lvl],
                    tc.student_t_nu, v2i, v2x, kl.xi, edges, tc.use_geometric, tc.gate_sigmas, True)
            for mix in BF16_MIXES:
                if mix[1]:  # the vote reads the float32 intensity
                    continue
                a = _bf16_args(vote, mix)
                good, e_abs, scaled, text, _, _ = _stratified_compare(a, lvl, tc, intrs[lvl])
                ok &= good
                srec["max_abs_err"] = max(srec["max_abs_err"], e_abs)
                srec["max_err_of_tol"] = max(srec["max_err_of_tol"], scaled)
                print(f"[kernels] esm_stratified {cam} L{lvl} K {K} {mix[0]}: template "
                      f"{tuple(kl.mask.shape)} stack {tuple(a[5].shape)} {a[5].dtype} {text} "
                      f"{'OK' if good else 'FAIL'}")
                if cam == "VGA" and mix[0] == "bf16 vote":
                    timing.append(("esm_stratified", f"bf16 L{lvl}",
                                   lambda a: kernels.esm_stratified(*a), _stratified_plain, a,
                                   FLOPS_PER_PIXEL["esm_stratified"] * kl.mask.numel(),
                                   f"template {tuple(kl.mask.shape)}, stack "
                                   f"{tuple(a[5].shape)}, K {K}, points and stack bf16", a))
    print(f"[kernels] bf16 planes: {'OK' if ok else 'FAIL'}")
    return ok, timing


EXIT_TOL = 1e-5  # SlamConfig.preset("real-v5e")'s tracking.early_exit_tol


def _prev_with_delta(step, d0: float):
    """A copy of ``step`` whose applied delta is (d0, 0, 0, 0, 0, 0): a
    previous iteration as the early exit reads it (its step norm is d0)."""
    out = step.out.clone()
    delta = torch.zeros((6,), dtype=torch.float32)
    delta[0] = float(d0)
    out[64:70] = delta.to(out.device)
    return kernels._irls_step(out)


def _exit_case(label: str, launch, ws, slot: int, tol: float):
    """One IRLS launch's early exit on the card: ``launch(prev, tol, slot)``
    with a previous step whose norm is just under ``tol`` (a few float32
    ulps) must leave ``out`` equal to that step's output bit for bit and
    the workspace (partials, scale rows, counter words, run counts) as it
    found it; just over ``tol`` it must run: the output equals a launch
    without ``prev`` bit for bit, and the slot's run count grows by one; at
    tol 0 ``prev`` is ignored. The plain version's test
    (``kernels._cpu_skips``) takes the same decisions. Returns (good, the
    skipping launch's previous step)."""
    tol32 = np.float32(tol)
    under = _prev_with_delta(launch(None, 0.0, -1), tol32 * np.float32(1.0 - 4e-7))
    over = _prev_with_delta(launch(None, 0.0, -1), tol32 * np.float32(1.0 + 4e-7))
    ref = launch(None, 0.0, -1)
    torch.cuda.synchronize()
    before = [t.clone() for t in (ws.partials, ws.sigma_rows, ws.counter, ws.runs)]
    skipped = launch(under, tol, slot)
    torch.cuda.synchronize()
    after = [t.clone() for t in (ws.partials, ws.sigma_rows, ws.counter, ws.runs)]
    copied = bool(torch.equal(skipped.out, under.out))
    untouched = all(torch.equal(a, b) for a, b in zip(before, after))
    ran = launch(over, tol, slot)
    torch.cuda.synchronize()
    runs = ws.runs.clone()
    counted = int(runs[slot] - after[3][slot]) == 1
    ran_eq = bool(torch.equal(ran.out, ref.out))
    zero_tol = bool(torch.equal(launch(under, 0.0, -1).out, ref.out))
    plain = kernels._cpu_skips(under, tol) and not kernels._cpu_skips(over, tol)
    counter = ws.counter.cpu().tolist()
    good = copied and untouched and counted and ran_eq and zero_tol and plain
    print(f"[kernels] early exit {label}: under tol out = prev bit for bit {copied}, workspace "
          f"untouched {untouched}; over tol runs (= a launch without prev bit for bit) {ran_eq}, "
          f"counted {counted}; tol 0 ignores prev {zero_tol}; plain decisions equal {plain}; "
          f"counter words {counter} {'OK' if good else 'FAIL'}")
    return good, under


def phase_early_exit():
    """The early exit inside the IRLS kernels (``_exit_case``) at the
    level-0 layouts of the main path: the ESM step (f32 and the bf16 loop
    mix), the IC lagged step, and the IC exact step at sigma_iters 2 and 3,
    whose cooperative launch has grid barriers that a block leaving early
    would deadlock. Returns (ok, timing): a skipped ESM launch at L0 is
    timed (its plain version is returning ``prev``: no work)."""
    ok, timing = True, []
    cfg = default_config()
    tc = cfg.tracking
    strides = tuple(tc.template_stride) + (1,) * tc.levels
    s2i = torch.full((), 0.01, device="cuda")
    s2x = torch.full((), 0.0025, device="cuda")
    kf, cur, T, intrs = _frame_pair(TUM_FR1, cfg)
    ws = kernels.workspace(T.device)
    kl, pts = template_level(kf.levels[0], intrs[0], strides[0])
    esm0 = (T, kl.intensity, pts, kl.mask, kl.jac, cur[0].stack7, intrs[0], tc.student_t_nu, s2i,
            s2x, tc.use_geometric, tc.gate_sigmas, tc.occlusion_gate, tc.occ_gate_cap)
    under = None
    for label, a in (("esm L0", esm0), ("esm L0 bf16 loop", _bf16_args(esm0, BF16_MIXES[0]))):
        good, prev = _exit_case(label, lambda p, t, sl, a=a: kernels.esm_irls_step(
            *a, damping=tc.damping, prev=p, tol=t, slot=sl), ws, 0, EXIT_TOL)
        ok &= good
        under = under or prev
    timing.append(("esm", "skipped L0",
                   lambda a: kernels.esm_irls_step(*a, damping=tc.damping, prev=under,
                                                   tol=EXIT_TOL),
                   lambda a: gauss_newton.step_norm(under.delta), esm0, 13.0,
                   "a skipped launch: reads the previous step's 6 floats, writes its 70",
                   (under.delta,)))
    icfg = ic_config("exact")
    itc = icfg.tracking
    kf, cur, T, intrs = _frame_pair(TUM_FR1, icfg)
    kl, pts = template_level(kf.levels[0], intrs[0], strides[0])
    cl = cur[0]
    for label, mode, iters in (("ic L0 lagged", "lagged", 1), ("ic L0 exact sigma_iters 2",
                                                                 "exact", 2),
                               ("ic L0 exact sigma_iters 3", "exact", 3)):
        a = (T, kl.intensity, pts, kl.mask, kl.jac, cl.intensity, cl.xi, cl.mask, intrs[0],
             itc.student_t_nu, s2i, s2x, iters, itc.use_geometric, itc.gate_sigmas, mode)
        good, _ = _exit_case(label, lambda p, t, sl, a=a: kernels.ic_irls_step(
            *a, damping=itc.damping, prev=p, tol=t, slot=sl), ws, 1, EXIT_TOL)
        ok &= good
    print(f"[kernels] early exit: {'OK' if ok else 'FAIL'}")
    return ok, timing


def _plain_update(T, res, damping: float, min_valid: float = 100.0):
    """The plain end of an IRLS iteration: ``ic_update`` on an evaluation,
    as the step its launch would write."""
    return kernels._irls_step(kernels._plain_out(T, res, damping, min_valid))


def _solve_case(label: str, T, result: torch.Tensor, damping: float, moves: bool,
                min_valid: float = 100.0):
    """``irls_solve_step`` against its plain version (``ic_update`` on the
    same 48 floats, the same ``min_valid``): the result copied bit for bit,
    T' and delta within 1e-6, delta zero where the update must be
    suppressed (``moves`` False), and a rerun bit-identical."""
    k = kernels.irls_solve_step(T, result, damping, min_valid=min_valid)
    k2 = kernels.irls_solve_step(T, result, damping, min_valid=min_valid)
    p = _plain_update(T, kernels.unpack_result(result), damping, min_valid)
    torch.cuda.synchronize()
    copied = bool(torch.equal(kernels.pack_result(k.result), result))
    dT, dd = _step_errs(k, p.T, p.delta)
    zero = not bool(k.delta.any())
    same = all(torch.equal(x, y) for x, y in zip(_flat(k), _flat(k2)))
    good = copied and dT <= 1e-6 and dd <= 1e-6 and zero == (not moves) and same
    print(f"[kernels] irls_solve {label}: n_valid {int(result[45])} result copied {copied}, T' "
          f"max|d| {dT:.1e} delta max|d| {dd:.1e} (tol 1e-6), delta zero {zero} (expected "
          f"{not moves}), rerun bit-identical {same} {'OK' if good else 'FAIL'}")
    return good, max(dT, dd)


def phase_solve(records):
    """The split iteration of the row-sharded tracker on the card:
    ``irls_solve_step`` against its plain version on a tracked step, a
    few-valid step (n_valid <= 100: delta zero) and a non-positive-definite
    H (delta zero); then, on the same inputs and at every level's layout,
    the result-only launch + ``allreduce_irls`` over one rank + the solve
    gives the fused ``esm_irls_step``'s output bit for bit; then the early
    exit in the solve launch (``_exit_case``). Returns (ok, timing)."""
    cfg = default_config()
    tc = cfg.tracking
    strides = tuple(tc.template_stride) + (1,) * tc.levels
    s2i = torch.full((), 0.01, device="cuda")
    s2x = torch.full((), 0.0025, device="cuda")
    kf, cur, T, intrs = _frame_pair(TUM_FR1, cfg)
    damping = tc.damping

    def level_args(lvl, mask=None):
        kl, pts = template_level(kf.levels[lvl], intrs[lvl], strides[lvl])
        cap = tc.occ_gate_cap if lvl <= tc.occ_gate_cap_level else 0.0
        return (T, kl.intensity, pts, kl.mask if mask is None else mask, kl.jac,
                cur[lvl].stack7, intrs[lvl], tc.student_t_nu, s2i, s2x, tc.use_geometric,
                tc.gate_sigmas, tc.occlusion_gate, cap)

    l0 = level_args(0)
    tracked = kernels.esm_result(*l0)
    few = kernels.esm_result(*level_args(0, _few_valid(l0[3])))
    not_pd = tracked.clone()
    not_pd[0] = -5.0  # H[0, 0]: the Cholesky factorization fails
    ok, err = True, 0.0
    inf = float("-inf")
    # min_valid -inf (the IC SPMD tracker's rule): a few-valid step is taken
    # (90 pixels spread over the template: the first 80 make a system too
    # ill-conditioned, cond ~1e8, for two float32 solves to agree to 1e-6),
    # the failed factorization still holds.
    spread = kernels.esm_result(*level_args(0, _spread_valid(l0[3])))
    for label, res, moves, mv in (("tracked L0", tracked, True, 100.0),
                                  ("few-valid L0", few, False, 100.0),
                                  ("H not positive definite", not_pd, False, 100.0),
                                  ("few-valid L0 spread, min_valid -inf", spread, True, inf),
                                  ("H not positive definite, min_valid -inf", not_pd, False,
                                   inf)):
        good, e = _solve_case(label, T, res, damping, moves, mv)
        ok &= good
        err = max(err, e)
    split_eq = []
    for lvl in range(tc.levels - 1, -1, -1):
        a = level_args(lvl)
        fused = kernels.esm_irls_step(*a, damping=damping)
        split = kernels.irls_solve_step(
            T, kernels.allreduce_irls(kernels.esm_result(*a), lambda t: t), damping)
        torch.cuda.synchronize()
        split_eq.append(all(torch.equal(x, y) for x, y in zip(_flat(fused), _flat(split))))
    ok &= all(split_eq)
    print(f"[kernels] irls_solve split step (result-only launch + allreduce_irls over one rank "
          f"+ solve) bit-equal to the fused esm_irls_step at L{tc.levels - 1}..L0: {split_eq} "
          f"{'OK' if all(split_eq) else 'FAIL'}")
    good, _ = _exit_case("irls_solve", lambda p, t, sl: kernels.irls_solve_step(
        T, tracked, damping, prev=p, tol=t, slot=sl), kernels.workspace(T.device), 0, EXIT_TOL)
    ok &= good
    records["irls_solve"] = dict(
        name="irls_solve", route="cuda", source="rgbid_tpu_torch/csrc/irls_solve.cu",
        replaces="rgbid_tpu/ops/gauss_newton.py:534", max_abs_err=err,
    )
    timing = [("irls_solve", "48 floats", lambda a: kernels.irls_solve_step(a[0], a[1],
                                                                            damping).out,
               lambda a: _plain_update(a[0], kernels.unpack_result(a[1]), damping),
               (T, tracked), float(SOLVE_FLOPS), "result (48), T (16) -> out (70)", (T, tracked))]
    print(f"[kernels] irls_solve: {'OK' if ok else 'FAIL'}")
    return ok, timing


# tests/test_fusion.py's pose covariance and inverse-depth noise.
ORACLE_COV = np.diag([1e-6, 1e-6, 1e-6, 1e-7, 1e-7, 1e-7])
ORACLE_XI_NOISE = 0.005


def punch_holes(depth_u16: np.ndarray, frac: float = 0.25, seed: int = 3) -> np.ndarray:
    """Blob dropout in a u16 depth image (invalid = 0), like the gauntlet's
    depth_holes scenario (tests/test_fusion.py's ``_punch_holes``)."""
    rng = np.random.default_rng(seed)
    h, w = depth_u16.shape
    out = depth_u16.copy()
    killed = 0
    while killed < frac * h * w:
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(5, 25)
        yy, xx = np.ogrid[:h, :w]
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        killed += blob.sum()
        out[blob] = 0
    return out


def _share(a: np.ndarray) -> float:
    return float(a.mean()) if a.size else 1.0


def phase_fusion_oracle():
    """The fusion kernel on the card against the numpy oracle
    (``reference_cpu/fusion.py``), at tests/test_fusion.py's rules, on a
    VGA pair with inverse-depth noise: ``fuse_inverse_depth`` (growth off,
    no floor) against ``fuse`` with the test's covariance, then
    ``fuse_frame`` (growth on, the pose-noise floor) on a hole-punched
    keyframe against ``fuse_grow`` given the same floor and the plain
    ``hole_guess`` of the same pyramid. The fused (and claimed) sets agree
    on more than 99.9% of the pixels, values within 5e-4 where both fused,
    variances rtol 2e-2 (Kalman step), hit counts on more than 99.9%,
    n_fused within 2e-3. Returns ok."""
    cfg = default_config()
    fcfg = cfg.fusion
    scene = make_scene(0)
    rng = np.random.default_rng(7)
    gt = camera_path(N_FRAMES)
    f0 = render(scene, TUM_FR1, gt[0], rng, ORACLE_XI_NOISE)
    f1 = render(scene, TUM_FR1, gt[3], rng, ORACLE_XI_NOISE)
    T_ck = np.linalg.inv(gt[3]) @ gt[0]
    kf_xi, kf_mask = odometry.inverse_depth_from_u16(f0[1])
    cur_xi, cur_mask = odometry.inverse_depth_from_u16(f1[1])
    kf_var = np.full_like(kf_xi, fcfg.sensor_sigma_xi**2)

    def cu(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    r_xi, r_var, _, r_n = fusion_ref.fuse(kf_xi, kf_var, kf_mask, cur_xi, cur_mask, T_ck,
                                          ORACLE_COV, TUM_FR1, fcfg)
    k = fusion.fuse_inverse_depth(cu(kf_xi), cu(kf_var), cu(kf_mask), cu(cur_xi), cu(cur_mask),
                                  cu(T_ck), cu(ORACLE_COV), TUM_FR1, fcfg)
    xi, var, n = k[0].cpu().numpy(), k[1].cpu().numpy(), float(k[3])
    changed, changed_ref = xi != kf_xi, r_xi != kf_xi
    agree = _share(changed == changed_ref)
    both = changed & changed_ref
    d_xi = float(np.abs(xi[both] - r_xi[both]).max())
    var_ok = np.allclose(var[both], r_var[both], rtol=2e-2, atol=1e-9)
    n_rel = abs(n - r_n) / max(r_n, 1)
    ok = agree > 0.999 and d_xi <= 5e-4 and var_ok and n_rel < 2e-3 and r_n > 0.5 * kf_mask.sum()
    print(f"[kernels] fusion oracle: fuse_inverse_depth on the card against reference_cpu "
          f"fusion.fuse, VGA, xi noise {ORACLE_XI_NOISE}: fused sets agree on {agree:.5f} "
          f"(> 0.999), xi max|d| where both fused {d_xi:.2e} (tol 5e-4), var within rtol 2e-2 "
          f"{var_ok}, n_fused {n:.0f} (oracle {r_n}, rel {n_rel:.1e}, tol 2e-3) "
          f"{'OK' if ok else 'FAIL'}")

    # Growth: a keyframe with 25% of its depth punched out.
    h_xi, h_mask = odometry.inverse_depth_from_u16(punch_holes(f0[1]))
    hits = np.where(h_mask, fcfg.confirm_hits, 0.0).astype(np.float32)
    xi_pyr, _ = build_pyramid(cu(h_xi), cu(h_mask), cfg.tracking.levels)
    levels = [fusion._Level0(x) for x in xi_pyr]
    k = fusion.fuse_frame(levels, cu(kf_var), cu(h_mask), cu(hits), cu(cur_xi), cu(cur_mask),
                          cu(T_ck), cu(ORACLE_COV), TUM_FR1, fcfg)
    guess, gmask = fusion.hole_guess([fusion._Level0(x.cpu()) for x in xi_pyr])
    floor = fusion.pose_noise_floor(fcfg, "cpu").double().numpy()
    r_xi, _, r_mask, r_hits, r_nf, r_nc = fusion_ref.fuse_grow(
        h_xi, kf_var, h_mask, hits, cur_xi, cur_mask, T_ck, ORACLE_COV + floor, TUM_FR1, fcfg,
        guess.numpy(), gmask.numpy())
    xi, mask, g_hits = k[0].cpu().numpy(), k[2].cpu().numpy() > 0.5, k[3].cpu().numpy()
    n = float(k[4])
    mask_agree = _share(mask == r_mask)
    claimed = mask & r_mask & ~h_mask
    close = _share(np.abs(xi[claimed] - r_xi[claimed]) <= 5e-4)
    hits_agree = _share(g_hits == r_hits)
    n_rel = abs(n - r_nf) / max(r_nf, 1)
    good = (r_nc > 1000 and mask_agree > 0.999 and close > 0.999 and hits_agree > 0.999
            and n_rel < 2e-3)
    ok &= good
    print(f"[kernels] fusion oracle: fuse_frame (growth on, pose-noise floor) on the card "
          f"against reference_cpu fusion.fuse_grow, VGA keyframe with 25% holes: claimed on "
          f"both {int(claimed.sum())} (oracle's claims {r_nc}, > 1000), masks agree on "
          f"{mask_agree:.5f}, claimed xi within 5e-4 on {close:.5f}, hits agree on "
          f"{hits_agree:.5f} (each > 0.999), n_fused {n:.0f} (oracle {r_nf}, rel {n_rel:.1e}, "
          f"tol 2e-3) "
          f"{'OK' if good else 'FAIL'}")
    return ok


def pack_sums(Hk, bk, nk, Gk, ek) -> np.ndarray:
    """(K, 50) stratified sums (gauss_newton.STRATIFIED_SUMS columns: 21 H,
    6 b, n, the error, 21 G; upper triangles row by row) from per-stratum
    H, b, n, G and error, as ``unpack_stratified`` splits them."""
    up = [(a, c) for a in range(6) for c in range(a, 6)]
    K = len(nk)
    out = np.zeros((K, gauss_newton.STRATIFIED_SUMS), np.float32)
    for j, (a, c) in enumerate(up):
        out[:, j] = Hk[:, a, c]
        out[:, 29 + j] = Gk[:, a, c]
    out[:, 21:27], out[:, 27], out[:, 28] = bk, nk, ek
    return out


def _vote_params(tc, tol: float):
    return consensus.VoteParams.of(tc, tol)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (so +0 differs from -0), a NaN matching a NaN
    (the card's NaN and the CPU's differ in their payload bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    ia, ib = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(na, nb) and torch.equal(ia[~na], ib[~nb])


def _vote_case(label: str, sums: np.ndarray, hist: np.ndarray, tol: float, bscale: float, tc):
    """One vote on the card against its plain version on the CPU, from the
    initial state and from a state with the last stratum already out. The
    whole new state, the rerun word, the decision words and the deltas
    (float64 Jacobi, then float32) must equal the plain version's bit for
    bit (``_same_bits``), and a rerun the first launch's, NaN payloads
    included. Returns (good, max |d| of the deltas)."""
    K = sums.shape[0]
    p = _vote_params(tc, tol)
    good, e_abs = True, 0.0
    member0 = np.ones((K,), np.float32)
    member1 = member0.copy()
    member1[-1] = 0.0
    for mname, member in (("fresh", member0), ("one out", member1)):
        state = consensus.VoteState.initial(torch.from_numpy(member))
        cpu = (torch.from_numpy(sums), torch.tensor(bscale, dtype=torch.float32),
               torch.from_numpy(hist), state)
        dev = tuple(t.cuda() for t in cpu)
        k = consensus.consensus_vote(*dev, p)
        k2 = consensus.consensus_vote(*dev, p)
        pl = consensus.vote_plain(*cpu, p)
        torch.cuda.synchronize()
        ks, kg, kd = (t.cpu() for t in k)
        ps, pg, pd = pl
        dk, dp = consensus.VoteDiag.split(kd, K), consensus.VoteDiag.split(pd, K)
        ed = float((dk.deltas - dp.deltas).abs().max())
        words = all(_same_bits(getattr(dk, f), getattr(dp, f)) for f in
                    ("excluded", "hostage", "dominant", "info_share", "member", "majority_ok",
                     "triggered", "rescue", "excluded_frac"))
        deltas = _same_bits(dk.deltas, dp.deltas)
        rerun = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(k, k2))
        same = _same_bits(ks, ps) and _same_bits(kg, pg) and words and deltas and rerun
        e_abs = max(e_abs, ed)
        good &= same
        if not same:
            print(f"[kernels] consensus_vote {label} ({mname}): state equal "
                  f"{_same_bits(ks, ps)}, go {int(kg)} / {int(pg)}, words equal {words}, deltas "
                  f"equal {deltas} (max|d| {ed:.3e}), rerun bit-identical {rerun} FAIL")
    return good, e_abs


def phase_consensus_vote(vote_sums):
    """The vote kernel (csrc/consensus_vote.cu) against its plain version
    (``consensus.vote_plain`` on the CPU): the six synthetic cases, the
    seeded random sums of tests/test_torch_consensus.py and the edge cases
    of ``consensus_edge_sums`` (each at baseline scale 1.0 and 1.7, under
    its own history), and the VGA vote layouts of
    [kernels] esm_stratified at L2 and L1 with K 1, 6 and 16 (under a cold
    and a ripe history), each from a fresh state and one with a stratum
    out. Returns (ok, record, timing)."""
    tc = default_config().tracking
    ok, e_abs, n = True, 0.0, 0
    for name in CONSENSUS_CASES:
        Hk, bk, nk, Gk, ek, prev = consensus_fixture(name)
        for bscale in (1.0, 1.7):
            good, e = _vote_case(f"{name} bscale {bscale}", pack_sums(Hk, bk, nk, Gk, ek), prev,
                                 0.4, bscale, tc)
            ok, e_abs, n = ok and good, max(e_abs, e), n + 1
    for seed, even, agree in CONSENSUS_RANDOM:
        Hk, bk, nk, Gk, ek, prev = consensus_random_sums(seed, even, agree)
        for bscale in (1.0, 1.7):
            good, e = _vote_case(f"random {seed} bscale {bscale}", pack_sums(Hk, bk, nk, Gk, ek),
                                 prev, 0.4, bscale, tc)
            ok, e_abs, n = ok and good, max(e_abs, e), n + 1
    for name in CONSENSUS_EDGE:
        Hk, bk, nk, Gk, ek, prev = consensus_edge_sums(name)
        for bscale in (1.0, 1.7):
            good, e = _vote_case(f"edge {name} bscale {bscale}", pack_sums(Hk, bk, nk, Gk, ek),
                                 prev, 0.4, bscale, tc)
            ok, e_abs, n = ok and good, max(e_abs, e), n + 1
    layouts = []
    for lvl, K, strata_from, kh, intr_l in vote_sums:
        tol = tc.consensus_tol * (intr_l.fx * 2.0**lvl / tc.consensus_ref_fx)
        for hname, hist in (("cold", np.zeros((K,), np.float32)),
                            ("ripe", np.full((K,), 5.0, np.float32))):
            good, e = _vote_case(f"VGA L{lvl} K {K} {strata_from} {hname}", kh, hist, tol, 1.0,
                                 tc)
            ok, e_abs, n = ok and good, max(e_abs, e), n + 1
        layouts.append(f"L{lvl} K{K} {strata_from}")
    print(f"[kernels] consensus_vote: {n} cases x 2 states ({len(CONSENSUS_CASES)} synthetic, "
          f"{len(CONSENSUS_RANDOM)} random and {len(CONSENSUS_EDGE)} edge cases (K 1..16, a "
          f"zero-pixel stratum, a zero pivot, tied medians and support, NaN / Inf sums) at "
          f"baseline scale 1.0 and 1.7; VGA {layouts} cold and ripe): state, rerun word, "
          f"decision words and deltas equal bit for bit (NaN matching NaN), deltas max|d| "
          f"{e_abs:.3e}, rerun bit-identical {'OK' if ok else 'FAIL'}")
    # Timed at the vote's own layout: VGA L2, K 6, the default config.
    lvl, K, _, kh, intr_l = next(v for v in vote_sums if v[1] == 6 and v[2] == "depth")
    tol = tc.consensus_tol * (intr_l.fx * 2.0**lvl / tc.consensus_ref_fx)
    args = (torch.from_numpy(kh).cuda(), torch.tensor(1.0, device="cuda"),
            torch.zeros((K,), device="cuda"),
            consensus.VoteState.initial(torch.ones((K,), device="cuda")), _vote_params(tc, tol))
    # Operations: per stratum 50 Jacobi rounds of three rotations (~12
    # operations each) applied to two matrices' columns and one's rows (36
    # entries x 3 operations x 3), float64, counted at the float64 rate as
    # float32-rate equivalents; the flow metric 84 K^2 and the rest ~100 K,
    # float32.
    f64 = K * (50 * (36 + 324) + 150)
    flops = f64 * F32_FLOPS / F64_FLOPS + 84 * K * K + 100 * K
    timing = [("consensus_vote", f"L{lvl}", lambda a: consensus.consensus_vote(*a),
               lambda a: consensus.vote_plain(*a), args, flops,
               f"VGA L{lvl} vote, K {K}", args[:4])]
    record = dict(name="consensus_vote", route="cuda",
                  source="rgbid_tpu_torch/csrc/consensus_vote.cu",
                  replaces="rgbid_tpu/tracking/consensus.py:134-424 (XLA, no Pallas kernel)",
                  max_abs_err=e_abs)
    return ok, record, timing


def phase_go(records):
    """The predicate word of the ESM step and of fusion: with go = 0 the
    output is ``hold`` (ESM: the step it copies) or the input planes
    (fusion, n_fused 0) bit for bit, the workspace's counter words 0 after
    it and nothing counted as run; with go = 1 the output equals the launch
    without the word bit for bit. At every level of the default
    configuration's layout (ESM) and at 480x640 and 641x481 (fusion). The
    held launches are timed beside the running ones. Returns (ok, timing)."""
    cfg = default_config()
    tc, fcfg = cfg.tracking, cfg.fusion
    strides = tuple(tc.template_stride) + (1,) * tc.levels
    ok, timing = True, []
    go0 = torch.zeros((), dtype=torch.int32, device="cuda")
    go1 = torch.ones((), dtype=torch.int32, device="cuda")
    kf, cur, T, intrs = _frame_pair(TUM_FR1, cfg)
    ws = kernels.workspace(torch.device("cuda"))
    for lvl in range(tc.levels - 1, -1, -1):
        kl, pts = template_level(kf.levels[lvl], intrs[lvl], strides[lvl])
        gate_cap = tc.occ_gate_cap if lvl <= tc.occ_gate_cap_level else 0.0
        args = (T, kl.intensity, pts, kl.mask, kl.jac, cur[lvl].stack7, intrs[lvl],
                tc.student_t_nu, torch.full((), 0.01, device="cuda"),
                torch.full((), 0.0025, device="cuda"), tc.use_geometric, tc.gate_sigmas,
                tc.occlusion_gate, gate_cap)
        hold = kernels.esm_irls_step(*args, damping=tc.damping)
        plain = kernels.esm_irls_step(*args, damping=tc.damping)
        kernels.reset_iteration_counts("cuda")
        held = kernels.esm_irls_step(*args, damping=tc.damping, go=go0, hold=hold, slot=0)
        ran = kernels.esm_irls_step(*args, damping=tc.damping, go=go1, hold=hold, slot=1)
        ev = kernels.esm_residuals_and_normal_eq(*args, go=go0, hold=hold,
                                                 slot=kernels.EVAL_SLOT)
        torch.cuda.synchronize()
        launched, run = kernels.iteration_counts("cuda")
        good = (torch.equal(held.out, hold.out) and torch.equal(ran.out, plain.out)
                and all(torch.equal(a, b) for a, b in zip(ev, hold.result))
                and ws.counter[:2].tolist() == [0, 0]
                and run[:2].tolist() == [0, 1] and int(run[kernels.EVAL_SLOT]) == 0
                and launched[:2].tolist() == [1, 1])
        ok &= good
        print(f"[kernels] go word, ESM L{lvl} template {tuple(kl.mask.shape)}: go 0 copies hold "
              f"{torch.equal(held.out, hold.out)} (the evaluation too), go 1 equals the launch "
              f"without the word {torch.equal(ran.out, plain.out)}, arrival counter words "
              f"{ws.counter[:2].tolist()} (expected [0, 0]), run counts "
              f"{run[:2].tolist()} of launched {launched[:2].tolist()} "
              f"{'OK' if good else 'FAIL'}")
        if lvl == 0:
            timing.append(("esm", "held L0", lambda a: kernels.esm_irls_step(
                *a, damping=tc.damping, go=go0, hold=hold), lambda a: hold, args, 0,
                f"template {tuple(kl.mask.shape)}, go = 0", (hold.out, go0)))
    vga, odd = _frame_pair(TUM_FR1, cfg), _frame_pair(ODD_INTR, cfg)
    cov = torch.diag(torch.tensor([1e-6] * 3 + [1e-7] * 3, device="cuda"))
    for size, (kf2, cur2, T2, intrs2) in (("480x640", vga), ("641x481", odd)):
        fargs = (kf2.levels, kf2.var, kf2.mask_full, kf2.hits, cur2[0].xi, cur2[0].mask, T2, cov,
                 intrs2[0], fcfg)
        base = fusion.fuse_frame(*fargs)
        held = fusion.fuse_frame(*fargs, go=go0)
        ran = fusion.fuse_frame(*fargs, go=go1)
        torch.cuda.synchronize()
        copied = all(torch.equal(a, b) for a, b in zip(held[:4], (kf2.levels[0].xi, kf2.var,
                                                                 kf2.mask_full, kf2.hits)))
        same = all(torch.equal(a, b) for a, b in zip(ran, base))
        good = copied and float(held[4]) == 0.0 and same and float(base[4]) > 0
        ok &= good
        print(f"[kernels] go word, fusion {size}: go 0 copies the planes through {copied}, "
              f"n_fused {float(held[4]):.0f}; go 1 equals the launch without the word {same} "
              f"(n_fused {float(base[4]):.0f}) {'OK' if good else 'FAIL'}")
        if size == "480x640":
            planes = (kf2.levels[0].xi, kf2.var, kf2.mask_full, kf2.hits)
            timing.append(("fusion", "held 480x640", lambda a: fusion.fuse_frame(*a, go=go0),
                           lambda a: tuple(p.clone() for p in a[1:4]), fargs,
                           0, "480x640, go = 0: the four planes copied through", planes + (go0,)))
    return ok, timing


FLIGHT_DEPTH = 32


def _guard_dispatch(slam):
    """Every dispatch of ``slam`` under torch.cuda.set_sync_debug_mode
    ("error"): a synchronizing operation inside one raises."""
    orig = slam._dispatch

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    slam._dispatch = guarded


def _flight_run(slam, frames, depth: int, defer_updates: bool = False):
    """One counted run: reset, every count set to 0, then the frames
    through ``feed(flight_depth=depth)`` (or, depth 0, a ``process_frame``
    loop), then ``finish()``. With ``defer_updates`` the back end's pose
    updates are applied at ``finish()`` only, in both kinds of run (their
    timing is the thread's)."""
    slam.reset()
    torch.cuda.synchronize()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    kernels.reset_iteration_counts("cuda")
    reads0, counts0 = slam._step.host_reads, slam.tracker_counts
    replays0 = slam._step.replays
    apply = slam._apply_pose_updates
    if defer_updates:
        slam._apply_pose_updates = lambda: None
    t0 = time.perf_counter()
    if depth:
        slam.feed(frames, flight_depth=depth)
    else:
        for f in frames:
            slam.process_frame(*f)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    slam._apply_pose_updates = apply
    slam.finish()
    torch.cuda.synchronize()
    out = {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}
    counts = {k: v - counts0[k] for k, v in slam.tracker_counts.items()}
    out.update(step_reads=slam._step.host_reads - reads0, replays=slam._step.replays - replays0,
               finalize_reads=slam.manager.host_reads, ran=int(kernels.iteration_counts("cuda")[1].sum()),
               records=_frame_records(slam.stats), poses=slam.poses(), wall_ms=wall_ms,
               ms=[r["ms"] for r in slam.stats[1:]], **counts)
    return out


def _kernels_per_frame(slam, frames, depth: int) -> float:
    """torch.profiler over one flight: device kernels (no copies or fills)
    per tracked frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slam.reset()
    slam.process_frame(*frames[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        slam.feed(frames[1:depth + 1], flight_depth=depth)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset")))
    return n / len(frames[1:depth + 1])


def phase_flight(smi: str):
    """[flight]: the default configuration on the rigid, mover and loop
    sequences and IC lagged on the rigid one, each as
    ``feed(flight_depth=32)`` and as a ``process_frame`` loop on one system
    (its graph captured once, in the warm-up): poses and per-frame records
    bit-equal; host reads one per flight plus the finalizes; one graph
    replay per tracked frame; every dispatch silent under
    set_sync_debug_mode("error"); the launches those of the captured graph
    and the IRLS launches run on the device 40 + rerun iterations + 42 x
    rescues per tracked frame. Then the reloc sequence with the back end
    on, feed against the loop, its relocalization inside the second
    flight. Prints ms/frame of both and kernels per tracked frame. Returns
    (ok, counts summed over the counted runs)."""
    runs = [("default rigid", default_config(), "rigid"), ("default mover", default_config(), "mover"),
            ("default loop", loop_config(), "loop"), ("ic lagged", ic_config("lagged"), "rigid")]
    ok, total = True, dict.fromkeys(COUNTERS, 0)
    seqs = {}
    for label, cfg, kind in runs:
        if kind not in seqs:
            seqs[kind] = SEQUENCES[kind]()
        frames, _ = seqs[kind]
        tc = cfg.tracking
        slam = port.SlamSystem(TUM_FR1, cfg, device="cuda")
        _run_sequence(slam, frames[:4])  # warm-up: builds and the capture
        _guard_dispatch(slam)
        loop = _flight_run(slam, frames, 0)
        flight = _flight_run(slam, frames, FLIGHT_DEPTH)
        n_kf = len(slam.manager.keyframes)
        kpf = _kernels_per_frame(slam, frames, 16)
        tracked = len(frames) - 1
        flights = -(-tracked // FLIGHT_DEPTH)
        expected = expected_launches(tc, tracked)
        checks = {
            "poses bit-equal": all(np.array_equal(a, b) for a, b in zip(loop["poses"], flight["poses"])),
            "records bit-equal": loop["records"] == flight["records"],
            "reads": loop["step_reads"] == tracked and flight["step_reads"] == flights
            and flight["finalize_reads"] == loop["finalize_reads"] == n_kf,
            "one replay per tracked frame": loop["replays"] == flight["replays"] == tracked
            and slam._step.captures == 1,
            "launches": all(r[k] == v for r in (loop, flight) for k, v in expected.items()),
            "device runs": all(r["ran"] == expected_runs(tc, tracked, r["rerun_iters"], r["rescues"])
                               for r in (loop, flight)),
        }
        good = all(checks.values())
        ok &= good
        for k in COUNTERS:
            total[k] += loop[k] + flight[k]
        print(f"[flight] {label}, {kind} sequence, {tracked} tracked frames: process_frame loop "
              f"{np.median(loop['ms'][5:]):.3f} ms/frame (median), feed(flight_depth="
              f"{FLIGHT_DEPTH}) {flight['wall_ms'] / tracked:.3f} ms/frame (mean, {flights} "
              f"flights) on {smi}; host reads of the step {loop['step_reads']} / "
              f"{flight['step_reads']}, finalizes {flight['finalize_reads']}; replays "
              f"{loop['replays']} / {flight['replays']}, captures {slam._step.captures}, graph "
              f"nodes {slam._step.graph_nodes}; kernels per tracked frame (torch.profiler, one "
              f"flight of 16) {kpf:.1f}; IRLS launches run {flight['ran']} of "
              f"{flight['esm_normal_eq'] + flight['ic_normal_eq']} (reruns "
              f"{flight['rerun_iters']} iterations, rescues {flight['rescues']}); "
              f"checks {checks} {'OK' if good else 'FAIL'}")
    # A relocalization inside a flight: the reloc sequence, back end on.
    frames, gt, i_reloc = make_reloc_sequence()
    slam = port.SlamSystem(TUM_FR1, port.SlamConfig(), device="cuda")
    _run_sequence(slam, frames[:4])
    _guard_dispatch(slam)
    dispatches = [0]
    orig = slam._dispatch

    def counted(*a, **k):
        dispatches[0] += 1
        return orig(*a, **k)

    slam._dispatch = counted
    loop = _flight_run(slam, frames, 0, defer_updates=True)
    d_loop = dispatches[0]
    flight = _flight_run(slam, frames, FLIGHT_DEPTH, defer_updates=True)
    d_flight = dispatches[0] - d_loop
    tracked = len(frames) - 1
    reloc = [i for i, r in enumerate(flight["records"]) if r.get("relocalized")]
    replayed = tracked - i_reloc if i_reloc < FLIGHT_DEPTH * 2 + 1 else 0
    checks = {
        "relocalized inside the second flight": reloc == [i_reloc]
        and FLIGHT_DEPTH < i_reloc < len(frames) - 1,
        "records bit-equal": loop["records"] == flight["records"],
        "poses bit-equal": all(np.array_equal(a, b) for a, b in zip(loop["poses"], flight["poses"])),
        "rest of the flight replayed": d_loop == tracked and d_flight == tracked + replayed,
        "errors": slam.backend.errors == 0,
    }
    good = all(checks.values())
    ok &= good
    for k in COUNTERS:
        total[k] += loop[k] + flight[k]
    dmax = max(float(np.abs(a - b).max()) for a, b in zip(loop["poses"], flight["poses"]))
    print(f"[flight] reloc sequence, SlamConfig() (back end on; pose updates applied at finish() "
          f"in both runs), {len(frames)} frames: relocalized at {reloc} (expected [{i_reloc}]), "
          f"dispatches loop {d_loop}, feed {d_flight} ({replayed} frames replayed after the "
          f"relocalization), poses max|d| {dmax:.1e}; checks {checks} "
          f"{'OK' if good else 'FAIL'}")
    return ok, total


def phase_times(records, timing):
    """Each kernel and its plain version, timed in turns (plain, kernel,
    kernel, plain) with CUDA events, the kernel's device time with CUDA
    events (``_event_device_ms``), then every device time with
    torch.profiler, beside the kernel's bound. Runs after the main path,
    and takes all the event times before the first profiler window: once
    torch.profiler has been used, the process's kernel launches cost more
    host time. ``timing`` holds (record, level, kernel, plain, args,
    operations, shape, reads): ``reads`` are the tensors the kernel must
    read, each counted once in its bound; a fused IRLS kernel is timed as
    the whole step and its plain version as the plain evaluation plus
    ``ic_update``."""
    events = []
    for _, _, kernel, plain, args, *_ in timing:
        events.append((_time_ms(lambda: plain(args)), _time_ms(lambda: kernel(args)),
                       _time_ms(lambda: kernel(args)), _time_ms(lambda: plain(args))))
    # Device time from CUDA events, the kernel's calls back to back behind
    # a spin, beside the profiler's (taken after it, like every event time).
    ev_dev = [_event_device_ms(lambda: kernel(args)) for _, _, kernel, _, args, *_ in timing]
    for (key, level, kernel, plain, args, flops, shape, reads), ev, ev_dev_ms in zip(
            timing, events, ev_dev):
        plain_ms, ms, ms2, plain_ms2 = ev
        dev_ms = _device_ms(lambda: kernel(args))
        plain_dev_ms = _device_ms(lambda: plain(args))
        bound_ms, bound_by, nbytes = _bound(reads, kernel(args), flops)
        print(f"[times] {key} {level} ({shape}): kernel {ms:.4f} / {ms2:.4f} ms, plain "
              f"{plain_ms:.4f} / {plain_ms2:.4f} ms per call (CUDA events, launch cost "
              f"included); device time per call: kernel {dev_ms * 1e3:.2f} us (profiler), "
              f"{ev_dev_ms * 1e3:.2f} us (CUDA events, back to back), plain "
              f"{plain_dev_ms:.4f} ms (profiler); bound {bound_ms * 1e3:.2f} us by {bound_by} "
              f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} Mflop), bound / device time "
              f"{bound_ms / dev_ms:.1%}")
        rec = dict(level=level, shape=shape, ms=min(ms, ms2), plain_ms=min(plain_ms, plain_ms2),
                   device_ms=dev_ms, event_device_ms=ev_dev_ms, plain_device_ms=plain_dev_ms,
                   bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, flops=flops)
        records[key].setdefault("levels", []).append(rec)
    # The top-level numbers of a record are those of its finest per-frame
    # layout (level 0, the largest) in float32; the scorer's layouts, the
    # bfloat16 layouts and the skipped and held launches stay in "levels".
    for rec in records.values():
        finest = [l for l in rec["levels"]
                  if not l["level"].startswith(("reloc", "bf16", "skipped", "kalman", "held"))][-1]
        rec.update({k: v for k, v in finest.items() if k != "level"})
        rec["library_ms"] = None  # no single PyTorch call computes any of these


def phase_profile(cfg, n: int = 10, label: str = "default"):
    """torch.profiler over ``n`` tracked frames of one SlamSystem run:
    device operations (kernels, copies, fills) per tracked frame, the
    device time they add up to, and the largest of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = make_sequence()[0][: n + 1]
    slam = port.SlamSystem(TUM_FR1, cfg, device="cuda")
    _run_sequence(slam, frames[:4])  # warm-up
    slam.reset()
    slam.process_frame(*frames[0])  # the keyframe, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[1:]:
            slam.process_frame(*f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels_ = [e for e in dev if not e.key.startswith(("Memcpy", "Memset"))]
    n_k = sum(e.count for e in kernels_) / n
    n_ops = sum(e.count for e in dev) / n
    dev_ms = sum(e.self_device_time_total for e in dev) / n / 1e3
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel") / n
    solver = sum(e.count for e in kernels_
                 if any(w in e.key.lower() for w in ("getrf", "potrf", "trsm", "cusolver"))) / n
    print(f"[profile] {label}, {n} tracked frames: {n_k:.1f} kernels per tracked frame "
          f"({n_ops:.1f} device ops with copies and fills, {launches:.1f} cudaLaunchKernel, "
          f"{solver:.1f} cuSOLVER/cuBLAS solver kernels); "
          f"device time {dev_ms:.3f} ms of {wall_ms:.2f} ms wall per frame under the profiler "
          f"(device idle {1 - dev_ms / wall_ms:.0%})")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[profile]   {e.count / n:7.1f}/frame {e.self_device_time_total / n:9.1f} us/frame "
              f"{e.key[:90]}")
    # Kernels of each tracked frame, one profiler window per frame, split by
    # what the frame did after tracking: fuse, switch keyframe, or neither.
    slam.reset()
    slam.process_frame(*frames[0])
    torch.cuda.synchronize()
    by_kind: dict = {}
    for f in frames[1:]:
        with profile(activities=[ProfilerActivity.CUDA]) as one:
            slam.process_frame(*f)
            torch.cuda.synchronize()
        s = slam.stats[-1]
        kind = "switch" if s.get("switch") else "fused" if s.get("n_fused", 0) > 0 else "other"
        by_kind.setdefault(kind, []).append(sum(
            e.count for e in one.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))))
    # A window that recorded nothing (the profiler drops one, rarely) is
    # left out of the means and shown in the lists.
    print(f"[profile] {label}, kernels per tracked frame by kind: " + ", ".join(
        f"{k} {np.mean([c for c in v if c > 0] or [0]):.1f} (frames {v})"
        for k, v in sorted(by_kind.items())))


# Rotations for [api]'s quaternions: each of Shepperd's four pivots the
# largest, an exact tie of the first two, and two near pi.
API_ROTATIONS = (
    _rot(0.2, -0.3, 0.1), _rot(2.6, 0.1, -0.2), _rot(0.1, 2.5, 0.15), _rot(-0.2, 0.1, 2.7),
    np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]]), _rot(np.pi - 1e-3, 0.0, 0.0),
    _rot(0.0, 0.0, -(np.pi - 5e-4)),
)


def _api_cases(intr: Intrinsics, seed: int = 16):
    """[api]'s calls: (name, function, numpy inputs, check), where check is
    ("close", rtol, atol), ("bilinear",) or ("equal",). VGA inputs."""
    from rgbid_tpu_torch.core import camera
    from rgbid_tpu_torch.ops import image, warp
    from rgbid_tpu_torch.tracking.step import unpack_frame

    rng = np.random.default_rng(seed)
    h, w = intr.height, intr.width
    f32 = np.float32
    T = np.eye(4, dtype=f32)
    T[:3, :3] = API_ROTATIONS[0]
    T[:3, 3] = [0.1, -0.05, 0.2]
    pts = rng.normal(size=(h * w, 3)).astype(f32)
    u = rng.uniform(-5, w + 5, (h, w)).astype(f32)
    v = rng.uniform(-5, h + 5, (h, w)).astype(f32)
    xi = rng.uniform(0.1, 3.0, (h, w)).astype(f32)
    xi[rng.random((h, w)) < 0.1] = 0.0
    mask = (rng.random((h, w)) > 0.15).astype(f32)
    mask[100:160, 200:330] = 0.0
    yy, xx = np.mgrid[0:h, 0:w]
    img = (0.5 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 13.0)).astype(f32)
    rots = np.stack(API_ROTATIONS).astype(f32)
    quats = np.stack([se3.to_quaternion(torch.from_numpy(r)).numpy() for r in rots])
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    depth = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    se3_tol, cam_tol = ("close", 1e-6, 1e-6), ("close", 1e-6, 0.0)

    def quaternions(r):
        return torch.stack([se3.to_quaternion(r[i]) for i in range(len(API_ROTATIONS))])

    def rotations(q):
        return torch.stack([se3.from_quaternion(q[i]) for i in range(len(API_ROTATIONS))])

    def pyramids(i0, m0, i1, m1):
        pyrs, mpyrs = image.build_pyramids_multi([i0, i1], [m0, m1], 4)
        return [p for pyr in pyrs + mpyrs for p in pyr]

    return [
        ("se3.identity", lambda t: se3.identity(device=t.device), (T,), ("equal",)),
        ("se3.from_rt", lambda t: se3.from_rt(t[:3, :3], t[:3, 3]), (T,), ("equal",)),
        ("se3.transform_points", se3.transform_points, (T, pts), se3_tol),
        ("se3.to_quaternion x7", quaternions, (rots,), se3_tol),
        ("se3.from_quaternion x7", rotations, (quats,), se3_tol),
        ("camera.pixel_grid", lambda x: camera.pixel_grid(h, w, device=x.device), (xi,),
         ("equal",)),
        ("camera.backproject", lambda a, b, c: camera.backproject(a, b, c, intr), (u, v, xi),
         cam_tol),
        ("camera.project", lambda a, b, c: camera.project(a, b, c, intr),
         (pts[:, 0].reshape(h, w), pts[:, 1].reshape(h, w), xi), cam_tol),
        ("warp.bilinear_sample", warp.bilinear_sample, (img, mask, u, v), ("bilinear",)),
        ("image.build_pyramids_multi", pyramids, (img, mask, xi, (xi > 0).astype(f32)),
         ("close", 0.0, 1e-6)),
        ("step.unpack_frame", unpack_frame, (pack_frame(rgb, depth),), ("equal",)),
    ]


def _api_agrees(check, card, cpu) -> tuple:
    """(ok, max |card - cpu|) over the outputs of one [api] call."""
    card = [card] if torch.is_tensor(card) else list(card)
    cpu = [cpu] if torch.is_tensor(cpu) else list(cpu)
    ok, err = len(card) == len(cpu), 0.0
    for i, (k, c) in enumerate(zip(card, cpu)):
        k, c = k.cpu().numpy(), c.numpy()
        ok &= k.shape == c.shape and k.dtype == c.dtype
        if not ok:
            break
        d = np.abs(k.astype(np.float64) - c.astype(np.float64))
        err = max(err, float(d.max()))
        if check[0] == "equal" or (check[0] == "bilinear" and i == 1):
            ok &= bool(np.array_equal(k, c))
        elif check[0] == "bilinear":
            ok &= bool((d <= 1e-5).all())
        else:
            ok &= bool(np.allclose(k, c, rtol=check[1], atol=check[2]))
    return ok, err


def phase_api(smi: str) -> bool:
    """[api]: the JAX package's smaller public functions on the card at VGA,
    each against the same call on the CPU (se3 within 1e-6 absolute below 1
    and relative above; camera within 1e-6 relative; ``bilinear_sample``'s
    validity equal and values within 1e-5; ``build_pyramids_multi`` within
    1e-6, masks equal; the rest equal), each call once under
    ``set_sync_debug_mode("error")`` (no host read), and its µs a call
    (CUDA events over 50 back-to-back calls, launch included)."""
    ok = True
    for name, fn, inputs, check in _api_cases(TUM_FR1):
        cpu_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in inputs]
        card_args = [a.cuda() for a in cpu_args]
        fn(*card_args)  # warm-up: the blur taps' one upload, cuDNN's plans
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card, synced = fn(*card_args), ""
        except RuntimeError as e:
            card, synced = None, str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if card is None:
            print(f"[api] {name}: FAIL, synchronized: {synced}")
            ok = False
            continue
        good, err = _api_agrees(check, card, fn(*cpu_args))
        us = _time_ms(lambda: fn(*card_args)) * 1e3
        print(f"[api] {name}: {'OK' if good else 'FAIL'}, max |card - cpu| {err:.3g} "
              f"({check[0]}{'' if len(check) == 1 else f' rtol {check[1]} atol {check[2]}'}), "
              f"no sync, {us:.2f} µs a call; {smi}")
        ok &= good
    print(f"[api] {'OK' if ok else 'FAILED'}")
    return ok


def _run_sequence(slam, frames):
    """Process frames; returns (poses, per-frame wall ms)."""
    ms = []
    for rgb, depth, t in frames:
        t0 = time.perf_counter()
        slam.process_frame(rgb, depth, t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    slam.finish()
    return slam.poses(), ms


# The counts the main paths read: (wrapper, attribute). Every wrapper adds
# one to ``launches`` where it launches its kernel; ``sigma_phases`` counts
# the scale steps run inside IC launches.
COUNTERS = {
    "esm_normal_eq": (kernels.esm_residuals_and_normal_eq, "launches"),
    "esm_stratified": (kernels.esm_stratified, "launches"),
    "ic_normal_eq": (kernels.ic_normal_eq, "launches"),
    "ic_sigma_stats": (kernels.ic_sigma_stats, "launches"),
    "ic_sigma_phases": (kernels.ic_normal_eq, "sigma_phases"),
    "fusion": (fusion.fuse_frame, "launches"),
    "irls_solve": (kernels.irls_solve_step, "launches"),
    "consensus_vote": (consensus.consensus_vote, "launches"),
}


def _n_iters(tc, level: int) -> int:
    return tc.iters[level] if level < len(tc.iters) else tc.iters[-1]


def _vote_levels(tc):
    return range(1, min(tc.consensus_level, tc.levels - 1) + 1)


def expected_launches(tc, tracked: int, fusion_on: bool = True) -> dict:
    """Launches a run must make. Every tracked frame is one replay of the
    captured step, whose launches are fixed: one per IRLS iteration (40 at
    the default iters) in every mode; under the consensus (ESM) also the
    masked reruns' (the vote levels' iterations, 18) and the rescue
    pyramid's (40, plus two level-0 evidence evaluations), each held on
    the device unless its vote fires, and one stratified and one vote
    launch per vote (two each); one fusion launch per tracked frame
    (copying the planes through unless the frame fuses); in IC exact
    max(sigma_iters, 1) scale phases inside each IC launch, and no
    standalone scale launch."""
    per_frame = sum(_n_iters(tc, l) for l in range(tc.levels))
    iters = tracked * per_frame
    out = {"fusion": tracked if fusion_on else 0}
    if tc.jacobian == "esm":
        votes = 0
        if tc.consensus:
            votes = tracked * len(_vote_levels(tc))
            reruns = sum(_n_iters(tc, l) for l in _vote_levels(tc))
            iters += tracked * (reruns + per_frame + 2)
        return {**out, "esm_normal_eq": iters, "esm_stratified": votes, "consensus_vote": votes,
                "ic_normal_eq": 0, "ic_sigma_stats": 0, "ic_sigma_phases": 0}
    sigma = iters * max(tc.sigma_iters, 1) if tc.sigma_mode == "exact" else 0
    return {**out, "esm_normal_eq": 0, "esm_stratified": 0, "consensus_vote": 0,
            "ic_normal_eq": iters, "ic_sigma_stats": 0, "ic_sigma_phases": sigma}


def expected_runs(tc, tracked: int, rerun_iters: int, rescues: int) -> int:
    """IRLS launches that must RUN on the device (the rest held by their
    predicate word): 40 per tracked frame, plus the consensus's rerun
    iterations, plus 42 per rescue (40 iterations and two level-0 evidence
    evaluations), as the frames' result vectors report them."""
    per_frame = sum(_n_iters(tc, l) for l in range(tc.levels))
    return tracked * per_frame + rerun_iters + rescues * (per_frame + 2)


def _consensus_trace(stats):
    """Per tracked frame: (consensus_frac, cons_flags, persistent flags,
    rescue), the run's consensus record."""
    return [(s.get("consensus_frac"), s.get("cons_flags"), s.get("cons_flags_persist"),
             s.get("rescue")) for s in stats[1:]]


def phase_main(cfg, label: str, mover: bool = False, loop: bool = False):
    """One main-path run. Returns (good, launches, median ms/frame, the
    system after its timed rerun)."""
    tc = cfg.tracking
    if loop:
        frames, gt = make_loop_sequence()
        bound, kind = LOOP_ATE_BOUND_M, "loop"
    else:
        frames, gt = make_mover_sequence() if mover else make_sequence()
        bound, kind = (MOVER_ATE_BOUND_M, "mover") if mover else (ATE_BOUND_M, "rigid")
    slam = port.SlamSystem(TUM_FR1, cfg, device="cuda")
    # Warm-up on a short prefix (kernel builds, the graph's capture), then a
    # fresh run: reset() keeps the graph.
    _run_sequence(slam, frames[:4])
    slam.reset()
    torch.cuda.synchronize()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    kernels.reset_iteration_counts("cuda")
    reads0, counts0 = slam.host_reads, slam.tracker_counts
    replays0, captures0 = slam._step.replays, slam._step.captures
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            poses, _ = _run_sequence(slam, frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launches = {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}
    reads = slam.host_reads - reads0
    counts = {k: v - counts0[k] for k, v in slam.tracker_counts.items()}
    replays = slam._step.replays - replays0
    captures = slam._step.captures - captures0
    ran = int(kernels.iteration_counts("cuda")[1].sum())
    # Every synchronizing operation PyTorch reports in the run should be
    # one of the deliberate host reads: one per tracked frame (its flight
    # of one) and one per finalize.
    syncs = sum(str(w.message).startswith("called a synchronizing") for w in caught)
    tracked = len(frames) - 1
    expected = expected_launches(tc, tracked)
    runs_expected = expected_runs(tc, tracked, counts["rerun_iters"], counts["rescues"])
    switches = sum(bool(s.get("switch")) for s in slam.stats)
    lost = sum(bool(s.get("lost")) for s in slam.stats)
    fused = sum(s.get("n_fused", 0) > 0 for s in slam.stats)
    finite = all(np.isfinite(T).all() for T in poses)
    ate = sequence_ate(gt, poses)
    traj = slam.trajectory()
    cloud = slam.map_points()
    n_kf = len(slam.manager.keyframes)
    # The front end's bookkeeping for the back end: an odometry edge per
    # switch between consecutive keyframes, the reloc planes of every
    # finalized keyframe, one packed read per finalize.
    edges = slam.manager.edges
    planes_ok = all(
        kf.reloc_planes is not None
        and kf.reloc_planes["intensity0_u8"].shape == (TUM_FR1.height, TUM_FR1.width)
        and all(np.isfinite(kf.reloc_planes[k]).all() for k in ("intensity", "xi", "mask"))
        for kf in slam.manager.keyframes)
    edges_ok = (len(edges) == switches == n_kf - 1
                and all(e.to_id == e.from_id + 1 and np.isfinite(e.information).all()
                        for e in edges))
    finalize_reads = slam.manager.host_reads
    trace = _consensus_trace(slam.stats)
    fired = consensus_fired(slam.stats)

    # A second run, with the sync-debug mode off (it slows the host), is
    # the timed one; the same input must give bit-identical poses and the
    # same consensus decisions.
    slam.reset()
    poses2, ms = _run_sequence(slam, frames)
    identical = (all(np.array_equal(a, b) for a, b in zip(poses, poses2))
                 and _consensus_trace(slam.stats) == trace)

    steady = ms[5:]
    cnt = ", ".join(f"{k} {launches[k]} (expected {v})" for k, v in expected.items())
    print(f"[main {label}] SlamSystem VGA {TUM_FR1.width}x{TUM_FR1.height}, "
          f"{kind} sequence, {len(frames)} frames ({tracked} tracked): graph replays {replays} "
          f"(expected {tracked}), captures {captures} (expected 0: reset() keeps the graph), "
          f"graph nodes {slam._step.graph_nodes}; launches {cnt}; IRLS launches run on the "
          f"device {ran} (expected {runs_expected} = 40/frame + reruns + 42/rescue), fused "
          f"frames {fused}; consensus reruns {counts['rerun_iters']} iterations, rescues "
          f"{counts['rescues']}; switches {switches}, lost {lost}, keyframes {n_kf}, odometry "
          f"edges {len(edges)} ({sum(e.episode for e in edges)} episode-tagged) ok {edges_ok}, "
          f"reloc planes on every keyframe {planes_ok}, finalize reads {finalize_reads}")
    if tc.consensus and tc.jacobian == "esm":
        print(f"[main {label}] consensus: max consensus_frac "
              f"{max(t[0] for t in trace):.3f}, frames with flags "
              f"{sum(t[1] > 0 for t in trace)}, with persistent flags "
              f"{sum(t[2] > 0 for t in trace)}, refounding rescues {sum(bool(t[3]) for t in trace)}"
              f"; fired {fired}")
    print(f"[main {label}] ATE {ate * 1e3:.3f} mm (bound {bound * 1e3:.1f} mm), poses "
          f"finite {finite}, trajectory {len(traj)} rows, map {len(cloud)} points, cloud "
          f"finite {bool(np.isfinite(cloud).all())}, rerun bit-identical {identical}")
    # The highest percentile with at least ten frames above it (the median
    # when there are fewer than twenty).
    q = 100.0 * max(len(steady) - 10, len(steady) // 2) / len(steady)
    print(f"[main {label}] ms/frame median {np.median(steady):.2f}, p{q:.0f} "
          f"{np.percentile(steady, q):.2f} (min {np.min(steady):.2f}, max "
          f"{np.max(steady):.2f}) over {len(steady)} frames (5..{len(frames) - 1}) of the "
          f"rerun; host reads "
          f"{reads} = {reads / tracked:.2f}/tracked frame (expected 1 + finalizes "
          f"{finalize_reads / tracked:.2f}); synchronizing operations "
          f"reported by torch.cuda sync-debug mode {syncs}")
    good = (
        all(launches[k] == v for k, v in expected.items())
        and fused >= 1
        and replays == tracked
        and captures == 0
        and ran == runs_expected
        and reads == tracked + finalize_reads
        and switches >= 1
        and lost == 0
        and finite
        and ate <= bound
        and (fired or not mover)
        and len(traj) == len(frames)
        and len(cloud) > 0
        and bool(np.isfinite(cloud).all())
        and identical
        and syncs == reads
        and edges_ok
        and planes_ok
        and finalize_reads == n_kf
        and (n_kf >= LOOP_MIN_KEYFRAMES or not loop)
    )
    print(f"[main {label}] {'OK' if good else 'FAIL'}")
    return good, launches, float(np.median(steady)), slam


def _host_planes(frame, cfg, level: int) -> dict:
    """A frame's reloc planes made on the host (numpy), as
    ``SlamSystem._try_relocalize`` makes a lost frame's."""
    pyr = odometry.preprocess_frame(frame[0], frame[1], level + 1, cfg.depth_scale,
                                    cfg.min_depth, cfg.max_depth)
    return {"intensity": pyr.intensity[level], "xi": pyr.xi[level],
            "mask": pyr.mask[level].astype(np.float32)}


def _counted_score(scorer: RelocScorer, templates, currents):
    """``score_pairs`` under the sync-debug mode. Returns (result, the
    scorer's launches, its reads, the syncs PyTorch reported, launches
    added to the per-frame ESM count: must be 0)."""
    torch.cuda.synchronize()
    l0, r0 = scorer.launches, scorer.host_reads
    frame0 = kernels.esm_residuals_and_normal_eq.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = scorer.score_pairs(templates, currents)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(str(w.message).startswith("called a synchronizing") for w in caught)
    return (res, scorer.launches - l0, scorer.host_reads - r0, syncs,
            kernels.esm_residuals_and_normal_eq.launches - frame0)


def _margins_text(scorer: RelocScorer, res, i: int) -> str:
    return ", ".join(f"{k} {v:+.4g}" for k, v in scorer.margins(res, i).items())


def phase_scorer():
    """``RelocScorer`` on the card against the same scorer on the CPU, on
    three pairs from the loop sequence at VGA, ``reloc_level`` 2: a revisit
    (frame 0 seen again from the third-last pose of the loop), an adjacent
    pair (frames 10 and 12), and an unrelated pair (frame 0 against the
    same pose in a room with other textures). The same ``accept`` on every
    pair, T within SCORER_POSE_TOL where both accept, every margin printed;
    exactly 3 x reloc_iters launches per pair, all in the scorer's own
    count, and one read (= one sync) per call."""
    cfg = default_config()
    frames, gt = make_loop_sequence()
    other, _ = make_loop_sequence(seed=5, n=1)
    on_card = RelocScorer(TUM_FR1, cfg, "cuda")
    on_cpu = RelocScorer(TUM_FR1, cfg, "cpu")
    planes = {i: _host_planes(frames[i], cfg, on_card.level) for i in (0, 10, 12, len(gt) - 3)}
    pairs = [("revisit", planes[0], planes[len(gt) - 3], True),
             ("adjacent", planes[10], planes[12], True),
             ("unrelated", planes[0], _host_planes(other[0], cfg, on_card.level), False)]
    templates, currents = [p[1] for p in pairs], [p[2] for p in pairs]
    iters = cfg.backend.reloc_iters
    on_card.score_pairs(templates[:1], currents[:1])  # warm-up
    res, launches, reads, syncs, leaked = _counted_score(on_card, templates, currents)
    ref = on_cpu.score_pairs(templates, currents)
    again = on_card.score_pairs(templates, currents)
    alone = on_card.score_pairs(templates[1:2], currents[1:2])
    same = (all(np.array_equal(a, b) for a, b in zip(res, again))
            and all(np.array_equal(a[0], b[1]) for a, b in zip(alone, res)))
    ok = (launches == 3 * iters * len(pairs) and reads == 1 and syncs == 1 and leaked == 0
          and on_cpu.launches == 0 and same)
    print(f"[scorer] {len(pairs)} pairs at {on_card.intr_l.width}x{on_card.intr_l.height}: "
          f"launches {launches} (expected 3 x {iters} x {len(pairs)} = "
          f"{3 * iters * len(pairs)}), added to the per-frame count {leaked} (expected 0), reads "
          f"{reads}, syncs {syncs} (expected 1 each); rerun and a pair scored alone "
          f"bit-identical {same}")
    for i, (name, _, _, expect) in enumerate(pairs):
        a_card, a_cpu = on_card.accept(res, i), on_cpu.accept(ref, i)
        dT = float(np.abs(res.T[i] - ref.T[i]).max())
        good = a_card == a_cpu == expect and (dT <= SCORER_POSE_TOL or not expect)
        ok &= good and bool(np.isfinite(res.T[i]).all())
        print(f"[scorer] {name}: accept card {a_card} cpu {a_cpu} (expected {expect}), T max|d| "
              f"card - cpu {dT:.2e} (tol {SCORER_POSE_TOL:.0e} where accepted); margins card: "
              f"{_margins_text(on_card, res, i)}; cpu: {_margins_text(on_cpu, ref, i)} "
              f"{'OK' if good else 'FAIL'}")
    # The revisit's pose against the ground truth (T maps template points
    # into the current frame).
    T_gt = np.linalg.inv(gt[len(gt) - 3]) @ gt[0]
    d_gt = float(np.abs(res.T[0] - T_gt)[:3, 3].max())
    ok &= d_gt < 5e-3
    print(f"[scorer] revisit translation against ground truth max|d| {d_gt * 1e3:.3f} mm "
          f"(bound 5 mm)")

    def wall(fn, reps=5):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    ms3 = wall(lambda: on_card.score_pairs(templates, currents))
    ms1 = wall(lambda: on_card.score_pairs(templates[:1], currents[:1]))
    cpu3 = wall(lambda: on_cpu.score_pairs(templates, currents), reps=1)
    print(f"[scorer] score_pairs wall ms (uploads, {3 * iters} launches a pair, one read): "
          f"1 pair {ms1:.2f}, 3 pairs {ms3:.2f}; the CPU scorer (plain versions), 3 pairs "
          f"{cpu3:.1f}")
    print(f"[scorer] {'OK' if ok else 'FAIL'}")
    return ok, {"score_pairs_ms_1": ms1, "score_pairs_ms_3": ms3}


def keyframe_ate(keyframes, poses, gt) -> float:
    """ATE of keyframe poses against the ground truth of their founding
    frames (timestamps are frame / 30)."""
    idx = [int(round(kf.timestamp * 30.0)) for kf in keyframes]
    gt0 = np.linalg.inv(gt[0])
    return absolute_trajectory_error([gt0 @ gt[i] for i in idx], poses)["rmse"]


def close_loop(slam, gt, device):
    """What the back end does with a finished loop run, without ORB and
    BoW: verify (last keyframe, keyframe 0) with the scorer on ``device``,
    build the loop edge as ``LoopCloser.process_keyframe`` does, and
    optimize the pose graph of the run's odometry edges plus that edge as
    ``BackendThread._optimize`` does. Returns a dict of what came out."""
    cfg = slam.config
    kfs = slam.manager.keyframes
    scorer = RelocScorer(slam.intr, cfg, device)
    if scorer.device.type == "cuda":
        res, launches, reads, syncs, leaked = _counted_score(
            scorer, [kfs[0].reloc_planes], [kfs[-1].reloc_planes])
    else:
        res = scorer.score_pairs([kfs[0].reloc_planes], [kfs[-1].reloc_planes])
        launches, reads, syncs, leaked = 0, scorer.host_reads, 0, 0
    t0 = time.perf_counter()
    scorer.score_pairs([kfs[0].reloc_planes], [kfs[-1].reloc_planes])
    score_ms = (time.perf_counter() - t0) * 1e3
    accepted = scorer.accept(res, 0)
    pg = PoseGraph(cfg.backend.pg_iterations, cfg.backend.pg_damping)
    for e in slam.manager.edges:
        pg.add_edge(e.from_id, e.to_id, e.T_rel, e.information, robust=bool(e.episode))
    edge = loop_edge(res, 0, kfs[0].kf_id, kfs[-1].kf_id)
    pg.add_edge(edge["from_id"], edge["to_id"], edge["T_rel"], edge["information"], robust=True)
    poses = [kf.T_wk.copy() for kf in kfs]
    # Timed twice: the first call also loads scipy.sparse's solver.
    optimize_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        result = pg.optimize(poses)
        optimize_ms.append((time.perf_counter() - t0) * 1e3)
    # The loop edge against the ground truth: T_rel maps the last
    # keyframe's points into keyframe 0.
    i_last = int(round(kfs[-1].timestamp * 30.0))
    T_rel_gt = np.linalg.inv(gt[0]) @ gt[i_last]
    return dict(
        accepted=accepted, margins=_margins_text(scorer, res, 0), launches=launches, reads=reads,
        syncs=syncs, leaked=leaked, score_ms=score_ms, optimize_ms=optimize_ms[1],
        optimize_first_ms=optimize_ms[0],
        n_edges=len(pg.edges), iterations=result["iterations"],
        initial_error=result["initial_error"], final_error=result["final_error"],
        finite=all(np.isfinite(T).all() for T in result["poses"]),
        ate_before=keyframe_ate(kfs, poses, gt), ate_after=keyframe_ate(kfs, result["poses"], gt),
        edge_err=float(np.abs(edge["T_rel"] - T_rel_gt)[:3, 3].max()),
        expected_launches=3 * cfg.backend.reloc_iters,
    )


def phase_loop():
    """The loop run: ``SlamSystem`` (the default configuration, back end
    off, tight keyframe limits) over the closed path, with every check of a
    main-path run, then ``close_loop`` on the card."""
    good, launches, median, slam = phase_main(loop_config(), "loop", loop=True)
    out = close_loop(slam, loop_path(LOOP_FRAMES), "cuda")
    ok = (out["accepted"] and out["finite"] and out["launches"] == out["expected_launches"]
          and out["reads"] == 1 and out["syncs"] == 1 and out["leaked"] == 0
          and out["final_error"] <= out["initial_error"] + 1e-12
          and out["ate_after"] <= out["ate_before"] + LOOP_PG_MARGIN_M)
    print(f"[loop] score_pairs(keyframe 0, keyframe {len(slam.manager.keyframes) - 1}) on the "
          f"card: accepted {out['accepted']} ({out['margins']}); launches {out['launches']} "
          f"(expected {out['expected_launches']}), reads {out['reads']}, syncs {out['syncs']}, "
          f"added to the per-frame count {out['leaked']}; loop edge translation against ground "
          f"truth max|d| {out['edge_err'] * 1e3:.3f} mm; {out['score_ms']:.2f} ms")
    print(f"[loop] PoseGraph.optimize over {len(slam.manager.keyframes)} keyframes, "
          f"{out['n_edges']} edges ({len(slam.manager.edges)} odometry + 1 loop): "
          f"{out['iterations']} iterations, error {out['initial_error']:.6g} -> "
          f"{out['final_error']:.6g}, poses finite {out['finite']}, keyframe ATE "
          f"{out['ate_before'] * 1e3:.3f} -> {out['ate_after'] * 1e3:.3f} mm (margin "
          f"{LOOP_PG_MARGIN_M * 1e3:.1f} mm); {out['optimize_ms']:.2f} ms (first call "
          f"{out['optimize_first_ms']:.2f} ms)")
    print(f"[loop] {'OK' if ok else 'FAIL'}")
    return good and ok, launches, median, out

# ---------------------------------------------------------------------------
# The back end on: ORB, the thread beside the front end, relocalization


def phase_orb():
    """The port's ORB on three VGA views of the loop sequence. The last
    frame's pose is the first's and the renderer adds noise to depth only,
    so its image, and every descriptor, must come out again; the third-last
    frame is a near view, whose best matches are printed."""
    frames, _ = make_loop_sequence()
    views = {i: gray_from_rgb(frames[i][0]) for i in (0, len(frames) - 3, len(frames) - 1)}
    feats, ms = {}, {}
    for i, gray in views.items():
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            feats[i] = orb.detect_and_compute(gray, 500)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[i] = float(np.median(times))
        pts, desc = extract_orb(gray, 500)
        same = np.array_equal(pts, feats[i].pts) and np.array_equal(desc, feats[i].descriptors)
        print(f"[orb] frame {i}: {len(pts)} keypoints, per octave "
              f"{np.bincount(feats[i].octave, minlength=orb.N_LEVELS).tolist()}, "
              f"{ms[i]:.1f} ms per call on this host (median of 5), extract_orb gives the same "
              f"{same}")
        if not same or pts.dtype != np.float32 or desc.dtype != np.uint8 or len(pts) == 0:
            print("[orb] FAIL")
            return False, ms

    def best(a, b):
        bits = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=2).sum(axis=2)
        return bits.min(axis=1)

    first, near, last = (feats[i].descriptors for i in views)
    d_last, d_near = best(first, last), best(first, near)
    ok = bool((d_last == 0).all()) and len(first) == len(last) and float(np.median(d_near)) <= 64
    print(f"[orb] best-match Hamming distance from frame 0's descriptors: to the last frame "
          f"(the same image) max {int(d_last.max())} (expected 0); to the third-last frame "
          f"median {np.median(d_near):.0f}, {int((d_near <= 40).sum())} of {len(d_near)} within "
          f"40 of 256 bits (bound: median at most 64)")
    print(f"[orb] {'OK' if ok else 'FAIL'}")
    return ok, ms


def _frame_records(stats):
    """The per-frame records without the wall time: what tracking decided."""
    return [{k: v for k, v in rec.items() if k != "ms"} for rec in stats]


def _drive(slam, frames, debug_syncs: bool):
    """Reset the system and drive it over the frames through
    ``process_frame`` and ``finish``. Returns what one run shows: per-frame
    launch counts, the scorer's counts, reads by part, syncs, timings."""
    slam.reset()
    torch.cuda.synchronize()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    step0, counts0 = slam._step.host_reads, slam.tracker_counts  # these outlive reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if debug_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for f in frames:
                slam.process_frame(*f)
            t0 = time.perf_counter()
            slam.finish()
            finish_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out = {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}
    be = slam.backend
    scorer = be.loop_closer.scorer if be is not None else None
    out.update(
        syncs=sum(str(w.message).startswith("called a synchronizing") for w in caught),
        reads=slam.host_reads - step0, step_reads=slam._step.host_reads - step0,
        finalize_reads=slam.manager.host_reads,
        thread_finalizes=be.finalized if be is not None else 0,
        scorer_reads=scorer.host_reads if scorer else 0,
        scorer_launches=scorer.launches if scorer else 0,
        scorer_steps=scorer.irls_steps if scorer else 0,
        rescues=slam.tracker_counts["rescues"] - counts0["rescues"],
        rerun_iters=slam.tracker_counts["rerun_iters"] - counts0["rerun_iters"],
        closures=be.num_loop_closures if be is not None else 0,
        errors=be.errors if be is not None else 0,
        finish_ms=finish_ms, ms=np.array([r["ms"] for r in slam.stats[1:]]),
        records=_frame_records(slam.stats), poses=slam.poses(),
    )
    return out


def _reads_text(run, tracked: int):
    """The run's host reads by part, as text, and whether the step's parts
    add up: one read of the result vectors per flight (a tracked frame
    under ``process_frame``), and nothing else: the votes, the fusion and
    the rescue are decided on the device."""
    step = {"flights": tracked}
    named = sum(step.values()) == run["step_reads"]
    on_thread = run["thread_finalizes"]
    return (", ".join(f"{k} {v}" for k, v in step.items())
            + f" (= the step's {run['step_reads']}: {named}), finalizes on the thread {on_thread}, "
            f"finalizes on the front end {run['finalize_reads'] - on_thread}, scorer calls "
            f"{run['scorer_reads']}"), named


def _score_breakdown(scorer: RelocScorer, template: dict, current: dict, rounds: int = 3) -> dict:
    """Where the wall time of one one-pair ``score_pairs`` call goes: the
    call's own steps, run one after the other with the card drained between
    them (so the parts need not add up to the call, which overlaps them);
    the median of ``rounds`` rounds after a warm-up round."""
    dev = scorer.device
    iters = scorer.cfg.backend.reloc_iters

    def one_round():
        parts = {}

        def part(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts[name] = (time.perf_counter() - t0) * 1e3
            return out

        t, c = part("upload (pin, copy) of both plane sets",
                    lambda: (scorer._upload(template), scorer._upload(current)))
        tp, cp = part("mini_pyramid of both", lambda: (mini_pyramid(t), mini_pyramid(c)))
        part("level_args at 3 levels (gradients, back-projection)",
             lambda: [scorer.level_args(tp[l], cp[l], scorer.intrs[l]) for l in (2, 1, 0)])
        state = [torch.eye(4, device=dev), torch.full((), 0.01, device=dev),
                 torch.full((), 0.0025, device=dev), None]

        def align():
            with kernels.count_launches_into(scorer):
                for l in (2, 1, 0):
                    state[:] = scorer._align_level(tp[l], cp[l], *state[:3], scorer.intrs[l])

        part(f"level_args again + {3 * iters} IRLS launches", align)
        part("result row, one read", lambda: torch.cat(
            [state[0].reshape(-1), state[3].H.reshape(-1)]).cpu())
        part("the whole call", lambda: scorer.score_pairs([template], [current]))
        return parts

    one_round()
    got = [one_round() for _ in range(rounds)]
    return {k: float(np.median([g[k] for g in got])) for k in got[0]}


def phase_backend():
    """The default configuration with the back end on over the loop
    sequence, in turns with the back end off (see the module docstring,
    item 8). Returns (ok, the counted on-run, timings for the JSON line)."""
    frames, gt = make_loop_sequence()
    tracked = len(frames) - 1
    cfg_on, cfg_off = backend_config(), loop_config()
    b = cfg_on.backend
    print(f"[backend] SlamConfig() with keyframe.max_translation "
          f"{cfg_on.keyframe.max_translation}, keyframe.max_rotation "
          f"{cfg_on.keyframe.max_rotation}; the back end's gates at their defaults: "
          f"min_keyframe_gap {b.min_keyframe_gap}, min_score {b.min_score}, rel_score "
          f"{b.rel_score}, max_candidates {b.max_candidates}, num_features {b.num_features}, "
          f"vocab_path {b.vocab_path!r}, reloc_level {b.reloc_level}, reloc_iters {b.reloc_iters}")
    systems = {True: port.SlamSystem(TUM_FR1, cfg_on, device="cuda"),
               False: port.SlamSystem(TUM_FR1, cfg_off, device="cuda")}
    for slam in systems.values():  # warm-up
        _drive(slam, frames[:6], False)
    # Two counted runs under the sync-debug mode, then timed runs in turns.
    counted = {on: _drive(systems[on], frames, True) for on in (False, True)}
    on, off = counted[True], counted[False]
    slam = systems[True]
    be, lc = slam.backend, slam.backend.loop_closer
    kfs = slam.manager.keyframes
    n_kf = len(kfs)
    ok = True

    def check(name, good, text):
        nonlocal ok
        ok &= bool(good)
        print(f"[backend] {name}: {text} {'OK' if good else 'FAIL'}")

    check("thread", be.errors == 0 and not be.alive and be._queue.empty(),
          f"errors {be.errors}, alive after finish() {be.alive}, queue empty "
          f"{be._queue.empty()};")
    idx = {kf.kf_id: int(round(kf.timestamp * 30.0)) for kf in kfs}
    edge_err = [float(np.abs(e["T_rel"] - np.linalg.inv(gt[idx[e["from_id"]]])
                             @ gt[idx[e["to_id"]]])[:3, 3].max()) for e in be._loop_edges]
    check("loop closures", be.num_loop_closures >= 1 and lc.n_accepted == be.num_loop_closures
          and lc.n_queries == n_kf and lc.n_accepted <= lc.n_candidates
          and all(e < LOOP_EDGE_TOL_M for e in edge_err)
          and all(e["to_id"] - e["from_id"] >= b.min_keyframe_gap for e in be._loop_edges),
          f"{n_kf} keyframes, {lc.n_queries} BoW queries, {lc.n_candidates} candidates, "
          f"{lc.n_accepted} accepted by the scorer = {be.num_loop_closures} loop edges "
          f"{[(e['from_id'], e['to_id']) for e in be._loop_edges]}, translation against ground "
          f"truth max|d| {[round(e * 1e3, 3) for e in edge_err]} mm (bound "
          f"{LOOP_EDGE_TOL_M * 1e3:.0f} mm); ORB keypoints per keyframe "
          f"{[len(kf.descriptors) for kf in kfs]};")
    res = be.last_result
    ate_on, ate_off = sequence_ate(gt, on["poses"]), sequence_ate(gt, off["poses"])
    kf_on = keyframe_ate(kfs, [kf.T_wk for kf in kfs], gt)
    kfs_off = systems[False].manager.keyframes
    kf_off = keyframe_ate(kfs_off, [kf.T_wk for kf in kfs_off], gt)
    check("pose graph", res is not None and res["final_error"] <= res["initial_error"] + 1e-12
          and all(np.isfinite(T).all() for T in on["poses"]) and ate_on <= LOOP_ATE_BOUND_M
          and kf_on <= kf_off + LOOP_PG_MARGIN_M,
          (f"last optimize {res['iterations']} iterations, error {res['initial_error']:.6g} -> "
           f"{res['final_error']:.6g}; " if res else "never ran; ")
          + f"ATE on {ate_on * 1e3:.3f} mm, off {ate_off * 1e3:.3f} mm (bound "
          f"{LOOP_ATE_BOUND_M * 1e3:.1f} mm); keyframe ATE on {kf_on * 1e3:.3f} mm, off "
          f"{kf_off * 1e3:.3f} mm (margin {LOOP_PG_MARGIN_M * 1e3:.1f} mm);")
    check("finalizes", all(kf.cloud is not None and kf.reloc_planes is not None
                           and kf.descriptors is not None for kf in kfs)
          and on["thread_finalizes"] == n_kf - 1 and on["finalize_reads"] == n_kf,
          f"every keyframe has its cloud, planes and descriptors; {on['thread_finalizes']} of "
          f"{n_kf} finalized by the thread (expected all but the last);")
    for name, run in (("off", off), ("on", on)):
        text, named = _reads_text(run, tracked)
        check(f"reads, back end {name}", named and run["syncs"] == run["reads"]
              == run["step_reads"] + run["finalize_reads"] + run["scorer_reads"],
              f"{run['reads']} host reads, {run['syncs']} syncs reported by the sync-debug mode "
              f"(process-wide: the thread's too): {text};")
    expected = expected_launches(cfg_on.tracking, tracked)
    per_frame = {k: on[k] for k in COUNTERS}
    pairs = lc.n_candidates
    check("launches", per_frame == {k: off[k] for k in COUNTERS}
          and all(on[k] == v for k, v in expected.items())
          and on["scorer_launches"] == on["scorer_steps"] == 3 * b.reloc_iters * pairs
          and on["scorer_reads"] == len(be.timings.get("score_pairs", [])),
          f"per-frame counts on {per_frame} = off; the scorer's own count "
          f"{on['scorer_launches']} (expected 3 x {b.reloc_iters} x {pairs} pairs = "
          f"{3 * b.reloc_iters * pairs}) in {on['scorer_reads']} calls;")

    # Timed runs in turns; every run's records against the first's.
    timed = {True: [], False: []}
    timings = {}
    for is_on in (False, True, True, False):
        run = _drive(systems[is_on], frames, False)
        timed[is_on].append(run)
        if is_on:
            for k, v in systems[True].backend.timings.items():
                timings.setdefault(k, []).extend(v)
    runs = [off, on] + timed[False] + timed[True]
    same = all(r["records"] == off["records"] for r in runs)
    closures = [r["closures"] for r in timed[True]]
    check("records", same and len(off["records"]) == len(frames),
          f"the per-frame records (keyframe id, error, overlap, inliers, n_fused, switch, lost, "
          f"relocalized, the consensus fields) of {len(runs)} runs, half of them with the back "
          f"end on, equal bit for bit {same};")
    ok &= all(r["thread_finalizes"] == n_kf - 1 and r["closures"] >= 1 and r["errors"] == 0
              for r in timed[True])

    def front(rs):
        ms = np.concatenate([r["ms"][4:] for r in rs])
        return float(np.median(ms)), float(ms.mean())

    (med_on, mean_on), (med_off, mean_off) = front(timed[True]), front(timed[False])
    finish_on = [round(r["finish_ms"], 1) for r in timed[True]]
    finish_off = [round(r["finish_ms"], 1) for r in timed[False]]
    print(f"[backend] front end ms/frame (process_frame's own clock, frames 5..{tracked} of two "
          f"runs each, in turns off/on/on/off): on median {med_on:.2f} mean {mean_on:.2f}, off "
          f"median {med_off:.2f} mean {mean_off:.2f}; the thread costs the front end "
          f"{med_on - med_off:+.2f} ms/frame in the median, {mean_on - mean_off:+.2f} in the "
          f"mean; finish() waits {finish_on} ms on, {finish_off} ms off; loop closures in the "
          f"timed on-runs {closures}")
    # The same comparison with the interpreter handing the GIL over every
    # 0.5 ms instead of every 5 ms: how much of the cost is the front end
    # waiting for the thread's Python to yield. Printed, not checked.
    interval = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        short = {is_on: _drive(systems[is_on], frames, False) for is_on in (False, True)}
    finally:
        sys.setswitchinterval(interval)
    ok &= all(r["records"] == off["records"] for r in short.values())
    (s_on, sm_on), (s_off, sm_off) = front([short[True]]), front([short[False]])
    print(f"[backend] with sys.setswitchinterval(0.0005) (default {interval}), one run each: on "
          f"median {s_on:.2f} mean {sm_on:.2f}, off median {s_off:.2f} mean {sm_off:.2f}: "
          f"{s_on - s_off:+.2f} ms/frame in the median, {sm_on - sm_off:+.2f} in the mean")
    print("[backend] the thread's host ms per keyframe event, by part (median, max, events, "
          "over the two timed runs): " + "; ".join(
              f"{k} {np.median(v):.2f}, {np.max(v):.2f}, {len(v)}" for k, v in timings.items()))
    parts = _score_breakdown(lc.scorer, kfs[0].reloc_planes, kfs[-1].reloc_planes)
    print("[backend] one score_pairs call on (keyframe 0, last keyframe), its steps run one "
          "after the other with the card drained between them, ms: "
          + "; ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    print(f"[backend] {'OK' if ok else 'FAIL'}")
    record = {"backend_ms_frame_on": med_on, "backend_ms_frame_off": med_off,
              "backend_ms_frame_on_short_switch": s_on, "backend_ms_frame_off_short_switch": s_off,
              "backend_finish_ms": float(np.median(finish_on)),
              "thread_ms": {k: float(np.median(v)) for k, v in timings.items()}}
    return ok, on, record


def phase_reloc():
    """The relocalization run (the module docstring, item 9). Returns (ok,
    the run)."""
    frames, gt, i_reloc = make_reloc_sequence()
    cfg = port.SlamConfig()
    slam = port.SlamSystem(TUM_FR1, cfg, device="cuda")
    # The database must hold the sweep's keyframes before the dropout, so
    # the drive waits for the thread there. A live user would not: a
    # keyframe that arrives later is only a candidate later.
    torch.cuda.synchronize()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i, f in enumerate(frames):
                if i == RELOC_FRAMES:
                    deadline = time.time() + 60.0
                    want = len(slam.manager.keyframes) - 1
                    while slam.backend.loop_closer.n_queries < want and time.time() < deadline:
                        time.sleep(0.01)
                slam.process_frame(*f)
            slam.finish()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum(str(w.message).startswith("called a synchronizing") for w in caught)
    launches = {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}
    be, lc = slam.backend, slam.backend.loop_closer
    stats, kfs = slam.stats, slam.manager.keyframes
    tracked = len(frames) - 1
    lost = [i for i, rec in enumerate(stats) if rec.get("lost")]
    relocalized = [i for i, rec in enumerate(stats) if rec.get("relocalized")]
    new = kfs[stats[i_reloc]["kf_id"]]
    T_gt = np.linalg.inv(gt[0]) @ gt[i_reloc]
    # The keyframe's pose as founded (the trajectory row moves with later
    # pose-graph updates; the loop edge holds what the scorer measured).
    ext = [e for e in be._loop_edges if e["to_id"] == new.kf_id]
    err_kf = float(np.linalg.norm(new.T_wk[:3, 3] - T_gt[:3, 3]))
    after = [float(np.linalg.norm(slam.poses()[i][:3, 3] - (np.linalg.inv(gt[0]) @ gt[i])[:3, 3]))
             for i in (i_reloc + 1, i_reloc + 2)]
    counts = slam.tracker_counts
    expected = expected_launches(cfg.tracking, tracked)
    iters = cfg.backend.reloc_iters
    pairs, rest = divmod(lc.scorer.irls_steps, 3 * iters)
    reads = slam.host_reads
    ok = (be.errors == 0 and not be.alive and be._queue.empty()
          and lost == list(range(RELOC_FRAMES, i_reloc + 1)) and relocalized == [i_reloc]
          and new.timestamp == frames[i_reloc][2] and len(ext) == 1
          and err_kf < RELOC_POSE_TOL_M and all(e < RELOC_POSE_TOL_M for e in after)
          and syncs == reads
          and all(launches[k] == v for k, v in expected.items())
          and lc.scorer.launches == lc.scorer.irls_steps and rest == 0
          and pairs > lc.n_candidates >= 0
          and all(np.isfinite(T).all() for T in slam.poses()))
    print(f"[reloc] SlamConfig() over {len(frames)} VGA frames: {RELOC_FRAMES} of a 1.3 rad "
          f"sweep, 3 dropout frames, then the views of frames 2 (depth on the left 45% only), 3 "
          f"and 4; {len(kfs)} keyframes, lost frames {lost}, relocalized frames {relocalized} "
          f"(expected [{i_reloc}]), thread errors {be.errors}, alive {be.alive}")
    print(f"[reloc] frame {i_reloc} founded keyframe {new.kf_id} {err_kf * 1e3:.2f} mm from "
          f"ground truth (bound {RELOC_POSE_TOL_M * 1e3:.0f} mm), external loop edge(s) "
          f"{[(e['from_id'], e['to_id']) for e in ext]}; the next two frames tracked "
          f"{[round(e * 1e3, 2) for e in after]} mm from ground truth; loop edges in all "
          f"{be.num_loop_closures}, of which the thread's {lc.n_accepted}")
    print(f"[reloc] host reads {reads} (step {slam._step.host_reads}, finalizes "
          f"{slam.manager.host_reads} of which on the thread {be.finalized}, scorer calls "
          f"{lc.scorer.host_reads}) = syncs {syncs}; per-frame counts {launches} (expected "
          f"{expected}); scorer launches {lc.scorer.launches} = 3 x {iters} x {pairs} pairs, "
          f"{lc.n_candidates} of them the thread's, the rest the front end's relocalization "
          f"attempts; ms of the frames with an attempt "
          f"{[stats[i]['ms'] for i in lost[2:]]}, median of the others "
          f"{np.median([rec['ms'] for rec in stats[5:RELOC_FRAMES]]):.2f}")
    print(f"[reloc] {'OK' if ok else 'FAIL'}")
    return ok, dict(launches, scorer_launches=lc.scorer.launches)


def _gauntlet_row(name, seq_kwargs, cfg_over, frames, intr, base_over, cache):
    """One gauntlet row through the port's runner on the card, the launch
    counts set to 0 just before and read just after. Returns (row, system,
    launches, whether they are the counts the run must make)."""
    over = {k: v for k, v in {**base_over, **cfg_over}.items() if not k.startswith("_")}
    key = port.SlamConfig().override(**over).config_hash()
    slam = cache.get(key)
    counts0 = slam.tracker_counts if slam is not None else {"rerun_iters": 0, "rescues": 0}
    torch.cuda.synchronize()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    row = gauntlet.run_scenario(name, seq_kwargs, cfg_over, frames, intr, base_over, cache,
                                seed=GAUNTLET_SEED, device="cuda")
    torch.cuda.synchronize()
    launches = {k: getattr(wrapper, attr) for k, (wrapper, attr) in COUNTERS.items()}
    slam = cache[key]
    counts = {k: v - counts0[k] for k, v in slam.tracker_counts.items()}
    expected = expected_launches(slam.config.tracking, row["frames"] - 1)
    exact = all(launches[k] == v for k, v in expected.items())
    return row, slam, launches, exact


def phase_gauntlet(w: int = 640, h: int = 480, frames: int = GAUNTLET_FRAMES):
    """Three gauntlet rows through the port's runner (the module docstring,
    item 10). Returns (ok, the per-frame launch counts summed over the runs,
    the scorer's launches).

    The revisit row's reclaim: its pre-finish ATE is taken after the last
    frame and before ``finish()``, so it is the odometry's ATE only if the
    thread has not yet published a pose-graph update by then; when the loop
    is closed a few frames before the end (at keyframe 6 of 8), whether it
    has is a race between the thread and the front end (on the CPU the
    update lands 4 frames before the end). The front end never reads the
    back end's poses, so the same row with the back end off gives the
    odometry's ATE exactly: the reclaim is held to that, and the pre-finish
    ATE must equal it or be below it (an update that landed early)."""
    intr = Intrinsics(fx=0.808 * w, fy=1.076 * h, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w,
                      height=h)
    cache, ok = {}, True
    total, scorer_launches = dict.fromkeys(COUNTERS, 0), 0
    rendered, render_s = {}, {}
    generate = synthetic.generate_sequence

    def timed_generate(*args, **kwargs):
        # One render per sequence: the revisit row's back-end-off run reuses it.
        key = json.dumps([args, kwargs], default=repr, sort_keys=True)
        if key not in rendered:
            t0 = time.perf_counter()
            rendered[key] = generate(*args, **kwargs)
            render_s[key] = time.perf_counter() - t0
        return rendered[key]

    synthetic.generate_sequence = timed_generate
    try:
        for name, seq_kwargs, cfg_over in gauntlet.scenarios(frames):
            if name not in GAUNTLET_ROWS:
                continue
            n_keys = len(render_s)
            row, slam, launches, exact = _gauntlet_row(name, seq_kwargs, cfg_over, frames, intr,
                                                       {}, cache)
            secs = list(render_s.values())[n_keys] if len(render_s) > n_keys else float("nan")
            be = slam.backend
            recorded, factor = VGA_RECORDED_MM[name]
            bound = max(recorded * factor, 1.5)
            checks = {
                "envelope": row["ate_rmse_mm"] <= bound,
                "lost": row["lost"] == 0,
                "finite": all(np.isfinite(T).all() for T in slam.poses()),
                "thread": be.errors == 0 and not be.alive,
                "launches": exact,
            }
            runs = [(launches, be.loop_closer.scorer.launches)]
            text = ""
            if "ate_pre_finish_mm" in row:
                off, _, off_launches, off_exact = _gauntlet_row(
                    name, seq_kwargs, cfg_over, frames, intr, {"backend.enabled": False}, cache)
                runs.append((off_launches, 0))
                odo, pre, post = off["ate_rmse_mm"], row["ate_pre_finish_mm"], row["ate_rmse_mm"]
                checks["reclaim"] = (post < GAUNTLET_RECLAIM * odo and row["loop_closures"] >= 1
                                     and pre <= odo + 1e-3 and off_exact)
                text = (f", pre-finish {pre:.3f} mm, the same row with the back end off "
                        f"{odo:.3f} mm (post/pre {post / pre:.3f}, post/off {post / odo:.3f}, "
                        f"bound {GAUNTLET_RECLAIM}; "
                        + ("the thread published before the last frame" if pre < odo - 1e-3
                           else "no update before the last frame") + ")")
            good = all(checks.values())
            ok &= good
            for run, scorer in runs:
                for k in COUNTERS:
                    total[k] += run[k]
                scorer_launches += scorer
            step_ms = np.array([rec["ms"] for rec in slam.stats[1:]])
            print(f"[gauntlet] {json.dumps(row)}")
            print(f"[gauntlet] {name}: ATE {row['ate_rmse_mm']:.3f} mm (recorded "
                  f"{recorded} on a TPU, bound {bound:.2f}){text}; renderer "
                  f"{secs / row['frames'] * 1e3:.1f} host ms/frame over {row['frames']} frames; "
                  f"process_frame ms median {np.median(step_ms):.2f} (max {step_ms.max():.2f}), "
                  f"the row's window {row['ms_per_frame']} ms/frame (with finish() and the "
                  f"ATE); loop closures {row['loop_closures']}, thread errors {be.errors}; "
                  f"launches {launches} (exact: {exact}), scorer "
                  f"{be.loop_closer.scorer.launches}; checks {checks} {'OK' if good else 'FAIL'}")
    finally:
        synthetic.generate_sequence = generate
    print(f"[gauntlet] {'OK' if ok else 'FAIL'}")
    return ok, total, scorer_launches


# SlamConfig.preset("real-v5e") against SlamConfig() (tests/test_torch_preset.py
# holds the two equal): the u12 codec, the early exit, bf16 planes, the
# stacked gather (accepted and ignored by the port).
PRESET_FLIPS = {"depth_codec": "u12", "tracking.early_exit_tol": 1e-5,
                "tracking.plane_dtype": "bf16", "tracking.stacked_gather": True}


def preset_config():
    """``default_config`` (back end off) with the preset's flips."""
    return default_config().override(**PRESET_FLIPS)


def preset_backend_config():
    """``backend_config`` (back end on, tight keyframe limits) with the
    preset's flips."""
    return backend_config().override(**PRESET_FLIPS)


SEQUENCES = {"rigid": lambda: make_sequence(), "mover": lambda: make_mover_sequence(),
             "loop": lambda: make_loop_sequence()}
# [preset]'s runs without the knobs, each read beside the runs with them.
REFERENCE_RUNS = {"default rigid": (default_config, "rigid"),
                  "default mover": (default_config, "mover"),
                  "back end on loop": (backend_config, "loop")}
# [preset]'s runs: label -> (config, sequence, the run without the knobs).
PRESET_RUNS = {
    "preset rigid": (preset_config, "rigid", "default rigid"),
    "preset mover": (preset_config, "mover", "default mover"),
    "preset loop": (preset_backend_config, "loop", "back end on loop"),
    "u12 rigid": (lambda: default_config().override(depth_codec="u12"), "rigid", "default rigid"),
    "u16h rigid": (lambda: default_config().override(depth_codec="u16h"), "rigid",
                   "default rigid"),
}
# max(2 x the port's CPU ATE under the same configuration, 5 mm), the CPU
# runs held to half by tests/test_torch_preset.py: rigid 0.680 mm, mover
# 32.631 mm, loop (back end on) 1.123 mm, u12 0.144 mm, u16h 0.101 mm.
PRESET_ATE_BOUND_M = {"preset rigid": 5e-3, "preset mover": 0.066, "preset loop": 5e-3,
                      "u12 rigid": 5e-3, "u16h rigid": 5e-3}
# kinect_sensor at VGA under PRESET_FLIPS: max(2 x the port's CPU ATE on the
# row, 1.5 mm); the CPU ATE is 1.773 mm (python -m rgbid_tpu_torch.eval.gauntlet
# --res 640x480 --frames 60 --only kinect_sensor --device cpu with the flips
# as --set; the JAX package's runner gives 1.767).
GAUNTLET_PRESET_BOUND_MM = 2 * 1.773


def _fixed_reads(run) -> int:
    """The step's reads: one per flight, whatever the frames decided."""
    return run["step_reads"]


def phase_preset():
    """``[preset]``: PRESET_RUNS on the card, each beside its run without the
    knobs (REFERENCE_RUNS) in the same call. Each run: counted under the
    sync-debug mode (launch counts set to 0 just before, read just after),
    then again for run-to-run bit-identity. Checks: ATE within
    PRESET_ATE_BOUND_M, no loss, finite poses; launches exactly
    ``expected_launches`` (the host enqueues the whole budget); the device's
    count of IRLS iterations run, per level, at most those enqueued, and the
    enqueued ones the launches with a level slot (all but the rescues'
    evidence); reads = syncs, every read of the step named, and the step's
    fixed reads per tracked frame (results and votes) those of the run
    without the knobs; the back end (loop) without errors, with a loop
    closure when the run without the knobs has one. Then kinect_sensor at
    VGA under PRESET_FLIPS through the gauntlet runner (bound
    GAUNTLET_PRESET_BOUND_MM, exact launches, no loss). Returns (ok, counts
    summed over every counted run, scorer launches)."""
    ok = True
    total, scorer_launches = dict.fromkeys(COUNTERS, 0), 0
    refs, seqs = {}, {}

    def sequence(kind):
        if kind not in seqs:
            seqs[kind] = SEQUENCES[kind]()
        return seqs[kind]

    def add(run):
        nonlocal scorer_launches
        for k in COUNTERS:
            total[k] += run[k]
        scorer_launches += run["scorer_launches"]

    for label, (cfg_fn, kind) in REFERENCE_RUNS.items():
        frames, gt = sequence(kind)
        slam = port.SlamSystem(TUM_FR1, cfg_fn(), device="cuda")
        _drive(slam, frames[:4], False)  # warm-up
        run = _drive(slam, frames, True)
        add(run)
        tracked = len(frames) - 1
        run["ate"] = sequence_ate(gt, run["poses"])
        refs[label] = run
        print(f"[preset] {label} (without the knobs): ATE {run['ate'] * 1e3:.3f} mm, reads "
              f"{run['reads']} ({run['step_reads'] / tracked:.3f}/tracked frame in the step, "
              f"fixed {_fixed_reads(run) / tracked:.3f}), syncs {run['syncs']}, loop closures "
              f"{run['closures']}")
    for label, (cfg_fn, kind, ref_label) in PRESET_RUNS.items():
        frames, gt = sequence(kind)
        cfg = cfg_fn()
        tc = cfg.tracking
        ref = refs[ref_label]
        slam = port.SlamSystem(TUM_FR1, cfg, device="cuda")
        _drive(slam, frames[:4], False)
        kernels.reset_iteration_counts("cuda")
        run = _drive(slam, frames, True)
        launched, ran = kernels.iteration_counts("cuda")
        again = _drive(slam, frames, False)
        add(run)
        tracked = len(frames) - 1
        expected = expected_launches(tc, tracked)
        launches_ok = all(run[k] == v for k, v in expected.items())
        levels = tc.levels
        # Every ESM launch of the step has a slot: the iterations their
        # level's, the rescue's two evidence evaluations kernels.EVAL_SLOT.
        slots_ok = (int(launched.sum()) == run["esm_normal_eq"]
                    and bool((ran <= launched).all())
                    and int(launched[levels:kernels.EVAL_SLOT].sum()) == 0
                    and int(launched[kernels.EVAL_SLOT]) == 2 * tracked
                    and int(ran[kernels.EVAL_SLOT]) == 2 * run["rescues"])
        reads_text, named = _reads_text(run, tracked)
        fixed_eq = _fixed_reads(run) == _fixed_reads(ref)
        ate = sequence_ate(gt, run["poses"])
        bound = PRESET_ATE_BOUND_M[label]
        lost = sum(bool(r.get("lost")) for r in run["records"])
        finite = all(np.isfinite(T).all() for T in run["poses"])
        identical = (all(np.array_equal(a, b) for a, b in zip(run["poses"], again["poses"]))
                     and run["records"] == again["records"])
        backend_ok = True
        if slam.backend is not None:
            backend_ok = (run["errors"] == 0 and again["errors"] == 0 and not slam.backend.alive
                          and (run["closures"] >= 1 or ref["closures"] == 0))
        checks = {"ate": ate <= bound, "lost": lost == 0, "finite": finite,
                  "launches": launches_ok, "iterations": slots_ok,
                  "reads = syncs": run["reads"] == run["syncs"], "reads named": named,
                  "fixed reads as without the knobs": fixed_eq, "bit-identical": identical,
                  "back end": backend_ok}
        good = all(checks.values())
        ok &= good
        per_level = ", ".join(f"L{l} {int(ran[l])}/{int(launched[l])}" for l in range(levels))
        print(f"[preset] {label}: ATE {ate * 1e3:.3f} mm (bound {bound * 1e3:.1f}; without the "
              f"knobs {ref['ate'] * 1e3:.3f}), lost {lost}; launches {run['esm_normal_eq']} ESM "
              f"(expected {expected['esm_normal_eq']}), stratified {run['esm_stratified']}, "
              f"fusion {run['fusion']}; IRLS iterations run/enqueued on the device {per_level} "
              f"({int(ran.sum())}/{int(launched.sum())} = {ran.sum() / max(launched.sum(), 1):.3f}); "
              f"reads {run['reads']} = {run['reads'] / tracked:.3f}/tracked frame (without the "
              f"knobs {ref['reads'] / tracked:.3f}), step fixed {_fixed_reads(run) / tracked:.3f} "
              f"(without {_fixed_reads(ref) / tracked:.3f}), syncs {run['syncs']}; {reads_text}; "
              f"loop closures {run['closures']}; checks {checks} {'OK' if good else 'FAIL'}")

    # kinect_sensor under the preset's flips, through the gauntlet runner.
    w, h = 640, 480
    intr = Intrinsics(fx=0.808 * w, fy=1.076 * h, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w,
                      height=h)
    name = "kinect_sensor"
    seq_kwargs, cfg_over = next((k, o) for n, k, o in gauntlet.scenarios(GAUNTLET_FRAMES)
                                if n == name)
    row, slam, launches, exact = _gauntlet_row(name, seq_kwargs, cfg_over, GAUNTLET_FRAMES, intr,
                                               PRESET_FLIPS, {})
    be = slam.backend
    for k in COUNTERS:
        total[k] += launches[k]
    scorer_launches += be.loop_closer.scorer.launches
    checks = {"envelope": row["ate_rmse_mm"] <= GAUNTLET_PRESET_BOUND_MM, "lost": row["lost"] == 0,
              "finite": all(np.isfinite(T).all() for T in slam.poses()),
              "thread": be.errors == 0 and not be.alive, "launches": exact}
    good = all(checks.values())
    ok &= good
    print(f"[preset] gauntlet {json.dumps(row)}")
    print(f"[preset] gauntlet {name} under the preset's flips: ATE {row['ate_rmse_mm']:.3f} mm "
          f"(bound {GAUNTLET_PRESET_BOUND_MM:.3f}; SlamConfig() recorded "
          f"{VGA_RECORDED_MM[name][0]}); launches {launches} (exact: {exact}); checks {checks} "
          f"{'OK' if good else 'FAIL'}")
    print(f"[preset] {'OK' if ok else 'FAIL'}")
    return ok, total, scorer_launches


# Each knob alone, and the preset, against SlamConfig() (back end off) on
# the rigid sequence: the ms/frame table of PERF.md.
KNOB_RUNS = {
    "SlamConfig()": {},
    "depth_codec u12": {"depth_codec": "u12"},
    "depth_codec u16h": {"depth_codec": "u16h"},
    "plane_dtype bf16": {"tracking.plane_dtype": "bf16"},
    "plane_dtype bf16-stack": {"tracking.plane_dtype": "bf16-stack"},
    "plane_dtype bf16-points": {"tracking.plane_dtype": "bf16-points"},
    "early_exit_tol 1e-5": {"tracking.early_exit_tol": 1e-5},
    "conv_skip_tol 1e-5": {"tracking.conv_skip_tol": 1e-5},
    "preset real-v5e": PRESET_FLIPS,
}
KNOB_ROUNDS = 4


def phase_knob_times():
    """ms/frame (``process_frame`` + a sync, frames 5..35 of the rigid
    sequence) of every KNOB_RUNS configuration, in KNOB_ROUNDS rounds whose
    order alternates forward and backward, one system per configuration:
    the median over the rounds' frames and the spread of the rounds'
    medians; and the IRLS iterations run per level under each early-exit
    configuration. Returns {label: median ms}."""
    frames, _ = make_sequence()
    systems = {}
    for label, over in KNOB_RUNS.items():
        systems[label] = port.SlamSystem(TUM_FR1, default_config().override(**over), device="cuda")
        _run_sequence(systems[label], frames[:4])
    ms = {label: [] for label in KNOB_RUNS}
    iters = {}
    for r in range(KNOB_ROUNDS):
        order = list(KNOB_RUNS) if r % 2 == 0 else list(KNOB_RUNS)[::-1]
        for label in order:
            slam = systems[label]
            slam.reset()
            kernels.reset_iteration_counts("cuda")
            _, m = _run_sequence(slam, frames)
            ms[label].append(np.array(m[5:]))
            if r == 0:
                iters[label] = kernels.iteration_counts("cuda")
    out = {}
    base = float(np.median(np.concatenate(ms["SlamConfig()"])))
    for label in KNOB_RUNS:
        allm = np.concatenate(ms[label])
        med = float(np.median(allm))
        rounds = [float(np.median(m)) for m in ms[label]]
        launched, ran = iters[label]
        lv = ", ".join(f"L{l} {int(ran[l])}/{int(launched[l])}"
                       for l in range(default_config().tracking.levels))
        out[label] = med
        print(f"[knobs] {label}: ms/frame median {med:.2f} ({med - base:+.2f} against "
              f"SlamConfig()), rounds {', '.join(f'{x:.2f}' for x in rounds)} (spread "
              f"{max(rounds) - min(rounds):.2f}), p90 {np.percentile(allm, 90):.2f}; IRLS "
              f"iterations run/enqueued {lv}")
    return out


CODECS = ("u16", "u12", "u16h")


def phase_codecs():
    """Per upload codec on the rigid sequence: the packed bytes per frame,
    the host ms of ``pack_frame`` in its native pass and on its numpy path
    (``native.toolchain`` set to None for the second) side by side, bytes
    equal, with the two counters, the host ms of ``SlamSystem._upload``
    (pin and enqueue), and the device time of the host-to-device copy (CUDA
    events around the copy of an already pinned buffer). Returns the
    packed first frames, for ``phase_decode_kernels``, and whether every
    native frame equalled its numpy twin and counted as native."""
    frames, _ = make_sequence()
    first, ok = {}, True
    for codec in CODECS:
        cfg = default_config().override(depth_codec=codec)
        slam = port.SlamSystem(TUM_FR1, cfg, device="cuda")
        pack_ms, numpy_ms, up_ms, h2d_ms = [], [], [], []
        packed = []
        n0, m0 = pack_frame.native_calls, pack_frame.numpy_calls
        for rgb, depth, _ in frames:
            t0 = time.perf_counter()
            p = pack_frame(rgb, depth, cfg)
            pack_ms.append((time.perf_counter() - t0) * 1e3)
            packed.append(p)
        toolchain, native.toolchain = native.toolchain, lambda: None
        try:
            same = True
            for (rgb, depth, _), p in zip(frames, packed):
                t0 = time.perf_counter()
                q = pack_frame(rgb, depth, cfg)
                numpy_ms.append((time.perf_counter() - t0) * 1e3)
                same &= bool(np.array_equal(p, q))
        finally:
            native.toolchain = toolchain
        counts = (pack_frame.native_calls - n0, pack_frame.numpy_calls - m0)
        good = same and counts == (len(frames), len(frames))
        ok &= good
        for p in packed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slam._upload(p)
            up_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            pinned = torch.from_numpy(p).pin_memory()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            pinned.to("cuda", non_blocking=True)
            b.record()
            torch.cuda.synchronize()
            h2d_ms.append(a.elapsed_time(b))
        first[codec] = packed[0]
        print(f"[codecs] {codec}: {packed[0].nbytes} B per frame {tuple(packed[0].shape)}, "
              f"pack_frame host us median native {np.median(pack_ms) * 1e3:.1f} / numpy "
              f"{np.median(numpy_ms) * 1e3:.1f} (bytes equal {same}; native_calls "
              f"+{counts[0]}, numpy_calls +{counts[1]} over {len(frames)} frames each) "
              f"{'OK' if good else 'FAIL'}, _upload host ms median "
              f"{np.median(up_ms):.3f}, H2D copy device ms median {np.median(h2d_ms):.4f} "
              f"({packed[0].nbytes / np.median(h2d_ms) / 1e6:.2f} GB/s)")
    return first, ok


def phase_decode_kernels(first):
    """The kernels ``decode_frame`` launches per frame for each codec and
    their device time (torch.profiler over ten decodes of the first frame)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for codec in CODECS:
        cfg = default_config().override(depth_codec=codec)
        dev = torch.from_numpy(first[codec]).cuda()
        decode_frame(dev, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                decode_frame(dev, cfg)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not e.key.startswith(("Memcpy", "Memset"))]
        print(f"[codecs] {codec}: decode_frame launches {sum(e.count for e in ev) / 10:.1f} "
              f"kernels a frame, {sum(e.self_device_time_total for e in ev) / 10:.1f} us device "
              f"time")


def phase_cli():
    """The command line in-process on the card (the module docstring, item
    11). Returns (ok, the per-frame launch counts)."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--synthetic", "40", "--max-frames", "16", "--out-dir", out_dir, "--eval",
                       "--quiet"])
    torch.cuda.synchronize()
    launches = {k: getattr(wrapper, attr) for k, (wrapper, attr) in COUNTERS.items()}
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    log = os.path.join(out_dir, "frames.jsonl")
    recs = [json.loads(line) for line in open(log)] if os.path.exists(log) else []
    checks = {
        "rc": rc == 0,
        "frames": result["frames"] == 16,
        "lost": result["lost_frames"] == 0,
        "ate": result["ate"]["rmse"] < CLI_MAX_ATE_M,
        "files": all(os.path.exists(os.path.join(out_dir, f)) for f in ("trajectory.txt", "map.ply")),
        "log": bool(recs) and recs[0]["type"] == "run_header" and "config_hash" in recs[0]
        and sum(r["type"] == "frame" for r in recs) == 16 and recs[-1]["type"] == "result",
        "launches": launches["esm_normal_eq"] > 0 and launches["esm_stratified"] > 0
        and launches["fusion"] > 0,
    }
    ok = all(checks.values())
    print(f"[cli] --synthetic 40 --max-frames 16 --eval, default config on the card: frames "
          f"{result['frames']}, keyframes {result['keyframes']}, loop closures "
          f"{result['loop_closures']}, lost {result['lost_frames']}, ATE "
          f"{result['ate']['rmse'] * 1e3:.3f} mm (bound {CLI_MAX_ATE_M * 1e3:.0f}), wall "
          f"{result['wall_s']} s, {len(recs)} log records; launches {launches}; checks {checks}")
    print(f"[cli] {'OK' if ok else 'FAIL'}")
    return ok, launches


# ---------------------------------------------------------------------------
# Real RGB-D data: the TUM reader, the live source and the snapshot

SMOKE_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
# The backend-off snapshot is taken after this many frames of the rigid
# sequence; the live source streams this many QVGA frames.
SNAPSHOT_AT = 18
LIVE_FRAMES = 20
LIVE_IDLE_S = 1.0
QVGA_FR1 = Intrinsics(fx=TUM_FR1.fx / 2, fy=TUM_FR1.fy / 2, cx=(TUM_FR1.cx + 0.5) / 2 - 0.5,
                      cy=(TUM_FR1.cy + 0.5) / 2 - 0.5, width=320, height=240)


def _zero_counts():
    torch.cuda.synchronize()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)


def _read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: getattr(wrapper, attr) for k, (wrapper, attr) in COUNTERS.items()}


def _append_tum_frame(root: str, rgb, depth, t: float, jitter: float, filt: int) -> float:
    """One frame into a TUM directory as a capture daemon writes it: the two
    PNGs (the port's encoder), then a line appended to each index. Returns
    the RGB timestamp as the index gives it."""
    tr, td = f"{t:.6f}", f"{t + jitter:.6f}"
    png.write(os.path.join(root, "rgb", tr + ".png"), rgb, filt=filt)
    png.write(os.path.join(root, "depth", td + ".png"), depth, filt=filt)
    with open(os.path.join(root, "rgb.txt"), "a") as f:
        f.write(f"{tr} rgb/{tr}.png\n")
    with open(os.path.join(root, "depth.txt"), "a") as f:
        f.write(f"{td} depth/{td}.png\n")
    return float(tr)


def _new_tum_dir(root: str) -> None:
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    for name in ("rgb.txt", "depth.txt"):
        with open(os.path.join(root, name), "w") as f:
            f.write("# timestamp filename\n")


def write_tum_dir(root: str, frames, gt, intr: Intrinsics, filt: int = 1, seed: int = 0):
    """The sequence as a TUM RGB-D directory: rgb/ and depth/ PNGs (every row
    filtered with ``filt``; 1, Sub, is what cv2.imwrite writes), rgb.txt,
    depth.txt with the depth timestamps jittered by up to 10 ms,
    groundtruth.txt (t tx ty tz qx qy qz qw) and calibration.txt (no
    distortion). Returns the RGB timestamps as the index gives them."""
    _new_tum_dir(root)
    jitter = np.random.default_rng(seed).uniform(0.0, 0.01, len(frames))
    ts = [_append_tum_frame(root, rgb, depth, t, float(j), filt)
          for (rgb, depth, t), j in zip(frames, jitter)]
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, T in zip(ts, gt):
            q = _quat_from_R(T[:3, :3])
            f.write(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*T[:3, 3], *q)) + "\n")
    with open(os.path.join(root, "calibration.txt"), "w") as f:
        f.write(f"{intr.fx} {intr.fy} {intr.cx} {intr.cy} {intr.width} {intr.height}\n")
    return ts


def _median_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def _reader_host_times(frames, smi: str) -> None:
    """Host ms to decode one VGA pair (RGB + 16-bit depth) with the native
    unfilter and with the numpy oracle, on PNGs filtered with Paeth and with
    Sub (cv2.imwrite's choice), and of the fr1 undistortion."""
    rgb, depth, _ = frames[0]
    work = os.path.join(SMOKE_BUILD, "chip_smoke_png")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    for filt, name in ((4, "Paeth"), (1, "Sub")):
        pr, pd = os.path.join(work, f"rgb{filt}.png"), os.path.join(work, f"depth{filt}.png")
        png.write(pr, rgb, filt=filt)
        png.write(pd, depth, filt=filt)
        for nat, label in ((True, "native"), (False, "numpy")):
            same = (np.array_equal(png.read_color(pr, native=nat), rgb)
                    and np.array_equal(png.read_unchanged(pd, native=nat), depth))
            ms = _median_ms(lambda: (png.read_color(pr, native=nat),
                                     png.read_unchanged(pd, native=nat)), 3 if nat else 2)
            print(f"[tum] decode of a VGA pair ({os.path.getsize(pr) + os.path.getsize(pd)} B), "
                  f"{name} rows, {label} unfilter: {ms:.2f} host ms, lossless {same}; {smi}")
    K = np.array([[TUM_FR1.fx, 0, TUM_FR1.cx], [0, TUM_FR1.fy, TUM_FR1.cy], [0, 0, 1]])
    t0 = time.perf_counter()
    m1, m2 = _cv.undistort_maps(K, tum.TUM_DISTORTION["freiburg1"], (640, 480))
    plan = _cv.linear_plan(m1, m2, (480, 640))
    maps_ms = (time.perf_counter() - t0) * 1e3
    ms = _median_ms(lambda: (_cv.remap_linear_u8(rgb, m1, m2, plan),
                             _cv.remap_nearest(depth, m1, m2)), 5)
    print(f"[tum] fr1 undistortion of a VGA pair (bilinear RGB + nearest depth): {ms:.2f} host "
          f"ms; maps and bilinear plan once per sequence {maps_ms:.2f} ms; {smi}")


def phase_tum(smi: str):
    """The command line's ``--tum`` path on the card (the module docstring,
    item 13). Returns (ok, the launch counts of the two counted runs)."""
    frames, gt = make_sequence()
    root = os.path.join(SMOKE_BUILD, "chip_smoke_tum", "rgbd_dataset_smoke_rigid")
    out_dir = os.path.join(SMOKE_BUILD, "chip_smoke_tum", "out")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ts = write_tum_dir(root, frames, gt, TUM_FR1)
    write_s = time.perf_counter() - t0
    _zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--tum", root, "--eval", "--quiet", "--set", "backend.enabled=false",
                       "--out-dir", out_dir])
    cli_counts = _read_counts()
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    recs = [json.loads(line) for line in open(os.path.join(out_dir, "frames.jsonl"))]
    recs = [r for r in recs if r["type"] == "frame"]
    # The same frames in memory, through process_frame.
    _zero_counts()
    slam = port.SlamSystem(TUM_FR1, default_config(), device="cuda")
    mem_ms = []
    for rgb, depth, t in frames:
        t1 = time.perf_counter()
        slam.process_frame(rgb, depth, t)
        torch.cuda.synchronize()
        mem_ms.append((time.perf_counter() - t1) * 1e3)
    mem_counts = _read_counts()
    poses_equal = (len(recs) == len(frames) and all(
        np.array_equal(np.asarray(r["T_wc"]), T) for r, (_, T) in zip(recs, slam.trajectory())))
    stamps = [r["t"] for r in recs] == ts
    # fuse_inverse_depth, the Kalman-only step, on the run's last keyframe
    # state and last frame: one launch of the fusion kernel, growth off.
    _zero_counts()
    kf = slam._kf_state
    cur = frame_pyramid(torch.from_numpy(pack_frame(*frames[-1][:2])).cuda(), slam.config)
    cov = torch.diag(torch.tensor([4e-6, 4e-6, 9e-6, 1e-6, 1e-6, 4e-6], device=kf.var.device))
    fid_args = (kf.levels[0].xi, kf.var, kf.mask_full, cur[0].xi, cur[0].mask,
                slam._motion.T_ck, cov, TUM_FR1, slam.config.fusion)
    k = fusion.fuse_inverse_depth(*fid_args)
    fid_counts = _read_counts()
    p = fusion.fuse_core_plain(*fid_args)
    fid_ok = (k[2] is kf.mask_full and float(k[3]) == float(p[4]) > 0
              and float((k[0] - p[0]).abs().max()) <= 1e-6
              and float((k[1] - p[1]).abs().max()) <= 1e-9)
    tracked = len(frames) - 1
    fused = sum(r.get("n_fused", 0) > 0 for r in recs)
    counts = slam.tracker_counts
    expected = expected_launches(slam.config.tracking, tracked)
    cli_ms = [r["ms"] for r in recs[5:]]
    checks = {
        "rc": rc == 0,
        "frames": result["frames"] == len(frames),
        "lost": result["lost_frames"] == 0,
        "ate": result["ate"]["rmse"] <= ATE_BOUND_M and result["ate"]["n"] == len(frames),
        "poses bit-equal": poses_equal,
        "timestamps": stamps,
        "launches": cli_counts == mem_counts
        and all(mem_counts[k] == v for k, v in expected.items()) and fused >= 1,
        "fuse_inverse_depth": fid_ok and fid_counts["fusion"] == 1
        and sum(fid_counts.values()) == 1,
    }
    ok = all(checks.values())
    print(f"[tum] --tum over the rigid sequence written as a TUM directory ({len(frames)} VGA "
          f"pairs, Sub rows, depth stamps jittered up to 10 ms; written in {write_s:.2f} s), "
          f"SlamConfig() back end off, on the card: frames {result['frames']}, lost "
          f"{result['lost_frames']}, ATE against groundtruth.txt "
          f"{result['ate']['rmse'] * 1e3:.3f} mm over {result['ate']['n']} matches (bound "
          f"{ATE_BOUND_M * 1e3:.1f}), poses bit-equal to process_frame in memory {poses_equal}; "
          f"launches {cli_counts} (in memory {mem_counts}; expected {expected}, fusion {fused}); "
          f"fuse_inverse_depth on the last state: {fid_counts['fusion']} fusion launch, n_fused "
          f"{int(k[3])}, mask returned as given {k[2] is kf.mask_full}")
    print(f"[tum] ms/frame median over frames 5..{len(frames) - 1}: --tum {np.median(cli_ms):.2f} "
          f"(PNG decode on the prefetch thread), in memory {np.median(mem_ms[5:]):.2f}; --tum "
          f"wall {result['wall_s'] * 1e3 / result['frames']:.2f} ms/frame with finish(); {smi}")
    _reader_host_times(frames, smi)
    print(f"[tum] checks {checks} {'OK' if ok else 'FAIL'}")
    return ok, {k: cli_counts[k] + mem_counts[k] + fid_counts[k] for k in COUNTERS}


def phase_live(smi: str):
    """``LiveSource`` over a TUM directory that a writer thread grows (the
    module docstring, item 14). Returns (ok, the launch counts)."""
    frames, _ = make_sequence(QVGA_FR1, n=LIVE_FRAMES)
    root = os.path.join(SMOKE_BUILD, "chip_smoke_live")
    _new_tum_dir(root)
    written, done = [], []

    def writer():
        for i, (rgb, depth, t) in enumerate(frames):
            if i:
                time.sleep(0.03)
            written.append(_append_tum_frame(root, rgb, depth, t, 0.004 * (i % 3), 1))
        done.append(time.monotonic())  # the last write

    _zero_counts()
    slam = port.SlamSystem(QVGA_FR1, default_config(), device="cuda")
    w = threading.Thread(target=writer, name="capture-writer")
    w.start()
    src = live.LiveSource(root, poll_interval=0.01, idle_timeout=LIVE_IDLE_S,
                          intrinsics=QVGA_FR1)
    got, first_at, same = [], None, True
    for fr in src.frames():
        i = len(got)
        got.append(fr.timestamp)
        same &= (i < len(frames) and np.array_equal(fr.rgb, frames[i][0])
                 and np.array_equal(fr.depth, frames[i][1]))
        first_at = first_at or time.monotonic()
        slam.process_frame(fr.rgb, fr.depth, fr.timestamp)
    ended = time.monotonic()
    w.join()
    counts = _read_counts()
    tc = slam.config.tracking
    tr = slam.tracker_counts
    expected = expected_launches(tc, len(got) - 1)
    fused = sum(s.get("n_fused", 0) > 0 for s in slam.stats)
    lost = sum(bool(s.get("lost")) for s in slam.stats)
    checks = {
        "exactly once, in order": got == written and len(got) == LIVE_FRAMES,
        "frames bit-equal": same,
        "overlapped the capture": first_at is not None and first_at < done[0],
        "ended on idle": ended - done[0] >= LIVE_IDLE_S,
        "lost": lost == 0,
        "launches": all(counts[k] == v for k, v in expected.items()),
    }
    ok = all(checks.values())
    print(f"[live] LiveSource on a TUM directory grown by a writer thread ({LIVE_FRAMES} QVGA "
          f"pairs, 30 ms apart), SlamSystem on the card: delivered {len(got)}, lost {lost}, "
          f"stream ended {ended - done[0]:.2f} s after the last write (idle timeout "
          f"{LIVE_IDLE_S} s); launches {counts} (expected {expected}, fusion {fused}); {smi}")
    print(f"[live] checks {checks} {'OK' if ok else 'FAIL'}")
    return ok, counts


def _records(stats):
    return [{k: v for k, v in r.items() if k != "ms"} for r in stats]


def phase_snapshot(smi: str):
    """Save and resume on the card (the module docstring, item 15).
    Returns (ok, the launch counts, the scorer's launches)."""
    work = os.path.join(SMOKE_BUILD, "chip_smoke_snapshot")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # Back end off, rigid sequence: saved after SNAPSHOT_AT frames, restored,
    # and run to the end beside the uninterrupted run.
    frames, _ = make_sequence()
    path = os.path.join(work, "rigid.npz")
    _zero_counts()
    a = port.SlamSystem(TUM_FR1, default_config(), device="cuda")
    for i, f in enumerate(frames):
        if i == SNAPSHOT_AT:
            t0 = time.perf_counter()
            snapshot.save(a, path)
            save_ms = (time.perf_counter() - t0) * 1e3
        a.process_frame(*f)
    t0 = time.perf_counter()
    b = snapshot.restore(path, device="cuda")
    restore_ms = (time.perf_counter() - t0) * 1e3
    for f in frames[SNAPSHOT_AT:]:
        b.process_frame(*f)
    counts = _read_counts()
    tc = a.config.tracking
    ca, cb = a.tracker_counts, b.tracker_counts
    expected = expected_launches(tc, len(frames) - 1 + len(frames) - SNAPSHOT_AT)
    fused = (sum(s.get("n_fused", 0) > 0 for s in a.stats)
             + sum(s.get("n_fused", 0) > 0 for s in b.stats[SNAPSHOT_AT:]))
    records_equal = _records(b.stats) == _records(a.stats)
    poses_equal = all(np.array_equal(x, y) for x, y in zip(a.poses(), b.poses()))
    off = {
        "records bit-equal": records_equal and len(b.stats) == len(frames),
        "poses bit-equal": poses_equal,
        "launches": all(counts[k] == v for k, v in expected.items()),
    }
    print(f"[snapshot] back end off, rigid sequence: saved after {SNAPSHOT_AT} frames "
          f"({os.path.getsize(path)} B, save {save_ms:.1f} ms, restore on the card "
          f"{restore_ms:.1f} ms host), resumed to frame {len(frames) - 1}: per-frame records "
          f"and poses bit-equal to the uninterrupted run {records_equal and poses_equal}; "
          f"launches {counts} (expected {expected}, fusion {fused}); {smi}")
    # Back end on, loop sequence: saved after finish() and restored.
    frames, _ = make_loop_sequence()
    path = os.path.join(work, "loop.npz")
    _zero_counts()
    slam = port.SlamSystem(TUM_FR1, backend_config(), device="cuda")
    for f in frames:
        slam.process_frame(*f)
    slam.finish()
    loop_counts = _read_counts()
    scorer = slam.backend.loop_closer.scorer.launches
    snapshot.save(slam, path)
    back = snapshot.restore(path, device="cuda")
    e0, e1 = slam.backend._loop_edges, back.backend._loop_edges
    edges_equal = len(e0) == len(e1) >= 1 and all(
        (x["from_id"], x["to_id"]) == (y["from_id"], y["to_id"])
        and np.array_equal(x["T_rel"], y["T_rel"])
        and np.array_equal(x["information"], y["information"]) for x, y in zip(e0, e1))
    entries = slam.backend.loop_closer.db.entries
    bow_equal = back.backend.loop_closer.db.entries == entries and len(entries) >= 1
    processed = back.backend._processed == {kf.kf_id for kf in slam.manager.keyframes
                                            if kf.descriptors is not None
                                            and len(kf.descriptors) > 0}
    back.finish()
    tc = slam.config.tracking
    tr = slam.tracker_counts
    expected = expected_launches(tc, len(frames) - 1)
    on = {
        "errors": slam.backend.errors == 0 and back.backend.errors == 0,
        "loop edges equal": edges_equal,
        "BoW entries equal": bow_equal,
        "processed": processed,
        "launches": all(loop_counts[k] == v for k, v in expected.items()),
    }
    print(f"[snapshot] back end on, loop sequence: saved after finish() "
          f"({os.path.getsize(path)} B), restored on the card: loop edges {len(e1)} of "
          f"{len(e0)} equal {edges_equal}, BoW entries {len(back.backend.loop_closer.db.entries)}"
          f" of {len(entries)} equal {bow_equal}, thread errors {slam.backend.errors} / "
          f"{back.backend.errors} after finish(); launches {loop_counts} (expected {expected}), "
          f"scorer {scorer}")
    ok = all(off.values()) and all(on.values())
    print(f"[snapshot] checks {off} {on} {'OK' if ok else 'FAIL'}")
    return ok, {k: counts[k] + loop_counts[k] for k in COUNTERS}, scorer


# ---------------------------------------------------------------------------
# The live viewer and the plots; the row-sharded tracker and the sharded scorer

VIZ_EVERY = 3
SPMD_WORLDS = ((1, "nccl", "cuda"), (2, "gloo", "cuda:0"), (4, "gloo", "cuda:0"))
SPMD_RELOC_WORLDS = (1, 2)
SPMD_REPS = 5
SPMD_T_TOL = 5e-5  # tests/test_torch_parallel.py under the consensus
SPMD_RELOC_PAIRS = ((0, 3), (3, 0), (0, 12))
# SpmdTracker: the VGA pair at level 0 (480 = 8 x 60 rows), 25 iterations
# from ground truth perturbed by a fifth of tests/test_parallel.py's 3 cm
# twist: at VGA L0 the CPU run converges from it (to 0.68 mm of the log's
# norm, 0.14 mm from ground truth itself) and not from the test's whole
# twist.
SPMD_IC_ITERS = 25
SPMD_IC_TWIST = np.array([0.004, -0.003, 0.002, 0.0016, -0.0012, 0.002])
SPMD_IC_TOL = 5e-4  # tests/test_parallel.py:98, 1 against 8 devices
SPMD_IC_S2_RTOL = 1e-4  # tests/test_torch_spmd.py's scales against JAX
# tests/test_parallel.py:75's 3e-3 floor, scaled as the twist is.
SPMD_IC_GT = 3e-3 / 5


def _counted_run(slam, frames):
    """process_frame over ``frames``; per frame, the host reads and the
    launch counts it added (host integers: no sync)."""
    reads, launches = [], []
    for rgb, depth, t in frames:
        r0, c0 = slam.host_reads, {k: getattr(w, a) for k, (w, a) in COUNTERS.items()}
        slam.process_frame(rgb, depth, t)
        reads.append(slam.host_reads - r0)
        launches.append({k: getattr(w, a) - c0[k] for k, (w, a) in COUNTERS.items()})
    torch.cuda.synchronize()
    return reads, launches


def phase_viz(smi: str):
    """The live viewer on the main path (the module docstring, item 16).
    Returns (ok, the launch counts of the counted runs)."""
    frames, _ = make_sequence()
    out_dir = os.path.join(SMOKE_BUILD, "chip_smoke_viz")
    shutil.rmtree(out_dir, ignore_errors=True)
    base = default_config()
    runs = {}
    _zero_counts()
    for label, cfg in (("off", base), ("on", base.override(**{
            "viz.enabled": True, "viz.every_n": VIZ_EVERY, "viz.map_every": 1,
            "viz.out_dir": os.path.join(out_dir, "live")}))):
        slam = port.SlamSystem(TUM_FR1, cfg, device="cuda")
        t0 = time.perf_counter()
        reads, launches = _counted_run(slam, frames)
        ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        t1 = time.perf_counter()
        slam.finish()
        runs[label] = (slam, reads, launches, ms, (time.perf_counter() - t1) * 1e3)
    counts = _read_counts()
    off, on = runs["off"][0], runs["on"][0]
    v = on.viewer
    published = sum(1 for i in range(1, len(frames)) if (i + 1) % VIZ_EVERY == 0)
    live_png = os.path.join(out_dir, "live", "live.png")
    live = png.read_color(live_png) if os.path.exists(live_png) else None
    h, w = TUM_FR1.height, TUM_FR1.width
    # The command line's --viz plots and --live-viz viewer, in-process.
    cli_dir = os.path.join(out_dir, "cli")
    _zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--synthetic", "40", "--max-frames", "12", "--out-dir", cli_dir, "--viz",
                       "--live-viz", os.path.join(cli_dir, "live"), "--quiet", "--set",
                       "backend.enabled=false"])
    cli_counts = _read_counts()
    plots = {f: png.read_color(os.path.join(cli_dir, f)).shape
             for f in ("trajectory.png", "map_topdown.png", os.path.join("live", "live.png"))
             if os.path.exists(os.path.join(cli_dir, f))}
    checks = {
        "poses bit-equal": all(np.array_equal(a, b) for a, b in zip(on.poses(), off.poses())),
        "records equal": [dict(r, ms=0) for r in on.stats] == [dict(r, ms=0) for r in off.stats],
        "reads per frame equal": runs["on"][1] == runs["off"][1],
        "launches per frame equal": runs["on"][2] == runs["off"][2],
        "launched": counts["esm_normal_eq"] > 0 and counts["fusion"] > 0,
        "errors 0": v.errors == 0,
        "rendered + dropped = published": v.rendered + v.dropped == published and v.rendered > 0,
        "live.png decodes": live is not None and live.shape == (2 * h + max(w, 240), 2 * w, 3),
        "cli": rc == 0 and plots.get("trajectory.png") == (660, 660, 3)
        and plots.get("map_topdown.png") == (660, 660, 3) and len(plots) == 3
        and cli_counts["esm_normal_eq"] > 0,
    }
    ok = all(checks.values())
    rms = np.asarray(v.render_ms)
    print(f"[viz] SlamConfig() back end off, rigid sequence ({len(frames)} VGA frames) with the "
          f"live viewer (every_n {VIZ_EVERY}, map_every 1) against the same run without it: "
          f"published {published}, rendered {v.rendered}, dropped {v.dropped}, errors "
          f"{v.errors}; host reads per frame {sum(runs['on'][1])} / {sum(runs['off'][1])} in all "
          f"(on / off); ms/frame {runs['on'][3]:.2f} on, {runs['off'][3]:.2f} off; finish() "
          f"{runs['on'][4]:.1f} ms on (the viewer drains), {runs['off'][4]:.1f} ms off")
    if len(rms):
        print(f"[viz] host ms per render ({2 * w}x{2 * h + max(w, 240)} panel: both panes, the "
              f"map pane with up to {live_view.MAP_POINTS} cloud points, PNG encode and rename, "
              f"on the viewer's thread): median "
              f"{np.median(rms):.1f}, max {rms.max():.1f} over {len(rms)}; {smi}")
    print(f"[viz] --viz --live-viz in-process: rc {rc}, decoded {plots}; launches {cli_counts}")
    print(f"[viz] checks {checks} {'OK' if ok else 'FAIL'}")
    return ok, {k: counts[k] + cli_counts[k] for k in COUNTERS}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spmd_ic_pair():
    """SpmdTracker's inputs, made on the card and returned on the CPU: the
    VGA pair's level-0 keyframe planes and float32 IC field, the current
    frame's planes, the ground-truth pose and the perturbed start."""
    cfg = ic_config("lagged").override(**{"tracking.jac_dtype": "f32"})
    kf, cur, T_gt, _ = _frame_pair(TUM_FR1, cfg)
    k0, c0 = kf.levels[0], cur[0]
    planes = tuple(t.cpu() for t in (k0.intensity, k0.xi, k0.mask, k0.jac, c0.intensity, c0.xi,
                                     c0.mask))
    T_gt = T_gt.cpu()
    T0 = se3_np.exp(SPMD_IC_TWIST) @ T_gt.double().numpy()
    return planes, T_gt, torch.from_numpy(T0.astype(np.float32))


def _spmd_ic(mesh, dev: torch.device, ic_pair, reps: int) -> dict:
    """SpmdTracker on this rank: with ``reps`` a warm-up first; then the
    counted run (the launch counts zeroed just before and read just after;
    under NCCL inside torch.cuda.set_sync_debug_mode("error"), so a host
    read raises); then ``reps`` timed runs."""
    import torch.distributed as dist

    planes, _, T0 = ic_pair
    args = tuple(t.to(dev) for t in planes) + (T0.to(dev),)
    tr = SpmdTracker(mesh, TUM_FR1)
    nccl = dist.get_backend() == "nccl"
    if reps:
        tr.track(*args, SPMD_IC_ITERS)
        _sync(dev)
    dist.barrier()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    n0 = tr.allreduces
    reads = None
    if nccl:
        torch.cuda.set_sync_debug_mode("error")
    try:
        res = tr.track(*args, SPMD_IC_ITERS)
        reads = 0 if nccl else None
    except RuntimeError as e:  # a synchronizing operation under NCCL
        if not nccl:
            raise
        reads = str(e).splitlines()[0]
        res = None
    finally:
        if nccl:
            torch.cuda.set_sync_debug_mode("default")
    _sync(dev)
    counts = {k: getattr(w, a) for k, (w, a) in COUNTERS.items()}
    allreduces = tr.allreduces - n0
    if res is None:
        res = tr.track(*args, SPMD_IC_ITERS)
    ms = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        tr.track(*args, SPMD_IC_ITERS)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3 / SPMD_IC_ITERS)
    prof = _profile_track(tr, args) if reps and nccl else None
    return dict(ic=res, ic_counts=counts, ic_allreduces=allreduces, ic_reads=reads,
                ic_ms=float(np.median(ms)) if ms else None, ic_profile=prof)


def _profile_track(tr, args) -> dict:
    """torch.profiler over one track: device us and kernels per iteration,
    and us per iteration of each kernel kind (the largest eight)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.track(*args, SPMD_IC_ITERS)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    n = SPMD_IC_ITERS
    kinds = sorted(((e.key[:60], e.count / n, e.self_device_time_total / n) for e in evs),
                   key=lambda k: -k[2])
    return dict(us=sum(k[2] for k in kinds), kernels=sum(k[1] for k in kinds), kinds=kinds[:8])


def _spmd_ic_rank(rank: int, world: int, dev: torch.device, ic_pair):
    """SpmdTracker alone, counted and untimed: the CPU run of [spmd]."""
    return _spmd_ic(make_mesh(world), dev, ic_pair, 0)


def _spmd_rank(rank: int, world: int, dev: torch.device, reloc_planes, ic_pair):
    """One rank of [spmd] (run by ``run_ranks``): the VGA frame pair under
    ``SlamConfig()``'s tracking settings through ``ShardedTracker`` (the
    launch counts zeroed just before and read just after), the one-process
    ``Tracker`` on the same inputs, both timed in turns, with
    ``reloc_planes`` the sharded scorer against ``score_pairs``, then
    SpmdTracker on ``ic_pair`` (``_spmd_ic``)."""
    import torch.distributed as dist

    cfg = default_config()
    tc = cfg.tracking
    kf, cur, T_gt, _ = _frame_pair(TUM_FR1, cfg, tc.esm_geo_min_level, device=dev)
    T0 = torch.eye(4, device=dev)
    hist = np.zeros((tc.consensus_bins,), np.float32)
    mesh = make_mesh(world)
    one = Tracker(TUM_FR1, tc, tc.jac_dtype)
    st = ShardedTracker(mesh, TUM_FR1, tc, tc.jac_dtype)
    ref = one.track(kf.levels, cur, T0, hist)  # warm-up, and the reference
    st.track(kf.levels, cur, T0)
    _sync(dev)
    dist.barrier()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    n0 = st.allreduces
    res = st.track(kf.levels, cur, T0)
    _sync(dev)
    counts = {k: getattr(w, a) for k, (w, a) in COUNTERS.items()}
    allreduces = st.allreduces - n0
    one_ms, sharded_ms = [], []
    for _ in range(SPMD_REPS):
        t0 = time.perf_counter()
        one.track(kf.levels, cur, T0, hist)
        _sync(dev)
        one_ms.append((time.perf_counter() - t0) * 1e3)
        dist.barrier()
        t0 = time.perf_counter()
        st.track(kf.levels, cur, T0)
        _sync(dev)
        sharded_ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(result=res, ref=ref, T_gt=T_gt, counts=counts, allreduces=allreduces,
               one_ms=float(np.median(one_ms)), sharded_ms=float(np.median(sharded_ms)))
    if reloc_planes is not None:
        temps, curs = reloc_planes
        scorer = RelocScorer(TUM_FR1, cfg, dev)
        out["reloc"] = (shard_reloc_batch(scorer, mesh, temps, curs),
                        scorer.score_pairs(temps, curs))
    out.update(_spmd_ic(mesh, dev, ic_pair, SPMD_REPS))
    return out


def _same_result(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor)
               else np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def _pose_err(T: torch.Tensor, T_gt: torch.Tensor) -> float:
    """The norm of se3.log(T_gt^-1 T), float64."""
    D = se3_np.inv(T_gt.double().numpy()) @ T.double().numpy()
    return float(np.linalg.norm(se3_np.log(D)))


def _spmd_ic_checks(world: int, backend: str, outs, ref, cpu, T_gt) -> dict:
    """SpmdTracker's checks at one world size: every rank the same bits,
    exact launches and all-reduces per rank, T within SPMD_IC_TOL and the
    scales within SPMD_IC_S2_RTOL of ``ref`` (the CPU run at 1 rank, else
    the 1-rank run), the ground-truth bound from the CPU run ``cpu``, no
    host read under NCCL."""
    n = SPMD_IC_ITERS
    want = dict.fromkeys(COUNTERS, 0)
    want.update(ic_sigma_stats=n, ic_normal_eq=n, irls_solve=n)
    res = outs[0]["ic"]
    checks = {
        "SpmdTracker ranks bit-identical": all(_same_result(o["ic"], res) for o in outs[1:]),
        "SpmdTracker launches": all(o["ic_counts"] == want and o["ic_allreduces"] == 3 * n
                                    for o in outs),
        f"SpmdTracker within {SPMD_IC_TOL:g} of " + ("the CPU run" if world == 1 else "1 rank"):
            float((res[0] - ref[0]).abs().max()) <= SPMD_IC_TOL,
        f"SpmdTracker scales within rtol {SPMD_IC_S2_RTOL:g}":
            all(_rel(res[i], ref[i]) <= SPMD_IC_S2_RTOL for i in (1, 2)),
        "SpmdTracker ground truth": _pose_err(res[0], T_gt)
        <= max(2 * _pose_err(cpu["ic"][0], T_gt), SPMD_IC_GT),
    }
    if backend == "nccl":
        checks["SpmdTracker host reads 0"] = all(o["ic_reads"] == 0 for o in outs)
    return checks


def phase_spmd(smi: str):
    """The row-sharded tracker, SpmdTracker and the sharded scorer across
    ranks (the module docstring, item 17). Returns (ok, the ranks' launch
    counts)."""
    cfg = default_config()
    frames, _ = make_sequence()
    level = RelocScorer(TUM_FR1, cfg, "cpu").level
    planes = {i: _host_planes(frames[i], cfg, level) for pair in SPMD_RELOC_PAIRS for i in pair}
    reloc = ([planes[i] for i, _ in SPMD_RELOC_PAIRS], [planes[j] for _, j in SPMD_RELOC_PAIRS])
    ic_pair = spmd_ic_pair()
    T_gt = ic_pair[1]
    # The same run on the CPU: the plain versions over one gloo rank.
    t0 = time.perf_counter()
    cpu = run_ranks(_spmd_ic_rank, 1, "gloo", "cpu", ic_pair)[0]
    cpu_s = time.perf_counter() - t0
    print(f"[spmd] SpmdTracker on the CPU (1 gloo rank, the plain versions): VGA L0, "
          f"{SPMD_IC_ITERS} iterations from {np.linalg.norm(SPMD_IC_TWIST):.2e} (the twist's "
          f"norm) off ground truth: error {_pose_err(cpu['ic'][0], T_gt):.3e}, s2i "
          f"{float(cpu['ic'][1]):.4e}, s2x {float(cpu['ic'][2]):.4e}; {cpu_s:.1f} s with the "
          f"rank's start")
    total = dict.fromkeys(COUNTERS, 0)
    ok = True
    one = None
    for world, backend, device in SPMD_WORLDS:
        t0 = time.perf_counter()
        outs = run_ranks(_spmd_rank, world, backend, device,
                         reloc if world in SPMD_RELOC_WORLDS else None, ic_pair)
        wall = time.perf_counter() - t0
        r0 = outs[0]
        res, ref = r0["result"], r0["ref"]
        tc = cfg.tracking
        per_frame = sum(_n_iters(tc, l) for l in range(tc.levels))
        # Every launch is enqueued (the reruns and the rescue held unless
        # their vote fires): the main pyramid, the vote levels' reruns, the
        # rescue pyramid, and the rescue's two evidence evaluations.
        iters = 2 * per_frame + sum(_n_iters(tc, l) for l in _vote_levels(tc))
        counts = r0["counts"]
        checks = {
            "ranks bit-identical": all(_same_result(o["result"], res) for o in outs[1:]),
            "launches": all(o["counts"] == counts for o in outs)
            and counts["irls_solve"] == iters
            and counts["esm_normal_eq"] == iters + 2
            and counts["esm_stratified"] == counts["consensus_vote"] == 2,
        }
        if world == 1:
            checks["bit-equal to Tracker"] = _same_result(res, ref)
        H = ref.H.cpu().numpy()
        dT = float((res.T - ref.T).abs().max())
        gt_mm = float(torch.linalg.vector_norm(res.T[:3, 3] - r0["T_gt"][:3, 3])) * 1e3
        dH = np.abs(res.H.cpu().numpy() - H)
        h_share = float((dH / (2e-4 * np.abs(H) + 1e-5 * np.abs(H).max())).max())
        checks["within tolerances of Tracker"] = (
            dT <= SPMD_T_TOL and h_share <= 1.0
            and np.allclose(res.n_valid.cpu().numpy(), ref.n_valid.cpu().numpy(), rtol=1e-6,
                            atol=0)
            and abs(float(res.overlap) - float(ref.overlap)) <= 1e-5 * abs(float(ref.overlap))
            and torch.equal(res.cons_excluded, ref.cons_excluded))
        if "reloc" in r0:
            checks["shard_reloc_batch = score_pairs"] = all(
                all(np.array_equal(a, b) for a, b in zip(*o["reloc"])) for o in outs)
        for k in COUNTERS:
            total[k] += sum(o["counts"][k] + o["ic_counts"][k] for o in outs)
        ic = r0["ic"]
        ref_ic = cpu["ic"] if world == 1 else one
        ic_checks = _spmd_ic_checks(world, backend, outs, ref_ic, cpu, T_gt)
        if world == 1:
            one = ic
        print(f"[spmd] SpmdTracker {world} rank(s) over {backend} on {device}: VGA L0, bands of "
              f"{TUM_FR1.height // world} rows, {SPMD_IC_ITERS} iterations: error to ground "
              f"truth {_pose_err(ic[0], T_gt):.3e} (bound max(2 x CPU run's, {SPMD_IC_GT:g})), "
              f"T max|d| vs {'the CPU run' if world == 1 else '1 rank'} "
              f"{float((ic[0] - ref_ic[0]).abs().max()):.2e} (tol {SPMD_IC_TOL:g}), s2i "
              f"{float(ic[1]):.4e} ({float(ref_ic[1]):.4e}), s2x {float(ic[2]):.4e} "
              f"({float(ref_ic[2]):.4e}), rel {max(_rel(ic[1], ref_ic[1]), _rel(ic[2], ref_ic[2])):.1e} "
              f"(tol {SPMD_IC_S2_RTOL:g}); launches on rank 0 {r0['ic_counts']}; all-reduces "
              f"{r0['ic_allreduces']}; host reads in track {r0['ic_reads']} (NCCL only)")
        print(f"[spmd] SpmdTracker {world} rank(s): ms per iteration, median of {SPMD_REPS} "
              f"tracks of {SPMD_IC_ITERS}: {r0['ic_ms']:.4f} (rank 0; gloo ranks sharing the "
              f"card copy each all-reduce through the host); {smi}")
        prof = r0["ic_profile"]
        if prof is not None:
            print(f"[spmd] SpmdTracker {world} rank(s), torch.profiler over one track: device "
                  f"{prof['us']:.2f} us and {prof['kernels']:.1f} device ops per iteration; "
                  f"by kind (ops, us per iteration): " + "; ".join(
                      f"{k} {c:.0f}, {u:.2f}" for k, c, u in prof["kinds"]))
        print(f"[spmd] SpmdTracker {world} rank(s) checks {ic_checks} "
              f"{'OK' if all(ic_checks.values()) else 'FAIL'}")
        checks.update(ic_checks)
        good = all(checks.values())
        ok &= good
        print(f"[spmd] {world} rank(s) over {backend} on {device}: VGA pair, SlamConfig() "
              f"tracking (4 levels, strides {tuple(tc.template_stride)}, consensus on): T "
              f"max|d| vs Tracker {dT:.2e} (tol {SPMD_T_TOL:g}), translation {gt_mm:.3f} mm "
              f"from ground truth, H {h_share:.2f} of tol, "
              f"n_valid {float(res.n_valid[0]):.0f} ({float(ref.n_valid[0]):.0f}), "
              f"cons_excluded {res.cons_excluded.tolist()}, rerun iterations "
              f"{float(res.rerun_iters):.0f}, rescue ran {float(res.rescue_ran):.0f}; launches "
              f"on rank 0 {counts}; "
              f"all-reduces per tracked pair {r0['allreduces']}; wall {wall:.1f} s with the "
              f"ranks' start")
        print(f"[spmd] {world} rank(s): ms per tracked pair, median of {SPMD_REPS}: sharded "
              f"{r0['sharded_ms']:.2f}, one-process Tracker {r0['one_ms']:.2f} (in the same "
              f"rank); with several ranks on one card over gloo this measures the wrapper and "
              f"gloo's host copies, not an interconnect; {smi}")
        print(f"[spmd] {world} rank(s) checks {checks} {'OK' if good else 'FAIL'}")
    return ok, total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    name, smi = phase_device()
    phase_build()
    k_ok, records, timing = phase_kernels(slice_config())
    s_ok, s_records, s_timing, vote_sums = phase_stratified()
    v_ok, records["consensus_vote"], v_timing = phase_consensus_vote(vote_sums)
    ic_ok, ic_records, ic_timing = phase_ic_kernels()
    records.update(s_records)
    records.update(ic_records)
    r_ok, r_timing = phase_scorer_layouts(records)
    b_ok, b_timing = phase_bf16_kernels(records)
    e_ok, e_timing = phase_early_exit()
    so_ok, so_timing = phase_solve(records)
    go_ok, go_timing = phase_go(records)
    fo_ok = phase_fusion_oracle()
    timing += s_timing + ic_timing + r_timing + b_timing + e_timing + so_timing + v_timing
    timing += go_timing
    k_ok = (k_ok and s_ok and ic_ok and r_ok and b_ok and e_ok and so_ok and v_ok and go_ok
            and fo_ok)
    a_ok = phase_api(smi)
    runs = [("esm consensus off", slice_config(), False), ("default", default_config(), False),
            ("default mover", default_config(), True), ("ic lagged", ic_config("lagged"), False),
            ("ic exact", ic_config("exact"), False)]
    m_ok, total, median = True, dict.fromkeys(COUNTERS, 0), {}
    for label, run_cfg, mover in runs:
        good, launches, median[label], _ = phase_main(run_cfg, label, mover)
        m_ok &= good
        for k, v in launches.items():
            total[k] += v
    # Flights: feed(flight_depth=32) against the process_frame loop.
    f_ok, f_launches = phase_flight(smi)
    m_ok &= f_ok
    for k in COUNTERS:
        total[k] += f_launches[k]
    # This slice's own path: loop verification and pose-graph correction.
    sc_ok, scorer_ms = phase_scorer()
    good, launches, median["loop"], loop_out = phase_loop()
    m_ok &= sc_ok and good
    for k, v in launches.items():
        total[k] += v
    # The back end on: ORB, the thread beside the front end, relocalization.
    o_ok, orb_ms = phase_orb()
    b_ok, backend_run, backend_record = phase_backend()
    rl_ok, reloc_run = phase_reloc()
    m_ok &= o_ok and b_ok and rl_ok
    for run in (backend_run, reloc_run):
        for k in COUNTERS:
            total[k] += run[k]
    # The port's renderer: gauntlet rows and the command line.
    g_ok, g_launches, g_scorer = phase_gauntlet()
    c_ok, c_launches = phase_cli()
    m_ok &= g_ok and c_ok
    for run in (g_launches, c_launches):
        for k in COUNTERS:
            total[k] += run[k]
    # Real RGB-D data: --tum (with fuse_inverse_depth), the live source and
    # the snapshot.
    t_ok, t_launches = phase_tum(smi)
    l_ok, l_launches = phase_live(smi)
    sn_ok, sn_launches, sn_scorer = phase_snapshot(smi)
    m_ok &= t_ok and l_ok and sn_ok
    for run in (t_launches, l_launches, sn_launches):
        for k in COUNTERS:
            total[k] += run[k]
    # The live viewer and the plots; the row-sharded tracker and the
    # sharded scorer across ranks (their launches counted in the ranks).
    v_ok, v_launches = phase_viz(smi)
    sp_ok, sp_launches = phase_spmd(smi)
    m_ok &= v_ok and sp_ok
    for run in (v_launches, sp_launches):
        for k in COUNTERS:
            total[k] += run[k]
    # The storage, codec and early-exit knobs: SlamConfig.preset("real-v5e")
    # and the codecs on the main path, then each knob's ms/frame.
    p_ok, p_launches, p_scorer = phase_preset()
    m_ok &= p_ok
    for k in COUNTERS:
        total[k] += p_launches[k]
    phase_knob_times()
    first_packed, c_ok = phase_codecs()
    m_ok &= c_ok
    print(f"[main] ms/frame median in this call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in median.items()) + f"; IC exact - IC lagged "
          f"{median['ic exact'] - median['ic lagged']:+.2f}, default - consensus off "
          f"{median['default'] - median['esm consensus off']:+.2f}")
    phase_times(records, timing)
    phase_profile(default_config())
    phase_profile(preset_config(), label="preset real-v5e")
    phase_decode_kernels(first_packed)
    # Counts summed over the six main-path runs, the counted back-end-on run,
    # the relocalization run, the gauntlet rows, the command line, the
    # real-data, viewer and preset runs and the ranks of [spmd]. The scale step runs on
    # the main path as phases of the IC exact launches: its ``launches`` is
    # that count, and its standalone launches (SpmdTracker's, in [spmd])
    # stand beside it.
    for key, counter in (("esm", "esm_normal_eq"), ("esm_stratified", "esm_stratified"),
                         ("fusion", "fusion"), ("ic_normal", "ic_normal_eq"),
                         ("ic_sigma", "ic_sigma_phases"), ("irls_solve", "irls_solve"),
                         ("consensus_vote", "consensus_vote")):
        records[key]["launches"] = total[counter]
    # The ESM kernel's launches on the loop-verification path, counted by
    # the scorer (they never enter the per-frame count), stand beside the
    # per-frame launches and inside the total: close_loop's pair, the
    # back-end threads' candidates (the loop run's and the gauntlet rows')
    # and the relocalization attempts.
    scorer_launches = (loop_out["launches"] + backend_run["scorer_launches"]
                       + reloc_run["scorer_launches"] + g_scorer + p_scorer + sn_scorer)
    records["esm"]["scorer_launches"] = scorer_launches
    records["esm"]["launches"] += scorer_launches
    records["esm"].update(scorer_ms, loop_score_ms=loop_out["score_ms"],
                          loop_optimize_ms=loop_out["optimize_ms"],
                          orb_ms=float(np.median(list(orb_ms.values()))), **backend_record)
    records["ic_sigma"]["standalone_launches"] = total["ic_sigma_stats"]
    kern = [records[k] for k in ("esm", "esm_stratified", "fusion", "ic_normal", "ic_sigma",
                                 "irls_solve", "consensus_vote")]
    print(json.dumps({"kernels": kern}))
    if not (k_ok and a_ok and m_ok):
        print(f"chip_smoke: FAILED (kernels {'ok' if k_ok else 'failed'}, api "
              f"{'ok' if a_ok else 'failed'}, main paths {'ok' if m_ok else 'failed'})",
              file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
