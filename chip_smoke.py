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
   step alone and the one-launch fusion step (480x640 and 641x481, growth
   on and off) are held to their plain versions and rerun;
4. main paths: SlamSystem over a synthetic VGA sequence with known ground
   truth, three times: the ESM slice configuration, then the
   inverse-compositional (IC) configuration with lagged and then exact
   Student-t scales. Each run checks launch counts (one per IRLS
   iteration, one fusion launch per fused frame, the scale phases inside
   the IC exact launches), keyframe switches, lost frames, finite poses,
   its ATE bound, host reads against the syncs PyTorch reports, and
   run-to-run bit-identity of poses, and prints ms/frame;
5. times: each kernel and its plain version, with CUDA events and with
   torch.profiler, beside the least time the card could take (bytes over
   3.35 TB/s, or operations over 67 TFLOP/s f32); the ESM kernel at every
   pyramid level's layout, the IC step lagged and exact. Then
   torch.profiler over tracked frames of one ESM run: device ops per frame
   (fused and not) and the largest of them. Profiling runs last, because
   it slows later launches.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Imports no JAX and no OpenCV: the scene is
rendered here with numpy and scipy.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from scipy import ndimage

import rgbid_tpu_torch as port
from rgbid_tpu_torch.core import se3
from rgbid_tpu_torch.core.camera import TUM_FR1, Intrinsics
from rgbid_tpu_torch.eval import absolute_trajectory_error
from rgbid_tpu_torch.mapping import fusion
from rgbid_tpu_torch.ops import _build, gauss_newton, kernels
from rgbid_tpu_torch.ops.gauss_newton import ic_update
from rgbid_tpu_torch.tracking.step import ProcessFrame, frame_pyramid, pack_frame
from rgbid_tpu_torch.tracking.tracker import template_level

N_FRAMES = 36
# ATE bound of every main-path run: max(2 x the CPU run's ATE, 5 mm). The
# port tracks this same sequence on the CPU in
# tests/test_torch_slice.py::test_chip_smoke_scene_on_cpu (ESM, 0.14 mm)
# and tests/test_torch_ic.py::test_chip_smoke_scene_on_cpu_ic (IC, lagged
# and exact), and asserts each ATE stays under half of this bound.
ATE_BOUND_M = 5e-3

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


def slice_config():
    return port.SlamConfig().override(
        **{"tracking.consensus": False, "backend.enabled": False}
    )


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


def _scaled_err(k: torch.Tensor, p: torch.Tensor):
    """(max |k - p|, max |k - p| / (2e-4 |p| + 1e-5 max|p|)): the second
    is <= 1 when every entry is inside the tolerance."""
    d = (k - p).abs()
    tol = 2e-4 * p.abs() + 1e-5 * p.abs().max().clamp(min=1e-30)
    return float(d.max()), float((d / tol).max())


def _frame_pair(intr: Intrinsics, cfg, geo_min: int = 0):
    """Keyframe + current pyramid on the card from two frames of the scene
    (ESM or IC templates, as ``cfg`` says), and the ground-truth relative
    pose as the linearization point."""
    scene = make_scene(0)
    rng = np.random.default_rng(5)
    gt = camera_path(N_FRAMES)
    f0 = render(scene, intr, gt[0], rng)
    f1 = render(scene, intr, gt[3], rng)
    cfg = cfg.override(**{"tracking.esm_geo_min_level": geo_min})
    step = ProcessFrame(intr, cfg, "cuda")
    kf = step.init_keyframe(torch.from_numpy(pack_frame(*f0)).cuda())
    cur = frame_pyramid(torch.from_numpy(pack_frame(*f1)).cuda(), cfg)
    T = torch.from_numpy(np.linalg.inv(gt[3]) @ gt[0]).float().cuda()
    return kf, cur, T, step.intrs


ODD_INTR = Intrinsics(fx=517.3, fy=516.5, cx=319.6, cy=239.8, width=641, height=481)


# The card's published peaks (H100 SXM data sheet, 700 W): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Operations per template (or, for fusion, level-0) pixel, counted from the
# kernels' sources: projection 25, corners 10, gather and mask 7 per plane
# + 3, residuals and weights ~26, Jacobians ~89 (ESM), the 32 sums ~180.
# Each kernel is bytes-bound by more than 4x, so the counts only need to be
# close.
FLOPS_PER_PIXEL = {"esm": 385, "ic_normal": 256, "ic_sigma": 79, "fusion": 220}


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


def _rel(a, b) -> float:
    return float((a - b).abs() / b.abs().clamp(min=1e-30))


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
        p = kernels.esm_residuals_and_normal_eq_plain(*a)
        return (p,) + ic_update(a[0], p.H, p.b, damping, p.n_valid)

    esm_abs, esm_scaled, esm_pose = 0.0, 0.0, 0.0
    for label, (kf, cur, T, intrs), lvl, geo, gate, cap in cases:
        kl, pts = template_level(kf.levels[lvl], intrs[lvl], strides[lvl])
        stack = cur[lvl].stack7
        args = (T, kl.intensity, pts, kl.mask, kl.jac, stack, intrs[lvl], tc.student_t_nu,
                s2i, s2x, geo, tc.gate_sigmas, gate, cap)
        ks = step(args)
        k = ks.result
        p, Tp, dp = chain(args)
        torch.cuda.synchronize()
        eH, sH = _scaled_err(k.H, p.H)
        eb, sb = _scaled_err(k.b, p.b)
        # Counts are exact: the kernel rounds every per-pixel step like the
        # plain version (same operation order, no FMA contraction).
        exact = bool(k.n_valid == p.n_valid) and bool(k.inlier_frac == p.inlier_frac)
        scal = max(
            float(((k.error - p.error).abs() / p.error.abs().clamp(min=1e-30))),
            float(((k.sigma2_int - p.sigma2_int).abs() / p.sigma2_int)),
            float(((k.sigma2_xi - p.sigma2_xi).abs() / p.sigma2_xi)),
        )
        dT, dd = _step_errs(ks, Tp, dp)
        good = (sH <= 1.0 and sb <= 1.0 and exact and scal <= 1e-4 and dT <= 1e-6
                and dd <= 1e-6)
        ok &= good
        esm_abs = max(esm_abs, eH, eb)
        esm_scaled = max(esm_scaled, sH, sb)
        esm_pose = max(esm_pose, dT, dd)
        print(f"[kernels] esm {label}: template {tuple(kl.mask.shape)} stack "
              f"{tuple(stack.shape)} n_valid {int(k.n_valid)} (plain {int(p.n_valid)}) "
              f"H max|d| {eH:.3e} ({sH:.2f} of tol) b max|d| {eb:.3e} ({sb:.2f} of tol) "
              f"err/sigma rel {scal:.1e} (tol 1e-4) T' max|d| {dT:.1e} delta max|d| {dd:.1e} "
              f"(tol 1e-6) {'OK' if good else 'FAIL'}")

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
    return ok, records, timing


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
        ("ic_normal", "L0", step, lambda a: chain(a)[1:], lagged,
         FLOPS_PER_PIXEL["ic_normal"] * n0, shape, lagged),
        ("ic_sigma", "L0", lambda a: kernels.ic_sigma_stats(*a),
         lambda a: gauss_newton.sigma_stats_plain(*a), sigma_args,
         FLOPS_PER_PIXEL["ic_sigma"] * n0, f"template {tuple(l0[1].shape)}, planes "
         f"{tuple(l0[5].shape)}", sigma_args),
    ]
    return ok, records, timing


def phase_times(records, timing):
    """Each kernel and its plain version, timed in turns (plain, kernel,
    kernel, plain) with CUDA events, then every device time with
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
    for (key, level, kernel, plain, args, flops, shape, reads), ev in zip(timing, events):
        plain_ms, ms, ms2, plain_ms2 = ev
        dev_ms = _device_ms(lambda: kernel(args))
        plain_dev_ms = _device_ms(lambda: plain(args))
        bound_ms, bound_by, nbytes = _bound(reads, kernel(args), flops)
        print(f"[times] {key} {level} ({shape}): kernel {ms:.4f} / {ms2:.4f} ms, plain "
              f"{plain_ms:.4f} / {plain_ms2:.4f} ms per call (CUDA events, launch cost "
              f"included); device time per call (profiler): kernel {dev_ms:.4f} ms, plain "
              f"{plain_dev_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us by {bound_by} "
              f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} Mflop), bound / device time "
              f"{bound_ms / dev_ms:.1%}")
        rec = dict(level=level, shape=shape, ms=min(ms, ms2), plain_ms=min(plain_ms, plain_ms2),
                   device_ms=dev_ms, plain_device_ms=plain_dev_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, flops=flops)
        records[key].setdefault("levels", []).append(rec)
    # The top-level numbers of a record are those of its finest layout
    # (level 0, the largest).
    for rec in records.values():
        rec.update({k: v for k, v in rec["levels"][-1].items() if k != "level"})
        rec["library_ms"] = None  # no single PyTorch call computes any of these


def phase_profile(cfg, n: int = 10):
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
    print(f"[profile] {n} tracked frames: {n_k:.1f} kernels per tracked frame "
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
    print("[profile] kernels per tracked frame by kind: " + ", ".join(
        f"{k} {np.mean([c for c in v if c > 0] or [0]):.1f} (frames {v})"
        for k, v in sorted(by_kind.items())))


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
    "ic_normal_eq": (kernels.ic_normal_eq, "launches"),
    "ic_sigma_stats": (kernels.ic_sigma_stats, "launches"),
    "ic_sigma_phases": (kernels.ic_normal_eq, "sigma_phases"),
    "fusion": (fusion.fuse_frame, "launches"),
}


def expected_launches(tc, tracked: int) -> dict:
    """IRLS counts a run must make: one launch per iteration (40 per tracked
    frame) in every mode, max(sigma_iters, 1) scale phases inside each IC
    exact launch, and no standalone scale launch."""
    iters = tracked * sum(tc.iters[: tc.levels])
    if tc.jacobian == "esm":
        return {"esm_normal_eq": iters, "ic_normal_eq": 0, "ic_sigma_stats": 0,
                "ic_sigma_phases": 0}
    sigma = iters * max(tc.sigma_iters, 1) if tc.sigma_mode == "exact" else 0
    return {"esm_normal_eq": 0, "ic_normal_eq": iters, "ic_sigma_stats": 0,
            "ic_sigma_phases": sigma}


def phase_main(cfg, label: str):
    tc = cfg.tracking
    frames, gt = make_sequence()
    slam = port.SlamSystem(TUM_FR1, cfg, device="cuda")
    # Warm-up on a short prefix (library init, allocator), then a fresh run.
    _run_sequence(slam, frames[:4])
    slam.reset()
    torch.cuda.synchronize()
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)
    reads0 = slam.host_reads
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            poses, _ = _run_sequence(slam, frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launches = {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}
    reads = slam.host_reads - reads0
    # Every synchronizing operation PyTorch reports in the run should be
    # one of the deliberate host reads (none inside the IRLS loop).
    syncs = sum(str(w.message).startswith("called a synchronizing") for w in caught)
    tracked = len(frames) - 1
    expected = expected_launches(tc, tracked)
    switches = sum(bool(s.get("switch")) for s in slam.stats)
    lost = sum(bool(s.get("lost")) for s in slam.stats)
    fused = sum(s.get("n_fused", 0) > 0 for s in slam.stats)
    finite = all(np.isfinite(T).all() for T in poses)
    ate = sequence_ate(gt, poses)
    traj = slam.trajectory()
    cloud = slam.map_points()
    n_kf = len(slam.manager.keyframes)

    # A second run, with the sync-debug mode off (it slows the host), is
    # the timed one; the same input must give bit-identical poses.
    slam.reset()
    poses2, ms = _run_sequence(slam, frames)
    identical = all(np.array_equal(a, b) for a, b in zip(poses, poses2))

    steady = ms[5:]
    counts = ", ".join(f"{k} {launches[k]} (expected {v})" for k, v in expected.items())
    print(f"[main {label}] SlamSystem VGA {TUM_FR1.width}x{TUM_FR1.height}, {len(frames)} "
          f"frames ({tracked} tracked): counts {counts}, fusion launches {launches['fusion']} "
          f"(expected 1 per fused frame: {fused}); switches {switches}, lost {lost}, "
          f"keyframes {n_kf}")
    print(f"[main {label}] ATE {ate * 1e3:.3f} mm (bound {ATE_BOUND_M * 1e3:.1f} mm), poses "
          f"finite {finite}, trajectory {len(traj)} rows, map {len(cloud)} points, cloud "
          f"finite {bool(np.isfinite(cloud).all())}, rerun bit-identical {identical}")
    # The highest percentile with at least ten frames above it (the median
    # when there are fewer than twenty).
    q = 100.0 * max(len(steady) - 10, len(steady) // 2) / len(steady)
    print(f"[main {label}] ms/frame median {np.median(steady):.2f}, p{q:.0f} "
          f"{np.percentile(steady, q):.2f} (min {np.min(steady):.2f}, max "
          f"{np.max(steady):.2f}) over {len(steady)} frames (5..{len(frames) - 1}) of the "
          f"rerun; host reads "
          f"{reads} = {reads / tracked:.2f}/tracked frame; synchronizing operations "
          f"reported by torch.cuda sync-debug mode {syncs}")
    good = (
        all(launches[k] == v for k, v in expected.items())
        and launches["fusion"] == fused >= 1
        and switches >= 1
        and lost == 0
        and finite
        and ate <= ATE_BOUND_M
        and len(traj) == len(frames)
        and len(cloud) > 0
        and bool(np.isfinite(cloud).all())
        and identical
        and syncs == reads
    )
    print(f"[main {label}] {'OK' if good else 'FAIL'}")
    return good, launches, float(np.median(steady))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    name, smi = phase_device()
    phase_build()
    cfg = slice_config()
    k_ok, records, timing = phase_kernels(cfg)
    ic_ok, ic_records, ic_timing = phase_ic_kernels()
    records.update(ic_records)
    timing += ic_timing
    runs = [("esm", cfg), ("ic lagged", ic_config("lagged")), ("ic exact", ic_config("exact"))]
    m_ok, total, median = True, dict.fromkeys(COUNTERS, 0), {}
    for label, run_cfg in runs:
        good, launches, median[label] = phase_main(run_cfg, label)
        m_ok &= good
        for k, v in launches.items():
            total[k] += v
    print(f"[main] ms/frame median, IC exact - IC lagged in this call: "
          f"{median['ic exact'] - median['ic lagged']:+.2f}")
    phase_times(records, timing)
    phase_profile(cfg)
    # Counts summed over the three main-path runs. The scale step runs on
    # the main path as phases of the IC exact launches: its ``launches`` is
    # that count, and its standalone launches (0 on the main path) stand
    # beside it.
    for key, counter in (("esm", "esm_normal_eq"), ("fusion", "fusion"),
                         ("ic_normal", "ic_normal_eq"), ("ic_sigma", "ic_sigma_phases")):
        records[key]["launches"] = total[counter]
    records["ic_sigma"]["standalone_launches"] = total["ic_sigma_stats"]
    kern = [records[k] for k in ("esm", "fusion", "ic_normal", "ic_sigma")]
    print(json.dumps({"kernels": kern}))
    if not (k_ok and ic_ok and m_ok):
        print(f"chip_smoke: FAILED (kernels {'ok' if k_ok and ic_ok else 'failed'}, main "
              f"paths {'ok' if m_ok else 'failed'})", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
