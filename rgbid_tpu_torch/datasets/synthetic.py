"""Synthetic RGB-D sequence renderer with exact ground-truth poses.

TUM RGB-D sequences are not available offline, so all CI-grade
correctness tests and benchmarks run on synthetic sequences rendered here
(SURVEY.md §4, consequence (3)). The renderer is deliberately simple —
textured rectangles ray-cast in closed form — but produces exactly the
signal structure dense RGB-D odometry needs: smooth band-limited texture (non-degenerate photometric gradients),
piecewise-planar depth with discontinuities (occlusion handling), and a
realistic sensor model (u16 quantization + constant-inverse-depth noise,
the structured-light model motivating the reference's parametrization).

Pure numpy; no JAX dependency (this is host-side L0 I/O).

The port's copy of ``rgbid_tpu/datasets/synthetic.py``: the same scenes,
trajectories, sensor model and random draws in the same order, so a seed
gives the reference's sequence. The reference's five OpenCV calls go to
``_cv.py``, which reproduces them in numpy (it states where the result
differs from OpenCV's, and by how much).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from ..core.camera import Intrinsics
from . import _cv

# ---------------------------------------------------------------------------
# Scene


@dataclass
class TexturedRect:
    """Rectangle p0 + a*eu + b*ev, (a, b) in [0,1]^2, with a gray texture."""

    p0: np.ndarray  # (3,)
    eu: np.ndarray  # (3,)
    ev: np.ndarray  # (3,)
    texture: np.ndarray  # (T, T) float32 in [0, 1]
    tint: np.ndarray  # (3,) per-channel color multiplier

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.eu, self.ev)
        return n / np.linalg.norm(n)


@dataclass
class Scene:
    rects: List[TexturedRect] = field(default_factory=list)


def _smooth_texture(rng: np.random.Generator, size: int = 512, octaves=(8, 16, 32, 64)) -> np.ndarray:
    """Band-limited multi-octave noise texture in [0.15, 0.85]."""
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for res in octaves:
        coarse = rng.standard_normal((res, res)).astype(np.float32)
        tex += amp * _cv.resize_cubic(coarse, (size, size))
        amp *= 0.55
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return (0.15 + 0.7 * tex).astype(np.float32)


def make_scene(seed: int = 0) -> Scene:
    """Default test scene: a room corner (back wall, side wall, floor) plus a
    free-standing tilted panel that creates parallax and occlusions.

    World frame = camera frame of the canonical origin pose (x right,
    y down, z forward); the scene sits 1.5–4 m in front of the origin.
    """
    rng = np.random.default_rng(seed)

    def rect(p0, eu, ev, tint):
        return TexturedRect(
            p0=np.asarray(p0, np.float64),
            eu=np.asarray(eu, np.float64),
            ev=np.asarray(ev, np.float64),
            texture=_smooth_texture(rng),
            tint=np.asarray(tint, np.float32),
        )

    scene = Scene()
    # Back wall: z = 4.0
    scene.rects.append(rect([-4.0, -3.0, 4.0], [8.0, 0, 0], [0, 6.0, 0], [1.0, 0.95, 0.9]))
    # Left wall: x = -2.5, spanning z in [1.0, 4.0]
    scene.rects.append(rect([-2.5, -3.0, 1.0], [0, 0, 3.0], [0, 6.0, 0], [0.9, 1.0, 0.95]))
    # Floor: y = 1.8
    scene.rects.append(rect([-4.0, 1.8, 1.0], [8.0, 0, 0], [0, 0, 3.0], [0.95, 0.95, 1.0]))
    # Tilted panel in the middle (occluder).
    scene.rects.append(rect([-0.9, -0.8, 2.0], [1.5, 0.1, 0.45], [0.05, 1.5, -0.1], [1.0, 1.0, 0.85]))
    return scene


# ---------------------------------------------------------------------------
# Rendering


def render_frame(
    scene: Scene,
    intr: Intrinsics,
    T_wc: np.ndarray,
    depth_scale: float = 5000.0,
    xi_noise_sigma: float = 0.0,
    rng: np.random.Generator | None = None,
):
    """Ray-cast one frame from camera pose ``T_wc`` (camera-to-world).

    Returns (rgb_u8 (H,W,3), depth_u16 (H,W), intensity_f32, depth_f32).
    depth_f32 is the noise-free ground-truth depth in meters (0 = no hit).
    """
    h, w = intr.height, intr.width
    u = np.arange(w, dtype=np.float64)[None, :].repeat(h, 0)
    v = np.arange(h, dtype=np.float64)[:, None].repeat(w, 1)
    # Unnormalized camera-frame ray directions with dz = 1 => hit param t == depth.
    d_cam = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, np.ones_like(u)], axis=-1)
    R, o = T_wc[:3, :3], T_wc[:3, 3]
    d_w = d_cam @ R.T  # (H, W, 3)

    depth = np.full((h, w), np.inf, np.float64)
    gray = np.zeros((h, w), np.float32)
    rgb = np.zeros((h, w, 3), np.float32)

    for r_ in scene.rects:
        n = r_.normal
        denom = d_w @ n
        # t on the infinite plane; mask out near-parallel rays.
        t = np.where(np.abs(denom) > 1e-9, ((r_.p0 - o) @ n) / np.where(np.abs(denom) > 1e-9, denom, 1.0), np.inf)
        valid = (t > 0.05) & np.isfinite(t)
        p = o + d_w * np.where(np.isfinite(t), t, 0.0)[..., None]  # world hit points
        rel = p - r_.p0
        uu, vv = r_.eu, r_.ev
        # Solve rel = a*eu + b*ev in the plane (2x2 Gram system).
        g11, g12, g22 = uu @ uu, uu @ vv, vv @ vv
        r1, r2 = rel @ uu, rel @ vv
        det = g11 * g22 - g12 * g12
        a = (g22 * r1 - g12 * r2) / det
        b = (g11 * r2 - g12 * r1) / det
        # Rays parallel to the plane have t = inf -> NaN plane coords;
        # sanitize before they reach the integer texture indexing.
        a = np.nan_to_num(a, nan=-1.0, posinf=-1.0, neginf=-1.0)
        b = np.nan_to_num(b, nan=-1.0, posinf=-1.0, neginf=-1.0)
        inside = valid & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1) & (t < depth)
        if not inside.any():
            continue
        tex = r_.texture
        ts = tex.shape[0]
        # Bilinear texture sample at (a, b).
        ta = np.clip(a * (ts - 1), 0, ts - 1.000001)
        tb = np.clip(b * (ts - 1), 0, ts - 1.000001)
        ia, ib = ta.astype(np.int64), tb.astype(np.int64)
        fa, fb = (ta - ia).astype(np.float32), (tb - ib).astype(np.float32)
        ia1 = np.minimum(ia + 1, ts - 1)
        ib1 = np.minimum(ib + 1, ts - 1)
        val = (
            tex[ib, ia] * (1 - fa) * (1 - fb)
            + tex[ib, ia1] * fa * (1 - fb)
            + tex[ib1, ia] * (1 - fa) * fb
            + tex[ib1, ia1] * fa * fb
        )
        depth[inside] = t[inside]
        gray[inside] = val[inside]
        rgb[inside] = val[inside, None] * r_.tint[None, :]

    hit = np.isfinite(depth)
    depth_f32 = np.where(hit, depth, 0.0).astype(np.float32)
    rgb_u8 = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)

    # Sensor model: noise constant in inverse depth, then u16 quantization.
    d = depth_f32.astype(np.float64)
    if xi_noise_sigma > 0:
        if rng is None:
            rng = np.random.default_rng(0)
        xi = np.where(hit, 1.0 / np.maximum(d, 1e-6), 0.0)
        xi = xi + rng.normal(0.0, xi_noise_sigma, size=xi.shape) * hit
        d = np.where(hit & (xi > 1e-3), 1.0 / np.maximum(xi, 1e-3), 0.0)
    depth_u16 = np.clip(np.round(d * depth_scale), 0, 65535).astype(np.uint16)
    return rgb_u8, depth_u16, gray, depth_f32


# ---------------------------------------------------------------------------
# Trajectories


def orbit_trajectory(n: int, trans_amp=0.25, rot_amp=0.06, periods=1.25) -> List[np.ndarray]:
    """Smooth exploratory motion: sinusoidal translation + small rotations.

    Returns camera-to-world poses T_wc; frame 0 is the identity.
    """
    poses = []
    for i in range(n):
        s = periods * 2 * np.pi * i / max(n - 1, 1)
        t = np.array(
            [trans_amp * np.sin(s), 0.5 * trans_amp * np.sin(2 * s + 0.7), 0.35 * trans_amp * (1 - np.cos(s))]
        )
        rx = rot_amp * np.sin(s + 0.3)
        ry = rot_amp * np.sin(0.8 * s)
        rz = 0.4 * rot_amp * np.sin(1.3 * s + 1.1)
        T = np.eye(4)
        T[:3, :3] = _euler(rx, ry, rz)
        T[:3, 3] = t
        poses.append(T)
    return poses


def loopy_trajectory(n: int, radius=0.35, rot_amp=0.10) -> List[np.ndarray]:
    """Closed-loop motion returning near the start pose (for loop closure)."""
    poses = []
    for i in range(n):
        s = 2 * np.pi * i / max(n - 1, 1)
        t = np.array([radius * np.sin(s), 0.12 * np.sin(2 * s), 0.5 * radius * (1 - np.cos(s))])
        T = np.eye(4)
        T[:3, :3] = _euler(0.3 * rot_amp * np.sin(2 * s), rot_amp * np.sin(s), 0.0)
        T[:3, 3] = t
        poses.append(T)
    return poses


def handheld_trajectory(
    n: int,
    trans_amp: float = 0.25,
    rot_amp: float = 0.08,
    jitter_trans: float = 0.004,
    jitter_rot: float = 0.003,
    seed: int = 0,
) -> List[np.ndarray]:
    """Handheld-like motion: the smooth orbit path plus band-limited
    per-frame pose jitter (smoothed random walk — the tremor + step
    content of handheld footage that breaks constant-velocity priors)."""
    rng = np.random.default_rng(seed)
    base = orbit_trajectory(n, trans_amp, rot_amp)
    # Smoothed random-walk jitter (EMA of white noise, zero-mean).
    jit = np.zeros((n, 6))
    state = np.zeros(6)
    scale = np.array([jitter_trans] * 3 + [jitter_rot] * 3)
    for i in range(n):
        state = 0.7 * state + rng.normal(size=6) * scale
        jit[i] = state
    jit -= jit.mean(axis=0)
    poses = []
    for i, T in enumerate(base):
        J = np.eye(4)
        J[:3, :3] = _euler(*jit[i, 3:])
        J[:3, 3] = jit[i, :3]
        poses.append(T @ J)
    return poses


def _euler(rx, ry, rz):
    cx_, sx = np.cos(rx), np.sin(rx)
    cy_, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx_, -sx], [0, sx, cx_]])
    Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


# ---------------------------------------------------------------------------
# Sequence


@dataclass
class SyntheticSequence:
    """A rendered RGB-D sequence with ground truth (mirrors TumSequence)."""

    intrinsics: Intrinsics
    timestamps: List[float]
    rgb: List[np.ndarray]
    depth: List[np.ndarray]
    gt_poses: List[np.ndarray]  # camera-to-world T_wc
    depth_scale: float = 5000.0

    def __len__(self):
        return len(self.timestamps)

    def frames(self):
        from . import Frame

        for i in range(len(self)):
            yield Frame(self.timestamps[i], self.rgb[i], self.depth[i])


def _apply_kinect_artifacts(rgb, d16, intr, T_now, T_prev, sev, rng):
    """Kinect-class sensor degradations (see generate_sequence docstring).

    All effects scale with ``sev`` in (0, 1]. Depth works in meters via
    the 5000.0 TUM scale used by render_frame.
    """
    h, w = d16.shape
    z = d16.astype(np.float64) / 5000.0
    hit = z > 1e-6

    # (a) Motion blur along the dominant inter-frame image flow. Global
    # approximation: translation flow at the median scene depth plus
    # rotational flow, smeared over a ~40% shutter duty cycle.
    D = np.linalg.inv(T_prev) @ T_now
    dt = D[:3, 3]
    ang = np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]) * 0.5
    z_med = np.median(z[hit]) if hit.any() else 2.0
    flow = np.array([
        intr.fx * (dt[0] / max(z_med, 0.3)) + intr.fx * ang[1],
        intr.fy * (dt[1] / max(z_med, 0.3)) - intr.fy * ang[0],
    ])
    L = int(round(0.4 * sev * np.hypot(*flow)))
    if L >= 1:
        k = 2 * L + 1
        kern = np.zeros((k, k), np.float32)
        direc = flow / max(np.hypot(*flow), 1e-9)
        for s in np.linspace(-L, L, 2 * k):
            x = int(round(L + s * direc[0]))
            y = int(round(L + s * direc[1]))
            kern[np.clip(y, 0, k - 1), np.clip(x, 0, k - 1)] += 1.0
        kern /= kern.sum()
        rgb = _cv.filter2d_u8(rgb, kern)

    # (b) Disparity quantization: d = f*b/z quantized to 1/8 px with the
    # Kinect's f*b ~= 43.5 m*px -> z staircase growing as z^2.
    fb8 = 43.5 * 8.0 / max(sev, 1e-6)  # sev<1 = finer staircase
    disp = np.where(hit, fb8 / np.maximum(z, 0.05), 0.0)
    zq = np.where(hit, fb8 / np.maximum(np.round(disp), 1.0), 0.0)

    # (c) Edge dropout: structured light loses depth DISCONTINUITIES
    # (projector shadowing at occlusion boundaries). Detect on a 3x3
    # median of the depth so per-pixel sensor noise (xi_noise * z^2
    # grows to ~0.08 m/px at 4 m) does not read as edges — only real
    # geometry steps do; threshold relative to depth.
    zs = _cv.median3_f32(zq.astype(np.float32)).astype(np.float64)
    gx = np.abs(np.diff(zs, axis=1, prepend=zs[:, :1]))
    gy = np.abs(np.diff(zs, axis=0, prepend=zs[:1, :]))
    edge = ((gx + gy) > 0.06 * np.maximum(zs, 0.3)) & hit
    edge = _cv.dilate3_u8(edge.astype(np.uint8), iterations=1 if sev < 0.75 else 2).astype(bool)

    # (d) Speckle: random salt holes.
    speckle = rng.random((h, w)) < 0.015 * sev

    zq = np.where(edge | speckle, 0.0, zq)
    d16_out = np.clip(np.round(zq * 5000.0), 0, 65535).astype(np.uint16)
    return rgb, d16_out


def generate_sequence(
    n_frames: int = 30,
    intr: Intrinsics | None = None,
    motion: str | Sequence[np.ndarray] = "orbit",
    seed: int = 0,
    xi_noise_sigma: float = 0.0,
    fps: float = 30.0,
    scene: Scene | None = None,
    exposure_drift: float = 0.0,
    depth_hole_frac: float = 0.0,
    moving_occluder: bool = False,
    occluder_z: float = 1.4,
    occluder_speed: float | None = None,
    occluder_window: tuple | None = None,
    moving_occluder2: bool = False,
    occluder2_z: float = 2.4,
    occluder2_speed: float | None = None,
    occluder2_window: tuple | None = None,
    kinect_artifacts: float = 0.0,
    **motion_kwargs,
) -> SyntheticSequence:
    """Render a sequence; the optional degradations make up the hard-mode
    accuracy gauntlet (round-2 VERDICT item 5):

    * ``exposure_drift``: slow multiplicative gain + additive bias drift
      (auto-exposure-like; amplitude g means gain wanders in [1-g, 1+g]) —
      violates brightness constancy between frame and keyframe.
    * ``depth_hole_frac``: approximate fraction of valid pixels dropped
      per frame in contiguous blobs (structured-light dropouts).
    * ``moving_occluder``: a textured panel sweeping through the view
      over the sequence (dynamic content the occlusion gates must reject).
    * ``occluder_window``: (on, off) — the panel exists only for frames
      ``on <= i < off`` (a person walking through and leaving the scene).
      Ints are frame indices; floats in [0, 1] are fractions of the
      sequence, resolved as ``round(f * (n_frames - 1))`` so a scenario
      spec stays length-independent. The panel's sweep position still
      advances with the ABSOLUTE frame index (it does not freeze while
      hidden). None (default) = present for the whole sequence.
    * ``moving_occluder2``: a SECOND independent panel (own texture,
      depth, window) sweeping right-to-left — two simultaneous movers
      in different depth strata are the depth-stratified consensus's
      two-front regime (a probe accepted on one mover's stratum must
      not knock back the other's streak; tracking/tracker.py streak
      transfer is scoped to the involved strata for exactly this).
    * ``motion="handheld"``: jittered trajectory (handheld_trajectory).
    * ``kinect_artifacts``: severity (0..1) of the Kinect-class sensor
      model the plain renderer is kinder than (round-2 VERDICT missing
      item 1 — every synthetic number is otherwise cleaner than real
      fr1/desk imagery). At severity 1: (a) MOTION BLUR — the RGB image
      is blurred along the dominant inter-frame image flow with a line
      kernel sized to a ~40% shutter duty cycle (rolling-shutter-class
      smear on fast frames; violates the sharp-template assumption);
      (b) DISPARITY QUANTIZATION — depth re-quantized to 1/8 px of
      Kinect disparity (f*b ~= 43.5 m*px), the real z^2-growing depth
      staircase (~2.8 mm at 1 m, ~45 mm at 4 m), replacing the
      benign flat u16 rounding; (c) EDGE DROPOUT — depth removed where
      the depth gradient is large, dilated (structured light fails on
      discontinuities/oblique surfaces — exactly where the geometric
      channel is most informative); (d) SPECKLE — ~1.5% random salt
      holes per frame.
    """
    from ..core.camera import DEFAULT

    intr = intr or DEFAULT
    scene = scene or make_scene(seed)
    if isinstance(motion, str):
        if motion == "orbit":
            poses = orbit_trajectory(n_frames, **motion_kwargs)
        elif motion == "loop":
            poses = loopy_trajectory(n_frames, **motion_kwargs)
        elif motion == "handheld":
            poses = handheld_trajectory(n_frames, seed=seed, **motion_kwargs)
        elif motion == "static":
            poses = [np.eye(4) for _ in range(n_frames)]
        else:
            raise ValueError(f"unknown motion {motion}")
    else:
        poses = list(motion)
    rng = np.random.default_rng(seed + 1)
    seq = SyntheticSequence(intr, [], [], [], [], 5000.0)

    def _resolve_window(w):
        if w is None:
            return 0, n_frames
        return tuple(
            int(round(v * (n_frames - 1))) if isinstance(v, float) else int(v)
            for v in w
        )

    occluders = []  # (rect_at_frame_0, velocity, on, off)
    if moving_occluder:
        occ_rng = np.random.default_rng(seed + 7)
        rect = TexturedRect(
            p0=np.array([-1.6, -0.5, occluder_z]),
            eu=np.array([0.55, 0.05, 0.1]),
            ev=np.array([0.0, 0.65, 0.05]),
            texture=_smooth_texture(occ_rng),
            tint=np.array([0.85, 1.0, 1.0], np.float32),
        )
        # Sweeps left-to-right through the frustum over the sequence.
        # Default: sweep the full 2.6 m across the sequence (per-frame
        # speed then scales with 1/n_frames — a 24-frame clip gets a
        # ballistic ~0.11 m/frame panel). occluder_speed pins the
        # per-frame speed in m/frame instead (0.015 at 30 Hz ~= a person
        # walking at 0.45 m/s — the realistic dynamic-scene regime).
        speed = (
            occluder_speed
            if occluder_speed is not None
            else 2.6 / max(n_frames - 1, 1)
        )
        on, off = _resolve_window(occluder_window)
        occluders.append((rect, np.array([speed, 0.0, 0.0]), on, off))
    if moving_occluder2:
        # Independent second mover: own texture draw, right-to-left
        # sweep, offset vertically so both panels are simultaneously
        # visible, and (by default) a different depth stratum.
        occ_rng2 = np.random.default_rng(seed + 13)
        rect2 = TexturedRect(
            p0=np.array([1.3, 0.05, occluder2_z]),
            eu=np.array([0.6, -0.04, 0.08]),
            ev=np.array([0.0, 0.6, -0.04]),
            texture=_smooth_texture(occ_rng2),
            tint=np.array([1.0, 0.9, 0.82], np.float32),
        )
        speed2 = (
            occluder2_speed
            if occluder2_speed is not None
            else -2.6 / max(n_frames - 1, 1)
        )
        on2, off2 = _resolve_window(occluder2_window)
        occluders.append((rect2, np.array([speed2, 0.0, 0.0]), on2, off2))

    for i, T in enumerate(poses):
        active = [
            TexturedRect(
                p0=rect.p0 + vel * i,
                eu=rect.eu,
                ev=rect.ev,
                texture=rect.texture,
                tint=rect.tint,
            )
            for rect, vel, on, off in occluders
            if on <= i < off
        ]
        if active:
            frame_scene = Scene(rects=list(scene.rects) + active)
        else:
            frame_scene = scene
        rgb, d16, _, _ = render_frame(frame_scene, intr, T, 5000.0, xi_noise_sigma, rng)
        if exposure_drift > 0:
            s = 2 * np.pi * i / max(n_frames - 1, 1)
            gain = 1.0 + exposure_drift * np.sin(1.7 * s + 0.4)
            bias = 12.0 * exposure_drift * np.sin(0.9 * s + 2.1)
            rgb = np.clip(rgb.astype(np.float32) * gain + bias, 0, 255).astype(np.uint8)
        if depth_hole_frac > 0:
            # Contiguous dropout blobs: threshold smoothed noise at the
            # requested quantile (holes move frame to frame).
            blob = rng.standard_normal((intr.height // 8, intr.width // 8)).astype(np.float32)
            blob = _cv.resize_cubic(blob, (intr.width, intr.height))
            thresh = np.quantile(blob, 1.0 - depth_hole_frac)
            d16 = np.where(blob > thresh, 0, d16).astype(np.uint16)
        if kinect_artifacts > 0:
            rgb, d16 = _apply_kinect_artifacts(
                rgb, d16, intr, T, poses[i - 1] if i > 0 else T,
                kinect_artifacts, rng,
            )
        seq.timestamps.append(i / fps)
        seq.rgb.append(rgb)
        seq.depth.append(d16)
        seq.gt_poses.append(T)
    return seq
