"""Live visualization: the reference's 3-pane GUI as periodic snapshots.

Counterpart of ``rgbid_tpu/utils/live_view.py``, without OpenCV or
matplotlib. A thread composites three panes into ``<dir>/live.png`` every
time the system publishes a snapshot: the current frame (grey | coloured
inverse depth, with a label), the active keyframe (the same, from its
founding frame), and a top-down map (trajectory, keyframes and the cloud
of the finalized keyframes, drawn by ``utils/raster.py``).

The same contract as the JAX package's viewer:

- ``publish`` never blocks: a depth-1 queue whose waiting snapshot a newer
  one replaces (``dropped`` counts those); ``rendered`` counts the panels
  written.
- The panes are made from host data only (the raw frame, keyframe records,
  poses, finalized clouds): the system reads nothing from the device for
  them (``SlamSystem._publish_viz``).
- The PNG goes to ``.live.tmp.png`` and is then renamed to ``live.png``
  (``os.replace``), so a reader never sees half a file; with ``history``
  every panel is also kept as ``live_<frame>.png``.
- The map pane is drawn again every ``map_every`` snapshots.
- ``close()`` renders what is queued, then stops the thread.
- A snapshot that fails to render is printed with its traceback, counted
  in ``errors``, and the thread goes on. ``render_ms`` holds the host
  milliseconds of every panel rendered and written.

The current and keyframe panes equal the JAX viewer's bit for bit outside
the label. The label's glyphs come from the table recovered from
``cv2.putText`` (``tools/recover_viz_tables.py``) and are blended glyph
after glyph, where OpenCV draws the strokes; on the viewer's labels that
gives OpenCV's pixels too (``tests/test_torch_viz.py``), which is not
promised for every string. The map pane is this port's own drawing, of
the JAX pane's size: the panel width by max(width / 2, 240) rows.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from typing import List, Optional

import numpy as np

from . import raster
from .viz import cloud_bgr, colorize_inverse_depth, gray_bgr, subsample, write_bgr

MAP_POINTS = 60000
LABEL_ORG = (6, 18)  # the label's pen start, as the JAX viewer's putText org


def _gray_bgr(rgb_or_gray: np.ndarray) -> np.ndarray:
    a = np.asarray(rgb_or_gray)
    if a.ndim == 2:
        return gray_bgr(a)
    return np.ascontiguousarray(a[..., ::-1])


def _xi_from_depth_u16(depth_u16: np.ndarray, depth_scale: float, min_depth: float,
                       max_depth: float):
    z = depth_u16.astype(np.float32) / depth_scale
    mask = (z > min_depth) & (z < max_depth)
    xi = np.where(mask, 1.0 / np.maximum(z, 1e-6), 0.0).astype(np.float32)
    return xi, mask.astype(np.float32)


def _label(img: np.ndarray, text: str) -> np.ndarray:
    raster.text(img, text, *LABEL_ORG, raster.WHITE)
    return img


def label_box(text: str):
    """(row0, row1, col0, col1): the pixels a pane's label can touch."""
    return raster.text_box(text, *LABEL_ORG)


def current_label(snap: dict) -> str:
    state = "LOST" if snap.get("lost") else "tracking"
    return f"frame {snap.get('frame', 0)}  kf {snap.get('n_keyframes', 0)}  {state}"


def keyframe_label(snap: dict) -> str:
    return f"active keyframe {snap.get('kf_id', 0)}"


class LiveViewer:
    """Periodic 3-pane snapshot renderer on its own thread (see the module
    docstring)."""

    def __init__(self, out_dir: str, history: bool = False, map_every: int = 3):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.history = history
        self.map_every = max(1, int(map_every))
        self._q: "queue.Queue[Optional[dict]]" = queue.Queue(maxsize=1)
        self._map_png: Optional[np.ndarray] = None
        self._count = 0
        self.rendered = 0  # snapshots written
        self.dropped = 0  # snapshots replaced before rendering
        self.errors = 0  # snapshots that raised while rendering
        self.render_ms: List[float] = []
        self._thread = threading.Thread(target=self._run, name="rgbid-liveview", daemon=True)
        self._thread.start()

    def publish(self, snap: dict) -> None:
        """Non-blocking, lossy: the latest snapshot wins."""
        while True:
            try:
                self._q.put_nowait(snap)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass

    def close(self, timeout: float = 30.0) -> None:
        """Render anything still queued, then stop the thread."""
        self._q.put(None)  # blocks until the renderer has taken the queued snapshot
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while True:
            snap = self._q.get()
            if snap is None:
                return
            try:
                t0 = time.perf_counter()
                self._render(snap)
                self.render_ms.append((time.perf_counter() - t0) * 1e3)
                self.rendered += 1
            except Exception:  # a bad snapshot must not end the thread
                self.errors += 1
                traceback.print_exc()

    def panes(self, snap: dict):
        """(current pane, keyframe pane) of a snapshot, BGR, labels drawn."""
        h, w = snap["depth"].shape
        scale = snap.get("depth_scale", 5000.0)
        lo, hi = snap.get("min_depth", 0.3), snap.get("max_depth", 10.0)
        xi, mask = _xi_from_depth_u16(snap["depth"], scale, lo, hi)
        cur = np.concatenate([_gray_bgr(snap["rgb"]), colorize_inverse_depth(xi, mask)], axis=1)
        _label(cur, current_label(snap))
        kf_rgb = snap.get("kf_rgb")
        kf_depth = snap.get("kf_depth")
        if kf_rgb is not None:
            if kf_depth is not None:
                kxi, kmask = _xi_from_depth_u16(kf_depth, scale, lo, hi)
            else:
                kxi, kmask = np.zeros((h, w), np.float32), np.zeros((h, w), np.float32)
            kf_pane = np.concatenate([_gray_bgr(kf_rgb), colorize_inverse_depth(kxi, kmask)],
                                     axis=1)
            _label(kf_pane, keyframe_label(snap))
        else:
            kf_pane = np.zeros_like(cur)
        return cur, kf_pane

    def compose(self, snap: dict) -> np.ndarray:
        """The whole panel of a snapshot (the map pane redrawn every
        ``map_every`` snapshots)."""
        cur, kf_pane = self.panes(snap)
        if self._count % self.map_every == 0 or self._map_png is None:
            cloud = snap.get("cloud")
            if cloud is None and snap.get("kf_clouds"):
                from ..mapping.export import transform_cloud

                cloud = np.concatenate([transform_cloud(c, T) for T, c in snap["kf_clouds"]])
            self._map_png = render_map(snap.get("poses", []), snap.get("kf_poses", []), cloud,
                                       cur.shape[1])
        self._count += 1
        return np.concatenate([cur, kf_pane, self._map_png], axis=0)

    def _render(self, snap: dict) -> None:
        panel = self.compose(snap)
        tmp = os.path.join(self.out_dir, ".live.tmp.png")
        write_bgr(tmp, panel)
        os.replace(tmp, os.path.join(self.out_dir, "live.png"))
        if self.history:
            write_bgr(os.path.join(self.out_dir, f"live_{snap.get('frame', 0):06d}.png"), panel)


def render_map(poses: List[np.ndarray], kf_poses: List[np.ndarray], cloud: Optional[np.ndarray],
               width_px: int) -> np.ndarray:
    """Top-down trajectory + keyframes + cloud as a (max(width / 2, 240),
    width, 3) BGR image."""
    height = max(width_px // 2, 240)
    img = raster.canvas(height, width_px)
    pts = subsample(cloud, MAP_POINTS) if cloud is not None and len(cloud) else None
    traj = np.array([np.asarray(T)[:3, 3] for T in poses], np.float64).reshape(-1, 3)
    kf = np.array([np.asarray(T)[:3, 3] for T in kf_poses], np.float64).reshape(-1, 3)
    xs = [traj[:, 0], kf[:, 0]] + ([pts[:, 0]] if pts is not None else [])
    zs = [traj[:, 2], kf[:, 2]] + ([pts[:, 2]] if pts is not None else [])
    ax = raster.Axes((48, 26, width_px - 12, height - 24), xs, zs)
    ax.grid(img)
    if pts is not None:
        raster.scatter(img, *ax.px(pts[:, 0], pts[:, 2]), cloud_bgr(pts))
    if len(traj):
        raster.polyline(img, *ax.px(traj[:, 0], traj[:, 2]), raster.TAB_BLUE, thickness=2)
    if len(kf):
        raster.fill_squares(img, *ax.px(kf[:, 0], kf[:, 2]), 2, raster.TAB_RED)
    ax.frame(img)
    title = "trajectory + map (top-down)"
    raster.text(img, title, (width_px - raster.text_width(title)) // 2, 16, raster.BLACK)
    return img
