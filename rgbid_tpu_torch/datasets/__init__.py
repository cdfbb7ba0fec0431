"""Dataset / frame-source layer.

The port's copy of ``rgbid_tpu/datasets/__init__.py``: the ``Frame``
record, ``prefetch_frames`` and the synthetic RGB-D renderer (host numpy,
no OpenCV). The TUM reader and the live source (``tum.py``, ``live.py``)
read through OpenCV in the JAX package and are not ported yet (ROADMAP
Queue 1 #8).
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class Frame:
    """One RGB-D frame, as the sensor/dataset delivers it.

    rgb:   (H, W, 3) uint8
    depth: (H, W) uint16, raw sensor units (meters = depth / depth_scale)
    """

    timestamp: float
    rgb: np.ndarray
    depth: np.ndarray


def prefetch_frames(frames, depth: int = 4):
    """Iterate ``frames`` through a background decoder thread.

    Dataset frame production is host-heavy (PNG decode + undistortion
    remap, ~5-15 ms/frame at VGA); running it in a worker overlaps it
    with SLAM compute on the caller's thread. ``depth`` bounds the queue
    so a slow consumer cannot make the reader buffer a whole sequence.
    Exceptions in the reader are re-raised at the consumption point.
    """
    import queue as _queue
    import threading as _threading

    q: "_queue.Queue" = _queue.Queue(maxsize=max(depth, 1))
    _END = object()

    def _reader():
        try:
            for f in frames:
                q.put(f)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            q.put(e)
            return
        finally:
            q.put(_END)

    _threading.Thread(target=_reader, daemon=True, name="frame-prefetch").start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


from .synthetic import SyntheticSequence, generate_sequence, make_scene, render_frame  # noqa: E402,F401
