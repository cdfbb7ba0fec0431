"""Live frame source: follow a growing TUM-format capture directory.

The port's copy of ``rgbid_tpu/datasets/live.py``. A headless RGB-D
capture daemon (openni2_recorder, realsense-record, ROS bag exporters)
writes the TUM layout, PNGs plus append-only rgb.txt / depth.txt, so
following that directory as it grows is live capture from the system's
point of view: frames arrive over time, RGB and depth timestamps
interleave arbitrarily, and there is no known end.

Semantics:

* yields ``datasets.Frame`` in timestamp order, exactly once each, through
  the offline ``TumSequence`` reader (association, undistortion,
  calibration); ``refresh()`` re-reads the index files between polls;
* association runs on the full lists each poll (the matcher is
  deterministic, so pairs already yielded keep their association), and a
  timestamp watermark keeps delivery exactly-once: a depth file that
  arrives late for an RGB timestamp already passed is dropped, not
  yielded out of order (a live consumer cannot rewind; a frame missed is
  a frame dropped);
* a PNG still being written raises IOError in ``TumSequence``
  (``datasets/png.py`` checks lengths, CRCs and the end chunk), so the
  stream stops at that frame and retries it at the next poll;
* ``stop()``, or ``idle_timeout`` seconds without new data, ends the
  stream: the capture daemon going away is the normal shutdown signal.

Wrap in ``datasets.prefetch_frames`` to overlap the PNG decode with
tracking, as for the offline reader.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np

from . import Frame
from .tum import TumSequence


class LiveSource:
    """Follow a growing TUM-format capture directory in real time."""

    def __init__(
        self,
        seq_dir: str,
        poll_interval: float = 0.05,
        idle_timeout: float = 10.0,
        wait_for_dir: float = 30.0,
        **tum_kwargs,
    ):
        self.dir = seq_dir
        self.poll_interval = float(poll_interval)
        self.idle_timeout = float(idle_timeout)
        self.wait_for_dir = float(wait_for_dir)
        self._tum_kwargs = tum_kwargs
        self._seq: Optional[TumSequence] = None
        self._stopped = False

    def stop(self) -> None:
        """End the stream after the frames already indexed."""
        self._stopped = True

    @property
    def intrinsics(self):
        self._open()
        return self._seq.intrinsics

    def _open(self) -> None:
        if self._seq is not None:
            return
        # The capture daemon may still be creating the directory, the first
        # index lines and the first frame pair. Wait for the first
        # associated frame, not just the layout: TumSequence adapts the
        # intrinsics to the size of the first depth image, so opening an
        # empty capture would lock in an unadapted calibration.
        deadline = time.monotonic() + self.wait_for_dir
        while True:
            try:
                seq = TumSequence(self.dir, **self._tum_kwargs)
                if len(seq) > 0:
                    self._seq = seq
                    return
            except (FileNotFoundError, IOError):
                pass
            if self._stopped or time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no frames appeared in {self.dir!r} within "
                    f"{self.wait_for_dir:.0f}s"
                )
            time.sleep(self.poll_interval)

    def frames(self) -> Iterator[Frame]:
        self._open()
        seq = self._seq
        watermark = -np.inf  # newest rgb timestamp yielded
        last_new = time.monotonic()
        while True:
            try:
                n = seq.refresh()
            except (FileNotFoundError, IOError):
                # An index file mid-rewrite by the capture daemon; retry.
                n = 0
            progressed = False
            for i in range(n):
                t = seq._items[i][0]
                if t <= watermark:
                    continue  # already yielded, or arrived late (dropped)
                try:
                    frame = seq[i]
                except IOError:
                    # The index line exists but a PNG is still being
                    # written: stop at this frame, retry at the next poll.
                    break
                watermark = t
                progressed = True
                yield frame
            if progressed:
                last_new = time.monotonic()
            elif self._stopped or (time.monotonic() - last_new > self.idle_timeout):
                return
            else:
                time.sleep(self.poll_interval)
