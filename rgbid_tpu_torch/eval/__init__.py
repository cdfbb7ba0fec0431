"""Trajectory metrics (``metrics.py``, the port's numpy copy of the JAX
package's ``eval/metrics.py``), the gauntlet runner (``gauntlet.py``) and
its seed sweep (``seed_sweep.py``)."""

from .metrics import (  # noqa: F401
    absolute_trajectory_error,
    relative_pose_error,
    trajectory_from_tum_rows,
    umeyama_alignment,
)
