"""Trajectory metrics: the JAX package's numpy-only ``eval/metrics.py``,
loaded by path (see ``_pathload.py``)."""

from .._pathload import load_reference

_metrics = load_reference("eval/metrics.py")

absolute_trajectory_error = _metrics.absolute_trajectory_error

__all__ = ["absolute_trajectory_error"]
