"""Carry tracking state between the JAX package and the port.

The JAX package's ``DeviceKeyframe`` / ``MotionState`` come in as the same
NamedTuples with numpy leaves (``jax.tree_util.tree_map(np.asarray, x)``);
any object with the same field names works, so this module imports no JAX.
bfloat16 leaves convert exactly to float32. A keyframe level's ``jac`` may
hold either template layout, the (4, H, W) ESM gradients or the (12, H, W)
IC Jacobian field: nothing here depends on the plane count. The
``*_to_numpy`` functions go back: the port's state as numpy arrays under
the same field names.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .mapping.keyframe import DeviceKeyframe
from .tracking.frames import KeyframeLevel
from .tracking.step import MotionState


class HostKeyframe(NamedTuple):
    levels: Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray], ...]  # (I, xi, mask, jac)
    var: np.ndarray
    fused_count: int
    hits: np.ndarray
    mask_full: np.ndarray


class HostMotion(NamedTuple):
    T_ck: np.ndarray
    delta: np.ndarray
    lost_count: np.ndarray
    cons_excluded: np.ndarray


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def keyframe_from_reference(kf, device) -> DeviceKeyframe:
    """The JAX package's DeviceKeyframe (numpy leaves) -> the port's."""
    levels = tuple(
        KeyframeLevel(_t(l.intensity, device), _t(l.xi, device), _t(l.mask, device),
                      _t(l.jac, device))
        for l in kf.levels
    )
    return DeviceKeyframe(
        levels=levels,
        var=_t(kf.var, device),
        fused_count=torch.from_numpy(np.asarray(kf.fused_count, np.int32).reshape(())).to(device),
        hits=_t(kf.hits, device),
        mask_full=_t(kf.mask_full, device),
    )


def keyframe_to_numpy(kf: DeviceKeyframe) -> HostKeyframe:
    return HostKeyframe(
        levels=tuple((_n(l.intensity), _n(l.xi), _n(l.mask), _n(l.jac)) for l in kf.levels),
        var=_n(kf.var),
        fused_count=int(_n(kf.fused_count)),
        hits=_n(kf.hits),
        mask_full=_n(kf.mask_full),
    )


def motion_from_reference(m, device) -> MotionState:
    """The JAX package's MotionState (numpy leaves) -> the port's, the
    consensus streaks (cons_excluded) a float32 device vector like the rest;
    a state without them (None) keeps None."""
    streaks = getattr(m, "cons_excluded", None)
    return MotionState(
        T_ck=_t(m.T_ck, device),
        delta=_t(m.delta, device),
        lost_count=_t(m.lost_count, device).reshape(()),
        cons_excluded=None if streaks is None else _t(streaks, device),
    )


def motion_to_numpy(m: MotionState) -> HostMotion:
    streaks = None if m.cons_excluded is None else _n(m.cons_excluded).astype(np.float32)
    return HostMotion(_n(m.T_ck), _n(m.delta), _n(m.lost_count), streaks)
