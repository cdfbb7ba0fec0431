"""The system configuration: the JAX package's own ``core/config.py``.

That file imports only the standard library, so it is loaded by path (see
``_pathload.py``) and re-exported: the port and the reference share one
``SlamConfig``, one JSON format and one ``config_hash``.
"""

from __future__ import annotations

from .._pathload import load_reference

_config = load_reference("core/config.py")

TrackingConfig = _config.TrackingConfig
KeyframeConfig = _config.KeyframeConfig
FusionConfig = _config.FusionConfig
BackendConfig = _config.BackendConfig
VizConfig = _config.VizConfig
SlamConfig = _config.SlamConfig

__all__ = [
    "TrackingConfig",
    "KeyframeConfig",
    "FusionConfig",
    "BackendConfig",
    "VizConfig",
    "SlamConfig",
]
