"""Load the JAX package's host-only modules by file path.

Importing anything under ``rgbid_tpu`` runs ``rgbid_tpu/__init__.py``,
which imports ``core/__init__.py`` and with it ``_precision.py`` and
``import jax``. The modules loaded here import only the standard library
and numpy, so loading their files directly, under private module names,
shares one source of truth (the config, its JSON and hash, the numpy SE(3)
helpers, the map/trajectory writers, the trajectory metrics) without
pulling JAX into the port.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

_REFERENCE_ROOT = Path(__file__).resolve().parent.parent / "rgbid_tpu"


def load_reference(relpath: str) -> ModuleType:
    """Load ``rgbid_tpu/<relpath>`` as a standalone module (cached)."""
    name = "_rgbid_reference_" + relpath.replace("/", "_").removesuffix(".py")
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    path = _REFERENCE_ROOT / relpath
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load reference module {path}")
    mod = importlib.util.module_from_spec(spec)
    # Registered before exec: dataclasses resolves the module by name
    # while the class bodies run.
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod
