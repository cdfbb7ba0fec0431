"""Native C++ host components (ctypes bindings).

The port's counterpart of ``rgbid_tpu/native/__init__.py``: pose-graph
normal-system assembly (the O(E) small-matrix loop) and batched Hamming
descriptor distances, from ``pose_graph.cpp`` (a copy of the JAX package's
source). The numpy implementations stay as oracles
(backend/pose_graph.py, backend/place_recognition.py).

The shared library is built with ``g++`` at first use, never at import,
into ``build/rgbid_tpu_torch/`` at the repository root (the directory of
the CUDA kernels' library), named by a hash of the source and flags;
nothing is written next to the source. One rule decides who uses it:
``toolchain()`` is the path of ``g++`` or None. With a toolchain the
wrappers build and load the library, and a build or load that fails
raises ``RuntimeError``; there is no quiet fall back to numpy. Without one
the wrappers raise, and ``place_recognition.hamming_distances`` (the only
caller with a numpy twin on its path) takes numpy because
``toolchain()`` is None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "pose_graph.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "rgbid_tpu_torch"
# No -march=native: a build directory copied to another machine must still load.
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def toolchain():
    """Path of the C++ compiler the library is built with, or None."""
    return shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libslamnative_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = toolchain()
    if cxx is None:
        raise RuntimeError("g++ not found: the native pose-graph library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        tmp = work / out.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({run.returncode}):\n{' '.join(cmd)}\n{run.stdout}{run.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load():
    """Build (if needed) and load the library; cached for the process.
    Raises RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise RuntimeError(f"cannot load {out}: {e}") from e
        d = ctypes.c_double
        i = ctypes.c_int
        pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.pg_build_system.restype = d
        lib.pg_build_system.argtypes = [pd, i, pi, pi, pd, pd, pu8, i, d, pd, pd]
        lib.pg_total_error.restype = d
        lib.pg_total_error.argtypes = [pd, i, pi, pi, pd, pd, i]
        lib.pg_apply_updates.restype = None
        lib.pg_apply_updates.argtypes = [pd, i, pd, pu8]
        lib.hamming_batch.restype = None
        lib.hamming_batch.argtypes = [pu8, i, pu8, i, i, pi]
        _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# numpy-facing wrappers


def _poses_c(poses) -> np.ndarray:
    return np.ascontiguousarray(np.stack(poses).reshape(len(poses), 16), np.float64)


def pg_build_system(poses, e_from, e_to, e_T, e_info, e_robust, huber_delta):
    """Returns (H (6N,6N), b (6N,), robust_total_error)."""
    lib = load()
    n = len(poses)
    dim = 6 * n
    H = np.zeros((dim, dim), np.float64)
    b = np.zeros(dim, np.float64)
    err = lib.pg_build_system(
        _poses_c(poses).reshape(-1),
        n,
        np.ascontiguousarray(e_from, np.int32),
        np.ascontiguousarray(e_to, np.int32),
        np.ascontiguousarray(e_T, np.float64).reshape(-1),
        np.ascontiguousarray(e_info, np.float64).reshape(-1),
        np.ascontiguousarray(e_robust, np.uint8),
        len(e_from),
        float(huber_delta),
        H.reshape(-1),
        b,
    )
    return H, b, float(err)


def pg_total_error(poses, e_from, e_to, e_T, e_info):
    lib = load()
    return float(
        lib.pg_total_error(
            _poses_c(poses).reshape(-1),
            len(poses),
            np.ascontiguousarray(e_from, np.int32),
            np.ascontiguousarray(e_to, np.int32),
            np.ascontiguousarray(e_T, np.float64).reshape(-1),
            np.ascontiguousarray(e_info, np.float64).reshape(-1),
            len(e_from),
        )
    )


def pg_apply_updates(poses, delta, fixed_mask):
    lib = load()
    n = len(poses)
    poses_c = _poses_c(poses)
    lib.pg_apply_updates(
        poses_c.reshape(-1),
        n,
        np.ascontiguousarray(delta, np.float64),
        np.ascontiguousarray(fixed_mask, np.uint8),
    )
    return [poses_c[i].reshape(4, 4).copy() for i in range(n)]


def hamming_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = load()
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    out = np.zeros((len(a), len(b)), np.int32)
    if len(a) and len(b):
        lib.hamming_batch(a, len(a), b, len(b), a.shape[1], out)
    return out
