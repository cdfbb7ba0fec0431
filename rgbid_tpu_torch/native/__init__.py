"""Native C++ host components (ctypes bindings).

The port's counterpart of ``rgbid_tpu/native/__init__.py``: pose-graph
normal-system assembly (the O(E) small-matrix loop) and batched Hamming
descriptor distances, from ``pose_graph.cpp`` (a copy of the JAX package's
source), PNG row unfiltering from ``png_unfilter.cpp`` and the frame's
host packing from ``pack_frame.cpp`` (the port's own). The numpy
implementations stay as oracles (backend/pose_graph.py,
backend/place_recognition.py, datasets/png.py, tracking/step.py).

The shared library is built with ``g++`` at first use, never at import,
into ``build/rgbid_tpu_torch/`` at the repository root (the directory of
the CUDA kernels' library), named by a hash of the source and flags;
nothing is written next to the source. One rule decides who uses it:
``toolchain()`` is the path of ``g++`` or None. With a toolchain the
wrappers build and load the library, and a build or load that fails
raises ``RuntimeError``; there is no quiet fall back to numpy. Without one
the wrappers raise, and ``place_recognition.hamming_distances``,
``png.unfilter`` and ``step.pack_frame`` / ``step.gray_from_rgb`` (the
callers with a numpy twin on their path) take numpy because
``toolchain()`` is None.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SOURCES = tuple(Path(__file__).resolve().parent / f
                 for f in ("pose_graph.cpp", "png_unfilter.cpp", "pack_frame.cpp"))
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "rgbid_tpu_torch"
# No -march=native: a build directory copied to another machine must still load.
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


@functools.cache
def toolchain():
    """Path of the C++ compiler the library is built with, or None. Looked
    up once a process: ``pack_frame`` asks on every frame, and a PATH
    search costs tens of microseconds."""
    return shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslamnative_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = toolchain()
    if cxx is None:
        raise RuntimeError("g++ not found: the native pose-graph library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        tmp = work / out.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(src) for src in _SOURCES)]
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
        lib.png_unfilter.restype = i
        lib.png_unfilter.argtypes = [pu8, i, i, i, pu8]
        vp = ctypes.c_void_p
        z = ctypes.c_ssize_t
        lib.pack_gray.restype = None
        lib.pack_gray.argtypes = [vp, z, z, z, i, i, i, vp, z]
        lib.pack_u16.restype = None
        lib.pack_u16.argtypes = [vp, z, z, z, i, vp, z, z, i, i, vp]
        _lib = lib
        return _lib


def available() -> bool:
    """False when there is no toolchain; else True once ``load()``
    succeeds. A failed build or load raises ``RuntimeError`` here too: it
    never turns into a quiet False."""
    if toolchain() is None:
        return False
    load()
    return True


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


def png_unfilter(raw: np.ndarray, stride: int, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered PNG rows -> (h, stride) uint8 image bytes.
    Raises ValueError naming the first row whose filter byte is not 0-4."""
    lib = load()
    raw = np.ascontiguousarray(raw, np.uint8)
    h = raw.shape[0]
    out = np.empty((h, stride), np.uint8)
    bad = lib.png_unfilter(raw.reshape(-1), h, stride, bpp, out.reshape(-1))
    if bad:
        raise ValueError(f"row {bad - 1} has filter type {raw[bad - 1, 0]} (0-4 allowed)")
    return out


def _frame_args(frame: np.ndarray) -> tuple:
    """(address, row, pixel and channel strides in bytes, channels) of a
    uint8 (h, w) gray or (h, w, >= 3) colour frame, as ``pack_frame.cpp``
    reads it; 1 channel is copied, 3 give the luma."""
    if frame.dtype != np.uint8 or not (frame.ndim == 2 or (frame.ndim == 3 and frame.shape[2] >= 3)):
        raise ValueError(f"expected a uint8 (h, w) or (h, w, >= 3) frame, got {frame.dtype} "
                         f"{frame.shape}")
    rs, ps = frame.strides[:2]
    if frame.ndim == 2:
        return frame.ctypes.data, rs, ps, 0, 1
    return frame.ctypes.data, rs, ps, frame.strides[2], 3


def pack_gray(frame: np.ndarray, out: np.ndarray) -> None:
    """Write the gray of ``frame`` (``_frame_args``; its luma, or itself if
    gray) into ``out``, a uint8 (h, w) array of unit pixel stride whose rows
    may lie apart (the u12 codec's gray columns)."""
    lib = load()
    h, w = out.shape
    if (frame.shape[:2] != (h, w) or out.dtype != np.uint8 or (w > 1 and out.strides[1] != 1)
            or not out.flags.writeable):
        raise ValueError(f"frame {frame.shape} and gray {out.dtype} {out.shape} / "
                         f"{out.strides} (writeable {out.flags.writeable}) do not match")
    lib.pack_gray(*_frame_args(frame), h, w, out.ctypes.data, out.strides[0])


def pack_u16(frame: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """The "u16" codec's (3, h, w) buffer [gray, depth low byte, depth high
    byte] in one pass: ``frame`` as ``pack_gray`` takes it, ``depth`` an
    (h, w) array of 2-byte items, its bytes in memory order."""
    lib = load()
    h, w = depth.shape
    if frame.shape[:2] != (h, w) or depth.dtype.itemsize != 2:
        raise ValueError(f"frame {frame.shape} and depth {depth.dtype} {depth.shape} do not "
                         f"match: the depth needs (h, w) 2-byte items")
    out = np.empty((3, h, w), np.uint8)
    lib.pack_u16(*_frame_args(frame), depth.ctypes.data, *depth.strides, h, w, out.ctypes.data)
    return out
