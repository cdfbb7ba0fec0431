"""Build the repository's CUDA sources with nvcc and bind them with ctypes.

The sources under ``rgbid_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers), so nvcc builds them in seconds: one nvcc process per
source, all started together, then one link. The shared library goes to
``build/rgbid_tpu_torch/`` at the repository root, named by a hash of the
sources, headers and flags: the first call in a process builds it if that
file is missing, later calls load it. Nothing here runs at import.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so the kernels'
per-pixel float arithmetic rounds exactly like the plain PyTorch versions
they are checked against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / f for f in ("consensus_vote.cu", "esm_normal_eq.cu",
                                             "esm_stratified.cu", "fusion.cu", "ic_normal_eq.cu",
                                             "irls_solve.cu"))
HEADERS = tuple(_PKG / "csrc" / f for f in ("esm_pixel.cuh", "fusion_pixel.cuh",
                                            "irls_common.cuh", "irls_solve.cuh"))
BUILD_DIR = _PKG.parent / "build" / "rgbid_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
)


class EsmParams(ctypes.Structure):
    """By-value parameters of ``esm_irls_launch`` and ``esm_stratified_launch``
    (csrc/esm_pixel.cuh)."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("use_geometric", ctypes.c_int),
        ("occlusion_gate", ctypes.c_int),
        ("fx", ctypes.c_float),
        ("fy", ctypes.c_float),
        ("cx", ctypes.c_float),
        ("cy", ctypes.c_float),
        ("nu", ctypes.c_float),
        ("nu1", ctypes.c_float),
        ("gate2", ctypes.c_float),
        ("occ_a", ctypes.c_float),
        ("occ_b", ctypes.c_float),
        ("cap2", ctypes.c_float),
        ("umax", ctypes.c_float),
        ("vmax", ctypes.c_float),
        ("damping", ctypes.c_float),
        ("tol", ctypes.c_float),
    ]


MAX_STRATA = 16  # kMaxStrata in csrc/esm_stratified.cu


class StrataParams(ctypes.Structure):
    """By-value stratum edges of ``esm_stratified_launch``
    (csrc/esm_stratified.cu)."""

    _fields_ = [
        ("k", ctypes.c_int),
        ("edges", ctypes.c_float * (MAX_STRATA + 1)),
    ]


class IcParams(ctypes.Structure):
    """By-value parameters of ``ic_sigma_launch`` and ``ic_irls_launch``
    (csrc/ic_normal_eq.cu)."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("use_geometric", ctypes.c_int),
        ("fx", ctypes.c_float),
        ("fy", ctypes.c_float),
        ("cx", ctypes.c_float),
        ("cy", ctypes.c_float),
        ("nu", ctypes.c_float),
        ("nu1", ctypes.c_float),
        ("gate2", ctypes.c_float),
        ("umax", ctypes.c_float),
        ("vmax", ctypes.c_float),
        ("damping", ctypes.c_float),
        ("tol", ctypes.c_float),
    ]


class VoteParams(ctypes.Structure):
    """By-value parameters of ``consensus_vote_launch``
    (csrc/consensus_vote.cu)."""

    _fields_ = [
        ("k", ctypes.c_int),
        ("tol", ctypes.c_float),
        ("min_frac", ctypes.c_float),
        ("err_ratio", ctypes.c_float),
        ("err_floor", ctypes.c_float),
        ("trigger_frac", ctypes.c_float),
        ("max_frac", ctypes.c_float),
        ("persist", ctypes.c_int),
        ("attack_probe", ctypes.c_int),
    ]


MAX_COARSE = 7  # fusion::kMaxCoarse in csrc/fusion_pixel.cuh


class FusionParams(ctypes.Structure):
    """By-value parameters of ``fusion_launch`` (csrc/fusion_pixel.cuh)."""

    _fields_ = [
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("grow", ctypes.c_int),
        ("n_coarse", ctypes.c_int),
        ("cov_rs", ctypes.c_int),
        ("cov_cs", ctypes.c_int),
        ("fx", ctypes.c_float),
        ("fy", ctypes.c_float),
        ("cx", ctypes.c_float),
        ("cy", ctypes.c_float),
        ("inv_fx", ctypes.c_float),
        ("inv_fy", ctypes.c_float),
        ("umax", ctypes.c_float),
        ("vmax", ctypes.c_float),
        ("sensor_var", ctypes.c_float),
        ("gate_k2", ctypes.c_float),
        ("min_var", ctypes.c_float),
        ("max_var", ctypes.c_float),
        ("claim_tol", ctypes.c_float),
        ("claim_infl", ctypes.c_float),
        ("trans_var", ctypes.c_float),
        ("rot_var", ctypes.c_float),
        ("ch", ctypes.c_int * MAX_COARSE),
        ("cw", ctypes.c_int * MAX_COARSE),
        ("coarse", ctypes.c_void_p * MAX_COARSE),
    ]


class Library:
    """The loaded kernels plus what building them printed and cost."""

    def __init__(self, path: Path, log: str, build_s: float):
        self.path = path
        self.log = log
        self.build_s = build_s
        lib = ctypes.CDLL(str(path))
        P = ctypes.c_void_p
        I = ctypes.c_int
        lib.consensus_vote_launch.argtypes = [VoteParams] + [P] * 8
        lib.consensus_vote_launch.restype = I
        lib.esm_irls_launch.argtypes = [EsmParams, I, I, I] + [P] * 18
        lib.esm_irls_launch.restype = I
        lib.esm_stratified_launch.argtypes = [EsmParams, StrataParams, I, I, I] + [P] * 15
        lib.esm_stratified_launch.restype = I
        lib.fusion_launch.argtypes = [FusionParams, I] + [P] * 17
        lib.fusion_launch.restype = I
        lib.ic_sigma_launch.argtypes = [IcParams, I] + [P] * 15
        lib.ic_sigma_launch.restype = I
        lib.ic_irls_launch.argtypes = [IcParams, I, I, I] + [P] * 19
        lib.ic_irls_launch.restype = I
        lib.irls_solve_launch.argtypes = [ctypes.c_float] * 3 + [P] * 8
        lib.irls_solve_launch.restype = I
        self.consensus_vote_launch = lib.consensus_vote_launch
        self.esm_irls_launch = lib.esm_irls_launch
        self.esm_stratified_launch = lib.esm_stratified_launch
        self.fusion_launch = lib.fusion_launch
        self.ic_sigma_launch = lib.ic_sigma_launch
        self.ic_irls_launch = lib.ic_irls_launch
        self.irls_solve_launch = lib.irls_solve_launch
        self._lib = lib


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of rgbid_tpu_torch are built on the machine with the card"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile_and_link(out: Path) -> str:
    """nvcc -c for every source in parallel, then nvcc -shared; returns the
    compilers' output. The library appears at ``out`` atomically."""
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    procs = []
    try:
        for src in SOURCES:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        log = ""
        for cmd, proc in procs:
            text = proc.communicate()[0]
            log += text
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        tmp = work / out.name
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(work / f"{s.stem}.o") for s in SOURCES)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        return log
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


_LIBRARY: Library | None = None


def library() -> Library:
    """Build (if needed) and load the kernels; cached for the process."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out = BUILD_DIR / f"librgbid_kernels_{_digest()}.so"
    log, build_s = "", 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile_and_link(out)
        build_s = time.perf_counter() - t0
    _LIBRARY = Library(out, log, build_s)
    return _LIBRARY


def require(t, name: str, device, shape=None, contiguous: bool = True,
            dtypes=(torch.float32,)) -> None:
    """Check a kernel argument: device, dtype (float32 unless the kernel
    has an instantiation for others), contiguous (unless the kernel takes
    its strides), shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name} must be {names}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def check(status: int, name: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
