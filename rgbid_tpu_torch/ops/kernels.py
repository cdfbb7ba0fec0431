"""The ESM normal-equation kernel's wrapper, its plain version and its count.

``esm_residuals_and_normal_eq`` is the counterpart of
``rgbid_tpu/ops/pallas_kernels.py::esm_residuals_and_normal_eq_pallas``
(kernel ``_esm_kernel``). On a CPU tensor it runs the plain PyTorch
version (``esm_residuals_and_normal_eq_plain``, from ops/gauss_newton.py);
on a CUDA tensor it launches ``csrc/esm_normal_eq.cu`` or raises. It has
no other path: no fallback, no switch.

``esm_residuals_and_normal_eq.launches`` counts kernel launches.

The TPU-only tiling of the Pallas wrapper (row tiles, padding to 8 or 16
rows) is not carried over: one thread per template pixel needs none.
"""

from __future__ import annotations

import torch

from ..core.camera import Intrinsics
from . import _build
from .gauss_newton import IrlsResult
from .gauss_newton import esm_residuals_and_normal_eq as esm_residuals_and_normal_eq_plain

_THREADS = 256  # kThreads in csrc/esm_normal_eq.cu
_SUMS = 32


def _esm_cuda(
    T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr: Intrinsics, nu,
    sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap,
) -> IrlsResult:
    dev = T.device
    th, tw = kf_int.shape
    c, h, w = cur_stack.shape
    if c not in (3, 5, 7):
        raise ValueError(f"current stack must have 3, 5 or 7 planes, got {c}")
    Px, Py, Pz = kf_points
    require = _build.require
    require(T, "T", dev, (4, 4))
    for name, t in (("kf_int", kf_int), ("Px", Px), ("Py", Py), ("Pz", Pz),
                    ("kf_mask", kf_mask)):
        require(t, name, dev, (th, tw))
    require(kf_grads, "kf_grads", dev, (4, th, tw))
    require(cur_stack, "cur_stack", dev)
    require(sigma2_int, "sigma2_int", dev, ())
    require(sigma2_xi, "sigma2_xi", dev, ())

    lib = _build.library()
    n = th * tw
    n_blocks = (n + _THREADS - 1) // _THREADS
    partials = torch.empty((max(n_blocks, 1), _SUMS), dtype=torch.float32, device=dev)
    out = torch.empty((48,), dtype=torch.float32, device=dev)
    p = _build.EsmParams(
        n=n, h=h, w=w, use_geometric=int(bool(use_geometric)),
        occlusion_gate=int(bool(occlusion_gate)),
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        nu=nu, nu1=nu + 1.0, gate2=gate_sigmas**2,
        occ_a=(2.0 * gate_sigmas) ** 2, occ_b=0.05**2, cap2=gate_cap * gate_cap,
        umax=w - 1.001, vmax=h - 1.001,
    )
    status = lib.esm_normal_eq_launch(
        p, c, T.data_ptr(), sigma2_int.data_ptr(), sigma2_xi.data_ptr(), kf_int.data_ptr(),
        Px.data_ptr(), Py.data_ptr(), Pz.data_ptr(), kf_mask.data_ptr(),
        kf_grads.data_ptr(), cur_stack.data_ptr(), partials.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "esm_normal_eq_launch")
    esm_residuals_and_normal_eq.launches += 1
    return IrlsResult(
        H=out[0:36].view(6, 6),
        b=out[36:42],
        sigma2_int=out[42],
        sigma2_xi=out[43],
        error=out[44],
        n_valid=out[45],
        inlier_frac=out[46],
    )


def esm_residuals_and_normal_eq(
    T: torch.Tensor,
    kf_int: torch.Tensor,
    kf_points: tuple,
    kf_mask: torch.Tensor,
    kf_grads: torch.Tensor,
    cur_stack: torch.Tensor,
    intr: Intrinsics,
    nu: float,
    sigma2_int: torch.Tensor,
    sigma2_xi: torch.Tensor,
    use_geometric: bool = True,
    gate_sigmas: float = 3.0,
    occlusion_gate: bool = False,
    gate_cap: float = 0.0,
) -> IrlsResult:
    """One ESM IRLS evaluation (see ops/gauss_newton.py for the contract).

    The device of ``T`` decides: CPU runs the plain version, CUDA the
    kernel. On CUDA every plane must be a contiguous float32 tensor on the
    same card: the template planes (Ht, Wt), ``kf_grads`` (4, Ht, Wt), the
    current stack (3|5|7, H, W), and the sigmas as 0-d tensors."""
    if T.device.type == "cpu":
        return esm_residuals_and_normal_eq_plain(
            T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate,
            gate_cap,
        )
    if T.device.type != "cuda":
        raise ValueError(f"no ESM kernel for device {T.device}")
    return _esm_cuda(
        T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
        sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap,
    )


esm_residuals_and_normal_eq.launches = 0
