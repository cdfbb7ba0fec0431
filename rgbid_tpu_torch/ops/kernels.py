"""The IRLS kernels' wrappers, their plain versions and their counts.

- ``esm_residuals_and_normal_eq``: counterpart of
  ``rgbid_tpu/ops/pallas_kernels.py::esm_residuals_and_normal_eq_pallas``
  (kernel ``_esm_kernel``), launching ``csrc/esm_normal_eq.cu``.
- ``ic_sigma_stats`` and ``ic_normal_eq``: counterparts of ``sigma_stats``
  (``_sigma_kernel``) and ``normal_eq`` (``_normal_kernel``), launching
  ``csrc/ic_normal_eq.cu``; ``residuals_and_normal_eq`` chains them as
  ``residuals_and_normal_eq_pallas`` does.

On a CPU tensor each runs its plain PyTorch version (ops/gauss_newton.py);
on a CUDA tensor it launches its kernel or raises. There is no other path:
no fallback, no switch. ``<wrapper>.launches`` counts kernel launches.

The TPU-only tiling of the Pallas wrappers (row tiles, padding to 8 or 16
rows) is not carried over: one thread per template pixel needs none.
"""

from __future__ import annotations

import torch

from ..core.camera import Intrinsics
from . import _build
from .gauss_newton import IrlsResult, SigmaStats, normal_eq_plain, sigma_stats_plain
from .gauss_newton import esm_residuals_and_normal_eq as esm_residuals_and_normal_eq_plain
from .gauss_newton import residuals_and_normal_eq as residuals_and_normal_eq_plain

_THREADS = 256  # irls::kThreads in csrc/irls_common.cuh
_SUMS = 32
_SIGMA_SUMS = 3


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
    partials = _partials(n, _SUMS, dev)
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
    return _irls_result(out)


def _partials(n: int, sums: int, dev) -> torch.Tensor:
    """The (n_blocks, sums) per-block partials of a one-thread-per-pixel pass."""
    n_blocks = (n + _THREADS - 1) // _THREADS
    return torch.empty((max(n_blocks, 1), sums), dtype=torch.float32, device=dev)


def _irls_result(out: torch.Tensor) -> IrlsResult:
    """Views of the 48 floats written by irls::normal_finalize."""
    return IrlsResult(
        H=out[0:36].view(6, 6),
        b=out[36:42],
        sigma2_int=out[42],
        sigma2_xi=out[43],
        error=out[44],
        n_valid=out[45],
        inlier_frac=out[46],
    )


def _device_kind(T: torch.Tensor, what: str) -> str:
    if T.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {T.device}")
    return T.device.type


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
    args = (T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap)
    if _device_kind(T, "ESM") == "cpu":
        return esm_residuals_and_normal_eq_plain(*args)
    return _esm_cuda(*args)


esm_residuals_and_normal_eq.launches = 0


# ---------------------------------------------------------------------------
# IC: csrc/ic_normal_eq.cu


def _ic_check(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, sigma2_int, sigma2_xi):
    dev = T.device
    th, tw = kf_int.shape
    require = _build.require
    require(T, "T", dev, (4, 4))
    for name, t in (("kf_int", kf_int), ("Px", kf_points[0]), ("Py", kf_points[1]),
                    ("Pz", kf_points[2]), ("kf_mask", kf_mask)):
        require(t, name, dev, (th, tw))
    require(cur_int, "cur_int", dev)
    if cur_int.dim() != 2:
        raise ValueError(f"cur_int must be (H, W), got {tuple(cur_int.shape)}")
    require(cur_xi, "cur_xi", dev, cur_int.shape)
    require(cur_mask, "cur_mask", dev, cur_int.shape)
    require(sigma2_int, "sigma2_int", dev, ())
    require(sigma2_xi, "sigma2_xi", dev, ())


def _ic_params(n: int, cur_int, intr: Intrinsics, nu, gate_sigmas, use_geometric):
    h, w = cur_int.shape
    return _build.IcParams(
        n=n, h=h, w=w, use_geometric=int(bool(use_geometric)),
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        nu=nu, nu1=nu + 1.0, gate2=gate_sigmas**2, umax=w - 1.001, vmax=h - 1.001,
    )


def _ic_sigma_cuda(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr, nu,
                   sigma2_int, sigma2_xi, use_geometric) -> SigmaStats:
    _ic_check(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, sigma2_int, sigma2_xi)
    dev = T.device
    n = kf_int.numel()
    partials = _partials(n, _SIGMA_SUMS, dev)
    out = torch.empty((5,), dtype=torch.float32, device=dev)
    Px, Py, Pz = kf_points
    status = _build.library().ic_sigma_launch(
        _ic_params(n, cur_int, intr, nu, 3.0, use_geometric),
        T.data_ptr(), sigma2_int.data_ptr(), sigma2_xi.data_ptr(), kf_int.data_ptr(),
        Px.data_ptr(), Py.data_ptr(), Pz.data_ptr(), kf_mask.data_ptr(), cur_int.data_ptr(),
        cur_xi.data_ptr(), cur_mask.data_ptr(), partials.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "ic_sigma_launch")
    ic_sigma_stats.launches += 1
    return SigmaStats(*out.unbind())


def _ic_normal_cuda(T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
                    sigma2_int, sigma2_xi, use_geometric, gate_sigmas, lagged) -> IrlsResult:
    _ic_check(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, sigma2_int, sigma2_xi)
    dev = T.device
    _build.require(jac12, "jac12", dev, (12,) + tuple(kf_int.shape))
    n = kf_int.numel()
    partials = _partials(n, _SUMS, dev)
    out = torch.empty((48,), dtype=torch.float32, device=dev)
    Px, Py, Pz = kf_points
    status = _build.library().ic_normal_launch(
        _ic_params(n, cur_int, intr, nu, gate_sigmas, use_geometric), int(bool(lagged)),
        T.data_ptr(), sigma2_int.data_ptr(), sigma2_xi.data_ptr(), kf_int.data_ptr(),
        Px.data_ptr(), Py.data_ptr(), Pz.data_ptr(), kf_mask.data_ptr(), jac12.data_ptr(),
        cur_int.data_ptr(), cur_xi.data_ptr(), cur_mask.data_ptr(), partials.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "ic_normal_launch")
    ic_normal_eq.launches += 1
    return _irls_result(out)


def ic_sigma_stats(
    T: torch.Tensor,
    kf_int: torch.Tensor,
    kf_points: tuple,
    kf_mask: torch.Tensor,
    cur_int: torch.Tensor,
    cur_xi: torch.Tensor,
    cur_mask: torch.Tensor,
    intr: Intrinsics,
    nu: float,
    sigma2_int: torch.Tensor,
    sigma2_xi: torch.Tensor,
    use_geometric: bool = True,
) -> SigmaStats:
    """One Student-t scale step (see ``sigma_stats_plain``). The device of
    ``T`` decides: CPU runs the plain version, CUDA the kernel. On CUDA the
    template planes (Ht, Wt) and current planes (H, W) must be contiguous
    float32 on the same card, the scales 0-d tensors."""
    args = (T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr, nu,
            sigma2_int, sigma2_xi, use_geometric)
    if _device_kind(T, "IC sigma") == "cpu":
        return sigma_stats_plain(*args)
    return _ic_sigma_cuda(*args)


def ic_normal_eq(
    T: torch.Tensor,
    kf_int: torch.Tensor,
    kf_points: tuple,
    kf_mask: torch.Tensor,
    jac12: torch.Tensor,
    cur_int: torch.Tensor,
    cur_xi: torch.Tensor,
    cur_mask: torch.Tensor,
    intr: Intrinsics,
    nu: float,
    sigma2_int: torch.Tensor,
    sigma2_xi: torch.Tensor,
    use_geometric: bool = True,
    gate_sigmas: float = 3.0,
    lagged: bool = True,
) -> IrlsResult:
    """One IC normal-equation pass from the stored (12, Ht, Wt) field (see
    ``normal_eq_plain``); devices and layouts as ``ic_sigma_stats``."""
    args = (T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, lagged)
    if _device_kind(T, "IC normal-equation") == "cpu":
        return normal_eq_plain(*args)
    return _ic_normal_cuda(*args)


def residuals_and_normal_eq(
    T: torch.Tensor,
    kf_int: torch.Tensor,
    kf_points: tuple,
    kf_mask: torch.Tensor,
    jac12: torch.Tensor,
    cur_int: torch.Tensor,
    cur_xi: torch.Tensor,
    cur_mask: torch.Tensor,
    intr: Intrinsics,
    nu: float,
    sigma2_int: torch.Tensor,
    sigma2_xi: torch.Tensor,
    sigma_iters: int,
    use_geometric: bool = True,
    gate_sigmas: float = 3.0,
    sigma_mode: str = "exact",
) -> IrlsResult:
    """One IC IRLS evaluation (see ops/gauss_newton.py for the contract).

    CPU runs the plain version. CUDA runs ``max(sigma_iters, 1)`` sigma
    kernel launches in exact mode, each reading the scales the previous one
    wrote, then one normal-equation launch; nothing reads back to the host."""
    if _device_kind(T, "IC") == "cpu":
        return residuals_and_normal_eq_plain(
            T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
            sigma2_int, sigma2_xi, sigma_iters, use_geometric, gate_sigmas, sigma_mode,
        )
    exact = sigma_mode == "exact"
    if exact:
        for _ in range(max(sigma_iters, 1)):
            st = _ic_sigma_cuda(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr,
                                nu, sigma2_int, sigma2_xi, use_geometric)
            sigma2_int, sigma2_xi = st.sigma2_int, st.sigma2_xi
    return _ic_normal_cuda(T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask,
                           intr, nu, sigma2_int, sigma2_xi, use_geometric, gate_sigmas,
                           lagged=not exact)


ic_sigma_stats.launches = 0
ic_normal_eq.launches = 0
