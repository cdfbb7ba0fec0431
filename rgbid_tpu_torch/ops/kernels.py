"""The IRLS kernels' wrappers, their plain versions and their counts.

- ``esm_irls_step``: one ESM IRLS iteration, the evaluation and the damped
  6x6 solve with the pose update, as one launch of ``csrc/esm_normal_eq.cu``:
  the counterpart of
  ``rgbid_tpu/ops/pallas_kernels.py::esm_residuals_and_normal_eq_pallas``
  (kernel ``_esm_kernel``) followed by ``ic_update``.
  ``esm_residuals_and_normal_eq`` makes the same launch and returns the
  evaluation alone.
- ``ic_irls_step``: one IC IRLS iteration as one launch of
  ``csrc/ic_normal_eq.cu``: the normal-equation pass with the solve and
  pose update (counterpart of ``normal_eq`` / ``_normal_kernel`` followed
  by ``ic_update``), in exact sigma mode preceded inside the same
  cooperative launch by ``max(sigma_iters, 1)`` phases of the Student-t
  scale step (counterpart of ``sigma_stats`` / ``_sigma_kernel``).
  ``ic_normal_eq`` and ``residuals_and_normal_eq`` make the same launch and
  return the evaluation alone.
- ``ic_sigma_stats``: one scale step alone, one launch (used by the checks;
  the tracker runs its scale steps inside ``ic_irls_step``).
- ``esm_stratified``: the motion-consensus vote's (K, 50) per-stratum ESM
  sums as one launch of ``csrc/esm_stratified.cu``; no Pallas kernel is
  behind it, it replaces the XLA reduction
  ``rgbid_tpu/ops/gauss_newton.py::stratified_normal_eq``.

On a CPU tensor each runs its plain PyTorch version (ops/gauss_newton.py),
and a step adds ``ic_update``; on a CUDA tensor it launches its kernel or
raises. There is no other path: no fallback, no switch.
``esm_residuals_and_normal_eq.launches``, ``ic_normal_eq.launches``,
``ic_sigma_stats.launches`` and ``esm_stratified.launches`` count kernel
launches, whichever wrapper made them; ``ic_normal_eq.sigma_phases`` counts
the scale steps run inside IC launches.

The launches share one per-card workspace (``workspace``): a (max_blocks,
32) block partials buffer, a (max_blocks + 1, 3) buffer of scale-step rows
and their published sums, the stratified kernel's (16 x 64, 50) block
partials, and three counter words (the last-block arrival count and the
exact-mode grid barrier's arrivals, both 0 between launches, and its
generation). The fusion kernel (mapping/fusion.py) uses it too.
Launches go on the launching thread's current stream, one after the
other; two launches on two streams at once would share the workspace, and
the port never makes them: the front end and the back end's scorer
(backend/relocalization.py) both launch on the default stream, each
thread's current stream unless it is changed.

The TPU-only tiling of the Pallas wrappers (row tiles, padding to 8 or 16
rows) is not carried over: a grid-stride loop over template pixels needs
none.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import Intrinsics
from . import _build
from .gauss_newton import STRATIFIED_SUMS, IrlsResult, SigmaStats, ic_update, normal_eq_plain
from .gauss_newton import sigma_stats_plain, stratified_sums
from .gauss_newton import esm_residuals_and_normal_eq as esm_residuals_and_normal_eq_plain
from .gauss_newton import residuals_and_normal_eq as residuals_and_normal_eq_plain

_SUMS = 32  # irls::kNormalSums
_SIGMA_SUMS = 3
_OUT = 48 + 16 + 6  # irls::kOut: result, T', delta
_BLOCKS_PER_SM = 3  # irls::kMinBlocksPerSm: the kernels' grid per SM at most
_STRATA_BLOCKS = 64  # the stratified kernel's blocks per stratum at most


class IrlsStep(NamedTuple):
    """One IRLS iteration: the updated pose, the evaluation at the incoming
    pose, and the applied step (zero when the update was suppressed)."""

    T: torch.Tensor  # (4, 4) orthonormalize(T . exp(-delta))
    result: IrlsResult
    delta: torch.Tensor  # (6,)


class Workspace(NamedTuple):
    max_blocks: int
    partials: torch.Tensor  # (max_blocks, 32) float32
    sigma_rows: torch.Tensor  # (max_blocks + 1, 3) float32: block rows, then the step's sums
    strata_partials: torch.Tensor  # (MAX_STRATA * _STRATA_BLOCKS, 50) float32
    counter: torch.Tensor  # (3,) int32: arrivals, barrier arrivals, barrier generation


_WORKSPACES: dict = {}
_WORKSPACE_LOCK = threading.Lock()


def workspace(dev: torch.device) -> Workspace:
    """The kernels' workspace on one card, made once."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    ws = _WORKSPACES.get(key)
    if ws is None:
        with _WORKSPACE_LOCK:
            return _WORKSPACES.get(key) or _make_workspace(key, dev)
    return ws


def _make_workspace(key: int, dev: torch.device) -> Workspace:
    sms = torch.cuda.get_device_properties(key).multi_processor_count
    max_blocks = _BLOCKS_PER_SM * sms
    ws = Workspace(
        max_blocks,
        torch.empty((max_blocks, _SUMS), dtype=torch.float32, device=dev),
        torch.empty((max_blocks + 1, _SIGMA_SUMS), dtype=torch.float32, device=dev),
        torch.empty((_build.MAX_STRATA * _STRATA_BLOCKS, STRATIFIED_SUMS),
                    dtype=torch.float32, device=dev),
        torch.zeros((3,), dtype=torch.int32, device=dev),
    )
    _WORKSPACES[key] = ws
    return ws


# The ESM launch count goes to ``esm_residuals_and_normal_eq.launches``, the
# per-frame path's count, unless the launching thread has named another
# owner: the back end's scorer launches from its own thread and keeps its
# own count, so that neither count loses an update to the other thread.
_COUNT = threading.local()


@contextlib.contextmanager
def count_launches_into(owner):
    """Within the block, this thread's ESM launches add to
    ``owner.launches`` instead of ``esm_residuals_and_normal_eq.launches``."""
    before = getattr(_COUNT, "owner", None)
    _COUNT.owner = owner
    try:
        yield owner
    finally:
        _COUNT.owner = before


def _irls_step(out: torch.Tensor) -> IrlsStep:
    """Views of the irls::kOut floats one fused launch writes (few view
    ops: each costs host time on every iteration)."""
    H, b, scalars, T, delta = out.split([36, 6, 6, 16, 6])
    s2i, s2x, err, n_valid, inl, _ = scalars.unbind()
    return IrlsStep(T.view(4, 4), IrlsResult(H.view(6, 6), b, s2i, s2x, err, n_valid, inl), delta)


def _plain_step(T, res: IrlsResult, damping: float) -> IrlsStep:
    T_out, delta = ic_update(T, res.H, res.b, damping, res.n_valid)
    return IrlsStep(T_out, res, delta)


def _device_kind(T: torch.Tensor, what: str) -> str:
    if T.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {T.device}")
    return T.device.type


# ---------------------------------------------------------------------------
# ESM: csrc/esm_normal_eq.cu


def _esm_params(n, cur_stack, intr: Intrinsics, nu, use_geometric, gate_sigmas, occlusion_gate,
                gate_cap=0.0, damping=0.0):
    _, h, w = cur_stack.shape
    return _build.EsmParams(
        n=n, h=h, w=w, use_geometric=int(bool(use_geometric)),
        occlusion_gate=int(bool(occlusion_gate)),
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        nu=nu, nu1=nu + 1.0, gate2=gate_sigmas**2,
        occ_a=(2.0 * gate_sigmas) ** 2, occ_b=0.05**2, cap2=gate_cap * gate_cap,
        umax=w - 1.001, vmax=h - 1.001, damping=damping,
    )


def _esm_cuda(
    T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr: Intrinsics, nu,
    sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap, damping,
) -> IrlsStep:
    dev = T.device
    th, tw = kf_int.shape
    c = cur_stack.shape[0]
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
    ws = workspace(dev)
    out = torch.empty((_OUT,), dtype=torch.float32, device=dev)
    p = _esm_params(th * tw, cur_stack, intr, nu, use_geometric, gate_sigmas, occlusion_gate,
                    gate_cap, damping)
    status = lib.esm_irls_launch(
        p, c, ws.max_blocks, T.data_ptr(), sigma2_int.data_ptr(), sigma2_xi.data_ptr(),
        kf_int.data_ptr(), Px.data_ptr(), Py.data_ptr(), Pz.data_ptr(), kf_mask.data_ptr(),
        kf_grads.data_ptr(), cur_stack.data_ptr(), ws.partials.data_ptr(),
        ws.counter.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "esm_irls_launch")
    owner = getattr(_COUNT, "owner", None) or esm_residuals_and_normal_eq
    owner.launches += 1
    return _irls_step(out)


def esm_irls_step(
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
    *,
    damping: float,
) -> IrlsStep:
    """One ESM IRLS iteration: the evaluation of
    ``esm_residuals_and_normal_eq`` at ``T``, then ``ic_update`` with
    ``damping``. CPU runs the plain versions; CUDA one kernel launch that
    reads nothing back to the host."""
    args = (T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap)
    if _device_kind(T, "ESM") == "cpu":
        return _plain_step(T, esm_residuals_and_normal_eq_plain(*args), damping)
    return _esm_cuda(*args, damping)


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
    kernel (the launch of ``esm_irls_step``; its pose update is dropped).
    On CUDA every plane must be a contiguous float32 tensor on the same
    card: the template planes (Ht, Wt), ``kf_grads`` (4, Ht, Wt), the
    current stack (3|5|7, H, W), and the sigmas as 0-d tensors."""
    args = (T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap)
    if _device_kind(T, "ESM") == "cpu":
        return esm_residuals_and_normal_eq_plain(*args)
    return _esm_cuda(*args, 0.0).result


esm_residuals_and_normal_eq.launches = 0


# ---------------------------------------------------------------------------
# The consensus vote's stratified sums: csrc/esm_stratified.cu


def _stratified_cuda(T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr: Intrinsics, nu,
                     sigma2_int, sigma2_xi, xi, edges, use_geometric, gate_sigmas,
                     occlusion_gate) -> torch.Tensor:
    dev = T.device
    th, tw = kf_int.shape
    c = cur_stack.shape[0]
    k = len(edges) - 1
    if c not in (3, 5, 7):
        raise ValueError(f"current stack must have 3, 5 or 7 planes, got {c}")
    if not 1 <= k <= _build.MAX_STRATA:
        raise ValueError(f"{k} strata: the kernel takes 1 to {_build.MAX_STRATA}")
    Px, Py, Pz = kf_points
    require = _build.require
    require(T, "T", dev, (4, 4))
    for name, t in (("kf_int", kf_int), ("Px", Px), ("Py", Py), ("Pz", Pz),
                    ("kf_mask", kf_mask), ("xi", xi)):
        require(t, name, dev, (th, tw))
    require(kf_grads, "kf_grads", dev, (4, th, tw))
    require(cur_stack, "cur_stack", dev)
    require(sigma2_int, "sigma2_int", dev, ())
    require(sigma2_xi, "sigma2_xi", dev, ())
    sp = _build.StrataParams(k=k)
    sp.edges[: k + 1] = [float(e) for e in edges]
    ws = workspace(dev)
    out = torch.empty((k, STRATIFIED_SUMS), dtype=torch.float32, device=dev)
    status = _build.library().esm_stratified_launch(
        _esm_params(th * tw, cur_stack, intr, nu, use_geometric, gate_sigmas, occlusion_gate),
        sp, c, _STRATA_BLOCKS, ws.strata_partials.shape[0], T.data_ptr(),
        sigma2_int.data_ptr(), sigma2_xi.data_ptr(), kf_int.data_ptr(), Px.data_ptr(),
        Py.data_ptr(), Pz.data_ptr(), kf_mask.data_ptr(), kf_grads.data_ptr(),
        cur_stack.data_ptr(), xi.data_ptr(), ws.strata_partials.data_ptr(),
        ws.counter.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "esm_stratified_launch")
    esm_stratified.launches += 1
    return out


def esm_stratified(
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
    xi: torch.Tensor,
    edges: np.ndarray,
    use_geometric: bool = True,
    gate_sigmas: float = 3.0,
    occlusion_gate: bool = True,
) -> torch.Tensor:
    """The (K, 50) per-stratum ESM sums of one consensus vote (columns as
    ``gauss_newton.STRATIFIED_SUMS``; ``unpack_stratified`` splits them),
    with the strata from the template inverse depth ``xi`` against the
    K+1 float32 host ``edges``. CPU runs the plain version
    (``stratified_sums`` on the one-hot strata); CUDA one launch, with the
    layouts of ``esm_residuals_and_normal_eq`` and ``xi`` (Ht, Wt)."""
    if _device_kind(T, "stratified ESM") == "cpu":
        from ..tracking.consensus import stratum_onehot

        strata = stratum_onehot(xi, kf_mask, torch.from_numpy(np.asarray(edges, np.float32)))
        return stratified_sums(T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
                               sigma2_int, sigma2_xi, strata, use_geometric, gate_sigmas,
                               occlusion_gate)
    return _stratified_cuda(T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
                            sigma2_int, sigma2_xi, xi, edges, use_geometric, gate_sigmas,
                            occlusion_gate)


esm_stratified.launches = 0


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


def _ic_params(n: int, cur_int, intr: Intrinsics, nu, gate_sigmas, use_geometric, damping=0.0):
    h, w = cur_int.shape
    return _build.IcParams(
        n=n, h=h, w=w, use_geometric=int(bool(use_geometric)),
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        nu=nu, nu1=nu + 1.0, gate2=gate_sigmas**2, umax=w - 1.001, vmax=h - 1.001,
        damping=damping,
    )


def _ic_sigma_cuda(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, intr, nu,
                   sigma2_int, sigma2_xi, use_geometric) -> SigmaStats:
    _ic_check(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, sigma2_int, sigma2_xi)
    dev = T.device
    n = kf_int.numel()
    ws = workspace(dev)
    out = torch.empty((5,), dtype=torch.float32, device=dev)
    Px, Py, Pz = kf_points
    status = _build.library().ic_sigma_launch(
        _ic_params(n, cur_int, intr, nu, 3.0, use_geometric), ws.max_blocks,
        T.data_ptr(), sigma2_int.data_ptr(), sigma2_xi.data_ptr(), kf_int.data_ptr(),
        Px.data_ptr(), Py.data_ptr(), Pz.data_ptr(), kf_mask.data_ptr(), cur_int.data_ptr(),
        cur_xi.data_ptr(), cur_mask.data_ptr(), ws.sigma_rows.data_ptr(), ws.counter.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "ic_sigma_launch")
    ic_sigma_stats.launches += 1
    return SigmaStats(*out.unbind())


def _ic_normal_cuda(T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
                    sigma2_int, sigma2_xi, use_geometric, gate_sigmas, lagged, damping,
                    sigma_steps: int = 0) -> IrlsStep:
    """One launch: ``sigma_steps`` scale phases (exact mode, a cooperative
    launch) or none, then the normal pass, the solve and the pose update."""
    _ic_check(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, sigma2_int, sigma2_xi)
    dev = T.device
    _build.require(jac12, "jac12", dev, (12,) + tuple(kf_int.shape))
    n = kf_int.numel()
    ws = workspace(dev)
    out = torch.empty((_OUT,), dtype=torch.float32, device=dev)
    Px, Py, Pz = kf_points
    status = _build.library().ic_irls_launch(
        _ic_params(n, cur_int, intr, nu, gate_sigmas, use_geometric, damping),
        int(bool(lagged)), sigma_steps, ws.max_blocks,
        T.data_ptr(), sigma2_int.data_ptr(), sigma2_xi.data_ptr(), kf_int.data_ptr(),
        Px.data_ptr(), Py.data_ptr(), Pz.data_ptr(), kf_mask.data_ptr(), jac12.data_ptr(),
        cur_int.data_ptr(), cur_xi.data_ptr(), cur_mask.data_ptr(), ws.partials.data_ptr(),
        ws.sigma_rows.data_ptr(), ws.counter.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "ic_irls_launch")
    ic_normal_eq.launches += 1
    ic_normal_eq.sigma_phases += sigma_steps
    return _irls_step(out)


def _ic_chain_cuda(T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
                   sigma2_int, sigma2_xi, sigma_iters, use_geometric, gate_sigmas, sigma_mode,
                   damping) -> IrlsStep:
    """One launch in either mode; exact mode runs ``max(sigma_iters, 1)``
    scale phases inside it, each weighting with the scales the previous one
    produced, and the normal pass weights with the last."""
    exact = sigma_mode == "exact"
    return _ic_normal_cuda(T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask,
                           intr, nu, sigma2_int, sigma2_xi, use_geometric, gate_sigmas,
                           not exact, damping, max(sigma_iters, 1) if exact else 0)


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
    ``T`` decides: CPU runs the plain version, CUDA one launch of the
    kernel. On CUDA the template planes (Ht, Wt) and current planes (H, W)
    must be contiguous float32 on the same card, the scales 0-d tensors."""
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
    ``normal_eq_plain``); devices and layouts as ``ic_sigma_stats``. On
    CUDA it is the fused launch of ``ic_irls_step``, its pose update
    dropped."""
    args = (T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, lagged)
    if _device_kind(T, "IC normal-equation") == "cpu":
        return normal_eq_plain(*args)
    return _ic_normal_cuda(*args, 0.0).result


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

    CPU runs the plain version. CUDA runs the launch of ``ic_irls_step``
    and returns the evaluation; nothing reads back to the host."""
    args = (T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
            sigma2_int, sigma2_xi, sigma_iters, use_geometric, gate_sigmas, sigma_mode)
    if _device_kind(T, "IC") == "cpu":
        return residuals_and_normal_eq_plain(*args)
    return _ic_chain_cuda(*args, 0.0).result


def ic_irls_step(
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
    *,
    damping: float,
) -> IrlsStep:
    """One IC IRLS iteration: the evaluation of ``residuals_and_normal_eq``
    at ``T``, then ``ic_update`` with ``damping``. CPU runs the plain
    versions; CUDA one launch in either sigma mode (exact mode runs its
    ``max(sigma_iters, 1)`` scale steps inside it), reading nothing back to
    the host."""
    args = (T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
            sigma2_int, sigma2_xi, sigma_iters, use_geometric, gate_sigmas, sigma_mode)
    if _device_kind(T, "IC") == "cpu":
        return _plain_step(T, residuals_and_normal_eq_plain(*args), damping)
    return _ic_chain_cuda(*args, damping)


ic_sigma_stats.launches = 0
ic_normal_eq.launches = 0
ic_normal_eq.sigma_phases = 0
