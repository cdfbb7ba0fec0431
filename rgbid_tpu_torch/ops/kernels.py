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
- ``ic_sigma_stats``: one scale step alone, one launch (the IC SPMD
  tracker's and the checks'; the tracker runs its scale steps inside
  ``ic_irls_step``).
- ``esm_stratified``: the motion-consensus vote's (K, 50) per-stratum ESM
  sums as one launch of ``csrc/esm_stratified.cu``; no Pallas kernel is
  behind it, it replaces the XLA reduction
  ``rgbid_tpu/ops/gauss_newton.py::stratified_normal_eq``.
- ``irls_solve_step``: the end of one IRLS iteration alone (the damped 6x6
  solve and the pose update from a 48-float result) as one launch of
  ``csrc/irls_solve.cu``, for the row-sharded trackers: an iteration of
  ``parallel/tracker_spmd.py`` is ``esm_result`` on every rank's band (the
  result-only ESM launch, as a 48-float vector), ``allreduce_irls`` across
  the ranks, then this launch; one of ``parallel/spmd.py`` is
  ``ic_sigma_stats``, an all-reduce of its sums, ``ic_result`` (the
  result-only lagged IC launch), ``allreduce_irls``, then this launch.
  No Pallas kernel is behind it; it replaces the XLA ``ic_update`` after
  ``gauss_newton.allreduce_irls`` in the JAX package's sharded tracker and
  the replicated solve of its ``SpmdTracker``.

On a CPU tensor each runs its plain PyTorch version (ops/gauss_newton.py),
and a step adds ``ic_update``; on a CUDA tensor it launches its kernel or
raises. There is no other path: no fallback, no switch.

Plane storage (``TrackingConfig.plane_dtype``): the ESM and stratified
kernels take the template intensity, the points and the current stack as
float32 or bfloat16 each, and dispatch on the tensors' dtypes to an
instantiation that loads that type (``_plane_types``); a mix without one
raises ``TypeError``. No plane is converted to float32 first.

Early exit (``TrackingConfig.early_exit_tol`` / ``conv_skip_tol``): the
IRLS steps take the previous iteration's ``IrlsStep`` (``prev``) and
``tol``. When ``tol > 0`` and ``step_norm(prev.delta) <= tol`` the
iteration is skipped and the step equals ``prev``: on the card the launch
returns at entry after copying ``prev``'s output, on the CPU the plain
version selects ``prev``'s output over the one it computed. The host
enqueues every launch of the budget and reads nothing.

Predicate (``go``, ``hold``): the ESM steps and evaluations and the solve
take a device int32 word; when it is 0 the step is ``hold`` (a step whose
output the launch copies), and nothing is evaluated on the card. The
consensus's masked reruns and rescue pyramid (tracking/tracker.py) are
enqueued on every frame and run only when their vote wrote 1 there; on the
CPU the plain version computes the step and selects. Steps given a level
``slot`` are counted per slot: launched on the host, run (neither skipped
nor held) on the device (``iteration_counts``); ``EVAL_SLOT`` counts the
rescue's level-0 evidence evaluations.
``esm_residuals_and_normal_eq.launches``, ``ic_normal_eq.launches``,
``ic_sigma_stats.launches``, ``esm_stratified.launches`` and
``irls_solve_step.launches`` count kernel launches, whichever wrapper made
them; ``ic_normal_eq.sigma_phases`` counts the scale steps run inside IC
launches.

The launches share one per-card workspace (``workspace``): a (max_blocks,
32) block partials buffer, a (max_blocks + 1, 3) buffer of scale-step rows
and their published sums, the stratified launch's (16, 16 x 50) cluster
rows, three counter words (the last-block arrival count and the
exact-mode grid barrier's arrivals, both 0 between launches, and its
generation), and the IRLS iterations run per level slot. The fusion kernel (mapping/fusion.py) uses it too. A
stratified launch is one pass over the template in thread-block clusters
of 16 blocks of 256 threads, one cluster per 4096 pixels (5 at the vote
layouts; at most 16, after which threads take more pixels), each block
with (8 + 16) x K x 50 floats of dynamic shared memory (76.8 KB at K =
16): its warps' rows, and in rank 0 the cluster's block rows. Each
cluster's rank 0 writes one cluster row; the last to arrive (the arrival
count) sums them.
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
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.camera import Intrinsics
from . import _build
from .gauss_newton import STRATIFIED_SUMS, IrlsResult, SigmaStats, ic_update, normal_eq_plain
from .gauss_newton import sigma_stats_plain, step_norm, stratified_sums
from .gauss_newton import esm_residuals_and_normal_eq as esm_residuals_and_normal_eq_plain
from .gauss_newton import residuals_and_normal_eq as residuals_and_normal_eq_plain

_SUMS = 32  # irls::kNormalSums
_SIGMA_SUMS = 3
_OUT = 48 + 16 + 6  # irls::kOut: result, T', delta
MAX_SLOTS = 8  # irls::kMaxSlots: level slots of the iteration counts
EVAL_SLOT = MAX_SLOTS - 1  # the slot of the rescue's evidence evaluations
_BLOCKS_PER_SM = 3  # irls::kMinBlocksPerSm: the kernels' grid per SM at most
_STRATA_CLUSTERS = 16  # a stratified launch's clusters at most


class IrlsStep(NamedTuple):
    """One IRLS iteration: the updated pose, the evaluation at the incoming
    pose, and the applied step (zero when the update was suppressed)."""

    T: torch.Tensor  # (4, 4) orthonormalize(T . exp(-delta))
    result: IrlsResult
    delta: torch.Tensor  # (6,)
    # The step's irls::kOut floats (result | T' | delta), which the views
    # above share: the next iteration's early exit reads its delta, and a
    # held launch copies it.
    out: Optional[torch.Tensor] = None


class Workspace(NamedTuple):
    max_blocks: int
    partials: torch.Tensor  # (max_blocks, 32) float32
    sigma_rows: torch.Tensor  # (max_blocks + 1, 3) float32: block rows, then the step's sums
    strata_partials: torch.Tensor  # (_STRATA_CLUSTERS, MAX_STRATA * 50) float32: cluster rows
    counter: torch.Tensor  # (3,) int32: arrivals, barrier arrivals, barrier generation
    runs: torch.Tensor  # (MAX_SLOTS,) int32: IRLS iterations run per level slot


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
        torch.empty((_STRATA_CLUSTERS, _build.MAX_STRATA * STRATIFIED_SUMS),
                    dtype=torch.float32, device=dev),
        torch.zeros((3,), dtype=torch.int32, device=dev),
        torch.zeros((MAX_SLOTS,), dtype=torch.int32, device=dev),
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
    return IrlsStep(T.view(4, 4), IrlsResult(H.view(6, 6), b, s2i, s2x, err, n_valid, inl), delta,
                    out)


def _plain_out(T, res: IrlsResult, damping: float, min_valid: float = 100.0) -> torch.Tensor:
    """The plain version of a fused launch's output: the evaluation, then
    ``ic_update``, in the irls::kOut layout."""
    T_out, delta = ic_update(T, res.H, res.b, damping, res.n_valid, min_valid)
    return torch.cat([pack_result(res), T_out.reshape(16), delta.reshape(6)])


# Iteration counts per level slot: launched (host, both devices) and run on
# the CPU (a CPU tensor; the card keeps its own in the workspace).
_LAUNCHED = np.zeros((MAX_SLOTS,), np.int64)
_CPU_RUNS = torch.zeros((MAX_SLOTS,), dtype=torch.int64)


def _count_slot(slot: int) -> None:
    if not -1 <= slot < MAX_SLOTS:
        raise ValueError(f"slot {slot}: the iteration counts have slots 0 to {MAX_SLOTS - 1}")
    if slot >= 0:
        _LAUNCHED[slot] += 1


def _cpu_skips(prev: IrlsStep, tol: float) -> torch.Tensor:
    """The plain version's early-exit test, the kernels' float order and
    float32 tolerance: prev's step norm is not above ``tol`` (a bool
    tensor, read by nobody on the host)."""
    return ~(step_norm(prev.delta) > np.float32(tol))


def _cpu_step(out: torch.Tensor, slot: int, prev: Optional[IrlsStep], tol: float,
              go: Optional[torch.Tensor], hold: Optional[IrlsStep]) -> IrlsStep:
    """A plain step's output ``out`` under the early exit and the predicate:
    ``prev``'s output where the exit skips, ``hold``'s where ``go`` is 0;
    counted like a launch, with no host read."""
    _count_slot(slot)
    ran = None
    if prev is not None and tol > 0.0:
        skip = _cpu_skips(prev, tol)
        out = torch.where(skip, prev.out, out)
        ran = ~skip
    if go is not None:
        run = go != 0
        out = torch.where(run, out, hold.out)
        ran = run if ran is None else ran & run
    if slot >= 0:
        _CPU_RUNS[slot] += 1 if ran is None else ran.to(torch.int64)
    return _irls_step(out)


def _exit_args(prev: Optional[IrlsStep], tol: float, slot: int, ws: "Workspace", go=None,
               hold: Optional[IrlsStep] = None):
    """(prev, runs, go, hold) pointers of a launch: ``prev``'s output when
    the exit is on (``tol > 0``), the level's count slot when given, the
    predicate word and the step it holds when given."""
    dev = ws.runs.device
    prev_ptr = go_ptr = hold_ptr = None
    if prev is not None and tol > 0.0:
        if prev.out is None or prev.out.device != dev:
            raise ValueError("prev must be the previous launch's IrlsStep on the same card")
        prev_ptr = prev.out.data_ptr()
    if go is not None:
        _build.require(go, "go", dev, (), dtypes=(torch.int32,))
        if hold is None or hold.out is None or hold.out.device != dev:
            raise ValueError("a predicated step needs the IrlsStep it holds, on the same card")
        go_ptr, hold_ptr = go.data_ptr(), hold.out.data_ptr()
    runs_ptr = ws.runs[slot].data_ptr() if slot >= 0 else None
    return prev_ptr, runs_ptr, go_ptr, hold_ptr


def iteration_counts(device) -> tuple:
    """(launched, run): (MAX_SLOTS,) int64 arrays of the IRLS steps enqueued
    with each level slot since ``reset_iteration_counts``, and of those that
    ran rather than exiting early. On a card the second is a host read of
    the workspace (a sync): for checks and measurements, never per frame."""
    dev = torch.device(device)
    if dev.type == "cuda":
        runs = workspace(dev).runs.cpu().numpy().astype(np.int64)
    else:
        runs = _CPU_RUNS.numpy().copy()
    return _LAUNCHED.copy(), runs


def reset_iteration_counts(device) -> None:
    _LAUNCHED[:] = 0
    dev = torch.device(device)
    if dev.type == "cuda":
        workspace(dev).runs.zero_()
    else:
        _CPU_RUNS.zero_()


_PLANE_DTYPES = (torch.float32, torch.bfloat16)


def _plane_types(kf_int, kf_points, cur_stack) -> int:
    """The launch's plane-type code: bit 0 the template intensity is
    bfloat16, bit 1 the points, bit 2 the current stack. The kernels have
    no instantiation for a bfloat16 intensity with float32 points."""
    for t in (kf_int, *kf_points, cur_stack):
        if t.dtype not in _PLANE_DTYPES:
            raise TypeError(f"ESM planes must be float32 or bfloat16, got {t.dtype}")
    if len({p.dtype for p in kf_points}) != 1:
        raise TypeError("the three point planes must share one dtype")
    bf = torch.bfloat16
    code = (int(kf_int.dtype == bf) | int(kf_points[0].dtype == bf) << 1
            | int(cur_stack.dtype == bf) << 2)
    if code & 1 and not code & 2:
        raise TypeError("no ESM kernel takes a bfloat16 template intensity with float32 points")
    return code


def _device_kind(T: torch.Tensor, what: str) -> str:
    if T.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {T.device}")
    return T.device.type


# ---------------------------------------------------------------------------
# ESM: csrc/esm_normal_eq.cu


def _esm_params(n, cur_stack, intr: Intrinsics, nu, use_geometric, gate_sigmas, occlusion_gate,
                gate_cap=0.0, damping=0.0, tol=0.0):
    _, h, w = cur_stack.shape
    return _build.EsmParams(
        n=n, h=h, w=w, use_geometric=int(bool(use_geometric)),
        occlusion_gate=int(bool(occlusion_gate)),
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        nu=nu, nu1=nu + 1.0, gate2=gate_sigmas**2,
        occ_a=(2.0 * gate_sigmas) ** 2, occ_b=0.05**2, cap2=gate_cap * gate_cap,
        umax=w - 1.001, vmax=h - 1.001, damping=damping, tol=tol,
    )


def _esm_check(T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, sigma2_int, sigma2_xi,
               xi=None) -> int:
    """Check an ESM launch's arguments; returns the plane-type code."""
    dev = T.device
    th, tw = kf_int.shape
    c = cur_stack.shape[0]
    if c not in (3, 5, 7):
        raise ValueError(f"current stack must have 3, 5 or 7 planes, got {c}")
    types = _plane_types(kf_int, kf_points, cur_stack)
    require = _build.require
    require(T, "T", dev, (4, 4))
    for name, t in (("kf_int", kf_int), ("Px", kf_points[0]), ("Py", kf_points[1]),
                    ("Pz", kf_points[2])):
        require(t, name, dev, (th, tw), dtypes=_PLANE_DTYPES)
    require(kf_mask, "kf_mask", dev, (th, tw))
    if xi is not None:
        require(xi, "xi", dev, (th, tw))
    require(kf_grads, "kf_grads", dev, (4, th, tw))
    require(cur_stack, "cur_stack", dev, dtypes=_PLANE_DTYPES)
    require(sigma2_int, "sigma2_int", dev, ())
    require(sigma2_xi, "sigma2_xi", dev, ())
    return types


def _esm_cuda(
    T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr: Intrinsics, nu,
    sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap, damping,
    prev=None, tol=0.0, slot=-1, go=None, hold=None,
) -> IrlsStep:
    dev = T.device
    types = _esm_check(T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, sigma2_int, sigma2_xi)
    Px, Py, Pz = kf_points
    lib = _build.library()
    ws = workspace(dev)
    prev_ptr, runs_ptr, go_ptr, hold_ptr = _exit_args(prev, tol, slot, ws, go, hold)
    out = torch.empty((_OUT,), dtype=torch.float32, device=dev)
    p = _esm_params(kf_int.numel(), cur_stack, intr, nu, use_geometric, gate_sigmas,
                    occlusion_gate, gate_cap, damping, tol)
    status = lib.esm_irls_launch(
        p, cur_stack.shape[0], types, ws.max_blocks, T.data_ptr(), sigma2_int.data_ptr(),
        sigma2_xi.data_ptr(), kf_int.data_ptr(), Px.data_ptr(), Py.data_ptr(), Pz.data_ptr(),
        kf_mask.data_ptr(), kf_grads.data_ptr(), cur_stack.data_ptr(), ws.partials.data_ptr(),
        ws.counter.data_ptr(), out.data_ptr(), prev_ptr, runs_ptr, go_ptr, hold_ptr,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "esm_irls_launch")
    owner = getattr(_COUNT, "owner", None) or esm_residuals_and_normal_eq
    owner.launches += 1
    _count_slot(slot)
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
    prev: Optional[IrlsStep] = None,
    tol: float = 0.0,
    slot: int = -1,
    go: Optional[torch.Tensor] = None,
    hold: Optional[IrlsStep] = None,
) -> IrlsStep:
    """One ESM IRLS iteration: the evaluation of
    ``esm_residuals_and_normal_eq`` at ``T``, then ``ic_update`` with
    ``damping``; skipped (the step is ``prev``) under the early exit, and
    ``hold`` when the predicate word ``go`` is 0, see the module docstring;
    counted in ``slot`` when it is >= 0. CPU runs the plain versions; CUDA
    one kernel launch that reads nothing back to the host."""
    args = (T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap)
    if _device_kind(T, "ESM") == "cpu":
        out = _plain_out(T, esm_residuals_and_normal_eq_plain(*args), damping)
        return _cpu_step(out, slot, prev, tol, go, hold)
    return _esm_cuda(*args, damping, prev, tol, slot, go, hold)


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
    *,
    go: Optional[torch.Tensor] = None,
    hold: Optional[IrlsStep] = None,
    slot: int = -1,
) -> IrlsResult:
    """One ESM IRLS evaluation (see ops/gauss_newton.py for the contract);
    ``hold``'s result when the predicate word ``go`` is 0, counted in
    ``slot`` when it is >= 0, as ``esm_irls_step``.

    The device of ``T`` decides: CPU runs the plain version, CUDA the
    kernel (the launch of ``esm_irls_step``; its pose update is dropped).
    On CUDA every plane must be a contiguous tensor on the same card: the
    template planes (Ht, Wt), ``kf_grads`` (4, Ht, Wt), the current stack
    (3|5|7, H, W), and the sigmas as 0-d tensors; all float32 but the
    intensity, the points and the stack, which may be bfloat16
    (``_plane_types``)."""
    args = (T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap)
    if _device_kind(T, "ESM") == "cpu":
        res = esm_residuals_and_normal_eq_plain(*args)
        if go is None and slot < 0:
            return res
        out = torch.cat([pack_result(res), T.reshape(16), torch.zeros_like(res.b)])
        return _cpu_step(out, slot, None, 0.0, go, hold).result
    return _esm_cuda(*args, 0.0, slot=slot, go=go, hold=hold).result


esm_residuals_and_normal_eq.launches = 0


# ---------------------------------------------------------------------------
# The consensus vote's stratified sums: csrc/esm_stratified.cu


def _stratified_cuda(T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr: Intrinsics, nu,
                     sigma2_int, sigma2_xi, xi, edges, use_geometric, gate_sigmas,
                     occlusion_gate) -> torch.Tensor:
    dev = T.device
    k = len(edges) - 1
    if not 1 <= k <= _build.MAX_STRATA:
        raise ValueError(f"{k} strata: the kernel takes 1 to {_build.MAX_STRATA}")
    types = _esm_check(T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, sigma2_int, sigma2_xi,
                       xi)
    if types & 1:
        raise TypeError("the stratified kernel takes a float32 template intensity, got bfloat16")
    Px, Py, Pz = kf_points
    sp = _build.StrataParams(k=k)
    sp.edges[: k + 1] = [float(e) for e in edges]
    ws = workspace(dev)
    out = torch.empty((k, STRATIFIED_SUMS), dtype=torch.float32, device=dev)
    status = _build.library().esm_stratified_launch(
        _esm_params(kf_int.numel(), cur_stack, intr, nu, use_geometric, gate_sigmas,
                    occlusion_gate),
        sp, cur_stack.shape[0], types, ws.strata_partials.shape[0], T.data_ptr(),
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
    layouts of ``esm_residuals_and_normal_eq`` and ``xi`` (Ht, Wt); the
    points and the stack may be bfloat16, the intensity is float32."""
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


def _ic_params(n: int, cur_int, intr: Intrinsics, nu, gate_sigmas, use_geometric, damping=0.0,
               tol=0.0):
    h, w = cur_int.shape
    return _build.IcParams(
        n=n, h=h, w=w, use_geometric=int(bool(use_geometric)),
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        nu=nu, nu1=nu + 1.0, gate2=gate_sigmas**2, umax=w - 1.001, vmax=h - 1.001,
        damping=damping, tol=tol,
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
                    sigma_steps: int = 0, prev=None, tol=0.0, slot=-1) -> IrlsStep:
    """One launch: ``sigma_steps`` scale phases (exact mode, a cooperative
    launch) or none, then the normal pass, the solve and the pose update;
    or, under the early exit, a copy of ``prev``'s output."""
    _ic_check(T, kf_int, kf_points, kf_mask, cur_int, cur_xi, cur_mask, sigma2_int, sigma2_xi)
    dev = T.device
    _build.require(jac12, "jac12", dev, (12,) + tuple(kf_int.shape))
    n = kf_int.numel()
    ws = workspace(dev)
    prev_ptr, runs_ptr, _, _ = _exit_args(prev, tol, slot, ws)
    out = torch.empty((_OUT,), dtype=torch.float32, device=dev)
    Px, Py, Pz = kf_points
    status = _build.library().ic_irls_launch(
        _ic_params(n, cur_int, intr, nu, gate_sigmas, use_geometric, damping, tol),
        int(bool(lagged)), sigma_steps, ws.max_blocks,
        T.data_ptr(), sigma2_int.data_ptr(), sigma2_xi.data_ptr(), kf_int.data_ptr(),
        Px.data_ptr(), Py.data_ptr(), Pz.data_ptr(), kf_mask.data_ptr(), jac12.data_ptr(),
        cur_int.data_ptr(), cur_xi.data_ptr(), cur_mask.data_ptr(), ws.partials.data_ptr(),
        ws.sigma_rows.data_ptr(), ws.counter.data_ptr(), out.data_ptr(), prev_ptr, runs_ptr,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "ic_irls_launch")
    ic_normal_eq.launches += 1
    ic_normal_eq.sigma_phases += sigma_steps
    _count_slot(slot)
    return _irls_step(out)


def _ic_chain_cuda(T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
                   sigma2_int, sigma2_xi, sigma_iters, use_geometric, gate_sigmas, sigma_mode,
                   damping, prev=None, tol=0.0, slot=-1) -> IrlsStep:
    """One launch in either mode; exact mode runs ``max(sigma_iters, 1)``
    scale phases inside it, each weighting with the scales the previous one
    produced, and the normal pass weights with the last."""
    exact = sigma_mode == "exact"
    return _ic_normal_cuda(T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask,
                           intr, nu, sigma2_int, sigma2_xi, use_geometric, gate_sigmas,
                           not exact, damping, max(sigma_iters, 1) if exact else 0, prev, tol,
                           slot)


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
    prev: Optional[IrlsStep] = None,
    tol: float = 0.0,
    slot: int = -1,
) -> IrlsStep:
    """One IC IRLS iteration: the evaluation of ``residuals_and_normal_eq``
    at ``T``, then ``ic_update`` with ``damping``; skipped under the early
    exit and counted in ``slot`` as ``esm_irls_step``. CPU runs the plain
    versions; CUDA one launch in either sigma mode (exact mode runs its
    ``max(sigma_iters, 1)`` scale steps inside it), reading nothing back to
    the host."""
    args = (T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
            sigma2_int, sigma2_xi, sigma_iters, use_geometric, gate_sigmas, sigma_mode)
    if _device_kind(T, "IC") == "cpu":
        out = _plain_out(T, residuals_and_normal_eq_plain(*args), damping)
        return _cpu_step(out, slot, prev, tol, None, None)
    return _ic_chain_cuda(*args, damping, prev, tol, slot)


ic_sigma_stats.launches = 0
ic_normal_eq.launches = 0
ic_normal_eq.sigma_phases = 0


# ---------------------------------------------------------------------------
# The row-sharded iteration: csrc/irls_solve.cu

# irls::kResult: H (36), b (6), sigma2_int, sigma2_xi, error, n_valid, inlier_frac, 0.
RESULT = 48


def pack_result(res: IrlsResult) -> torch.Tensor:
    """The 48-float result layout of an evaluation (csrc/irls_common.cuh)."""
    scalars = torch.stack([res.sigma2_int, res.sigma2_xi, res.error, res.n_valid,
                           res.inlier_frac, torch.zeros_like(res.error)])
    return torch.cat([res.H.reshape(36), res.b.reshape(6), scalars])


def unpack_result(v: torch.Tensor) -> IrlsResult:
    H, b, scalars = v.split([36, 6, 6])
    s2i, s2x, err, n_valid, inl, _ = scalars.unbind()
    return IrlsResult(H.view(6, 6), b, s2i, s2x, err, n_valid, inl)


def esm_result(
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
    prev: Optional[IrlsStep] = None,
    tol: float = 0.0,
    go: Optional[torch.Tensor] = None,
    hold: Optional[IrlsStep] = None,
) -> torch.Tensor:
    """``esm_residuals_and_normal_eq`` as the (48,) result vector: on the card
    the result part of the fused launch's output (no copy), on the CPU the
    plain evaluation packed. Under the early exit (``prev``'s step norm
    <= ``tol``) it is ``prev``'s result, and under a predicate word ``go``
    of 0 ``hold``'s: the launch copies it, the CPU selects it."""
    args = (T, kf_int, kf_points, kf_mask, kf_grads, cur_stack, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, occlusion_gate, gate_cap)
    if _device_kind(T, "ESM") == "cpu":
        res = pack_result(esm_residuals_and_normal_eq_plain(*args))
        if prev is not None and tol > 0.0:
            res = torch.where(_cpu_skips(prev, tol), prev.out[:RESULT], res)
        if go is not None:
            res = torch.where(go != 0, res, hold.out[:RESULT])
        return res
    return _esm_cuda(*args, 0.0, prev, tol, go=go, hold=hold).out[:RESULT]


def ic_result(
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
) -> torch.Tensor:
    """The lagged ``ic_normal_eq`` at the given scales as the (48,) result
    vector, the IC counterpart of ``esm_result``: on the card the result
    part of the fused launch's output (no copy; its pose update, at damping
    0, is not read), counted in ``ic_normal_eq.launches``; on the CPU
    ``normal_eq_plain`` packed."""
    args = (T, kf_int, kf_points, kf_mask, jac12, cur_int, cur_xi, cur_mask, intr, nu,
            sigma2_int, sigma2_xi, use_geometric, gate_sigmas, True)
    if _device_kind(T, "IC normal-equation") == "cpu":
        return pack_result(normal_eq_plain(*args))
    return _ic_normal_cuda(*args, 0.0).out[:RESULT]


def allreduce_irls(res: torch.Tensor, reduce) -> torch.Tensor:
    """The global result of per-band results (``rgbid_tpu/ops/gauss_newton.py::
    allreduce_irls``): every field but n_valid is a per-pixel mean over the
    band's n_valid, so the global field is sum_r x_r (n_r / N) with N the
    sum of the n_r (at least 1), the scales clamped at 1e-12, and n_valid
    N. ``reduce`` sums a tensor over the ranks (in place or not; every rank
    gets the same bits). Two all-reduces: N (1 float), then the weighted
    48 floats. With one rank the weight is n / n = 1 exactly, so the result
    is the input bit for bit."""
    n = res[45:46].double()
    N = reduce(n.clone())
    out = reduce(res.double() * (n / torch.clamp(N, min=1.0))).float()
    return torch.cat([out[:42], torch.clamp(out[42:44], min=1e-12), out[44:45], N.float(),
                      out[46:]])


def irls_solve_step(
    T: torch.Tensor,
    result: torch.Tensor,
    damping: float,
    *,
    min_valid: float = 100.0,
    prev: Optional[IrlsStep] = None,
    tol: float = 0.0,
    slot: int = -1,
    go: Optional[torch.Tensor] = None,
    hold: Optional[IrlsStep] = None,
) -> IrlsStep:
    """``ic_update`` on a (48,) result vector (``allreduce_irls``'s): the
    solve, the updated pose and the applied step, as an IrlsStep in the
    fused launches' layout, the step suppressed unless n_valid >
    ``min_valid`` (``ic_update``'s argument); skipped under the early exit,
    held under a predicate word of 0 and counted in ``slot`` as
    ``esm_irls_step``. CPU runs ``ic_update``; CUDA one launch of one block
    that reads nothing back to the host."""
    if _device_kind(T, "IRLS solve") == "cpu":
        out = _plain_out(T, unpack_result(result), damping, min_valid)
        return _cpu_step(out, slot, prev, tol, go, hold)
    dev = T.device
    _build.require(T, "T", dev, (4, 4))
    _build.require(result, "result", dev, (RESULT,))
    ws = workspace(dev)
    prev_ptr, runs_ptr, go_ptr, hold_ptr = _exit_args(prev, tol, slot, ws, go, hold)
    out = torch.empty((_OUT,), dtype=torch.float32, device=dev)
    status = _build.library().irls_solve_launch(
        damping, tol, min_valid, result.data_ptr(), T.data_ptr(), out.data_ptr(), prev_ptr,
        runs_ptr, go_ptr, hold_ptr, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "irls_solve_launch")
    irls_solve_step.launches += 1
    _count_slot(slot)
    return _irls_step(out)


irls_solve_step.launches = 0
