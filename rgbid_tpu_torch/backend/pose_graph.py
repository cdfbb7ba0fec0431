"""SE(3) pose-graph optimization (host, numpy/scipy float64).

The port's copy of ``rgbid_tpu/backend/pose_graph.py``. One difference:
``method="native"`` raises when the C++ library cannot be built or loaded
(``rgbid_tpu_torch.native``); the JAX package falls back to the numpy loop
without a word.

Reference equivalent: src/pose_graph.* (SURVEY.md §2.1) — keyframe poses
as nodes, odometry + loop edges with information matrices, iterative
Gauss-Newton with the first node fixed, SPARSE 6Nx6N normal equations,
Cholesky/LU solve. Stays on the host per BASELINE.json:5.

Three implementations of the same math:

* ``method="sparse"`` (default, production): ANALYTIC edge Jacobians
  (closed-form SE(3) inverse left/right Jacobians — see
  backend/se3_batch.py) computed for ALL edges at once with batched
  numpy einsums, assembled into a scipy.sparse CSR system over the free
  nodes only, SuperLU solve. O(E) vectorized per iteration — hundreds of
  nodes and thousands of edges optimize in well under a second.
* ``method="dense_fd"``: the round-1 per-edge Python loop with central
  finite-difference Jacobians — slow but convention-proof; kept as the
  ORACLE the other paths are tested against (results agree to <=1e-8 on
  converged graphs, tests/test_backend.py).
* ``method="native"``: the C++ per-edge assembly kernels
  (rgbid_tpu_torch.native), same FD math as dense_fd.

Edge convention (matches mapping.manager.OdometryEdge):
    T_rel = T_{from<-to}, i.e. T_w,from @ T_rel ~= T_w,to,
    residual r = log( inv(T_w,to) @ T_w,from @ T_rel )  in R^6.
Updates are right-multiplied twists: T_i <- T_i @ exp(delta_i).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..reference_cpu import se3_np
from . import se3_batch as sb


@dataclass
class GraphEdge:
    from_id: int
    to_id: int
    T_rel: np.ndarray  # 4x4, T_{from<-to}
    information: np.ndarray  # 6x6 SPD
    robust: bool = False  # Huber kernel (used for loop edges)


def _edge_residual(T_from: np.ndarray, T_to: np.ndarray, T_rel: np.ndarray) -> np.ndarray:
    return se3_np.log(se3_np.inv(T_to) @ T_from @ T_rel)


def _numeric_jacobians(T_from, T_to, T_rel, eps: float = 1e-6):
    """d r / d delta_from, d r / d delta_to (right perturbations), 6x6 each."""
    Jf = np.zeros((6, 6))
    Jt = np.zeros((6, 6))
    for k in range(6):
        d = np.zeros(6)
        d[k] = eps
        E = se3_np.exp(d)
        Ei = se3_np.exp(-d)
        Jf[:, k] = (
            _edge_residual(T_from @ E, T_to, T_rel)
            - _edge_residual(T_from @ Ei, T_to, T_rel)
        ) / (2 * eps)
        Jt[:, k] = (
            _edge_residual(T_from, T_to @ E, T_rel)
            - _edge_residual(T_from, T_to @ Ei, T_rel)
        ) / (2 * eps)
    return Jf, Jt


def optimize_pose_graph(
    poses: Sequence[np.ndarray],
    edges: Sequence[GraphEdge],
    iterations: int = 15,
    damping: float = 1e-5,
    huber_delta: float = 0.1,
    fixed: Sequence[int] = (0,),
    use_native: Optional[bool] = None,
    method: str = "sparse",
) -> Dict:
    """Gauss-Newton over keyframe poses. Returns dict with 'poses',
    'initial_error', 'final_error', 'iterations'.

    method: "sparse" (analytic Jacobians + scipy.sparse, the default),
    "dense_fd" (numpy finite-difference oracle), "native" (C++ FD
    kernels; raises RuntimeError if they cannot be built). ``use_native`` is the legacy switch: True forces "native",
    False forces "dense_fd".
    """
    if use_native is True:
        method = "native"
    elif use_native is False:
        method = "dense_fd"
    if method == "sparse" and len(edges) > 0:
        return _optimize_sparse(poses, edges, iterations, damping, huber_delta, fixed)
    if method == "native" and len(edges) > 0:
        # Raises RuntimeError when the library cannot be built or loaded.
        return _optimize_native(poses, edges, iterations, damping, huber_delta, fixed)
    N = len(poses)
    T = [p.copy() for p in poses]
    fixed = set(fixed)

    def total_error():
        e = 0.0
        for ed in edges:
            r = _edge_residual(T[ed.from_id], T[ed.to_id], ed.T_rel)
            e += float(r @ ed.information @ r)
        return e

    err0 = total_error()
    prev = err0
    its = 0
    for it in range(iterations):
        H = np.zeros((6 * N, 6 * N))
        b = np.zeros(6 * N)
        for ed in edges:
            r = _edge_residual(T[ed.from_id], T[ed.to_id], ed.T_rel)
            info = ed.information
            if ed.robust:
                # Huber: scale the information by w = min(1, delta/|r|),
                # with |r| the METRIC norm of the 6-vector residual
                # (m + rad), matching huber_delta's documented scale
                # (0.1 ~= 100 mm). The Mahalanobis norm sqrt(r'Ir) is
                # WRONG here: production informations are H*n_valid
                # (~1e9), so a loop edge bridging a real 100 mm
                # inconsistency measured m ~= 3e3 and was annihilated
                # (w ~= 3e-5) against odometry edges of the SAME raw
                # scale — the one edge carrying the correction was the
                # one the kernel deleted (round-5 mover_then_revisit
                # forensics: two 4 mm-accurate bridging edges, 390 mm
                # tail, post-optimize trajectory moved 2 mm).
                m = float(np.linalg.norm(r))
                w = 1.0 if m <= huber_delta else huber_delta / m
                info = info * w
            Jf, Jt = _numeric_jacobians(T[ed.from_id], T[ed.to_id], ed.T_rel)
            f, t = 6 * ed.from_id, 6 * ed.to_id
            H[f : f + 6, f : f + 6] += Jf.T @ info @ Jf
            H[t : t + 6, t : t + 6] += Jt.T @ info @ Jt
            H[f : f + 6, t : t + 6] += Jf.T @ info @ Jt
            H[t : t + 6, f : f + 6] += Jt.T @ info @ Jf
            b[f : f + 6] += Jf.T @ info @ r
            b[t : t + 6] += Jt.T @ info @ r
        # Fix gauge: clamp the fixed nodes.
        for i in fixed:
            H[6 * i : 6 * i + 6, :] = 0.0
            H[:, 6 * i : 6 * i + 6] = 0.0
            H[6 * i : 6 * i + 6, 6 * i : 6 * i + 6] = np.eye(6)
            b[6 * i : 6 * i + 6] = 0.0
        H += damping * np.eye(6 * N)
        try:
            delta = -np.linalg.solve(H, b)
        except np.linalg.LinAlgError:
            break
        for i in range(N):
            if i in fixed:
                continue
            T[i] = se3_np.orthonormalize(T[i] @ se3_np.exp(delta[6 * i : 6 * i + 6]))
        its = it + 1
        cur = total_error()
        if prev - cur < 1e-12 * max(prev, 1.0):
            break
        prev = cur

    return {
        "poses": T,
        "initial_error": err0,
        "final_error": total_error(),
        "iterations": its,
    }


def _batched_orthonormalize(T: np.ndarray) -> np.ndarray:
    """SVD projection of each (4, 4) pose's R block onto SO(3)."""
    U, _, Vt = np.linalg.svd(T[:, :3, :3])
    det = np.linalg.det(U @ Vt)
    S = np.tile(np.eye(3), (len(T), 1, 1))
    S[:, 2, 2] = np.sign(det)
    out = T.copy()
    out[:, :3, :3] = U @ S @ Vt
    return out


def edge_jacobians_analytic(T_from, T_to, T_rel):
    """Closed-form d r / d delta_from, d r / d delta_to for one edge (or a
    batch with leading axis): r = log(inv(T_to) T_from T_rel), right-
    multiplied perturbations.

        r(df) = log(M T_rel exp(Adj(T_rel^-1) df))  -> Jf = Jr^-1(r) Adj(T_rel^-1)
        r(dt) = log(exp(-dt) exp(r^))               -> Jt = -Jl^-1(r)

    Tested against the central-FD oracle (_numeric_jacobians) to <=1e-6.
    """
    T_from = np.asarray(T_from, np.float64)
    batched = T_from.ndim == 3
    if not batched:
        T_from, T_to, T_rel = T_from[None], np.asarray(T_to)[None], np.asarray(T_rel)[None]
    M = sb.inv_b(T_to) @ T_from @ T_rel
    r = sb.log_b(M)
    Jf = sb.jr_inv_b(r) @ sb.adjoint_b(sb.inv_b(T_rel))
    Jt = -sb.jl_inv_b(r)
    if not batched:
        return Jf[0], Jt[0], r[0]
    return Jf, Jt, r


def _optimize_sparse(poses, edges, iterations, damping, huber_delta, fixed):
    """Vectorized analytic assembly + scipy.sparse solve over free nodes."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve

    N = len(poses)
    fixed = set(fixed)
    free = [i for i in range(N) if i not in fixed]
    slot = np.full(N, -1, np.int64)  # node -> free-variable slot
    for s, i in enumerate(free):
        slot[i] = s
    F = len(free)
    T = np.stack([np.asarray(p, np.float64) for p in poses])
    e_from = np.array([e.from_id for e in edges], np.int64)
    e_to = np.array([e.to_id for e in edges], np.int64)
    Trel = np.stack([e.T_rel for e in edges]).astype(np.float64)
    info = np.stack([e.information for e in edges]).astype(np.float64)
    robust = np.array([e.robust for e in edges], bool)
    adj_rel = sb.adjoint_b(sb.inv_b(Trel))  # constant across iterations

    def residuals(T):
        return sb.log_b(sb.inv_b(T[e_to]) @ T[e_from] @ Trel)

    def total_error(T):
        r = residuals(T)
        return float(np.einsum("ei,eij,ej->", r, info, r))

    if F == 0:
        e0 = total_error(T)
        return {"poses": [t for t in T], "initial_error": e0, "final_error": e0, "iterations": 0}

    # Constant sparsity-pattern index arrays for the 4 block families.
    a6 = np.arange(6)
    err0 = total_error(T)
    prev = err0
    its = 0
    for it in range(iterations):
        r = residuals(T)
        # Huber on the METRIC residual norm (see the dense-path comment:
        # the Mahalanobis norm at production info scales crushed every
        # real loop edge to nothing).
        m = np.sqrt(np.maximum(np.einsum("ei,ei->e", r, r), 1e-18))
        wgt = np.where(robust & (m > huber_delta), huber_delta / m, 1.0)
        info_w = info * wgt[:, None, None]
        Jf = sb.jr_inv_b(r) @ adj_rel
        Jt = -sb.jl_inv_b(r)
        WJf = info_w @ Jf
        WJt = info_w @ Jt
        Hff = np.einsum("eia,eib->eab", Jf, WJf)
        Htt = np.einsum("eia,eib->eab", Jt, WJt)
        Hft = np.einsum("eia,eib->eab", Jf, WJt)
        bf = np.einsum("eia,eij,ej->ea", Jf, info_w, r)
        bt = np.einsum("eia,eij,ej->ea", Jt, info_w, r)

        sf = slot[e_from]
        st = slot[e_to]
        rows_list, cols_list, data_list = [], [], []

        def add_blocks(B, bi, bj, mask):
            if not np.any(mask):
                return
            Bm, bim, bjm = B[mask], bi[mask], bj[mask]
            rows = (6 * bim)[:, None, None] + a6[None, :, None]
            cols = (6 * bjm)[:, None, None] + a6[None, None, :]
            rows_list.append(np.broadcast_to(rows, Bm.shape).ravel())
            cols_list.append(np.broadcast_to(cols, Bm.shape).ravel())
            data_list.append(Bm.ravel())

        add_blocks(Hff, sf, sf, sf >= 0)
        add_blocks(Htt, st, st, st >= 0)
        both = (sf >= 0) & (st >= 0)
        add_blocks(Hft, sf, st, both)
        add_blocks(np.swapaxes(Hft, -1, -2), st, sf, both)
        H = sp.coo_matrix(
            (np.concatenate(data_list), (np.concatenate(rows_list), np.concatenate(cols_list))),
            shape=(6 * F, 6 * F),
        ).tocsr()
        H = H + damping * sp.identity(6 * F, format="csr")
        b = np.zeros(6 * F)
        np.add.at(b, (6 * sf[:, None] + a6[None, :])[sf >= 0].ravel(), bf[sf >= 0].ravel())
        np.add.at(b, (6 * st[:, None] + a6[None, :])[st >= 0].ravel(), bt[st >= 0].ravel())
        try:
            delta = spsolve(H, -b)
        except Exception:
            break
        if not np.all(np.isfinite(delta)):
            break
        upd = sb.exp_b(delta.reshape(F, 6))
        T[free] = _batched_orthonormalize(T[free] @ upd)
        its = it + 1
        cur = total_error(T)
        if prev - cur < 1e-12 * max(prev, 1.0):
            break
        prev = cur

    return {
        "poses": [t for t in T],
        "initial_error": err0,
        "final_error": total_error(T),
        "iterations": its,
    }


def _optimize_native(poses, edges, iterations, damping, huber_delta, fixed):
    from .. import native

    N = len(poses)
    dim = 6 * N
    fixed = set(fixed)
    fixed_mask = np.zeros(N, np.uint8)
    for i in fixed:
        fixed_mask[i] = 1
    e_from = np.array([e.from_id for e in edges], np.int32)
    e_to = np.array([e.to_id for e in edges], np.int32)
    e_T = np.stack([e.T_rel for e in edges])
    e_info = np.stack([e.information for e in edges])
    e_robust = np.array([e.robust for e in edges], np.uint8)

    T = [p.copy() for p in poses]
    err0 = native.pg_total_error(T, e_from, e_to, e_T, e_info)
    prev = err0
    its = 0
    for it in range(iterations):
        H, b, _ = native.pg_build_system(
            T, e_from, e_to, e_T, e_info, e_robust, huber_delta
        )
        for i in fixed:
            H[6 * i : 6 * i + 6, :] = 0.0
            H[:, 6 * i : 6 * i + 6] = 0.0
            H[6 * i : 6 * i + 6, 6 * i : 6 * i + 6] = np.eye(6)
            b[6 * i : 6 * i + 6] = 0.0
        H += damping * np.eye(dim)
        try:
            delta = -np.linalg.solve(H, b)
        except np.linalg.LinAlgError:
            break
        T = native.pg_apply_updates(T, delta, fixed_mask)
        its = it + 1
        cur = native.pg_total_error(T, e_from, e_to, e_T, e_info)
        if prev - cur < 1e-12 * max(prev, 1.0):
            break
        prev = cur
    return {
        "poses": T,
        "initial_error": err0,
        "final_error": native.pg_total_error(T, e_from, e_to, e_T, e_info),
        "iterations": its,
    }


class PoseGraph:
    """Incremental wrapper: holds nodes + edges, optimizes on demand."""

    def __init__(self, iterations: int = 15, damping: float = 1e-5):
        self.iterations = iterations
        self.damping = damping
        self.edges: List[GraphEdge] = []

    def add_edge(self, from_id, to_id, T_rel, information, robust=False):
        self.edges.append(
            GraphEdge(from_id, to_id, np.asarray(T_rel, np.float64), np.asarray(information, np.float64), robust)
        )

    def optimize(self, poses: Sequence[np.ndarray]) -> Dict:
        return optimize_pose_graph(
            poses, self.edges, self.iterations, self.damping
        )
