"""Loop-closure pipeline + the back-end thread.

Counterpart of ``rgbid_tpu/backend/loop_closure.py:30-241``. Per finalized
keyframe: ORB features -> BoW query (temporal-gated) -> dense verification
on the device (``RelocScorer``, the ESM IRLS kernel) -> accepted loops
become robust pose-graph edges -> pose-graph optimization -> corrected
poses published back to the front end (which rebases keyframe poses under
a lock).

The thread gives the device work of two kinds: the deferred finalize's one
packed read and the scorer's launches and one read per keyframe event. Both
go on the default stream, like the front end's. The thread never dies of an
exception in its per-keyframe work; it counts them (``errors``), and a run
that is meant to be healthy checks that count. ``timings`` keeps the host
milliseconds of each part of every keyframe event (finalize, ORB, BoW query
and insert, ``score_pairs``, ``optimize``): each part is a span
(``utils/profiling.py``) named ``rgbid.backend.<part>``, so under
``torch.profiler`` the thread's parts show beside the front end's spans.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Dict, List, Optional

import numpy as np

from ..core.config import SlamConfig
from ..mapping.keyframe import Keyframe
from ..reference_cpu import se3_np
from ..utils.profiling import SinkSpan
from . import features
from .place_recognition import BowDatabase
from .pose_graph import PoseGraph
from .relocalization import RelocScorer


def loop_edge(res, i: int, from_id: int, to_id: int) -> dict:
    """The pose-graph edge of accepted pair ``i`` of a scorer result. The
    scorer returns T_{query<-candidate}; the edge stores T_rel =
    T_{from<-to} with from = candidate (old), to = query, and the scorer's
    un-normalized normal matrix as information."""
    T_qc = se3_np.orthonormalize(np.asarray(res.T[i], np.float64))
    H = np.asarray(res.H[i], np.float64) * float(res.n_valid[i])
    return {
        "from_id": from_id,
        "to_id": to_id,
        "T_rel": se3_np.inv(T_qc),
        "information": 0.5 * (H + H.T),
    }


def _timed(timings: Dict[str, List[float]], part: str) -> SinkSpan:
    """The block as the span ``rgbid.backend.<part>``; its wall
    milliseconds are appended to ``timings[part]``."""
    return SinkSpan("rgbid.backend." + part,
                    lambda ns: timings.setdefault(part, []).append(ns * 1e-6))


class LoopCloser:
    """Detect + verify loop closures for a stream of finalized keyframes."""

    def __init__(self, intr, cfg: SlamConfig, device):
        self.cfg = cfg
        b = cfg.backend
        # Guards the BoW database: inserts happen on the back-end thread,
        # relocalization queries come from the front-end thread.
        self.db_lock = threading.Lock()
        self.db = BowDatabase(
            max_words=b.vocab_branching**b.vocab_levels,
            min_score=b.min_score,
            min_gap=b.min_keyframe_gap,
            max_candidates=b.max_candidates,
            branching=b.vocab_branching,
            levels=b.vocab_levels,
            train_after=b.vocab_train_after,
            vocab_path=b.vocab_path,
            tf_mode=b.tf_mode,
            rel_score=b.rel_score,
        )
        self.scorer = RelocScorer(intr, cfg, device)
        self.n_queries = 0
        self.n_candidates = 0
        self.n_accepted = 0
        self.timings: Dict[str, List[float]] = {}

    def process_keyframe(self, kf: Keyframe, keyframes: List[Keyframe]) -> List[dict]:
        """Returns accepted loop edges:
        {from_id, to_id, T_rel (T_{from<-to}), information}."""
        planes = kf.reloc_planes
        if planes is None:
            return []
        with _timed(self.timings, "orb"):
            pts, desc = features.extract_orb(planes["intensity0_u8"],
                                             self.cfg.backend.num_features)
        kf.keypoints, kf.descriptors = pts, desc

        with _timed(self.timings, "bow"), self.db_lock:
            candidates = self.db.query(kf.kf_id, desc)
            self.db.insert(kf.kf_id, desc)
            kf.bow = dict(self.db.entries.get(kf.kf_id, {}))
        self.n_queries += 1
        if not candidates:
            return []
        self.n_candidates += len(candidates)

        cands = [keyframes[cid] for cid, _score in candidates]
        cands = [c for c in cands if c.reloc_planes is not None]
        if not cands:
            return []
        with _timed(self.timings, "score_pairs"):
            res = self.scorer.score_pairs([c.reloc_planes for c in cands], [planes] * len(cands))
        edges = []
        for i, cand in enumerate(cands):
            if self.scorer.accept(res, i):
                edges.append(loop_edge(res, i, cand.kf_id, kf.kf_id))
                self.n_accepted += 1
        return edges


class BackendThread:
    """The back-end thread: consume keyframes, close loops, optimize the
    pose graph, publish corrected poses."""

    def __init__(self, system):
        self.system = system
        self.cfg: SlamConfig = system.config
        self.loop_closer = LoopCloser(system.intr, self.cfg, system.device)
        self.pg = PoseGraph(self.cfg.backend.pg_iterations, self.cfg.backend.pg_damping)
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._lock = threading.Lock()
        self._optimized: Dict[int, np.ndarray] = {}
        self._loop_edges: List[dict] = []
        self._dirty = False  # accepted edges awaiting an optimize pass
        self._processed = set()
        self.errors = 0  # exceptions swallowed by the thread
        self.finalized = 0  # deferred finalizes done on the thread
        self.timings = self.loop_closer.timings
        self.last_result: Optional[dict] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="slam-backend")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, kf: Keyframe, device_state=None) -> None:
        """Queue a retired keyframe for the back end. ``device_state`` (the
        retiring keyframe's state, or the planes a finalize reads of it,
        packed: the front end's copy of its retire-ring slot) requests
        FINALIZATION on this thread first: the packed read and the cloud
        extraction move off the front end's critical path. The front end
        hands over a copy of its own (the ring slot and the graph's state
        buffers are overwritten by later frames), so a late read sees the
        state as it was retired."""
        if kf.kf_id not in self._processed:
            self._processed.add(kf.kf_id)
            self._queue.put((kf, device_state))

    def finish(self) -> None:
        """Drain the queue, wait for the thread to end, then run a final
        optimization."""
        self._queue.put(None)
        self._thread.join()
        self._final_optimize()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def has_updates(self) -> bool:
        with self._lock:
            return bool(self._optimized)

    def optimized_poses(self) -> Dict[int, np.ndarray]:
        """A copy of the pending optimized poses, taken under the lock
        (``take_updates`` pops them)."""
        with self._lock:
            return dict(self._optimized)

    def take_updates(self) -> Dict[int, np.ndarray]:
        """Pop the pending optimized poses (consume-once publication)."""
        with self._lock:
            out = self._optimized
            self._optimized = {}
            return out

    @property
    def num_loop_closures(self) -> int:
        return len(self._loop_edges)

    def add_external_loop_edge(self, edge: dict) -> None:
        """Register an edge found outside the keyframe pipeline (e.g. the
        front end's lost-tracking relocalization)."""
        self._loop_edges.append(edge)

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                break
            kf, device_state = item
            # The WHOLE per-keyframe pipeline (including _optimize) lives
            # inside the try: an exception here must never kill the thread,
            # or the front end would silently lose loop closure.
            try:
                if device_state is not None and kf.cloud is None:
                    # Deferred finalization (see submit).
                    with _timed(self.timings, "finalize"):
                        self.system.manager.finalize(kf, device_state)
                    self.finalized += 1
                edges = self.loop_closer.process_keyframe(kf, self.system.manager.keyframes)
                if edges:
                    self._loop_edges.extend(edges)
                    self._dirty = True
                # Throttle: optimize once per BURST of keyframe events,
                # only when no further keyframes are already waiting.
                if self._dirty and self._queue.empty():
                    self._optimize()
                    self._dirty = False
            except Exception:  # never kill the back-end thread; count it
                self.errors += 1
                traceback.print_exc()

    def _optimize(self) -> None:
        # Snapshot keyframes and both edge lists in one pass (each list()
        # is atomic under the GIL), then drop any edge referencing a
        # keyframe appended by the front end AFTER the pose snapshot:
        # otherwise a concurrent keyframe switch makes an edge point at
        # node index >= len(poses) and the solver raises.
        kfs = list(self.system.manager.keyframes)
        odo_edges = list(self.system.manager.edges)
        loop_edges = list(self._loop_edges)
        poses = [kf.T_wk.copy() for kf in kfs]
        n = len(poses)
        self.pg.edges = []
        for e in odo_edges:
            if e.from_id < n and e.to_id < n:
                # Episode-tagged edges (mover-contaminated interval) are
                # Huber-robustified on top of their softer information:
                # among them, the reweighting concentrates a loop closure's
                # correction in the ones carrying real inconsistency.
                self.pg.add_edge(e.from_id, e.to_id, e.T_rel, e.information,
                                 robust=bool(e.episode))
        for e in loop_edges:
            if e["from_id"] < n and e["to_id"] < n:
                self.pg.add_edge(e["from_id"], e["to_id"], e["T_rel"], e["information"],
                                 robust=True)
        with _timed(self.timings, "optimize"):
            result = self.pg.optimize(poses)
        with self._lock:
            self._optimized = {i: T for i, T in enumerate(result["poses"])}
        self.last_result = result

    def _final_optimize(self) -> None:
        if self._loop_edges:
            self._optimize()
