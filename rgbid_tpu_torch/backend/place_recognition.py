"""Bag-of-binary-words place recognition (host, numpy + native popcount).

The port's copy of ``rgbid_tpu/backend/place_recognition.py``; the packaged
vocabularies are copies too (``rgbid_tpu_torch/data/``). One difference:
``hamming_distances`` picks its implementation by one rule
(``hamming_backend``) and a failed native build raises.

Reference equivalent: DBoW2-style hierarchical vocabulary + inverted-index
database (SURVEY.md §2.1 "Loop detector / place recognition"). The
reference loads a vocabulary pretrained offline on a large image corpus;
with no network and no binary assets in this environment the vocabulary is
TRAINED IN-RUN: descriptors accumulate in the database, and once enough
are seen a real `branching^levels` hierarchical k-medians tree is built
(majority-bit medians under the Hamming metric — the binary-descriptor
analog of DBoW2's k-means++ tree) and all stored keyframes are
re-quantized against it. Until then a flat online-grown vocabulary covers
the cold start. The tree is retrained at exponentially spaced corpus
sizes, so long runs converge to a stable, data-fitted vocabulary.

Word assignment is ONE batched Hamming pass per keyframe (native C++
popcount kernel, rgbid_tpu_torch.native): at DBoW2-scale vocabularies the tree
descent is what makes assignment tractable, and `assign_hierarchical`
implements it; at the `branching**levels <= 4096` sizes used here, exact
flat argmin over the leaves is both faster (one (N, W) popcount pass,
measured far below 1 ms per 500-descriptor keyframe) and strictly more
accurate, so `assign` uses it by default.

Keyframes are TF-IDF vectors over words; query scoring is cosine
similarity via an inverted index with temporal-adjacency exclusion — the
same candidate-gating policy as the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def hamming_backend() -> str:
    """Which implementation ``hamming_distances`` runs: "native" (the C++
    popcount kernel of rgbid_tpu_torch.native) when the machine has the
    toolchain that builds it, else "numpy". A toolchain whose build fails
    raises there; it does not switch to numpy."""
    from .. import native

    return "native" if native.toolchain() is not None else "numpy"


def hamming_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distances between (N, 32) and (M, 32) uint8 rows,
    by ``hamming_backend()``'s implementation (the two are held equal in
    tests/test_torch_backend.py)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.int32)
    if hamming_backend() == "native":
        from .. import native

        return native.hamming_batch(a, b)
    return hamming_distances_numpy(a, b)


def hamming_distances_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``hamming_distances`` in numpy (``bitwise_count``)."""
    a64 = np.ascontiguousarray(a).view(np.uint64)  # (N, 4)
    b64 = np.ascontiguousarray(b).view(np.uint64)  # (M, 4)
    out = np.zeros((len(a), len(b)), np.int32)
    # Chunk over a to bound the (chunk, M, 4) xor intermediate.
    step = max(1, int(4e6 // max(len(b), 1)))
    for i in range(0, len(a), step):
        x = np.bitwise_xor(a64[i : i + step, None, :], b64[None, :, :])
        out[i : i + step] = np.bitwise_count(x).sum(axis=2, dtype=np.int32)
    return out


def _majority_center(descs: np.ndarray) -> np.ndarray:
    """Hamming-metric median of binary descriptors: per-bit majority vote."""
    bits = np.unpackbits(descs, axis=1)  # (N, 256)
    maj = (bits.sum(axis=0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj)


def _kmedians(
    descs: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Binary k-medians (Hamming metric). Returns (centers (k, 32), assign).

    Empty clusters are reseeded from the farthest points of the largest
    cluster, so exactly k centers always come back (complete-tree
    invariant for the vocabulary)."""
    n = len(descs)
    if n <= k:
        # Degenerate: every descriptor its own center, pad by repetition.
        reps = descs[rng.integers(0, n, k - n)] if n > 0 else np.zeros((k - n, 32), np.uint8)
        centers = np.concatenate([descs, reps]) if n > 0 else reps
        return centers.astype(np.uint8), np.arange(n) % k
    centers = descs[rng.choice(n, k, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = hamming_distances(descs, centers)  # (n, k)
        assign = d.argmin(axis=1)
        for j in range(k):
            members = descs[assign == j]
            if len(members) == 0:
                # Reseed from the point farthest from its center.
                far = d[np.arange(n), assign].argmax()
                centers[j] = descs[far]
            else:
                centers[j] = _majority_center(members)
    return centers, assign


class HierarchicalVocabulary:
    """branching^levels visual-word tree over 256-bit binary descriptors.

    ``nodes[l]`` holds the (branching^(l+1), 32) centers of tree level
    l+1 (complete tree; node n's children occupy rows n*B .. (n+1)*B-1 of
    the next level). The last level's rows are the WORDS.
    """

    def __init__(self, branching: int = 8, levels: int = 3, seed: int = 0):
        self.branching = branching
        self.levels = levels
        self.seed = seed
        self.nodes: List[np.ndarray] = []

    @property
    def trained(self) -> bool:
        return bool(self.nodes)

    @property
    def num_words(self) -> int:
        return len(self.nodes[-1]) if self.nodes else 0

    @property
    def words(self) -> np.ndarray:
        return self.nodes[-1] if self.nodes else np.zeros((0, 32), np.uint8)

    def train(self, descs: np.ndarray) -> None:
        """Hierarchical k-medians over the corpus (recursive split)."""
        B, L = self.branching, self.levels
        rng = np.random.default_rng(self.seed)
        descs = np.ascontiguousarray(descs, np.uint8)
        nodes: List[np.ndarray] = []
        # groups[i] = descriptor subset under node i of the current level.
        groups: List[np.ndarray] = [descs]
        for _l in range(L):
            centers_l = []
            next_groups: List[np.ndarray] = []
            for g in groups:
                c, a = _kmedians(g, B, rng)
                centers_l.append(c)
                for j in range(B):
                    next_groups.append(g[a == j] if len(g) else g)
            nodes.append(np.concatenate(centers_l).astype(np.uint8))
            groups = next_groups
        self.nodes = nodes

    def save(self, path: str) -> None:
        """Serialize the trained tree (DBoW2's vocabulary-file parity:
        the reference loads a pretrained vocabulary at startup)."""
        if not self.trained:
            raise ValueError("cannot save an untrained vocabulary")
        arrays = {f"level_{i}": n for i, n in enumerate(self.nodes)}
        np.savez_compressed(
            path,
            branching=np.asarray(self.branching),
            levels=np.asarray(self.levels),
            **arrays,
        )

    @classmethod
    def load(cls, path: str) -> "HierarchicalVocabulary":
        z = np.load(path)
        v = cls(branching=int(z["branching"]), levels=int(z["levels"]))
        v.nodes = [
            np.ascontiguousarray(z[f"level_{i}"], np.uint8)
            for i in range(v.levels)
        ]
        return v

    def assign(self, descs: np.ndarray) -> np.ndarray:
        """Exact word ids: ONE batched Hamming pass over all leaf words."""
        if len(descs) == 0:
            return np.zeros(0, np.int32)
        d = hamming_distances(descs, self.nodes[-1])
        return d.argmin(axis=1).astype(np.int32)

    def assign_hierarchical(self, descs: np.ndarray) -> np.ndarray:
        """Approximate word ids by tree descent (DBoW2's strategy —
        O(B*levels) comparisons per descriptor; the right choice for
        million-word vocabularies, kept for parity and tested against
        ``assign``)."""
        if len(descs) == 0:
            return np.zeros(0, np.int32)
        B = self.branching
        node = np.zeros(len(descs), np.int64)  # current node per descriptor
        for centers in self.nodes:
            # Children of node n are rows n*B..(n+1)*B-1 of this level.
            best = np.zeros(len(descs), np.int64)
            for n in np.unique(node):
                sel = node == n
                d = hamming_distances(descs[sel], centers[n * B : (n + 1) * B])
                best[sel] = n * B + d.argmin(axis=1)
            node = best
        return node.astype(np.int32)


class OnlineVocabulary:
    """Flat visual vocabulary grown from the data stream (cold-start
    fallback until the hierarchical tree has a training corpus)."""

    def __init__(self, max_words: int = 512, radius: int = 80):
        self.max_words = max_words
        self.radius = radius
        self.words = np.zeros((0, 32), np.uint8)

    def assign(self, desc: np.ndarray, grow: bool = True) -> np.ndarray:
        """Assign descriptors (N, 32) to word ids, growing the vocabulary.

        Batched: one Hamming pass against the current words; descriptors
        beyond the radius found new words (assigned sequentially so
        intra-batch duplicates collapse onto the first founder).
        """
        n = len(desc)
        ids = np.full(n, -1, np.int32)
        if n == 0:
            return ids
        if len(self.words) > 0:
            d = hamming_distances(desc, self.words)
            nearest = d.argmin(axis=1)
            nd = d[np.arange(n), nearest]
            ok = (nd <= self.radius) | (not grow) | (len(self.words) >= self.max_words)
            ids[ok] = nearest[ok].astype(np.int32)
        pending = np.flatnonzero(ids < 0)
        if not grow or len(pending) == 0:
            ids[ids < 0] = 0 if len(self.words) else -1
            return ids
        # Founders: assign sequentially against the words added this batch.
        for i in pending:
            if len(self.words) >= self.max_words:
                d = hamming_distances(desc[i : i + 1], self.words)[0]
                ids[i] = int(d.argmin())
                continue
            if len(self.words) > 0:
                d = hamming_distances(desc[i : i + 1], self.words)[0]
                j = int(d.argmin())
                if d[j] <= self.radius:
                    ids[i] = j
                    continue
            self.words = np.concatenate([self.words, desc[i : i + 1]], axis=0)
            ids[i] = len(self.words) - 1
        return ids


def resolve_vocab_path(path: str) -> str:
    """Resolve a vocabulary path; the sentinel "builtin" maps to the
    packaged vocabulary (rgbid_tpu_torch/data/vocab_b8l4.npz — 8^4 = 4096
    words, trained offline by backend.build_vocab on a 48-scene
    multi-resolution/motion/illumination synthetic ORB corpus; round-3
    revisit benchmark: recall 1.0, precision 0.92-0.98 with the sqrt-tf
    + relative-score scoring defaults, vs 0.90 for in-run training)."""
    if path == "builtin":
        import os

        return os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "data",
            "vocab_b8l4.npz",
        )
    return path


class BowDatabase:
    """TF-IDF inverted-index keyframe database with temporal gating.

    Vocabulary lifecycle: flat online vocabulary from frame 0; once
    ``train_after`` descriptors have accumulated, a hierarchical
    k-medians tree (branching^levels words) is trained on the full corpus
    and every stored keyframe is re-quantized; the tree is retrained each
    time the corpus quadruples (bounded number of retrains per run).
    """

    def __init__(
        self,
        max_words: int = 512,
        radius: int = 80,
        min_score: float = 0.12,
        min_gap: int = 10,
        max_candidates: int = 4,
        branching: int = 8,
        levels: int = 3,
        train_after: int = 3000,
        vocab_path: str = "",
        stop_df: float = 1.0,
        tf_mode: str = "linear",
        rel_score: float = 0.0,
    ):
        self.flat = OnlineVocabulary(max_words, radius)
        if vocab_path:
            # Pretrained vocabulary file (the reference's DBoW2 model:
            # load at startup, never retrain): quantization is stable
            # from keyframe 0, no flat-vocabulary cold start, and stored
            # keyframes never need re-quantization.
            self.vocab = HierarchicalVocabulary.load(
                resolve_vocab_path(vocab_path)
            )
            train_after = 1 << 62
        else:
            self.vocab = HierarchicalVocabulary(branching, levels)
        self.train_after = train_after
        self._next_train = train_after
        self.min_score = min_score
        self.min_gap = min_gap
        self.max_candidates = max_candidates
        # Stop-word gate: words present in more than this fraction of
        # stored keyframes carry no place information (DBoW2's stop-word
        # analog on top of TF-IDF) and are dropped from scoring vectors.
        # Only applied once enough keyframes exist for document
        # frequencies to be meaningful. 1.0 = off.
        self.stop_df = stop_df
        # Term-frequency transform: "linear" (raw counts, DBoW2-style),
        # "sqrt" (burstiness damping), or "binary" (word presence only).
        # sqrt measured +3-5 precision points on the revisit benchmark.
        self.tf_mode = tf_mode
        # Relative-score gate (DBoW2's normalized-score analog): keep
        # only candidates scoring at least this fraction of the best
        # candidate's score. Trailing weak candidates are mostly false
        # positives; the best match survives by construction. 0 = off.
        # 0.65 measured +7-8 precision points at unchanged recall; 0.8
        # started costing recall.
        self.rel_score = rel_score
        # keyframe id -> sparse word-count dict
        self.entries: Dict[int, Dict[int, int]] = {}
        # keyframe id -> raw descriptors (kept for re-quantization)
        self.raw: Dict[int, np.ndarray] = {}
        # word id -> list of keyframe ids containing it
        self.inverted: Dict[int, List[int]] = {}
        self._n_desc = 0

    # ------------------------------------------------------------------
    def _assign(self, desc: np.ndarray, grow: bool) -> np.ndarray:
        if self.vocab.trained:
            return self.vocab.assign(desc)
        return self.flat.assign(desc, grow=grow)

    def _bow(self, desc: np.ndarray, grow: bool) -> Dict[int, int]:
        ids = self._assign(desc, grow)
        counts: Dict[int, int] = {}
        for w in ids:
            if w >= 0:
                counts[int(w)] = counts.get(int(w), 0) + 1
        return counts

    def _idf(self, word: int) -> float:
        n_kf = max(len(self.entries), 1)
        n_w = max(len(self.inverted.get(word, ())), 1)
        return float(np.log(n_kf / n_w)) + 1e-3

    def _vector(self, counts: Dict[int, int]) -> Dict[int, float]:
        n_kf = len(self.entries)
        if self.stop_df < 1.0 and n_kf >= 10:
            cut = self.stop_df * n_kf
            counts = {
                w: c
                for w, c in counts.items()
                if len(self.inverted.get(w, ())) <= cut
            }
        if self.tf_mode == "sqrt":
            tf = {w: float(np.sqrt(c)) for w, c in counts.items()}
        elif self.tf_mode == "binary":
            tf = {w: 1.0 for w in counts}
        else:
            tf = counts
        vec = {w: c * self._idf(w) for w, c in tf.items()}
        norm = np.sqrt(sum(v * v for v in vec.values()))
        if norm > 0:
            vec = {w: v / norm for w, v in vec.items()}
        return vec

    def _maybe_train(self) -> None:
        if self._n_desc < self._next_train or not self.raw:
            return
        corpus = np.concatenate(list(self.raw.values()))
        self.vocab.train(corpus)
        self._next_train = max(self._next_train * 4, self._n_desc + 1)
        # Re-quantize every stored keyframe against the new words.
        self.entries = {}
        self.inverted = {}
        for kf_id, desc in self.raw.items():
            counts = self._bow(desc, grow=False)
            self.entries[kf_id] = counts
            for w in counts:
                self.inverted.setdefault(w, []).append(kf_id)

    # ------------------------------------------------------------------
    def query(self, kf_id: int, desc: np.ndarray) -> List[Tuple[int, float]]:
        """Score against stored keyframes (excluding temporal neighbors).

        Returns [(kf_id, score)] sorted by descending score, gated.
        """
        counts = self._bow(desc, grow=False)
        vec = self._vector(counts)
        # Gather candidate kfs sharing at least one word.
        cand_ids = set()
        for w in counts:
            cand_ids.update(self.inverted.get(w, ()))
        scores = []
        for cid in cand_ids:
            if abs(cid - kf_id) < self.min_gap:
                continue
            cvec = self._vector(self.entries[cid])
            s = sum(vec.get(w, 0.0) * v for w, v in cvec.items())
            if s >= self.min_score:
                scores.append((cid, float(s)))
        scores.sort(key=lambda t: -t[1])
        if self.rel_score > 0.0 and scores:
            cut = self.rel_score * scores[0][1]
            scores = [t for t in scores if t[1] >= cut]
        return scores[: self.max_candidates]

    def insert(self, kf_id: int, desc: np.ndarray) -> None:
        self.raw[kf_id] = np.ascontiguousarray(desc, np.uint8)
        self._n_desc += len(desc)
        counts = self._bow(desc, grow=True)
        self.entries[kf_id] = counts
        for w in counts:
            self.inverted.setdefault(w, []).append(kf_id)
        self._maybe_train()
