"""Place recognition through the port's ORB, on the CPU.

The two revisit clips of ``tests/test_vocabulary.py`` (two passes around one
loop, 110 frames at 160x120, 300 features): the port's extractor feeds the
port's ``BowDatabase``, under the thresholds those tests hold the JAX
package to, and the candidate lists are compared with the ones OpenCV's
descriptors give in the same database.

Tolerances, and why: the port's descriptors are OpenCV's as a set, in
another order. The packaged vocabulary quantizes each descriptor on its own
and a BoW vector is a histogram, so there the candidate lists must be equal
on every query. The in-run vocabulary is trained on the descriptors in the
order they arrive (k-medoids seeded by position), so its words, and with
them some candidates, may differ: the top candidate is held equal on at
least 90% of the queries.
"""

import cv2
import numpy as np
import pytest

from rgbid_tpu.backend.features import extract_orb as cv2_extract_orb
from rgbid_tpu.core.camera import Intrinsics as JIntrinsics
from rgbid_tpu.datasets import synthetic
from rgbid_tpu_torch.backend.features import extract_orb
from rgbid_tpu_torch.backend.place_recognition import BowDatabase
from rgbid_tpu_torch.tracking.step import gray_from_rgb

MIN_GAP = 12
CONFIGS = {
    # (database settings, least recall, least precision, least share of
    # queries with the same top candidate, with the same candidate set)
    "in-run": (dict(train_after=1500), 0.7, 0.5, 0.9, 0.0),
    "packaged": (dict(vocab_path="builtin", tf_mode="sqrt", rel_score=0.65), 0.95, 0.85, 1.0, 1.0),
}


@pytest.fixture(scope="module")
def clip():
    intr = JIntrinsics(fx=129.3, fy=129.1, cx=79.6, cy=59.8, width=160, height=120)
    poses = synthetic.loopy_trajectory(55, radius=0.45, rot_amp=0.12)
    poses = poses + poses  # the second pass revisits the first
    seq = synthetic.generate_sequence(n_frames=len(poses), intr=intr, motion=poses, seed=7)
    ours, theirs = [], []
    for rgb in seq.rgb:
        ours.append(extract_orb(gray_from_rgb(rgb), 300)[1])
        theirs.append(cv2_extract_orb(cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY), 300)[1])
    return poses, ours, theirs


def _run(poses, descs, settings):
    """Recall and precision as ``tests/test_vocabulary.py`` counts them, and
    each query's candidate list."""
    db = BowDatabase(min_score=0.02, min_gap=MIN_GAP, max_candidates=4, **settings)
    hits = misses = n_returned = n_true = 0
    lists = {}
    for i in range(len(poses)):
        positives = {
            j for j in range(i)
            if abs(i - j) >= MIN_GAP
            and np.linalg.norm(poses[i][:3, 3] - poses[j][:3, 3]) < 0.15
        }
        if positives:
            got = [cid for cid, _ in db.query(i, descs[i])]
            lists[i] = got
            n_returned += len(got)
            n_true += len(set(got) & positives)
            if set(got) & positives:
                hits += 1
            else:
                misses += 1
        db.insert(i, descs[i])
    return hits / max(hits + misses, 1), n_true / max(n_returned, 1), lists, db


def test_descriptors_equal_cv2_as_sets_on_every_frame(clip):
    _, ours, theirs = clip
    for a, b in zip(ours, theirs):
        assert sorted(map(bytes, a)) == sorted(map(bytes, b))
    assert sum(len(a) for a in ours) > 2000


@pytest.mark.parametrize("name", list(CONFIGS))
def test_revisit_clip_through_the_ports_orb(clip, name):
    poses, ours, theirs = clip
    settings, min_recall, min_precision, min_top, min_set = CONFIGS[name]
    recall, precision, lists, db = _run(poses, ours, settings)
    r_cv, p_cv, lists_cv, _ = _run(poses, theirs, settings)
    assert db.vocab.trained
    same_top = np.mean([lists[i][:1] == lists_cv[i][:1] for i in lists])
    same_set = np.mean([set(lists[i]) == set(lists_cv[i]) for i in lists])
    print(f"{name}: recall {recall:.3f} precision {precision:.3f} over {len(lists)} queries "
          f"(OpenCV's descriptors: {r_cv:.3f}, {p_cv:.3f}); same top candidate "
          f"{same_top:.3f}, same candidate set {same_set:.3f}")
    assert recall >= min_recall and precision >= min_precision, (recall, precision)
    assert same_top >= min_top and same_set >= min_set, (same_top, same_set)
