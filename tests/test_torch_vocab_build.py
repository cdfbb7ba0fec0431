"""The port's vocabulary builder against the JAX package's, on the CPU.

``build_corpus(2, 2)`` in both packages: the descriptors of every corpus
frame equal as multisets (the port's ORB is OpenCV's as a set, its order
within a level is row-major), and the whole corpus; then
``HierarchicalVocabulary`` trained on one corpus array in both packages
gives the same tree."""

import numpy as np

from rgbid_tpu.backend import build_vocab as jbuild
from rgbid_tpu.backend import features as jfeatures
from rgbid_tpu.backend.place_recognition import HierarchicalVocabulary as JVocab
from rgbid_tpu_torch.backend import build_vocab
from rgbid_tpu_torch.backend import features
from rgbid_tpu_torch.backend.place_recognition import HierarchicalVocabulary


def _recording(monkeypatch, module):
    frames = []
    orig = module.extract_orb

    def rec(img, n):
        kp, d = orig(img, n)
        frames.append(d)
        return kp, d

    monkeypatch.setattr(module, "extract_orb", rec)
    return frames


def _multiset(d):
    return sorted(map(bytes, d))


def test_build_corpus_frames_equal_jax_as_multisets(monkeypatch):
    ours = _recording(monkeypatch, features)
    theirs = _recording(monkeypatch, jfeatures)
    corpus = build_vocab.build_corpus(2, 2)
    jcorpus = jbuild.build_corpus(2, 2)
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert len(a) > 0 and _multiset(a) == _multiset(b)
    assert corpus.dtype == np.uint8 and corpus.shape == jcorpus.shape
    assert _multiset(corpus) == _multiset(jcorpus)
    # The rendered frames have far fewer corners than the per-level quotas,
    # so OpenCV's order is the port's row-major one: equal element for element.
    np.testing.assert_array_equal(corpus, jcorpus)


def test_vocabulary_trained_on_one_corpus_equals_jax(tmp_path):
    corpus = jbuild.build_corpus(2, 2)
    ours, theirs = HierarchicalVocabulary(8, 4), JVocab(8, 4)
    ours.train(corpus)
    theirs.train(corpus)
    ours.save(str(tmp_path / "port.npz"))
    theirs.save(str(tmp_path / "jax.npz"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    q = corpus[::7]
    np.testing.assert_array_equal(ours.assign(q), theirs.assign(q))
