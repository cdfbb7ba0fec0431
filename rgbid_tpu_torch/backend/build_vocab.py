"""Offline vocabulary builder (the reference's pretrained DBoW2 model).

The port's copy of ``rgbid_tpu/backend/build_vocab.py``: ORB descriptors
are extracted from many synthetic scenes (different seeds, viewpoints and
illumination) and a branching^levels hierarchical k-medians tree is trained
and saved. The scenes come from the port's renderer, the grey image from
``gray_from_rgb`` (OpenCV's integer RGB-to-grey rule, which the reference
applies) and the descriptors from the port's numpy ORB.

    python -m rgbid_tpu_torch.backend.build_vocab --out vocab_b8l4.npz

The corpus order feeds the k-medians seeding (``place_recognition.
_kmedians``), so the tree depends on it. The port's ORB returns a frame's
descriptors level by level, row-major within a level; OpenCV's order comes
out of a partial sort and can differ on a busy image. The rendered corpus
frames have far fewer corners than the ORB's per-level quotas (tens against
500), and there the two orders agree: the corpus equals the reference's
element for element, and the tree trained at the default settings equals
the packaged ``data/vocab_b8l4.npz`` byte for byte.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_corpus(
    n_scenes: int = 48, frames_per_scene: int = 8, num_features: int = 500
) -> np.ndarray:
    """Multi-scene, multi-condition ORB corpus, frame after frame.

    Diversity axes: scene seed (texture spectra), two resolutions (the ORB
    patch statistics the tree must cover depend on scale), orbit vs loop
    motion (viewpoint coverage), and exposure drift on a third of the
    scenes (illumination robustness)."""
    from ..core.camera import Intrinsics
    from ..datasets import synthetic
    from ..tracking.step import gray_from_rgb
    from .features import extract_orb

    intrs = [
        Intrinsics(fx=258.6, fy=258.2, cx=159.5, cy=119.5, width=320, height=240),
        Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120),
    ]
    descs = []
    for s in range(n_scenes):
        if s % 2 == 0:
            mkw = dict(
                motion="orbit",
                trans_amp=0.2 + 0.05 * (s % 4),
                rot_amp=0.05 + 0.02 * (s % 3),
            )
        else:
            mkw = dict(
                motion="loop",
                radius=0.35 + 0.05 * (s % 4),
                rot_amp=0.08 + 0.02 * (s % 3),
            )
        seq = synthetic.generate_sequence(
            n_frames=frames_per_scene,
            intr=intrs[s % len(intrs)],
            exposure_drift=0.15 if s % 3 == 0 else 0.0,
            seed=100 + s,
            **mkw,
        )
        for i in range(len(seq)):
            _, d = extract_orb(gray_from_rgb(seq.rgb[i]), num_features)
            if len(d):
                descs.append(d)
    return np.concatenate(descs).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--branching", type=int, default=8)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--scenes", type=int, default=48)
    ap.add_argument("--frames-per-scene", type=int, default=8)
    args = ap.parse_args(argv)

    from .place_recognition import HierarchicalVocabulary

    corpus = build_corpus(args.scenes, args.frames_per_scene)
    print(f"corpus: {len(corpus)} descriptors", file=sys.stderr)
    vocab = HierarchicalVocabulary(args.branching, args.levels)
    vocab.train(corpus)
    vocab.save(args.out)
    print(
        f"saved {args.branching}^{args.levels} = {vocab.num_words}-word "
        f"vocabulary to {args.out}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
