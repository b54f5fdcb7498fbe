"""Binary bag-of-words vocabulary for place recognition.

Counterpart of orb_slam2_detailed_comments_tpu/place/vocabulary.py, the
replacement of DBoW2's TemplatedVocabulary (reference:
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:135-241): a FLAT vocabulary
whose quantization is one Hamming argmin over all words, with TF-IDF
weights and L1 scoring, trained by binary k-medians (majority-bit voting).

The all-pairs distances run on `device` through ops/hamming.py; they are
integers, and torch.argmin takes the first minimum as np.argmin does, so
the words and BoW vectors equal the JAX package's. The rest is host numpy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..interop import desc_to_torch
from ..ops.hamming import hamming_distance_matrix


def _unpack_bits_np(desc):
    """(N, 8) uint32 -> (N, 256) uint8 bits."""
    bits = ((desc[:, :, None] >> np.arange(32, dtype=np.uint32)[None, None, :]) & 1)
    return bits.reshape(desc.shape[0], 256).astype(np.uint8)


def _pack_bits_np(bits):
    b = bits.reshape(-1, 8, 32).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)[None, None, :]).sum(axis=2).astype(np.uint32)


def _nearest(desc: np.ndarray, words: np.ndarray, device) -> np.ndarray:
    """Index of the nearest word (first on ties) for each descriptor."""
    d = hamming_distance_matrix(desc_to_torch(desc, device), desc_to_torch(words, device))
    return d.argmin(dim=1).cpu().numpy()


class BinaryVocabulary:
    """Flat binary vocabulary with TF-IDF weights and L1 scoring."""

    def __init__(self, words: np.ndarray, idf: Optional[np.ndarray] = None,
                 device="cuda"):
        self.words = np.asarray(words, np.uint32)        # (W, 8)
        self.n_words = self.words.shape[0]
        self.idf = (np.asarray(idf, np.float32) if idf is not None
                    else np.ones(self.n_words, np.float32))
        self.device = device

    # ------------------------------------------------------------------

    @classmethod
    def train(cls, descriptors: np.ndarray, n_words: int = 2048,
              n_iters: int = 4, seed: int = 0, device="cuda") -> "BinaryVocabulary":
        """Binary k-medians: assign by Hamming distance, update centers by
        per-bit majority vote (the same center update DBoW2's training uses,
        FORB::meanValue)."""
        rng = np.random.default_rng(seed)
        desc = np.unique(descriptors, axis=0)
        if len(desc) < n_words:
            # duplicate-pad: degenerate but functional for tiny training sets
            reps = int(np.ceil(n_words / max(len(desc), 1)))
            desc = np.tile(desc, (reps, 1))[: max(n_words, len(desc))]
        centers = desc[rng.choice(len(desc), n_words, replace=False)]

        for _ in range(n_iters):
            assign = _nearest(desc, centers, device)
            bits = _unpack_bits_np(desc)
            sums = np.zeros((n_words, 256), np.int64)
            counts = np.zeros(n_words, np.int64)
            np.add.at(sums, assign, bits)
            np.add.at(counts, assign, 1)
            nonempty = counts > 0
            maj = (sums >= (counts[:, None] + 1) // 2).astype(np.uint8)
            new_centers = centers.copy()
            new_centers[nonempty] = _pack_bits_np(maj[nonempty])
            # re-seed empty clusters from random descriptors
            n_empty = int((~nonempty).sum())
            if n_empty:
                new_centers[~nonempty] = desc[rng.choice(len(desc), n_empty)]
            centers = new_centers

        # idf from training distribution
        assign = _nearest(desc, centers, device)
        df = np.bincount(assign, minlength=n_words).astype(np.float32)
        idf = np.log(len(desc) / np.maximum(df, 1.0))
        return cls(centers, idf, device)

    # ------------------------------------------------------------------

    def transform(self, desc: np.ndarray, valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Quantize descriptors -> (word_ids (N,), bow (W,) dense L1-normalized
        TF-IDF vector). Replaces TemplatedVocabulary::transform
        (reference: TemplatedVocabulary.h:192-241)."""
        word_ids = _nearest(desc, self.words, self.device).astype(np.int32)
        word_ids[~valid] = -1
        bow = np.zeros(self.n_words, np.float32)
        ok = word_ids[word_ids >= 0]
        np.add.at(bow, ok, 1.0)
        bow *= self.idf
        s = bow.sum()
        if s > 0:
            bow /= s
        return word_ids, bow

    @staticmethod
    def score(v1: np.ndarray, v2: np.ndarray) -> float:
        """DBoW2 L1 score: 1 - 0.5 |v1 - v2|_1 = sum_w min(v1, v2) for
        L1-normalized vectors (reference: ScoringObject.cc L1Scoring)."""
        return float(np.minimum(v1, v2).sum())

    def save(self, path: str) -> None:
        np.savez_compressed(path, words=self.words, idf=self.idf)

    @classmethod
    def load(cls, path: str, device="cuda") -> "BinaryVocabulary":
        data = np.load(path)
        return cls(data["words"], data["idf"], device)
