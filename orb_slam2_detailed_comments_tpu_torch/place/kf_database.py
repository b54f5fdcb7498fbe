"""Keyframe database for loop/relocalization candidate retrieval.

TPU-native replacement for KeyFrameDatabase
(reference: src/KeyFrameDatabase.cc). Round 3 restored the reference's
SPARSE inverted index (word -> keyframe list, KeyFrameDatabase.h:103-105):
round 2's dense (KF_cap, n_words) matrix was one matmul per query, but at
ORBvoc scale (10^6 words x 1024 KFs) it is 4 GB — the inverted index is
exactly the sparsity that makes big vocabularies viable. Per-keyframe
bags are stored as fixed-cap (word_id, weight) arrays (a keyframe has at
most n_features distinct words, ~10^2-10^3 << n_words); shared-word
counting walks only the query's word lists, and L1 scores are gathered
per candidate. The selection cascade (0.8*maxCommonWords, minScore,
covisibility-group accumulation, 0.75*bestAccScore) is unchanged.

A copy of orb_slam2_detailed_comments_tpu/place/kf_database.py (pure numpy:
its numpy sorts keep the JAX package's tie order).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .vocabulary import BinaryVocabulary


class KeyFrameDatabase:
    def __init__(self, voc: BinaryVocabulary, max_keyframes: int,
                 per_kf_word_cap: int = 2048):
        self.voc = voc
        self.KF_CAP = max_keyframes
        self.W_CAP = per_kf_word_cap
        # sparse per-KF bags: word ids (pad 0) + weights (pad 0.0) — a
        # padded slot contributes min(0, q)=0 to the L1 score by design
        self.kf_words = np.zeros((max_keyframes, per_kf_word_cap), np.int64)
        self.kf_weights = np.zeros((max_keyframes, per_kf_word_cap),
                                   np.float32)
        self.kf_n_words = np.zeros(max_keyframes, np.int32)
        self.active = np.zeros(max_keyframes, bool)
        # inverted index: word -> list of keyframes containing it
        # (reference: mvInvertedFile, KeyFrameDatabase.h:103-105); ERASED
        # keyframes stay in the lists and are masked by `active` (lazy);
        # RE-ADDED slots purge their old words first (see add())
        self.inv: Dict[int, List[int]] = {}

    def _grow(self, need: int) -> None:
        """Track MapStore's growable keyframe capacity (slot ids are
        persistent and unbounded on long routes)."""
        new = max(int(self.KF_CAP * 1.5 + 1), need + 1)
        extra = new - self.KF_CAP
        self.kf_words = np.concatenate(
            [self.kf_words, np.zeros((extra, self.W_CAP), np.int64)])
        self.kf_weights = np.concatenate(
            [self.kf_weights, np.zeros((extra, self.W_CAP), np.float32)])
        self.kf_n_words = np.concatenate(
            [self.kf_n_words, np.zeros(extra, np.int32)])
        self.active = np.concatenate([self.active, np.zeros(extra, bool)])
        self.KF_CAP = new

    def add(self, kf: int, bow: np.ndarray) -> None:
        if kf >= self.KF_CAP:
            self._grow(kf)
        # re-adding a slot (vocabulary swap, recycled KF id) must purge
        # its OLD words from the inverted lists first — _common_words
        # assumes a KF appears at most once per word list
        n_old = int(self.kf_n_words[kf])
        if n_old:
            for w in self.kf_words[kf, :n_old]:
                lst = self.inv.get(int(w))
                if lst is not None:
                    try:
                        lst.remove(kf)
                    except ValueError:
                        pass
        words = np.nonzero(bow > 0)[0]
        if words.size > self.W_CAP:
            # keep the heaviest words (never expected: distinct words per
            # KF <= feature count <= W_CAP)
            order = np.argsort(-bow[words])[: self.W_CAP]
            words = np.sort(words[order])
        n = words.size
        self.kf_words[kf, :n] = words
        self.kf_words[kf, n:] = 0
        self.kf_weights[kf, :n] = bow[words]
        self.kf_weights[kf, n:] = 0.0
        self.kf_n_words[kf] = n
        self.active[kf] = True
        for w in words:
            self.inv.setdefault(int(w), []).append(kf)

    def erase(self, kf: int) -> None:
        self.active[kf] = False

    def clear(self) -> None:
        self.active[:] = False
        self.kf_n_words[:] = 0
        self.inv.clear()

    # ------------------------------------------------------------------

    def _common_words(self, bow_q: np.ndarray) -> np.ndarray:
        """Shared-word counts via the inverted index: walk only the
        query's word lists (reference: KeyFrameDatabase.cc:129-151)."""
        counts = np.zeros(self.KF_CAP, np.int32)
        for w in np.nonzero(bow_q > 0)[0]:
            lst = self.inv.get(int(w))
            if lst:
                # a KF appears at most once per word list -> plain fancy
                # add is duplicate-free
                counts[lst] += 1
        return counts

    def _scores_for(self, kfs: np.ndarray, bow_q: np.ndarray) -> np.ndarray:
        """L1 similarity sum(min(v_kf, v_q)) for the given keyframes only
        (pad slots have weight 0 -> contribute 0)."""
        if kfs.size == 0:
            return np.zeros(0, np.float32)
        w = self.kf_words[kfs]                  # (m, W_CAP)
        return np.minimum(self.kf_weights[kfs], bow_q[w]).sum(axis=1)

    def _score_map(self, kfs, bow_q):
        s = self._scores_for(np.asarray(kfs, np.int64), bow_q)
        return {int(k): float(v) for k, v in zip(kfs, s)}

    def _group_cascade(self, cand: np.ndarray, common: np.ndarray,
                       min_common: int, mask: np.ndarray, bow_q: np.ndarray,
                       map_store) -> List[int]:
        """Covisibility-group accumulation + 0.75*bestAccScore filter
        (reference: KeyFrameDatabase.cc:186-263)."""
        need = set(int(c) for c in cand)
        groups = {}
        for c in cand:
            group = [int(c)] + [int(x) for x in map_store.get_covisible(int(c), 10)]
            g = [x for x in group if mask[x] and common[x] > min_common]
            groups[int(c)] = g
            need.update(g)
        scores = self._score_map(sorted(need), bow_q)
        acc_scores = []
        for c in cand:
            g = groups[int(c)]
            acc = sum(scores[x] for x in g) if g else scores[int(c)]
            best_in_group = max(g, key=lambda x: scores[x]) if g else int(c)
            acc_scores.append((acc, best_in_group))
        best_acc = max(a for a, _ in acc_scores)
        out = []
        seen = set()
        for acc, best_kf in acc_scores:
            if acc > 0.75 * best_acc and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return out

    def detect_loop_candidates(self, kf: int, bow_q: np.ndarray, min_score: float,
                               covisible: np.ndarray, map_store) -> List[int]:
        """reference: KeyFrameDatabase::DetectLoopCandidates
        (KeyFrameDatabase.cc:114-263)."""
        common = self._common_words(bow_q)
        mask = self.active.copy()
        mask[kf] = False
        mask[covisible] = False  # exclude the covisible neighborhood
        common = np.where(mask, common, 0)
        if common.max(initial=0) == 0:
            return []
        min_common = int(0.8 * common.max())
        pre = np.nonzero(mask & (common > min_common))[0]
        if pre.size == 0:
            return []
        pre_scores = self._scores_for(pre, bow_q)
        cand = pre[pre_scores >= min_score]
        if cand.size == 0:
            return []
        return self._group_cascade(cand, common, min_common, mask, bow_q,
                                   map_store)

    def detect_relocalization_candidates(self, bow_q: np.ndarray, map_store) -> List[int]:
        """reference: KeyFrameDatabase::DetectRelocalizationCandidates
        (KeyFrameDatabase.cc:274-411) — same cascade without covisibility
        exclusion or minScore."""
        common = self._common_words(bow_q)
        common = np.where(self.active, common, 0)
        if common.max(initial=0) == 0:
            return []
        min_common = int(0.8 * common.max())
        cand = np.nonzero(self.active & (common > min_common))[0]
        if cand.size == 0:
            return []
        return self._group_cascade(cand, common, min_common, self.active,
                                   bow_q, map_store)
