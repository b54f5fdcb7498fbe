"""Parity of the port's place recognition (place/) with the JAX package's,
on the CPU: the same seeded descriptors through both. Hamming distances
are integers and both take the first minimum, so everything is exact:

  * BinaryVocabulary.train: the same words and idf; transform: the same
    word ids and BoW vectors;
  * TreeVocabulary.transform on the shipped vocabulary: the same words and
    BoW vectors, and the two packages' default_vocab.npz are byte-identical;
  * KeyFrameDatabase.detect_relocalization_candidates: the same list, from
    databases fed alike and from one carried across by interop;
  * interop.vocabulary_from_jax: the same transform.
"""
import filecmp
import types
from pathlib import Path

import numpy as np
import pytest

from orb_slam2_detailed_comments_tpu import system as JS
from orb_slam2_detailed_comments_tpu.place import kf_database as JDB, vocabulary as JV
from orb_slam2_detailed_comments_tpu_torch import system as TS
from orb_slam2_detailed_comments_tpu_torch.interop import kf_database_from_jax, vocabulary_from_jax
from orb_slam2_detailed_comments_tpu_torch.place import kf_database as TDB, vocabulary as TV

REPO = Path(__file__).resolve().parents[1]


def _clustered_descriptors(seed, n_centers=64, per=40, flips=12):
    """Descriptors around random centers: each a center with `flips`
    random bits flipped."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2 ** 32, (n_centers, 8), dtype=np.uint32)
    d = np.repeat(centers, per, axis=0)
    for _ in range(flips):
        w = rng.integers(0, 8, len(d))
        d[np.arange(len(d)), w] ^= np.uint32(1) << rng.integers(0, 32, len(d)).astype(np.uint32)
    return d


def test_binary_vocabulary_train_and_transform_match_jax():
    train = _clustered_descriptors(0)
    vj = JV.BinaryVocabulary.train(train, n_words=128, n_iters=3, seed=1)
    vt = TV.BinaryVocabulary.train(train, n_words=128, n_iters=3, seed=1, device="cpu")
    np.testing.assert_array_equal(vt.words, vj.words)
    np.testing.assert_array_equal(vt.idf, vj.idf)
    q = _clustered_descriptors(5, n_centers=20, per=30)
    valid = np.random.default_rng(2).random(len(q)) < 0.9
    (wj, bj), (wt, bt) = vj.transform(q, valid), vt.transform(q, valid)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(bt, bj)
    assert (wt >= 0).sum() == valid.sum() and len(np.unique(wt[wt >= 0])) > 10
    # carried across by interop
    wc, bc = vocabulary_from_jax(vj, device="cpu").transform(q, valid)
    np.testing.assert_array_equal(wc, wj)
    np.testing.assert_array_equal(bc, bj)


def test_shipped_vocabulary_is_the_jax_packages():
    assert filecmp.cmp(REPO / "orb_slam2_detailed_comments_tpu" / "data" / "default_vocab.npz",
                       REPO / "orb_slam2_detailed_comments_tpu_torch" / "data" / "default_vocab.npz",
                       shallow=False)
    assert Path(TS.DEFAULT_VOCAB_PATH).parent.parent.name == "orb_slam2_detailed_comments_tpu_torch"


def test_tree_vocabulary_transform_matches_jax():
    vj, vt = JS.load_default_vocabulary(), TS.load_default_vocabulary()
    assert type(vt).__module__.startswith("orb_slam2_detailed_comments_tpu_torch")
    q = _clustered_descriptors(7, n_centers=50, per=20, flips=20)
    valid = np.random.default_rng(3).random(len(q)) < 0.95
    (wj, bj), (wt, bt) = vj.transform(q, valid), vt.transform(q, valid)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(bt, bj)
    wc, bc = vocabulary_from_jax(vj).transform(q, valid)
    np.testing.assert_array_equal(wc, wj)
    np.testing.assert_array_equal(bc, bj)


@pytest.mark.parametrize("seed", [0, 1])
def test_relocalization_candidates_match_jax(seed):
    """Twenty keyframes drawn around a few places, a covisibility graph of
    neighbours in id order, and queries near some of the places."""
    rng = np.random.default_rng(seed)
    voc_j = JS.load_default_vocabulary()
    voc_t = TS.load_default_vocabulary()
    places = [_clustered_descriptors(100 + seed * 10 + p, n_centers=30, per=10, flips=6)
              for p in range(4)]
    covis = {k: [j for j in (k - 2, k - 1, k + 1, k + 2) if 0 <= j < 20] for k in range(20)}
    ms = types.SimpleNamespace(get_covisible=lambda k, n=None: np.asarray(covis[k][:n]))
    dj, dt = JDB.KeyFrameDatabase(voc_j, 32), TDB.KeyFrameDatabase(voc_t, 32)
    for k in range(20):
        d = places[k % 4].copy()
        keep = rng.random(len(d)) < 0.7
        _, bow = voc_t.transform(d, keep)
        dj.add(k, bow)
        dt.add(k, bow)
    dj.erase(5)
    dt.erase(5)
    carried = kf_database_from_jax(dj, voc_t)
    for p in range(4):
        q = places[p].copy()
        q[rng.integers(0, len(q), 40), rng.integers(0, 8, 40)] ^= np.uint32(1)
        _, bow = voc_t.transform(q, np.ones(len(q), bool))
        cj = dj.detect_relocalization_candidates(bow, ms)
        assert cj and dt.detect_relocalization_candidates(bow, ms) == cj
        assert carried.detect_relocalization_candidates(bow, ms) == cj
        assert 5 not in cj
