"""The port's default-vocabulary trainer
(orb_slam2_detailed_comments_tpu_torch/examples/train_default_vocabulary.py)
against the JAX package's examples/train_default_vocabulary.py, on the CPU.

gather_descriptors renders 240 views (twelve worlds); here both packages
gather from the first VIEWS views of each world (the trajectories of
tests/synthetic_world.py, which both load, cut for the test):

  * the same number of descriptors, keypoint for keypoint in the same
    order; at least MIN_AGREE of them within MATCH_BITS bits (the
    matchers' tight threshold, TH_LOW: the pair any search would match)
    and at least MIN_EQUAL bit-identical. The two pyramids part by
    float32 ulps on flat regions, which flips BRIEF comparisons of equal
    samples: on the tilted-plane worlds' flat texture a third of the
    descriptors differ by 1-20 bits, on the cylinders 1 in 120 by 1 bit;
  * the port's TreeVocabulary trained on those numpy descriptors (k=10,
    L=5, seed 1, the tool's defaults) equals the JAX package's, array for
    array;
  * main() (on those descriptors) writes a tree that loads back and
    reports the held-out lap's scores, and refuses to overwrite the
    shipped data/default_vocab.npz without --force.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import synthetic_world
from orb_slam2_detailed_comments_tpu.place.vocabulary_tree import TreeVocabulary as JTree
from orb_slam2_detailed_comments_tpu_torch.examples import train_default_vocabulary as TV
from orb_slam2_detailed_comments_tpu_torch.place.vocabulary_tree import TreeVocabulary as TTree

from torch_parity import jax_exact_modes

REPO = Path(__file__).resolve().parents[1]
VIEWS = 2
MIN_AGREE, MATCH_BITS, MIN_EQUAL = 0.99, 50, 0.8
TREE_FIELDS = ("node_desc", "node_children", "node_parent", "node_word", "word_weight",
               "word_node")


def _jax_module():
    spec = importlib.util.spec_from_file_location(
        "jax_train_default_vocabulary", REPO / "examples" / "train_default_vocabulary.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gathered():
    """Both packages' gather_descriptors with synthetic_world's
    trajectories cut to their first VIEWS poses."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("loop_trajectory", "smooth_trajectory"):
            full = getattr(synthetic_world, name)
            mp.setattr(synthetic_world, name, lambda *a, _f=full, **k: _f(*a, **k)[:VIEWS])
        with jax_exact_modes():
            theirs = _jax_module().gather_descriptors(600, verbose=False)
        ours = TV.gather_descriptors(600, verbose=False, device="cpu")
    return ours, theirs


def test_gather_descriptors_agrees_with_jax(gathered):
    ours, theirs = gathered
    assert ours.dtype == theirs.dtype == np.uint32 and ours.shape == theirs.shape
    assert len(ours) > 1000
    bits = np.unpackbits(np.bitwise_xor(ours, theirs).view(np.uint8), axis=-1).sum(-1)
    assert (bits <= MATCH_BITS).mean() >= MIN_AGREE, np.bincount(bits)
    assert (bits == 0).mean() >= MIN_EQUAL, np.bincount(bits)


def test_tree_equals_jax_tree(gathered):
    ours_desc, _ = gathered
    ours = TTree.train(ours_desc, k=10, L=5, seed=1)
    theirs = JTree.train(ours_desc, k=10, L=5, seed=1)
    assert ours.n_words == theirs.n_words > 100
    for f in TREE_FIELDS:
        assert np.array_equal(np.asarray(getattr(ours, f)), np.asarray(getattr(theirs, f))), f


def test_main_writes_a_tree(gathered, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(TV, "gather_descriptors", lambda *a, **k: gathered[0])
    out = tmp_path / "voc.npz"
    assert TV.main([str(out), "--L", "2", "--device", "cpu"]) == 0
    voc = TTree.load(str(out))
    assert voc.L == 2 and voc.n_words > 10
    assert "held-out lap: adjacent-view score" in capsys.readouterr().out


def test_default_output_needs_force():
    before = Path(TV.DEFAULT_OUT).read_bytes()
    with pytest.raises(SystemExit, match="--force"):
        TV.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="--force"):
        TV.main([TV.DEFAULT_OUT, "--device", "cpu"])
    assert Path(TV.DEFAULT_OUT).read_bytes() == before
    assert Path(TV.DEFAULT_OUT) == REPO / "orb_slam2_detailed_comments_tpu_torch" / "data" / \
        "default_vocab.npz"
