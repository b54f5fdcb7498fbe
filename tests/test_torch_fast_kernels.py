"""The plain versions of the port's FAST kernels against the JAX package's
Pallas kernels, run in interpret mode on the CPU, over the full maps:

  K3 fast_pyramid_pallas        <- ops/fast_pyramid.py::fast_pyramid
  K4 fast_score_nms_raw_pallas  <- ops/fast_pyramid.py::fast_score_nms_raw
  K5 fast_score_nms_pallas      <- ops/fast_pyramid.py::fast_score_nms

Tolerances: nms and raw bit-exact; blur within 1e-4 (the interpret-mode
kernels are XLA on the CPU, which contracts multiply-adds: 2 ulps at 255);
K5's nms bit-exact. The CUDA kernels themselves are held against the same
plain versions on the card (tests/test_torch_port.py's `cuda` tests, and
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.ops import fast as JF, pyramid as JP
from orb_slam2_detailed_comments_tpu.ops.pallas_fast import (
    fast_pyramid_pallas, fast_score_nms_pallas, fast_score_nms_raw_pallas)

from orb_slam2_detailed_comments_tpu_torch.ops.fast_pyramid import (
    fast_pyramid, fast_pyramid_plain, fast_score_nms, fast_score_nms_plain,
    fast_score_nms_raw, fast_score_nms_raw_plain)

from torch_parity import noise_image, squares_image

BLUR_TOL = 1e-4
IMAGES = {"noise": noise_image, "squares": squares_image}


def _image(kind, h, w, seed):
    return IMAGES[kind](h, w, seed)


def _levels(img, n_levels):
    return [np.array(lv) for lv in JP.build_pyramid(jnp.asarray(img), n_levels, 1.2)]


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_k3_pyramid_plain_matches_pallas_interpret(kind):
    levels = _levels(_image(kind, 120, 160, 5), 3)
    shapes = JP.pyramid_shapes(120, 160, 3, 1.2)
    nj, rj, bj = fast_pyramid_pallas(tuple(jnp.asarray(lv) for lv in levels), shapes, 7.0,
                                     interpret=True)
    for maps in (fast_pyramid_plain([torch.from_numpy(lv)[None] for lv in levels], 7.0),
                 fast_pyramid([torch.from_numpy(lv)[None].contiguous() for lv in levels], 7.0)):
        nms, raw, blur = maps
        for i in range(3):
            np.testing.assert_array_equal(nms[i][0].numpy(), np.asarray(nj[i]))
            np.testing.assert_array_equal(raw[i][0].numpy(), np.asarray(rj[i]))
            assert np.abs(blur[i][0].numpy() - np.asarray(bj[i])).max() < BLUR_TOL


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_k4_single_image_plain_matches_pallas_interpret(kind):
    img = _image(kind, 100, 150, 6)
    nj, rj, bj = fast_score_nms_raw_pallas(jnp.asarray(img), 7.0, interpret=True)
    for nms, raw, blur in (fast_score_nms_raw_plain(torch.from_numpy(img), 7.0),
                           fast_score_nms_raw(torch.from_numpy(img), 7.0)):
        np.testing.assert_array_equal(nms.numpy(), np.asarray(nj))
        np.testing.assert_array_equal(raw.numpy(), np.asarray(rj))
        assert np.abs(blur.numpy() - np.asarray(bj)).max() < BLUR_TOL


@pytest.mark.parametrize("kind,shape", [("noise", (64, 80)), ("noise", (97, 131)),
                                        ("squares", (120, 160))])
def test_k5_nms_plain_matches_pallas_interpret(kind, shape):
    img = _image(kind, *shape, 7)
    ref = np.asarray(fast_score_nms_pallas(jnp.asarray(img), 7.0, interpret=True))
    np.testing.assert_array_equal(fast_score_nms_plain(torch.from_numpy(img), 7.0).numpy(), ref)
    np.testing.assert_array_equal(fast_score_nms(torch.from_numpy(img), 7.0).numpy(), ref)


def test_k5_border_ring_differs_from_the_masked_nms():
    """K5 does not zero the 3-px border before its NMS, so a border score
    can suppress a pixel of the ring y in {3, H-4}, x in {3, W-4} that the
    masked NMS (K1/K3/K4, ops/fast.py) keeps; away from the ring the two
    agree exactly."""
    img = noise_image(64, 80, 7)
    k5 = fast_score_nms_plain(torch.from_numpy(img), 7.0).numpy()
    masked = np.asarray(JF.nms_3x3(JF.fast_score_map(jnp.asarray(img), 7.0)))
    np.testing.assert_array_equal(k5[4:-4, 4:-4], masked[4:-4, 4:-4])
    ys, xs = np.nonzero(k5 != masked)
    assert ys.size > 0
    assert np.all((ys == 3) | (ys == 60) | (xs == 3) | (xs == 76))
    assert np.all(k5[ys, xs] == 0.0)   # only suppressions


def test_k4_k5_wrappers_reject_bad_inputs():
    img = torch.from_numpy(noise_image(40, 50, 1))
    for f in (fast_score_nms, fast_score_nms_raw):
        with pytest.raises(TypeError):
            f(img.double(), 7.0)
        with pytest.raises(ValueError):
            f(img[None], 7.0)
        with pytest.raises(ValueError):
            f(img.t(), 7.0)
    assert fast_score_nms.launches == 0 and fast_score_nms_raw.launches == 0
