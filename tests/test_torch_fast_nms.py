"""K5's early rejection (csrc/fast_pyramid.cu::fast_nms_kernel), on the CPU.

  * A numpy replay of the kernel's early test (may_pass: two adjacent
    cardinal ring samples both brighter than c + th, or both darker than
    c - th, in rounded differences) over the image plus its 1-px ring, the
    ring samples read from the 4-px edge pad as the kernel stages them: on
    noise, squares and quantised plateau images at thresholds 0, 7 and 20,
    every pixel it rejects has fast_score_dense <= th, so its thresholded
    score is exactly 0; and it equals ops/fast_pyramid.py::
    fast_nms_survivors.
  * A numpy replay of the whole kernel, block by block (the staged tile,
    the test, the survivors' arc score by the kernel's min tree, the 3x3
    NMS, the border), equal to fast_score_nms_plain bit for bit.

The ring table and the tile constants are read from the CUDA source. K5's
plain version against the interpret-mode Pallas kernel stays in
tests/test_torch_fast_kernels.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_detailed_comments_tpu_torch.ops import fast as TF
from orb_slam2_detailed_comments_tpu_torch.ops.fast_pyramid import (
    CARDINALS, fast_nms_survivors, fast_score_nms_plain)
from orb_slam2_detailed_comments_tpu_torch.ops.pyramid import edge_pad

from torch_parity import noise_image, squares_image

SRC = (Path(__file__).resolve().parents[1] / "orb_slam2_detailed_comments_tpu_torch" / "csrc"
       / "fast_pyramid.cu").read_text()
HALO = 4


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _ring():
    tables = {}
    for name in ("ring_dy", "ring_dx"):
        body = re.search(name + r"\(int k\) \{\s*constexpr int t\[16\] = \{([^}]*)\}", SRC)
        tables[name] = np.asarray([int(v) for v in body.group(1).split(",")])
    return tables["ring_dy"], tables["ring_dx"]


def _cardinals_in_source():
    """The ring indices may_pass reads, in its order."""
    body = SRC[SRC.index("bool may_pass("):SRC.index("// One 32x16 output tile")]
    return tuple(int(k) for k in re.findall(r"ring_dy\((\d+)\)", body))


def plateau_image(h, w, seed):
    """Few grey levels in flat patches: many ring samples equal the centre."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 5, (h // 4 + 1, w // 4 + 1)).astype(np.float32) * 24 + 40
    img = np.kron(coarse, np.ones((4, 4), np.float32))[:h, :w]
    flip = rng.random((h, w)) < 0.05
    return np.where(flip, img + 24 * rng.integers(-1, 2, (h, w)), img).astype(np.float32)


IMAGES = {"noise": noise_image, "squares": squares_image, "plateau": plateau_image}


def _may_pass(pad, sy, sx, th):
    """csrc/fast_pyramid.cu::may_pass at staged positions (sy, sx) of a
    padded float32 image."""
    dy, dx = _ring()
    c = pad[sy, sx]
    d = [pad[sy + dy[k], sx + dx[k]] - c for k in _cardinals_in_source()]
    th = np.float32(th)
    b = [x > th for x in d]
    k = [x < -th for x in d]
    return ((b[0] & b[1]) | (b[1] & b[2]) | (b[2] & b[3]) | (b[3] & b[0])
            | (k[0] & k[1]) | (k[1] & k[2]) | (k[2] & k[3]) | (k[3] & k[0]))


@pytest.mark.parametrize("th", [0.0, 7.0, 20.0])
@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_k5_early_test_rejects_only_zero_scores(kind, th):
    assert _cardinals_in_source() == CARDINALS
    img = IMAGES[kind](53, 71, 12)
    H, W = img.shape
    pad = np.pad(img, HALO, mode="edge")
    sy, sx = np.mgrid[HALO - 1:H + HALO + 1, HALO - 1:W + HALO + 1]   # the image + 1 px
    keep = _may_pass(pad, sy, sx, th)
    score = TF.fast_score_dense(edge_pad(torch.from_numpy(img), HALO, HALO)).numpy()
    score = score[HALO - 1:H + HALO + 1, HALO - 1:W + HALO + 1]
    assert (score[~keep] <= th).all()
    ring = np.ones_like(keep)
    ring[4:-4, 4:-4] = False           # the image's 3-px border and the 1-px ring outside
    assert (~keep & ring).any() and (~keep).sum() > 50 and (score > th).any()
    np.testing.assert_array_equal(keep, fast_nms_survivors(torch.from_numpy(img), th).numpy())


def _tree_arc_best(x):
    """csrc/fast_pyramid.cu::arc_best over the last axis (16 samples)."""
    i = np.arange(16)
    m2 = np.minimum(x, x[..., (i + 1) & 15])
    m4 = np.minimum(m2, m2[..., (i + 2) & 15])
    m8 = np.minimum(m4, m4[..., (i + 4) & 15])
    return np.minimum(m8, x[..., (i + 8) & 15]).max(-1)


def _emulate_fast_nms(img, th):
    """csrc/fast_pyramid.cu::fast_nms_kernel, block by block: the staged
    tile + halo (edge-clamped), the early test over the tile + 1 px, the
    survivors' thresholded score (ring_score), the rejected pixels 0, the
    3x3 NMS with the scan-order tie-break, the 3-px border zeroed."""
    f32 = np.float32
    TW, TH = _constant("TW"), _constant("TH")
    H, W = img.shape
    dy, dx = _ring()
    out = np.full((H, W), np.nan, f32)
    th = f32(th)
    for y0 in range(0, H, TH):
        for x0 in range(0, W, TW):
            ys = np.clip(np.arange(y0 - HALO, y0 + TH + HALO), 0, H - 1)
            xs = np.clip(np.arange(x0 - HALO, x0 + TW + HALO), 0, W - 1)
            tile = img[ys[:, None], xs[None, :]]
            sy, sx = np.mgrid[HALO - 1:HALO + TH + 1, HALO - 1:HALO + TW + 1]
            survive = _may_pass(tile, sy, sx, th)
            score = np.zeros(sy.shape, f32)
            py, px = sy[survive], sx[survive]
            p = np.stack([tile[py + dy[k], px + dx[k]] for k in range(16)], -1)
            c = tile[py, px]
            r = np.maximum(_tree_arc_best(p) - c, c + _tree_arc_best(-p))
            score[survive] = np.where(r > th, r, f32(0))
            for ly in range(TH):
                for lx in range(TW):
                    gy, gx = y0 + ly, x0 + lx
                    if gy >= H or gx >= W:
                        continue
                    w3 = score[ly:ly + 3, lx:lx + 3]
                    cc = w3[1, 1]
                    earlier = max(w3[0, 0], w3[0, 1], w3[0, 2], w3[1, 0])
                    later = max(w3[1, 2], w3[2, 0], w3[2, 1], w3[2, 2])
                    inb = 3 <= gy < H - 3 and 3 <= gx < W - 3
                    keep = inb and cc > 0 and cc > earlier and cc >= later
                    out[gy, gx] = cc if keep else f32(0)
    return out


@pytest.mark.parametrize("kind,shape,th", [("noise", (37, 70), 7.0), ("squares", (50, 77), 7.0),
                                           ("plateau", (45, 66), 0.0), ("plateau", (40, 64), 20.0)])
def test_k5_kernel_schedule_emulated_matches_plain(kind, shape, th):
    img = IMAGES[kind](*shape, 13)
    ref = fast_score_nms_plain(torch.from_numpy(img), th).numpy()
    assert (ref > 0).sum() > 5
    np.testing.assert_array_equal(_emulate_fast_nms(img, th), ref)
