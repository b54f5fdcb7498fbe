"""The port's stereo_sad (the SAD refinement of the stereo matcher in one
call) on the CPU, and its CUDA kernel on the card.

  * stereo_sad_plain against the JAX package's SAD stage (ops/stereo.py::
    stereo_match, XLA path, ORB_PATCH_PALLAS=0) and against the port's
    previous formulation (edge_pad + patch_gather_plain windows, SADs by
    torch.sum). The three sum each SAD's 121 terms in different orders.
    Each order's sum is within 1e-6 S of the exact one (S the SAD itself,
    its terms being >= 0; tested below for the port's order against
    float64), so two orders differ by up to eps = 2e-6 S_max (S_max the
    largest of the three SADs of the parabola). So on slots whose two
    smallest SADs differ by more than 2 eps the first minimum is the same,
    and u_r differs by at most 5 eps / |denom| in delta (|d num| <= 2 eps,
    |d denom| <= 4 eps, |delta| <= 1) plus 3e-5 for rounding u_r twice
    near 160: U_TOL + 1e-5 S_max / |denom|.
  * The fixed-order SADs against a float64 sum: within 1e-6 S.
  * Slots within 10 px of every border, xr_i at 0 and W - 1: the in-place
    windows equal the edge_pad + patch_gather_plain windows exactly, and so
    does everything computed from them.
  * A numpy replay of csrc/stereo_sad.cu's warp (lanes, shuffles, tree,
    argmin, parabola), bit for bit against stereo_sad_plain.
  * The CPU wrapper is the plain version and counts nothing; bad inputs
    are refused; the kernel against the plain version on the card (`cuda`,
    skipped without one). jax is imported only by the JAX parity test, so
    the file also runs on the card's machine, which has no jax.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_detailed_comments_tpu_torch.ops.patch_gather import patch_gather_plain
from orb_slam2_detailed_comments_tpu_torch.ops.pyramid import edge_pad
from orb_slam2_detailed_comments_tpu_torch.ops.stereo_sad import (
    SAD_HALF, SLIDE, parabola, round_clamp, sad_curve, sad_windows, stereo_sad,
    stereo_sad_plain)

from torch_parity import jax_exact_modes

CSRC = Path(__file__).resolve().parents[1] / "orb_slam2_detailed_comments_tpu_torch" / "csrc"
H, W = 96, 160
DISP = 6.4          # true disparity of the rendered pair, px
U_TOL = 3e-5


def _cu_constant(name):
    src = (CSRC / "stereo_sad.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _texture(x, y, rng_seed=0):
    """A smooth texture of sinusoids, exact at fractional x."""
    rng = np.random.default_rng(rng_seed)
    v = np.full(np.broadcast(x, y).shape, 128.0)
    for _ in range(8):
        lam = rng.uniform(6.0, 30.0)
        th = rng.uniform(0, np.pi)
        v += rng.uniform(8, 20) * np.sin(2 * np.pi * (np.cos(th) * x + np.sin(th) * y) / lam
                                         + rng.uniform(0, 2 * np.pi))
    return v


def _pair(seed=0):
    """Left and right (H, W) float32 images of one textured plane at
    disparity DISP (right(x) = left(x + DISP)), each with +-2 grey levels of
    seeded noise."""
    rng = np.random.default_rng(seed + 100)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    imgs = []
    for shift in (0.0, DISP):
        img = _texture(x + shift, y, seed) + rng.uniform(-2, 2, (H, W))
        imgs.append(np.clip(img, 0, 255).astype(np.float32))
    return imgs


def _slots(n=256, n_extra=24, seed=1):
    """Left keypoints (a quarter within 10 px of a border), right keypoints
    near each one's true match (xl - DISP +- 1.5 px) in shuffled order plus
    n_extra others, and idx, each left slot's right keypoint."""
    rng = np.random.default_rng(seed)
    xl = rng.uniform(0, W - 1, n)
    yl = rng.uniform(0, H - 1, n)
    edge = rng.random(n) < 0.25
    side = rng.integers(0, 4, n)
    near = rng.uniform(0, 10, n)
    xl = np.where(edge & (side == 0), near, np.where(edge & (side == 1), W - 1 - near, xl))
    yl = np.where(edge & (side == 2), near, np.where(edge & (side == 3), H - 1 - near, yl))
    perm = rng.permutation(n + n_extra)[:n]
    xr = rng.uniform(0, W - 1, n + n_extra)
    xr[perm] = xl - DISP + rng.uniform(-1.5, 1.5, n)
    yr = rng.uniform(0, H - 1, n + n_extra)
    yr[perm] = yl + rng.uniform(-0.5, 0.5, n)
    f = np.float32
    return xl.astype(f), yl.astype(f), xr.astype(f), yr.astype(f), perm.astype(np.int32)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _curve(img_l, img_r, xl, yl, xr, idx):
    """The port's (N, 11) SADs and integer right centres."""
    xr_i = round_clamp(xr[idx.long()], W)
    return sad_curve(*sad_windows(img_l, img_r, round_clamp(xl, W), round_clamp(yl, H), xr_i)), xr_i


def _parabola_tol(sads):
    """Per slot: (separated, u_r tolerance) for another summation order of
    the same SADs (module doc)."""
    s = np.sort(sads.numpy().astype(np.float64), axis=1)
    best_off = sads.argmin(1)
    om = best_off.clamp(1, 2 * SLIDE - 1)
    three = torch.stack([sads.gather(1, (om + k)[:, None])[:, 0] for k in (-1, 0, 1)], 1).double()
    s_max = three.max(1).values.numpy()
    denom = (three[:, 0] + three[:, 2] - 2 * three[:, 1]).abs().numpy()
    eps = 2e-6 * s_max
    separated = (s[:, 1] - s[:, 0]) > 2 * eps
    return separated, U_TOL + 1e-5 * s_max / np.maximum(denom, 1e-30)


def test_stereo_sad_plain_matches_jax_sad_stage():
    import jax.numpy as jnp
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera as JCam
    from orb_slam2_detailed_comments_tpu.ops import orb as JO, stereo as JSt
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig as JOrb
    img_l, img_r = _pair()
    xl, yl, xr, yr, idx = _slots()
    n, m = len(xl), len(xr)
    rng = np.random.default_rng(2)
    desc_r = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    desc_l = desc_r[idx]                         # each slot's match at Hamming 0
    valid_l = np.ones(n, bool)
    valid_l[-8:] = False                         # unmatched slots: the median cut is inert

    def kps(xs, ys, desc, valid):
        k = len(xs)
        return JO.Keypoints(jnp.asarray(np.stack([xs, ys], -1)), jnp.zeros(k, jnp.float32),
                            jnp.zeros(k, jnp.int32), jnp.zeros(k, jnp.float32),
                            jnp.asarray(desc), jnp.asarray(valid))

    cam = JCam(fx=200.0, fy=200.0, cx=80.0, cy=48.0, bf=20.0, width=W, height=H)
    with jax_exact_modes():
        urj, _ = JSt.stereo_match(kps(xl, yl, desc_l, valid_l),
                                  kps(xr, yr, desc_r, np.ones(m, bool)),
                                  jnp.asarray(img_l), jnp.asarray(img_r), cam, JOrb(n_levels=3))
    urj = np.asarray(urj)
    args = _t(img_l, img_r, xl, yl, xr, idx)
    u_r, _ = stereo_sad_plain(*args)
    sads, _ = _curve(*args)
    separated, tol = _parabola_tol(sads)
    ok = urj >= 0
    assert ok.sum() >= 0.9 * (n - 8) and not ok[-8:].any()
    cmp = ok & separated
    assert cmp.sum() >= 0.95 * ok.sum() and np.median(tol[cmp]) < 1e-4
    d = np.abs(u_r.numpy() - urj).astype(np.float64)
    assert (d[cmp] <= tol[cmp]).all(), (d[cmp] - tol[cmp]).max()


def _previous_windows(img_l, img_r, xl_i, yl_i, xr_i):
    """The port's windows before stereo_sad: windows of the edge-padded
    images by patch_gather_plain, the template at (xl_i + SLIDE, yl_i), the
    strip at (xr_i, yl_i) of the padded frame."""
    G = SAD_HALF + SLIDE
    pad_l = edge_pad(img_l, SAD_HALF, G)
    pad_r = edge_pad(img_r, SAD_HALF, G)
    tmpl = patch_gather_plain(pad_l[None], torch.stack([xl_i + SLIDE, yl_i], -1),
                              2 * SAD_HALF + 1, 2 * SAD_HALF + 1)[:, 0]
    strip = patch_gather_plain(pad_r[None], torch.stack([xr_i, yl_i], -1),
                               2 * SAD_HALF + 1, 2 * G + 1)[:, 0]
    return tmpl, strip


def _previous_sads(tmpl, strip):
    """The port's SADs before stereo_sad: centre normalisation, then
    torch.sum over each 11x11 difference."""
    tmpl = tmpl - tmpl[:, SAD_HALF, SAD_HALF][:, None, None]
    strip = strip - strip[:, SAD_HALF, SAD_HALF + SLIDE][:, None, None]
    return torch.stack([
        torch.sum(torch.abs(tmpl - strip[:, :, o:o + 2 * SAD_HALF + 1]), dim=(1, 2))
        for o in range(2 * SLIDE + 1)], dim=-1)


def test_stereo_sad_plain_matches_previous_formulation():
    img_l, img_r, xl, yl, xr, idx = _t(*_pair(3), *_slots(seed=4)[:3], _slots(seed=4)[4])
    u_r, best_sad = stereo_sad_plain(img_l, img_r, xl, yl, xr, idx)
    xr_i = round_clamp(xr[idx.long()], W)
    prev = _previous_sads(*_previous_windows(img_l, img_r, round_clamp(xl, W),
                                             round_clamp(yl, H), xr_i))
    u_prev, best_prev = parabola(prev, xr_i)
    sads, _ = _curve(img_l, img_r, xl, yl, xr, idx)
    separated, tol = _parabola_tol(sads)
    assert separated.mean() >= 0.95
    assert torch.equal(sads.argmin(1)[separated], prev.argmin(1)[separated])
    d = (u_r - u_prev).abs().numpy().astype(np.float64)
    assert (d[separated] <= tol[separated]).all(), (d[separated] - tol[separated]).max()
    assert ((best_sad - best_prev).abs() <= 2e-6 * best_prev)[separated].all()


def test_fixed_order_sads_match_float64():
    img_l, img_r, xl, yl, xr, idx = _t(*_pair(5), *_slots(seed=6)[:3], _slots(seed=6)[4])
    xr_i = round_clamp(xr[idx.long()], W)
    tmpl, strip = sad_windows(img_l, img_r, round_clamp(xl, W), round_clamp(yl, H), xr_i)
    sads = sad_curve(tmpl, strip).double()
    t = (tmpl - tmpl[:, 5:6, 5:6]).double()
    s = (strip - strip[:, 5:6, 10:11]).double()
    ref = torch.stack([(t - s[:, :, o:o + 11]).abs().sum((1, 2)) for o in range(11)], -1)
    assert ((sads - ref).abs() <= 1e-6 * ref).all()


def _edge_slots():
    """Slots within 10 px of each border and at the corners, with the right
    centre at 0, W - 1 and in between."""
    xs = np.array([0, 1, 4, 9, W - 10, W - 5, W - 2, W - 1, 40, 80, 0, W - 1], np.float32)
    ys = np.array([0, H - 1, 3, 9, 0, H - 10, 5, H - 1, 0, H - 1, 50, 50], np.float32)
    xl = np.concatenate([xs, xs + 0.4, xs[::-1]])
    yl = np.concatenate([ys, ys[::-1], ys - 0.49])
    xr = np.array([0.0, W - 1.0, 0.4, W - 1.4, 5.0, W - 6.0, -3.0, W + 2.0], np.float32)
    idx = np.arange(len(xl), dtype=np.int32) % len(xr)
    return np.clip(xl, 0, W - 1), np.clip(yl, 0, H - 1), xr, idx


def test_edge_slots_match_edge_pad_gather_exactly():
    img_l, img_r = _t(*_pair(7))
    xl, yl, xr, idx = _t(*_edge_slots())
    xl_i, yl_i = round_clamp(xl, W), round_clamp(yl, H)
    xr_i = round_clamp(xr[idx.long()], W)
    assert {0, W - 1} <= set(xr_i.tolist()) and {0, H - 1} <= set(yl_i.tolist())
    got = sad_windows(img_l, img_r, xl_i, yl_i, xr_i)
    ref = _previous_windows(img_l, img_r, xl_i, yl_i, xr_i)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    u_r, best_sad = stereo_sad_plain(img_l, img_r, xl, yl, xr, idx)
    u_ref, best_ref = parabola(sad_curve(*ref), xr_i)
    assert torch.equal(u_r, u_ref) and torch.equal(best_sad, best_ref)


# ---- numpy emulation of the stereo_sad warp ------------------------------------

def _emulate_stereo_sad(img_l, img_r, xl, yl, xr, idx):
    """csrc/stereo_sad.cu::stereo_sad_kernel, slot by slot, the 32 lanes as
    a numpy axis, in float32."""
    f32 = np.float32
    half, slide, tree = _cu_constant("HALF"), _cu_constant("SLIDE"), _cu_constant("TREE")
    twin, noff = 2 * half + 1, 2 * slide + 1
    swin = twin + 2 * slide
    lane = np.arange(32)
    u_out = np.zeros(len(xl), f32)
    s_out = np.zeros(len(xl), f32)
    for k in range(len(xl)):
        j = int(idx[k])
        if not 0 <= j < len(xr):
            u_out[k] = s_out[k] = np.nan
            continue
        xli = min(max(int(np.rint(xl[k])), 0), W - 1)
        yli = min(max(int(np.rint(yl[k])), 0), H - 1)
        xri = min(max(int(np.rint(xr[j])), 0), W - 1)
        tc, sc = img_l[yli, xli], img_r[yli, xri]
        tcol = np.clip(xli + lane - half, 0, W - 1)
        scol = np.clip(xri + lane - half - slide, 0, W - 1)
        acc = np.zeros((noff, 32), f32)
        for r in range(twin):
            row = min(max(yli + r - half, 0), H - 1)
            t = np.where(lane < twin, img_l[row, tcol] - tc, f32(0))
            s = np.where(lane < swin, img_r[row, scol] - sc, f32(0))
            for o in range(noff):
                acc[o] = acc[o] + np.abs(t - s[(lane + o) % 32])     # __shfl_sync
        acc[:, lane >= twin] = 0
        h = tree // 2
        while h >= 1:   # __shfl_down_sync: lanes past 31 read their own
            acc = acc + np.concatenate([acc[:, h:], acc[:, 32 - h:]], axis=1)
            h //= 2
        sads = acc[:, 0]
        bo, best = 0, sads[0]
        for o in range(1, noff):
            if sads[o] < best:
                bo, best = o, sads[o]
        om = min(max(bo, 1), noff - 2)
        sm1, s0, sp1 = sads[om - 1], sads[om], sads[om + 1]
        denom = (sm1 + sp1) - f32(2) * s0
        delta = (sm1 - sp1) / (f32(2) * max(denom, f32(1e-6))) if abs(denom) > f32(1e-6) else f32(0)
        delta = min(max(delta, f32(-1)), f32(1))
        u_out[k] = (f32(xri) + f32(om - slide)) + delta
        s_out[k] = best
    return u_out, s_out


def test_stereo_sad_kernel_schedule_emulated_matches_plain():
    img_l, img_r = _pair(8)
    xl, yl, xr, _, idx = _slots(n=96, n_extra=8, seed=9)
    exl, eyl, exr, eidx = _edge_slots()
    xl, yl = np.concatenate([xl, exl]), np.concatenate([yl, eyl])
    idx = np.concatenate([idx, eidx, np.array([-1, len(xr), 3], np.int32)])
    xl, yl = np.concatenate([xl, [10.5, 20.5, 30.5]]), np.concatenate([yl, [11.5, 12.5, 2.5]])
    xl, yl = xl.astype(np.float32), yl.astype(np.float32)
    got = _emulate_stereo_sad(img_l, img_r, xl, yl, xr, idx)
    ref = stereo_sad_plain(*_t(img_l, img_r, xl, yl, xr, idx))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    assert np.isnan(got[0][-3:-1]).all() and not np.isnan(got[0][:-3]).any()


# ---- the wrapper ------------------------------------------------------------------

@pytest.fixture(scope="module")
def case():
    img_l, img_r = _pair(10)
    xl, yl, xr, _, idx = _slots(seed=11)
    return tuple(_t(img_l, img_r, xl, yl, xr, idx))


def test_stereo_sad_wrapper_cpu_is_plain_and_counts_nothing(case):
    before = stereo_sad.launches
    for a, b in zip(stereo_sad(*case), stereo_sad_plain(*case)):
        assert torch.equal(a, b)
    assert stereo_sad.launches == before


@pytest.mark.parametrize("bad", ["img_float64", "idx_int64", "xl_float64", "img_shapes",
                                 "img_rank", "yl_len", "idx_len", "xr_empty", "xl_noncontig",
                                 "mixed_devices"])
def test_stereo_sad_rejects_bad_inputs(case, bad):
    img_l, img_r, xl, yl, xr, idx = case
    args = dict(img_l=img_l, img_r=img_r, xl=xl, yl=yl, xr=xr, idx=idx)
    args.update({
        "img_float64": dict(img_l=img_l.double()),
        "idx_int64": dict(idx=idx.long()),
        "xl_float64": dict(xl=xl.double()),
        "img_shapes": dict(img_r=img_r[:, :-1].contiguous()),
        "img_rank": dict(img_l=img_l[None], img_r=img_r[None]),
        "yl_len": dict(yl=yl[:-1]),
        "idx_len": dict(idx=idx[:-1]),
        "xr_empty": dict(xr=xr[:0]),
        "xl_noncontig": dict(xl=torch.stack([xl, xl], 1)[:, 0]),
        "mixed_devices": dict(xr=torch.empty(xr.shape, device="meta")),
    }[bad])
    with pytest.raises((TypeError, ValueError)):
        stereo_sad(**args)


# ---- on the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_stereo_sad_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card")
    args = [a.cuda() for a in case]
    before = stereo_sad.launches
    got, ref = stereo_sad(*args), stereo_sad_plain(*args)
    torch.cuda.synchronize()
    assert stereo_sad.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
