"""The port's orb_desc (IC angle + rotated BRIEF of all levels in one call)
and the redesigned fast_pyramid kernel, on the CPU.

  * orb_desc_plain against the JAX package's _fused_level_angles_descriptors
    (XLA path, exact gather) on the same numpy levels and keypoints, and
    against the port's previous formulation (patch_gather_plain windows,
    moments by torch.sum): descriptors identical on >= 99% of valid
    keypoints, every angle within 1e-5 + 2e-6 S / |m| rad, and within a
    flat 1e-5 rad where S / |m| <= COND_CAP. The moments
    are summed in another order than XLA's and torch.sum's. Each order's
    sum is within 1e-6 S of the exact one (S, the sum of the terms'
    magnitudes; tested below for the port's order), so two orders differ by
    up to 2e-6 S, and the angle by that over the moments' length |m|: a flat
    1e-5 rad holds for 90% of the keypoints against XLA and 99.6% against
    torch.sum, and the rest have small |m|. A rotated sample that sits on a
    rounding boundary may then move by a pixel and flip a bit.
  * The fixed-order moments against a float64 sum: within 1e-6 of the sum
    of the terms' magnitudes (the scale of a float32 sum's error).
  * numpy emulations of both CUDA kernels, step by step as the sources
    schedule them (the fast_pyramid warp's row walk, register windows,
    arc score from the ring samples and shuffles; the orb_desc warp's lanes, shuffle tree and ballots), against
    the plain versions: fast_pyramid exact on full maps, orb_desc angle
    within 1e-6 rad and descriptors identical on >= 99.9% (numpy's and
    torch's atan2/cos/sin may differ by an ulp on the CPU; on the card the
    kernel is held bit for bit against the plain version). The FAST ring
    table is read from csrc/fast_pyramid.cu itself.
  * wrapper input checks; the kernels themselves against their plain
    versions on the card (`cuda` tests, skipped without one).
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_detailed_comments_tpu_torch.ops import fast as TF
from orb_slam2_detailed_comments_tpu_torch.ops.fast_pyramid import (
    fast_pyramid, fast_pyramid_plain)
from orb_slam2_detailed_comments_tpu_torch.ops.orb_desc import (
    DESC_RADIUS, desc_constants, ic_moments, orb_desc, orb_desc_plain)
from orb_slam2_detailed_comments_tpu_torch.ops.patch_gather import patch_gather_plain
from orb_slam2_detailed_comments_tpu_torch.ops.pyramid import (
    _gauss_kernel_1d, build_pyramid, edge_pad, gaussian_blur)

from torch_parity import noise_image

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "orb_slam2_detailed_comments_tpu_torch" / "csrc"
ANGLE_TOL = 1e-5
DESC_AGREE = 0.99
COND_CAP = 30.0     # S / |m| of the keypoints held to the flat ANGLE_TOL


def _cu_constant(name, source="fast_pyramid.cu"):
    """A `constexpr int` of a CUDA source: the tiling is decided there."""
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text()).group(1))


RUN, SPAN = _cu_constant("RUN"), _cu_constant("SPAN")


def _pyramid(B=2, h=120, w=160, n_levels=3, seed=0):
    imgs = torch.from_numpy(np.stack([noise_image(h, w, seed + b) for b in range(B)]))
    levels = [lv.contiguous() for lv in build_pyramid(imgs, n_levels, 1.2)]
    return levels, [gaussian_blur(lv).contiguous() for lv in levels]


def _keypoints(levels, counts, seed=1):
    """Per level, counts[l] slots: most inside the image, some past every
    edge (the wrap and clamp of the window start), ~10% invalid."""
    rng = np.random.default_rng(seed)
    B = levels[0].shape[0]
    xy = []
    for lv, n in zip(levels, counts):
        H, W = lv.shape[1:]
        x = rng.integers(0, W, (B, n))
        y = rng.integers(0, H, (B, n))
        out = rng.random((B, n)) < 0.15
        x = np.where(out, rng.integers(-45, W + 25, (B, n)), x)
        y = np.where(out, rng.integers(-45, H + 25, (B, n)), y)
        xy.append(np.stack([x, y], -1))
    xy = torch.from_numpy(np.concatenate(xy, 1).astype(np.int32))
    valid = torch.from_numpy(rng.random(xy.shape[:2]) >= 0.1)
    return xy, valid


@pytest.fixture(scope="module")
def case():
    levels, blurs = _pyramid()
    counts = (150, 100, 70)
    xy, valid = _keypoints(levels, counts)
    return levels, blurs, xy, valid, counts


def _moment_conditioning(levels, xy, counts):
    """Per slot, S / |m|: the float32 error scale of the IC moments (S, the
    sum of |I| (|u| + |v|) over the circle) over their length."""
    wx, wy = desc_constants(torch.device("cpu"))[:2]
    out, s = [], 0
    for lv, n in zip(levels, counts):
        p = patch_gather_plain(edge_pad(lv[:, None], DESC_RADIUS, DESC_RADIUS),
                               xy[:, s:s + n], 2 * DESC_RADIUS + 1, 2 * DESC_RADIUS + 1)
        win = p[:, :, 0, 4:-4, 4:-4].double()
        m10, m01 = ic_moments(win.float())
        scale = (win.abs() * (wx.abs() + wy.abs()).double()).sum((-2, -1))
        out.append(scale / torch.hypot(m10, m01).double().clamp_min(1e-30))
        s += n
    return torch.cat(out, 1).numpy()


def _agree(ang, desc, ang_ref, desc_ref, valid, cond):
    v = valid.numpy()
    assert v.sum() > 500
    d = np.abs(ang.numpy() - ang_ref.numpy()).astype(np.float64)
    d = np.minimum(d, 2 * np.pi - d)          # atan2 of (-0, x<0): pi against -pi
    assert (d[v] <= ANGLE_TOL + 2e-6 * cond[v]).all(), (d[v] - 2e-6 * cond[v]).max()
    tight = v & (cond <= COND_CAP)
    assert tight.sum() >= 50 and (d[tight] <= ANGLE_TOL).all(), d[tight].max()
    same = (desc.numpy() == desc_ref.numpy()).all(-1)
    assert same[v].mean() >= DESC_AGREE, same[v].mean()
    assert (ang.numpy()[~v] == 0).all() and (desc.numpy()[~v] == 0).all()


def test_orb_desc_plain_matches_jax_xla(case):
    import jax.numpy as jnp
    from orb_slam2_detailed_comments_tpu.ops.orb import _fused_level_angles_descriptors
    levels, blurs, xy, valid, counts = case
    angs, descs, s = [], [], 0
    for lv, bl, n in zip(levels, blurs, counts):
        per = [_fused_level_angles_descriptors(
            jnp.asarray(lv[b].numpy()), jnp.asarray(bl[b].numpy()),
            jnp.asarray(xy[b, s:s + n].numpy()), jnp.asarray(valid[b, s:s + n].numpy()),
            use_onehot=False, use_pallas_patch=False) for b in range(lv.shape[0])]
        angs.append(np.stack([np.asarray(a) for a, _ in per]))
        descs.append(np.stack([np.asarray(d).view(np.int32) for _, d in per]))
        s += n
    ang, desc = orb_desc_plain(levels, blurs, xy, valid, counts)
    _agree(ang, desc, torch.from_numpy(np.concatenate(angs, 1)),
           torch.from_numpy(np.concatenate(descs, 1)), valid,
           _moment_conditioning(levels, xy, counts))


def _previous_formulation(levels, blurs, xy, valid, counts):
    """The port's angle/descriptor before orb_desc: per level, the
    (B, n, 2, 39, 39) windows and the moments by torch.sum over the
    zero-padded 39x39 weights."""
    from orb_slam2_detailed_comments_tpu_torch.ops.hamming import pack_bits
    wx, wy, px, py = desc_constants(torch.device("cpu"))
    pad = DESC_RADIUS - 15
    wx39, wy39 = (torch.nn.functional.pad(w, (pad, pad, pad, pad)) for w in (wx, wy))
    r, psize = DESC_RADIUS, 2 * DESC_RADIUS + 1
    angs, descs, s = [], [], 0
    for img, blur, n in zip(levels, blurs, counts):
        padded = edge_pad(torch.stack([img, blur], dim=1), r, r)
        p = patch_gather_plain(padded, xy[:, s:s + n], psize, psize)
        rawp, blurp = p[:, :, 0], p[:, :, 1]
        ang = torch.atan2(torch.sum(rawp * wy39, dim=(-2, -1)), torch.sum(rawp * wx39, dim=(-2, -1)))
        ca, sa = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
        dx = torch.round(px * ca - py * sa).to(torch.int64)
        dy = torch.round(px * sa + py * ca).to(torch.int64)
        v = blurp.reshape(blurp.shape[:2] + (-1,)).gather(-1, (dy + r) * psize + (dx + r))
        angs.append(ang)
        descs.append(pack_bits(v[..., :256] < v[..., 256:]))
        s += n
    ang, desc = torch.cat(angs, 1), torch.cat(descs, 1)
    return torch.where(valid, ang, 0.0), torch.where(valid[..., None], desc, 0)


def test_orb_desc_plain_matches_previous_formulation(case):
    ang, desc = orb_desc_plain(*case)
    _agree(ang, desc, *_previous_formulation(*case), case[3],
           _moment_conditioning(case[0], case[2], case[4]))


def test_fixed_order_moments_match_float64(case):
    levels = case[0]
    rng = np.random.default_rng(2)
    img = levels[0][0]
    ys, xs = rng.integers(0, img.shape[0] - 31, 200), rng.integers(0, img.shape[1] - 31, 200)
    win = torch.stack([img[y:y + 31, x:x + 31] for y, x in zip(ys, xs)])
    m10, m01 = ic_moments(win)
    wx, wy = desc_constants(torch.device("cpu"))[:2]
    for m, w in ((m10, wx), (m01, wy)):
        terms = win.double() * w.double()
        ref = terms.sum((-2, -1))
        scale = terms.abs().sum((-2, -1))
        assert ((m.double() - ref).abs() <= 1e-6 * scale).all()


def test_orb_desc_wrapper_cpu_is_plain_and_counts_nothing(case):
    before = orb_desc.launches
    for a, b in zip(orb_desc(*case), orb_desc_plain(*case)):
        assert torch.equal(a, b)
    assert orb_desc.launches == before


@pytest.mark.parametrize("bad", ["xy_int64", "valid_uint8", "blur_shape", "counts_sum",
                                 "counts_len", "xy_noncontig", "blur_float64", "level_rank"])
def test_orb_desc_rejects_bad_inputs(case, bad):
    levels, blurs, xy, valid, counts = case
    args = dict(levels=levels, blurs=blurs, xy=xy, valid=valid, counts=counts)
    args.update({
        "xy_int64": dict(xy=xy.long()),
        "valid_uint8": dict(valid=valid.to(torch.uint8)),
        "blur_shape": dict(blurs=[blurs[0][:, :-1].contiguous()] + blurs[1:]),
        "counts_sum": dict(counts=(150, 100, 71)),
        "counts_len": dict(counts=(150, 170)),
        "xy_noncontig": dict(xy=xy.transpose(0, 1).contiguous().transpose(0, 1)),
        "blur_float64": dict(blurs=[b.double() for b in blurs]),
        "level_rank": dict(levels=[lv[0] for lv in levels]),
    }[bad])
    with pytest.raises((TypeError, ValueError)):
        orb_desc(**args)


@pytest.mark.parametrize("bad", ["no_levels", "level_too_small", "mixed_devices"])
def test_fast_pyramid_rejects_bad_levels(bad):
    lv = [torch.rand(2, 40, 40), torch.rand(2, 33, 33)]
    levels = {"no_levels": [], "level_too_small": lv + [torch.rand(2, 4, 40)],
              "mixed_devices": lv + [torch.rand(2, 28, 28, device="meta")]}[bad]
    with pytest.raises((TypeError, ValueError)):
        fast_pyramid(levels, 7.0)


# ---- the FAST arc score by the kernel's min tree ------------------------------

def _ring_from_source():
    """(dy, dx) of the 16 ring samples as csrc/fast_pyramid.cu lists them."""
    src = (CSRC / "fast_pyramid.cu").read_text()
    tables = {}
    for name in ("ring_dy", "ring_dx"):
        body = re.search(name + r"\(int k\) \{\s*constexpr int t\[16\] = \{([^}]*)\}", src)
        tables[name] = [int(v) for v in body.group(1).split(",")]
    return np.asarray(tables["ring_dy"]), np.asarray(tables["ring_dx"])


def _tree_arc_best(x):
    """csrc/fast_pyramid.cu::arc_best over the last axis (16 samples)."""
    i = np.arange(16)
    m2 = np.minimum(x, x[..., (i + 1) & 15])
    m4 = np.minimum(m2, m2[..., (i + 2) & 15])
    m8 = np.minimum(m4, m4[..., (i + 4) & 15])
    return np.minimum(m8, x[..., (i + 8) & 15]).max(-1)


def _kernel_score(p, c):
    """csrc/fast_pyramid.cu::arc_score: from the ring samples p (last axis)
    and the centre c, in float32."""
    return np.maximum(_tree_arc_best(p) - c, c + _tree_arc_best(-p))


@pytest.mark.parametrize("quantised", [False, True])
def test_min_tree_arc_score_matches_fast_score_dense(quantised):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    if quantised:   # many ties between ring samples
        img = np.round(img / 32).astype(np.float32) * 32
    dy, dx = _ring_from_source()
    np.testing.assert_array_equal(np.stack([dy, dx], -1), TF.RING_OFFSETS)
    ys, xs = np.mgrid[3:37, 3:47]
    p = img[ys[..., None] + dy, xs[..., None] + dx]
    ref = TF.fast_score_dense(torch.from_numpy(img)).numpy()[3:37, 3:47]
    np.testing.assert_array_equal(_kernel_score(p, img[ys, xs]), ref)


# ---- numpy emulation of the fast_pyramid warp ---------------------------------

def _reflect101(i, n):
    i = np.where(i < 0, -i, i)
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


def _emulate_fast_pyramid_level(img, th):
    """csrc/fast_pyramid.cu::fast_pyramid_kernel for one (H, W) image, task
    by task and step by step, the 32 lanes as a numpy axis."""
    f32 = np.float32
    H, W = img.shape
    g = _gauss_kernel_1d(7, 2.0)
    dy, dx = _ring_from_source()
    nms, raw, blur = (np.full((H, W), np.nan, f32) for _ in range(3))
    lane = np.arange(32)

    def shfl_up(v):     # lane l reads lane l - 1; lane 0 keeps its own
        return np.concatenate([v[:1], v[:-1]])

    def shfl_down(v):   # lane l reads lane l + 1; lane 31 keeps its own
        return np.concatenate([v[1:], v[-1:]])

    for y0 in range(0, H, RUN):
        for x0 in range(0, W, SPAN):
            xc = x0 - 1 + lane
            out_col = (lane >= 1) & (lane <= SPAN) & (xc < W)
            col_in = (xc >= 3) & (xc < W - 3)
            cx = [_reflect101(xc - 3 + k, W) for k in range(7)]
            win, hsum, sc = [None] * 8, [None] * 7, [None] * 3

            def load(y):
                row = img[_reflect101(np.asarray(y), H)]
                return [row[cx[k]] for k in range(7)]

            for s in range(RUN + 8):
                if s == 0:
                    win[0] = load(y0 - 4)
                if s + 1 < RUN + 8:
                    win[(s + 1) % 8] = load(y0 - 3 + s)
                if 1 <= s <= RUN + 6:
                    h = f32(g[0]) * win[s % 8][0]
                    for k in range(1, 7):
                        h = h + f32(g[k]) * win[s % 8][k]
                    hsum[s % 7] = h
                if s >= 6:
                    c = s - 3
                    yc = y0 - 4 + c
                    p = np.stack([win[(c + dy[k] + 8) % 8][3 + dx[k]] for k in range(16)], -1)
                    r = _kernel_score(p, win[c % 8][3])
                    inb = col_in & (yc >= 3) & (yc < H - 3)
                    sc[c % 3] = np.where(inb & (r > th), r, f32(0))
                    if 4 <= c < RUN + 4 and yc < H:
                        raw[yc, xc[out_col]] = r[out_col]
                    if c >= 5:
                        yo = yc - 1
                        up, mid, dn = sc[(c - 2) % 3], sc[(c - 1) % 3], sc[c % 3]
                        earlier = np.maximum(np.maximum(shfl_up(up), up),
                                             np.maximum(shfl_down(up), shfl_up(mid)))
                        later = np.maximum(np.maximum(shfl_down(mid), shfl_up(dn)),
                                           np.maximum(dn, shfl_down(dn)))
                        keep = (mid > 0) & (mid > earlier) & (mid >= later)
                        if yo < H:
                            nms[yo, xc[out_col]] = np.where(keep, mid, f32(0))[out_col]
                if 7 <= s <= RUN + 6:
                    yo = y0 - 7 + s
                    v = f32(g[0]) * hsum[(s - 6) % 7]
                    for k in range(1, 7):
                        v = v + f32(g[k]) * hsum[(s - 6 + k) % 7]
                    if yo < H:
                        blur[yo, xc[out_col]] = v[out_col]
    return nms, raw, blur


@pytest.mark.parametrize("shape", [(37, 61), (50, 95)])
def test_fast_pyramid_kernel_schedule_emulated_matches_plain(shape):
    img = noise_image(*shape, 9)
    img = np.round(img / 16).astype(np.float32) * 16 + noise_image(*shape, 10) * 1e-3
    got = _emulate_fast_pyramid_level(img, 7.0)
    ref = fast_pyramid_plain([torch.from_numpy(img)[None]], 7.0)
    assert (ref[0][0] > 0).sum() > 20
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r[0][0].numpy())


# ---- numpy emulation of the orb_desc warp ---------------------------------------

def _emulate_orb_desc(levels, blurs, xy, valid, counts):
    """csrc/orb_desc.cu::orb_desc_kernel, warp by warp, the 32 lanes as a
    numpy axis."""
    f32 = np.float32
    _, _, px, py = (t.numpy() for t in desc_constants(torch.device("cpu")))
    B, N = valid.shape
    first = np.cumsum((0,) + tuple(counts))[:-1]
    ang_out = np.zeros((B, N), f32)
    desc_out = np.zeros((B, N, 8), np.int32)
    lane = np.arange(32)
    u = lane - 15
    r = DESC_RADIUS
    for b in range(B):
        for j in range(N):
            if not valid[b, j]:
                continue
            lv = int(np.searchsorted(first, j, side="right")) - 1
            img, blr = levels[lv][b].numpy(), blurs[lv][b].numpy()
            H, W = img.shape
            x, y = int(xy[b, j, 0]), int(xy[b, j, 1])
            xc = min(max(x + W + 2 * r if x < 0 else x, 0), W - 1)
            yc = min(max(y + H + 2 * r if y < 0 else y, 0), H - 1)
            col = np.clip(xc + u, 0, W - 1)
            m10, m01 = np.zeros(32, f32), np.zeros(32, f32)
            for v in range(-15, 16):
                inside = u * u + v * v <= 240
                I = img[min(max(yc + v, 0), H - 1), col]
                m10 = np.where(inside, m10 + I * u.astype(f32), m10)
                m01 = np.where(inside, m01 + I * f32(v), m01)
            for o in (16, 8, 4, 2, 1):   # __shfl_down_sync: lanes past 31 keep their own
                m10 = m10 + np.concatenate([m10[o:], m10[32 - o:]])
                m01 = m01 + np.concatenate([m01[o:], m01[32 - o:]])
            a = np.arctan2(m01[0], m10[0]).astype(f32)
            c, s = np.cos(a).astype(f32), np.sin(a).astype(f32)
            words = []
            for k in range(8):
                vals = []
                for h in range(2):
                    i = 256 * h + 32 * k + lane
                    ddx = np.rint(px[i] * c - py[i] * s).astype(int)
                    ddy = np.rint(px[i] * s + py[i] * c).astype(int)
                    vals.append(blr[np.clip(yc + ddy, 0, H - 1), np.clip(xc + ddx, 0, W - 1)])
                bits = (vals[0] < vals[1]).astype(np.uint64)
                words.append(int((bits << lane.astype(np.uint64)).sum()))
            ang_out[b, j] = a
            desc_out[b, j] = np.asarray(words, np.uint64).astype(np.uint32).view(np.int32)
    return torch.from_numpy(ang_out), torch.from_numpy(desc_out)


def test_orb_desc_kernel_schedule_emulated_matches_plain():
    levels, blurs = _pyramid(B=2, h=90, w=120, n_levels=2, seed=4)
    counts = (60, 40)
    xy, valid = _keypoints(levels, counts, seed=5)
    got = _emulate_orb_desc(levels, blurs, xy, valid.numpy(), counts)
    ref = orb_desc_plain(levels, blurs, xy, valid, counts)
    v = valid.numpy()
    assert v.sum() > 150
    assert np.abs(got[0].numpy() - ref[0].numpy())[v].max() <= 1e-6
    same = (got[1].numpy() == ref[1].numpy()).all(-1)
    assert same[v].mean() >= 0.999 and (got[1].numpy()[~v] == 0).all()


# ---- hygiene ------------------------------------------------------------------

def test_port_entry_modules_import_no_jax():
    code = ("import sys\n"
            "import orb_slam2_detailed_comments_tpu_torch.frontend.tracking\n"
            "import orb_slam2_detailed_comments_tpu_torch.models.slam_step\n"
            "import orb_slam2_detailed_comments_tpu_torch.ops.orb_desc\n"
            "import orb_slam2_detailed_comments_tpu_torch.ops.stereo_sad\n"
            "import orb_slam2_detailed_comments_tpu_torch.system\n"
            "import orb_slam2_detailed_comments_tpu_torch.interop\n"
            "import orb_slam2_detailed_comments_tpu_torch.backend.device_kf\n"
            "import orb_slam2_detailed_comments_tpu_torch.backend.loop_closing\n"
            "import orb_slam2_detailed_comments_tpu_torch.backend.gba_runner\n"
            "import orb_slam2_detailed_comments_tpu_torch.optim.global_ba\n"
            "import orb_slam2_detailed_comments_tpu_torch.place.vocabulary_tree\n"
            "import orb_slam2_detailed_comments_tpu_torch.io.trajectory\n"
            "bad = [m for m in ('jax', 'orb_slam2_detailed_comments_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ---- on the card ----------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_orb_desc_kernel_matches_plain_on_card(case):
    dev = _need_cuda()
    levels, blurs, xy, valid, counts = case
    args = ([lv.to(dev) for lv in levels], [b.to(dev) for b in blurs], xy.to(dev),
            valid.to(dev), counts)
    before = orb_desc.launches
    got, ref = orb_desc(*args), orb_desc_plain(*args)
    torch.cuda.synchronize()
    assert orb_desc.launches == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
