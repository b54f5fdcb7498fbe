"""Parity of the port's modules with the JAX package's, module by module,
on the CPU: the same numpy inputs through both.

Tolerances, with their reasons:
  * resize matrices, BRIEF pattern, FAST nms/raw maps, patches, Hamming
    distances, projection matches: exact (same float32 operations in the
    same order, or integer results);
  * pyramid levels: 1e-4 absolute on [0, 255] pixels (a few float32 ulps),
    because XLA's and torch's matmuls sum in different orders;
  * blur: 1e-5 against XLA (XLA may contract multiply-adds), < 1e-3 against
    the interpret-mode Pallas roll kernel (it sums the taps k3 first);
  * extraction: valid, octave exact; the rest within the JAX package's own
    cross-path gates (tests/test_orb.py:286-305) or tighter;
  * pose GN: Tcw 1e-4, inlier set exact; stereo ur/depth 1e-3, same matches.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.geometry import se3 as JSE3, so3 as JSO3
from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_detailed_comments_tpu.ops import fast as JF, hamming as JH, matching as JM
from orb_slam2_detailed_comments_tpu.ops import orb as JO, pattern as JPat, pyramid as JP
from orb_slam2_detailed_comments_tpu.ops import stereo as JSt
from orb_slam2_detailed_comments_tpu.ops.pallas_fast import fast_pyramid_pallas_roll
from orb_slam2_detailed_comments_tpu.ops.pallas_patch import patch_gather as j_patch_gather
from orb_slam2_detailed_comments_tpu.optim import robust as JR
from orb_slam2_detailed_comments_tpu.optim.pose_gn import pose_optimization as j_pose
from orb_slam2_detailed_comments_tpu.utils import config as JC
from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig as JOrb

from orb_slam2_detailed_comments_tpu_torch.geometry import se3 as TSE3, so3 as TSO3
from orb_slam2_detailed_comments_tpu_torch.interop import config_from_jax, desc_to_numpy, desc_to_torch
from orb_slam2_detailed_comments_tpu_torch.ops import hamming as TH, matching as TM
from orb_slam2_detailed_comments_tpu_torch.ops import orb as TO, pattern as TPat, pyramid as TP
from orb_slam2_detailed_comments_tpu_torch.ops import stereo as TSt
from orb_slam2_detailed_comments_tpu_torch.ops.fast_pyramid import fast_pyramid
from orb_slam2_detailed_comments_tpu_torch.ops.patch_gather import patch_gather
from orb_slam2_detailed_comments_tpu_torch.optim import robust as TR
from orb_slam2_detailed_comments_tpu_torch.optim.pose_gn import pose_optimization as t_pose
from orb_slam2_detailed_comments_tpu_torch.utils import config as TC

from torch_parity import jax_exact_modes, noise_image, small_world, squares_image


@pytest.fixture(scope="module", autouse=True)
def _jax_exact_modes():
    with jax_exact_modes():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


# ---- pattern, pyramid -------------------------------------------------------

def test_brief_pattern_identical():
    np.testing.assert_array_equal(TPat.brief_pattern(1234), JPat.brief_pattern(1234))
    for a, b in zip(TPat.ic_angle_offsets(), JPat.ic_angle_offsets()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(120, 160, 3), (376, 1241, 2)])
def test_resize_matrices_exact(shape):
    rt, ct = TP._composed_resize_mats(*shape, 1.2)
    rj, cj = JP._composed_resize_mats(*shape, 1.2)
    for a, b in zip(rt + ct, rj + cj):
        np.testing.assert_array_equal(a, b)


def test_pyramid_and_blur_match_xla():
    img = squares_image(120, 160, seed=1)
    lt = TP.build_pyramid(t(img), 3, 1.2)
    lj = JP.build_pyramid(jnp.asarray(img), 3, 1.2)
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    np.testing.assert_allclose(TP.gaussian_blur(t(img)).numpy(),
                               np.asarray(JP.gaussian_blur(jnp.asarray(img))), atol=1e-5)
    np.testing.assert_array_equal(TP.features_per_level(1000, 8, 1.2),
                                  JP.features_per_level(1000, 8, 1.2))


# ---- K1: fast_pyramid ---------------------------------------------------------

def _jax_levels(img, n_levels):
    return [np.asarray(lv) for lv in JP.build_pyramid(jnp.asarray(img), n_levels, 1.2)]


@pytest.mark.parametrize("kind", ["noise", "squares"])
def test_fast_maps_match_xla(kind):
    img = (noise_image if kind == "noise" else squares_image)(120, 160, 2)
    levels = _jax_levels(img, 3)
    nms, raw, blur = fast_pyramid([t(lv)[None] for lv in levels], 7.0)
    xla = jax.jit(lambda x: (JF.nms_3x3(JF.fast_score_map(x, 7.0)), JF.fast_score_dense(x)))
    for lv, n, r, b in zip(levels, nms, raw, blur):
        nj, rj = xla(jnp.asarray(lv))
        np.testing.assert_array_equal(n[0].numpy(), np.asarray(nj))
        # XLA's ring wraps at the edge (jnp.roll), the kernels' reflects
        np.testing.assert_array_equal(r[0].numpy()[4:-4, 4:-4], np.asarray(rj)[4:-4, 4:-4])
        # op by op (not jitted): a fused XLA blur contracts multiply-adds
        np.testing.assert_allclose(b[0].numpy(), np.asarray(JP.gaussian_blur(jnp.asarray(lv))),
                                   atol=1e-5)


def test_fast_maps_match_pallas_roll_interpret():
    imgs = [squares_image(120, 160, s) for s in (3, 4)]
    levels = [_jax_levels(im, 3) for im in imgs]
    shapes = JP.pyramid_shapes(120, 160, 3, 1.2)
    nms, raw, blur = fast_pyramid([t(np.stack([lv[i] for lv in levels])) for i in range(3)], 7.0)
    for b in range(2):
        nj, rj, bj = fast_pyramid_pallas_roll(tuple(jnp.asarray(x) for x in levels[b]),
                                              shapes, 7.0, interpret=True)
        for i in range(3):
            np.testing.assert_array_equal(nms[i][b].numpy(), np.asarray(nj[i]))
            np.testing.assert_array_equal(raw[i][b].numpy(), np.asarray(rj[i]))
            assert np.abs(blur[i][b].numpy() - np.asarray(bj[i])).max() < 1e-3


# ---- K2: patch_gather ---------------------------------------------------------

@pytest.mark.parametrize("C,ph,pw", [(2, 39, 39), (1, 11, 11), (1, 11, 21)])
def test_patch_gather_matches_dynamic_slice(C, ph, pw):
    """All coordinates, in range or not: dynamic_slice wraps a negative
    start (x + W) and clamps the start into range."""
    rng = np.random.default_rng(ph * pw)
    src = rng.uniform(0, 255, (C, 90, 130)).astype(np.float32)
    xy = np.stack([rng.integers(-30, 160, 64), rng.integers(-30, 120, 64)], -1).astype(np.int32)
    ref = jax.vmap(lambda p: jax.lax.dynamic_slice(jnp.asarray(src), (0, p[1], p[0]),
                                                   (C, ph, pw)))(jnp.asarray(xy))
    np.testing.assert_array_equal(patch_gather(t(src), t(xy), ph, pw).numpy(), np.asarray(ref))
    # the batched form gathers each stack with its own coordinates
    out = patch_gather(t(np.stack([src, src[:, ::-1].copy()])), t(np.stack([xy, xy[::-1].copy()])),
                       ph, pw)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("psize", [39, 11])
def test_patch_gather_matches_pallas_interpret(psize):
    """The Pallas kernel (square windows) for in-range coordinates."""
    rng = np.random.default_rng(psize)
    src = rng.uniform(0, 255, (2, 150, 210)).astype(np.float32)
    xy = rng.integers(0, [210 - psize, 150 - psize], (29, 2)).astype(np.int32)
    ref = j_patch_gather(jnp.asarray(src), jnp.asarray(xy), psize, interpret=True)
    np.testing.assert_array_equal(patch_gather(t(src), t(xy), psize).numpy(), np.asarray(ref))


# ---- Hamming ------------------------------------------------------------------

def test_hamming_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2 ** 32, (70, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (90, 8), dtype=np.uint32)
    b[:10] = a[:10]
    ta, tb = desc_to_torch(a, "cpu"), desc_to_torch(b, "cpu")
    np.testing.assert_array_equal(TH.hamming_distance_matrix(ta, tb).numpy(),
                                  np.asarray(JH.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(TH.hamming_distance_pairs(ta[:10], tb[:10]).numpy(), 0)
    bits = TH.unpack_bits(ta)
    np.testing.assert_array_equal(desc_to_numpy(TH.pack_bits(bits)), a)
    np.testing.assert_array_equal(desc_to_numpy(TH.pack_bits(bits)),
                                  np.asarray(JH.pack_bits(jnp.asarray(bits.numpy()))))


# ---- ORB extraction -----------------------------------------------------------

ORB_SMALL = dict(n_features=150, max_keypoints=256, n_levels=3)


def _kp_np(kp):
    return [np.asarray(a) for a in kp[:4]] + [np.asarray(kp[4]).view(np.int32), np.asarray(kp[5])]


@pytest.mark.parametrize("batched", [False, True])
def test_extract_orb_matches_jax(batched):
    imgs = np.stack([noise_image(120, 160, s) for s in (6, 7)])
    cfg = JOrb(**ORB_SMALL)
    if batched:
        kj = _kp_np(JO.extract_orb_batch(jnp.asarray(imgs), cfg))
    else:
        kj = _kp_np(JO.extract_orb(jnp.asarray(imgs[0]), cfg))
    tcfg, _ = config_from_jax(cfg, JCam(1.0, 1.0, 0.0, 0.0))
    kt = (TO.extract_orb_batch(t(imgs), tcfg) if batched else TO.extract_orb(t(imgs[0]), tcfg))
    kt = [a.numpy() for a in kt]
    xy, resp, octave, ang, desc, valid = kt
    np.testing.assert_array_equal(valid, kj[5])
    np.testing.assert_array_equal(octave, kj[2])
    v = kj[5]
    assert v.sum() > 100 * (2 if batched else 1)
    np.testing.assert_allclose(xy[v], kj[0][v], atol=1e-3)
    np.testing.assert_allclose(resp[v], kj[1][v], rtol=1e-4)
    np.testing.assert_allclose(ang[v], kj[3][v], atol=1e-3)
    ham = np.bitwise_count(np.bitwise_xor(desc[v], kj[4][v]).view(np.uint32)).sum(-1)
    assert (ham == 0).mean() >= 0.98 and ham.max() <= 8


def test_extract_orb_flat_squares_with_jax_levels(monkeypatch):
    """bench.py's flat-background images, with the JAX package's own
    pyramid levels handed to the port (so the only differences left are
    the port's): the selection is exact, the rest within the JAX package's
    own cross-path gates."""
    img = squares_image(120, 160, seed=0)
    cfg = JOrb(**ORB_SMALL)
    kj = _kp_np(JO.extract_orb(jnp.asarray(img), cfg))
    levels = [t(np.asarray(lv))[None] for lv in
              jax.jit(lambda x: JP.build_pyramid(x, 3, 1.2))(jnp.asarray(img))]
    monkeypatch.setattr(TO, "build_pyramid", lambda imgs, n, sf: levels)
    tcfg, _ = config_from_jax(cfg, JCam(1.0, 1.0, 0.0, 0.0))
    xy, resp, octave, ang, desc, valid = [a.numpy() for a in TO.extract_orb(t(img), tcfg)]
    np.testing.assert_array_equal(valid, kj[5])
    np.testing.assert_array_equal(octave, kj[2])
    np.testing.assert_array_equal(resp, kj[1])
    v = kj[5]
    np.testing.assert_allclose(xy[v], kj[0][v], atol=1e-4)
    np.testing.assert_allclose(ang[v], kj[3][v], atol=1e-3)
    ham = np.bitwise_count(np.bitwise_xor(desc[v], kj[4][v]).view(np.uint32)).sum(-1)
    assert ham.mean() < 1.5 and (ham == 0).mean() >= 0.6 and (ham <= 4).mean() >= 0.95


# ---- matching -----------------------------------------------------------------

def _random_map(rng, P=300, N=200):
    cam = JCam(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=30.0, width=320, height=240)
    pos = rng.uniform([-3, -2, 3], [3, 2, 9], (P, 3)).astype(np.float32)
    dist = np.linalg.norm(pos, axis=-1)
    normal = (pos / dist[:, None]).astype(np.float32)
    octave = rng.integers(0, 4, N).astype(np.int32)
    uv = np.stack([cam.fx * pos[:, 0] / pos[:, 2] + cam.cx,
                   cam.fy * pos[:, 1] / pos[:, 2] + cam.cy], -1)
    src = rng.integers(0, P, N)
    kp_xy = (uv[src] + rng.normal(0, 1.5, (N, 2))).astype(np.float32)
    kp_ur = np.where(rng.random(N) < 0.7, kp_xy[:, 0] - cam.bf / pos[src, 2], -1.0).astype(np.float32)
    desc_p = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32)
    desc_k = desc_p[src] ^ (rng.random((N, 8)) < 0.02).astype(np.uint32)
    return dict(cam=cam, pos=pos, normal=normal, min_d=(0.5 * dist).astype(np.float32),
                max_d=(2.0 * dist).astype(np.float32), valid=rng.random(P) < 0.9,
                kp_xy=kp_xy, kp_ur=kp_ur, desc_p=desc_p, desc_k=desc_k,
                kp_valid=rng.random(N) < 0.95, octave=octave)


@pytest.mark.parametrize("check_stereo", [False, True])
def test_search_by_projection_matches_jax(check_stereo):
    m = _random_map(np.random.default_rng(11))
    cam = m["cam"]
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, 3] = [0.02, -0.01, 0.03]
    sf = np.asarray([1.2 ** i for i in range(4)], np.float32)
    ls = float(np.log(1.2))
    pj = JM.project_and_cull(*(jnp.asarray(m[k]) for k in ("pos", "valid", "normal", "min_d", "max_d")),
                             jnp.asarray(Tcw), cam, 4, ls)
    _, tcam = config_from_jax(JOrb(), cam)
    pt = TM.project_and_cull(*(t(m[k]) for k in ("pos", "valid", "normal", "min_d", "max_d")),
                             t(Tcw), tcam, 4, ls)
    np.testing.assert_array_equal(pt.visible.numpy(), np.asarray(pj.visible))
    np.testing.assert_array_equal(pt.pred_level.numpy(), np.asarray(pj.pred_level))
    np.testing.assert_allclose(pt.uv.numpy(), np.asarray(pj.uv), atol=1e-4)
    # the same projection into both matchers: idx/ok exact
    pt = TM.ProjectedPoints(*(t(np.asarray(a)) for a in pj))
    mj = JM.search_by_projection(pj, jnp.asarray(m["desc_p"]), jnp.asarray(m["kp_xy"]),
                                 jnp.asarray(m["kp_ur"]), jnp.asarray(m["desc_k"]),
                                 jnp.asarray(m["kp_valid"]), jnp.asarray(m["octave"]),
                                 jnp.asarray(sf), th=3.0, check_stereo=check_stereo)
    mt = TM.search_by_projection(pt, desc_to_torch(m["desc_p"], "cpu"), t(m["kp_xy"]), t(m["kp_ur"]),
                                 desc_to_torch(m["desc_k"], "cpu"), t(m["kp_valid"]), t(m["octave"]),
                                 t(sf), th=3.0, check_stereo=check_stereo)
    np.testing.assert_array_equal(mt.ok.numpy(), np.asarray(mj.ok))
    ok = np.asarray(mj.ok)
    assert ok.sum() > 50
    np.testing.assert_array_equal(mt.idx.numpy()[ok], np.asarray(mj.idx)[ok])
    np.testing.assert_array_equal(mt.dist.numpy()[ok], np.asarray(mj.dist)[ok])


def test_best_match_and_dedup_ties_match_jax():
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 12, (60, 40)).astype(np.int32)   # many ties
    mask = rng.random((60, 40)) < 0.5
    octave = rng.integers(0, 3, 40).astype(np.int32)
    for ratio, same in ((0.0, None), (0.9, True)):
        mj = JM.masked_best_match(jnp.asarray(dist), jnp.asarray(mask), 8, ratio, same,
                                  jnp.asarray(octave))
        mt = TM.masked_best_match(t(dist), t(mask), 8, ratio, same, t(octave))
        for a, b in zip(mt, mj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        dj = JM.resolve_duplicate_targets(mj, 40)
        dt = TM.resolve_duplicate_targets(mt, 40)
        np.testing.assert_array_equal(dt.ok.numpy(), np.asarray(dj.ok))


# ---- pose GN, stereo, geometry -----------------------------------------------

@pytest.mark.parametrize("stereo", [False, True])
def test_pose_optimization_matches_jax(stereo):
    rng = np.random.default_rng(4 + stereo)
    cam = JCam(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640, height=480)
    E = 300
    pts = rng.uniform([-3, -2, 4], [3, 2, 12], (E, 3)).astype(np.float32)
    u = cam.fx * pts[:, 0] / pts[:, 2] + cam.cx
    v = cam.fy * pts[:, 1] / pts[:, 2] + cam.cy
    ur = u - cam.bf / pts[:, 2] if stereo else np.full(E, -1.0)
    obs = np.stack([u, v, ur], -1).astype(np.float32)
    obs[:, :2] += rng.normal(0, 0.7, (E, 2)).astype(np.float32)
    obs[:30, :2] += rng.uniform(-40, 40, (30, 2)).astype(np.float32)   # outliers
    octave = rng.integers(0, 4, E).astype(np.int32)
    valid = rng.random(E) < 0.95
    T0 = np.asarray(JSE3.exp_se3(jnp.asarray([0.05, -0.03, 0.08, 0.01, -0.02, 0.015])))
    inv_s2 = np.asarray([1.2 ** (-2 * i) for i in range(8)], np.float32)
    Tj, inj, nj = j_pose(jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(octave),
                         jnp.asarray(valid), cam, jnp.asarray(inv_s2))
    _, tcam = config_from_jax(JOrb(), cam)
    Tt, int_, nt = t_pose(t(T0), t(pts), t(obs), t(octave), t(valid), tcam, t(inv_s2))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    assert int(nt) == int(nj) > 200


def test_stereo_match_matches_jax():
    """Both matchers get the JAX package's L/R keypoints."""
    arrs, orb, cam = small_world(seed=1)
    kps = JO.extract_orb_batch(jnp.asarray(np.stack([arrs["img_l"], arrs["img_r"]])), orb)
    kl, kr = (JO.Keypoints(*[a[i] for a in kps]) for i in (0, 1))
    urj, dj = JSt.stereo_match(kl, kr, jnp.asarray(arrs["img_l"]), jnp.asarray(arrs["img_r"]),
                               cam, orb)

    def to_t(kp):
        return TO.Keypoints(*(t(np.asarray(a)) for a in kp[:4]), desc_to_torch(kp[4], "cpu"),
                            t(np.asarray(kp[5])))

    torb, tcam = config_from_jax(orb, cam)
    urt, dt = TSt.stereo_match(to_t(kl), to_t(kr), t(arrs["img_l"]), t(arrs["img_r"]), tcam, torb)
    matched = np.asarray(urj) >= 0
    assert matched.sum() > 15
    np.testing.assert_array_equal(urt.numpy() >= 0, matched)
    np.testing.assert_allclose(urt.numpy(), np.asarray(urj), atol=1e-3)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-3)
    # RGB-D: the virtual right coordinate from the depth map
    xy = np.asarray(kl.xy)
    urj, dj = JSt.depth_to_stereo(kl, jnp.asarray(xy), jnp.asarray(arrs["depth"]), cam)
    urt, dt = TSt.depth_to_stereo(to_t(kl), t(xy), t(arrs["depth"]), tcam)
    np.testing.assert_allclose(urt.numpy(), np.asarray(urj), atol=1e-4)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_se3_and_camera_match_jax():
    rng = np.random.default_rng(8)
    xi = rng.normal(0, 0.3, (50, 6)).astype(np.float32)
    xi[:5, 3:] = 0.0                          # the small-angle branch
    Tj = np.asarray(JSE3.exp_se3(jnp.asarray(xi)))
    Tt = TSE3.exp_se3(t(xi)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)
    np.testing.assert_allclose(TSE3.log_se3(t(Tj)).numpy(), np.asarray(JSE3.log_se3(jnp.asarray(Tj))),
                               atol=1e-5)
    noisy = (Tj + rng.normal(0, 1e-3, Tj.shape)).astype(np.float32)
    np.testing.assert_allclose(TSE3.se3_renormalize(t(noisy)).numpy(),
                               np.asarray(JSE3.se3_renormalize(jnp.asarray(noisy))), atol=1e-6)
    cam = JCam(fx=500.0, fy=490.0, cx=320.0, cy=240.0, k1=0.1, k2=-0.05, p1=1e-3, p2=-2e-3, k3=0.01)
    _, tcam = config_from_jax(JOrb(), cam)
    uv = rng.uniform([0, 0], [640, 480], (100, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.undistort_pixels(t(uv)).numpy(),
                               np.asarray(cam.undistort_pixels(jnp.asarray(uv))), atol=1e-3)
    d = rng.uniform(1, 10, 100).astype(np.float32)
    np.testing.assert_allclose(tcam.backproject(t(uv), t(d)).numpy(),
                               np.asarray(cam.backproject(jnp.asarray(uv), jnp.asarray(d))), atol=1e-5)
    np.testing.assert_array_equal(tcam.K("cpu").numpy(), np.asarray(cam.K))


def test_se3_so3_helpers_match_jax():
    rng = np.random.default_rng(9)
    A = np.asarray(JSE3.exp_se3(jnp.asarray(rng.normal(0, 0.5, (6, 6)).astype(np.float32))))
    B = np.asarray(JSE3.exp_se3(jnp.asarray(rng.normal(0, 0.5, (6, 6)).astype(np.float32))))
    p = rng.normal(0, 3, (6, 20, 3)).astype(np.float32)
    pairs = [
        (TSE3.se3_inverse(t(A)), JSE3.se3_inverse(jnp.asarray(A))),
        (TSE3.se3_compose(t(A), t(B)), JSE3.se3_compose(jnp.asarray(A), jnp.asarray(B))),
        (TSE3.se3_apply(t(A), t(p)), JSE3.se3_apply(jnp.asarray(A), jnp.asarray(p))),
        (TSE3.se3_rotation(t(A)), JSE3.se3_rotation(jnp.asarray(A))),
        (TSE3.se3_translation(t(A)), JSE3.se3_translation(jnp.asarray(A))),
        (TSE3.se3_identity(device="cpu"), JSE3.se3_identity()),
    ]
    w = rng.normal(0, 1, (30, 3)).astype(np.float32)
    pairs += [(f(t(w)), g(jnp.asarray(w))) for f, g in (
        (TSO3.hat, JSO3.hat), (TSO3.exp_so3, JSO3.exp_so3),
        (TSO3.left_jacobian_so3, JSO3.left_jacobian_so3),
        (TSO3.left_jacobian_inv_so3, JSO3.left_jacobian_inv_so3))]
    R = np.asarray(JSO3.exp_so3(jnp.asarray(w)))
    pairs += [(TSO3.vee(t(R)), JSO3.vee(jnp.asarray(R))),
              (TSO3.log_so3(t(R)), JSO3.log_so3(jnp.asarray(R))),
              (TSO3.rotmat_to_quat(t(R)), JSO3.rotmat_to_quat(jnp.asarray(R)))]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for T in A:   # the host-side numpy helpers are copies: identical
        noisy = (T + rng.normal(0, 1e-3, T.shape)).astype(np.float32)
        np.testing.assert_array_equal(TSE3.se3_inverse_np(T), JSE3.se3_inverse_np(T))
        np.testing.assert_array_equal(TSE3.se3_renormalize_np(noisy), JSE3.se3_renormalize_np(noisy))


def test_robust_and_settings_match_jax():
    chi2 = np.random.default_rng(10).uniform(0, 30, 200).astype(np.float32)
    chi2[:3] = 0.0
    for delta in (TR.DELTA_MONO, TR.DELTA_STEREO):
        np.testing.assert_allclose(TR.huber_weight(t(chi2), delta).numpy(),
                                   np.asarray(JR.huber_weight(jnp.asarray(chi2), delta)), rtol=1e-6)
    assert (TR.CHI2_MONO, TR.CHI2_STEREO) == (JR.CHI2_MONO, JR.CHI2_STEREO)
    for path in sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml")):
        a, b = TC.load_settings_yaml(str(path)), JC.load_settings_yaml(str(path))
        assert tuple(a.camera) == tuple(b.camera), path.name
        assert dataclasses.asdict(a.orb) == dataclasses.asdict(b.orb), path.name
        assert (a.fps, a.rgb, a.th_depth, a.depth_map_factor, a.max_frames) == \
            (b.fps, b.rgb, b.th_depth, b.depth_map_factor, b.max_frames), path.name
