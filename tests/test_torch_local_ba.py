"""Parity of the port's mapping numerics with the JAX package's, on the
CPU: the same seeded problems through both.

  * local_bundle_adjustment on synthetic problems at the 16-camera bucket
    of backend/local_mapping.BA_BUCKETS (chip_smoke.synthetic_ba_problem:
    14 cameras, ~3700 points, ~11000 edges, half stereo, 3% gross
    outliers) and global_bundle_adjustment on one below the flat solver's
    4096-edge limit: the inlier masks equal, camera poses within CAM_TOL
    (max abs entry of Tcw), 99% of the points within PT_TOL m. Both run
    float32 LM with sums in different orders; the solutions part by up to
    3.4e-4 in the poses, and points seen twice from cameras 0.25 m apart
    at 12 m are ill-conditioned along their rays, so the largest point
    differences (up to ~0.1 m) are not bounded here;
  * search_for_triangulation, device_kf.triangulation_search_kernel and
    device_kf.fuse_targets_kernel: the same integer matches (exact);
    device_kf.compute_fundamental_np against the JAX package's twin and
    its ops.matching.compute_fundamental, and triangulate_dlt_np against
    the JAX package's;
  * DeviceKeyframeStore grown past its 128 rows with a keyframe culled in
    between keeps every row where it was (the JAX package renumbers them,
    ROADMAP.md C.1).
"""
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.backend import device_kf as JDK
from orb_slam2_detailed_comments_tpu.geometry import triangulate as JTri
from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_detailed_comments_tpu.ops import matching as JM
from orb_slam2_detailed_comments_tpu.optim import global_ba as JG, local_ba as JL

from orb_slam2_detailed_comments_tpu_torch.backend import device_kf as TDK
from orb_slam2_detailed_comments_tpu_torch.backend.local_mapping import BA_BUCKETS
from orb_slam2_detailed_comments_tpu_torch.geometry import triangulate as TTri
from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_detailed_comments_tpu_torch.interop import desc_to_torch
from orb_slam2_detailed_comments_tpu_torch.ops import matching as TM
from orb_slam2_detailed_comments_tpu_torch.optim import global_ba as TG, local_ba as TL

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CAM_TOL, PT_TOL = 1e-3, 1e-3
INV_S2 = (1.0 / (1.2 ** np.arange(8)) ** 2).astype(np.float32)


def _both(d):
    return (JL.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
            TL.BAProblem(**{k: torch.from_numpy(v) for k, v in d.items()}))


def _check_ba(d, out_j, out_t):
    cj, xj, ij = (np.asarray(a) for a in out_j)
    ct, xt, it = (a.numpy() for a in out_t)
    np.testing.assert_array_equal(it, ij)
    assert ij[d["edge_valid"]].mean() > 0.9 and not ij[~d["edge_valid"]].any()
    v, pv = d["cam_valid"], d["point_valid"]
    assert np.abs(ct[v] - cj[v]).max() < CAM_TOL
    fixed = ~d["cam_free"]      # renormalized at the end, as in the JAX package
    np.testing.assert_allclose(ct[fixed], d["cam_Tcw"][fixed], atol=1e-6)
    dx = np.linalg.norm(xt[pv] - xj[pv], axis=1)
    assert np.percentile(dx, 99) < PT_TOL
    # the rotations stay rotations (se3_renormalize at the end)
    R = ct[v, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_local_bundle_adjustment_matches_jax(seed):
    d = chip_smoke.synthetic_ba_problem(BA_BUCKETS[0], seed=seed)
    pj, pt = _both(d)
    out_j = JL.local_bundle_adjustment(pj, JCam(**chip_smoke.BA_CAM), jnp.asarray(INV_S2))
    out_t = TL.local_bundle_adjustment(pt, TCam(**chip_smoke.BA_CAM), torch.from_numpy(INV_S2))
    _check_ba(d, out_j, out_t)


def test_global_bundle_adjustment_matches_jax():
    d = chip_smoke.synthetic_ba_problem((16, 512, 2000), seed=1)
    pj, pt = _both(d)
    out_j = JG.global_bundle_adjustment(pj, JCam(**chip_smoke.BA_CAM), jnp.asarray(INV_S2))
    out_t = TG.global_bundle_adjustment(pt, TCam(**chip_smoke.BA_CAM), torch.from_numpy(INV_S2))
    _check_ba(d, out_j, out_t)


# ---- the mapping searches -------------------------------------------------------

N_KP, N_KF, N_WORLD = 512, 6, 700
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, bf=30.0, width=320, height=240)


def _scene(seed=0):
    """Keyframes 0.3 m apart seeing one world of points with descriptors:
    each keyframe's keypoints are the visible points' projections (0.7 px
    noise) with a few bits of their descriptor flipped, in random slots."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 4.5, N_WORLD), rng.uniform(-2, 2, N_WORLD),
                  rng.uniform(3, 8, N_WORLD)], -1)
    desc = rng.integers(0, 2 ** 32, (N_WORLD, 8), dtype=np.uint32)
    ang = rng.uniform(0, 2 * np.pi, N_WORLD)
    ms = types.SimpleNamespace(
        kf_xy=np.zeros((N_KF, N_KP, 2), np.float32), kf_ur=np.full((N_KF, N_KP), -1, np.float32),
        kf_desc=np.zeros((N_KF, N_KP, 8), np.uint32), kf_kp_valid=np.zeros((N_KF, N_KP), bool),
        kf_octave=np.zeros((N_KF, N_KP), np.int32), kf_angle=np.zeros((N_KF, N_KP), np.float32),
        kf_Tcw=np.tile(np.eye(4, dtype=np.float32), (N_KF, 1, 1)), kf_valid=np.ones(N_KF, bool))
    for k in range(N_KF):
        T = ms.kf_Tcw[k]
        T[:3, 3] = [-0.3 * k, 0.0, 0.0]
        pc = X + T[:3, 3]
        u = CAM["fx"] * pc[:, 0] / pc[:, 2] + CAM["cx"]
        v = CAM["fy"] * pc[:, 1] / pc[:, 2] + CAM["cy"]
        vis = np.nonzero((u >= 2) & (u < CAM["width"] - 2) & (v >= 2) & (v < CAM["height"] - 2))[0]
        vis = rng.permutation(vis)[:N_KP]
        slots = rng.permutation(N_KP)[:vis.size]
        ms.kf_xy[k, slots] = np.stack([u[vis], v[vis]], -1) + rng.normal(0, 0.7, (vis.size, 2))
        d = desc[vis].copy()
        for _ in range(3):
            d[np.arange(vis.size), rng.integers(0, 8, vis.size)] ^= (
                np.uint32(1) << rng.integers(0, 32, vis.size).astype(np.uint32))
        ms.kf_desc[k, slots] = d
        ms.kf_kp_valid[k, slots] = True
        ms.kf_octave[k, slots] = rng.integers(0, 3, vis.size)
        ms.kf_angle[k, slots] = ang[vis] + rng.normal(0, 0.02, vis.size)
        stereo = rng.random(vis.size) < 0.5
        ms.kf_ur[k, slots[stereo]] = (u[vis] - CAM["bf"] / pc[vis, 2])[stereo]
    return ms, X, desc, rng


def _stores(ms):
    sj, st = JDK.DeviceKeyframeStore(N_KP), TDK.DeviceKeyframeStore(N_KP, device="cpu")
    for k in range(N_KF):
        assert sj.row_of(ms, k) == st.row_of(ms, k) == k
    return sj, st


def _same(ok_t, idx_t, ok_j, idx_j):
    ok_j, idx_j = np.asarray(ok_j), np.asarray(idx_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(idx_t.numpy()[ok_j], idx_j[ok_j])
    return int(ok_j.sum())


def test_triangulation_searches_match_jax():
    ms, _, _, rng = _scene(0)
    sj, st = _stores(ms)
    K = np.array([[CAM["fx"], 0, CAM["cx"]], [0, CAM["fy"], CAM["cy"]], [0, 0, 1]], np.float32)
    sigma2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
    has1 = rng.random(N_KP) < 0.3
    rows2 = [1, 2, 3, 5]
    hm2 = rng.random((4, N_KP)) < 0.3
    F12s, epis = [], []
    O1 = -ms.kf_Tcw[0][:3, :3].T @ ms.kf_Tcw[0][:3, 3]
    for k in rows2:
        F = TDK.compute_fundamental_np(ms.kf_Tcw[0], ms.kf_Tcw[k], K, K)
        np.testing.assert_allclose(F, JDK.compute_fundamental_np(ms.kf_Tcw[0], ms.kf_Tcw[k], K, K))
        np.testing.assert_allclose(F, np.asarray(JM.compute_fundamental(
            *(jnp.asarray(a) for a in (ms.kf_Tcw[0], ms.kf_Tcw[k], K, K)))), rtol=1e-5, atol=1e-9)
        pc = ms.kf_Tcw[k][:3, :3] @ O1 + ms.kf_Tcw[k][:3, 3]
        F12s.append(F)
        # sideways steps: the epipole is at infinity (local_mapping's 1e6)
        assert abs(pc[2]) < 1e-6
        epis.append(np.array([1e6, 1e6], np.float32))
    F12s, epis = np.stack(F12s), np.stack(epis)
    ok_j, idx_j = JDK.triangulation_search_kernel(
        0, jnp.asarray(has1), jnp.asarray(np.asarray(rows2, np.int32)), jnp.asarray(hm2),
        jnp.asarray(F12s), jnp.asarray(epis), jnp.ones(4, bool), sj.d_xy, sj.d_desc,
        sj.d_valid, sj.d_octave, sj.d_angle, jnp.asarray(sigma2))
    t = torch.from_numpy
    ok_t, idx_t = TDK.triangulation_search_kernel(0, t(has1), rows2, t(hm2), t(F12s), t(epis),
                                                  st, t(sigma2))
    assert _same(ok_t, idx_t, ok_j, idx_j) > 200
    # the single-pair matcher on the same inputs (lane 2: keyframes 0 and 3)
    k = rows2[2]
    args = [(ms.kf_xy[0], ms.kf_desc[0], ms.kf_kp_valid[0], ms.kf_octave[0], ms.kf_angle[0], has1),
            (ms.kf_xy[k], ms.kf_desc[k], ms.kf_kp_valid[k], ms.kf_octave[k], ms.kf_angle[k], hm2[2])]
    flat = [a for side in args for a in side] + [F12s[2], epis[2], sigma2]
    mj = JM.search_for_triangulation(*(jnp.asarray(a) for a in flat))
    mt = TM.search_for_triangulation(*(desc_to_torch(a, "cpu") if a.dtype == np.uint32
                                       else t(a) for a in flat))
    assert _same(mt.ok, mt.idx, mj.ok, mj.idx) == int(np.asarray(ok_j)[2].sum())


def test_fuse_targets_match_jax():
    ms, X, desc, rng = _scene(1)
    sj, st = _stores(ms)
    P = 1024
    n = N_WORLD
    pos = np.zeros((P, 3), np.float32)
    pos[:n] = X + rng.normal(0, 0.01, X.shape)
    centre = np.array([0.75, 0.0, 0.0])
    nrm = np.zeros((P, 3), np.float32)
    nrm[:n] = (pos[:n] - centre) / np.linalg.norm(pos[:n] - centre, axis=1, keepdims=True)
    dist = np.linalg.norm(pos[:n] - centre, axis=1)
    mind, maxd = np.zeros(P, np.float32), np.zeros(P, np.float32)
    maxd[:n] = 1.2 * dist        # predicted level 1: octaves 0-2 searched
    mind[:n] = maxd[:n] / 1.2 ** 7
    pdesc = np.zeros((P, 8), np.uint32)
    pdesc[:n] = desc
    valid = np.zeros(P, bool)
    valid[:n] = rng.random(n) < 0.95
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    rows = [0, 2, 3, 4]
    Tcws = ms.kf_Tcw[rows]
    log_scale = float(np.log(1.2))
    for check_stereo in (True, False):
        ok_j, idx_j = JDK.fuse_targets_kernel(
            jnp.asarray(np.asarray(rows, np.int32)), jnp.asarray(Tcws), jnp.ones(4, bool),
            sj.d_xy, sj.d_ur, sj.d_desc, sj.d_valid, sj.d_octave, jnp.asarray(pos),
            jnp.asarray(valid), jnp.asarray(nrm), jnp.asarray(mind), jnp.asarray(maxd),
            jnp.asarray(pdesc), jnp.asarray(sf), JCam(**CAM), 8, log_scale, 0.75, JM.TH_LOW,
            check_stereo)
        t = torch.from_numpy
        ok_t, idx_t = TDK.fuse_targets_kernel(
            rows, t(Tcws), st, t(pos), t(valid), t(nrm), t(mind), t(maxd),
            desc_to_torch(pdesc, "cpu"), t(sf), TCam(**CAM), 8, log_scale, 0.75, TM.TH_LOW,
            check_stereo)
        assert _same(ok_t, idx_t, ok_j, idx_j) > 500


def test_triangulate_dlt_np_matches_jax():
    rng = np.random.default_rng(4)
    K = np.array([[250.0, 0, 160.0], [0, 250.0, 120.0], [0, 0, 1]])
    P1 = (K @ np.eye(4)[:3]).astype(np.float32)
    T2 = np.eye(4)[:3].copy()
    T2[0, 3] = -0.3
    P2 = (K @ T2).astype(np.float32)
    uv1 = rng.uniform([0, 0], [320, 240], (200, 2)).astype(np.float32)
    uv2 = (uv1 - np.array([250.0 * 0.3 / 5.0, 0]) + rng.normal(0, 0.3, uv1.shape)).astype(np.float32)
    got = TTri.triangulate_dlt_np(P1, P2, uv1, uv2)
    np.testing.assert_array_equal(got, JTri.triangulate_dlt_np(P1, P2, uv1, uv2))
    assert np.abs(np.median(got[:, 2]) - 5.0) < 0.1


# ---- the keyframe store ----------------------------------------------------------

def test_keyframe_store_rows_stay_put_across_growth():
    """Rows handed out before a growth (past the 128 initial rows), with a
    keyframe culled in between, still hold their keyframes' arrays after
    it; new rows are appended."""
    n_kf, n = 200, 16
    rng = np.random.default_rng(0)
    ms = types.SimpleNamespace(
        kf_xy=rng.normal(size=(n_kf, n, 2)).astype(np.float32),
        kf_ur=rng.normal(size=(n_kf, n)).astype(np.float32),
        kf_desc=rng.integers(0, 2 ** 32, (n_kf, n, 8), dtype=np.uint32),
        kf_kp_valid=rng.random((n_kf, n)) < 0.8,
        kf_octave=rng.integers(0, 8, (n_kf, n)).astype(np.int32),
        kf_angle=rng.normal(size=(n_kf, n)).astype(np.float32),
        kf_valid=np.ones(n_kf, bool))
    store = TDK.DeviceKeyframeStore(n, device="cpu")
    assert store.C == 128
    held = {k: store.row_of(ms, k) for k in range(100)}
    ms.kf_valid[50] = False                        # culled
    held.update({k: store.row_of(ms, k) for k in range(100, n_kf)})
    assert store.C == 256
    assert held == {k: k for k in range(n_kf)} and store.kf_row == held
    for k, r in held.items():
        assert store.row_of(ms, k) == r
        np.testing.assert_array_equal(store.d_xy[r].numpy(), ms.kf_xy[k])
        np.testing.assert_array_equal(store.d_ur[r].numpy(), ms.kf_ur[k])
        np.testing.assert_array_equal(store.d_desc[r].numpy(), ms.kf_desc[k].view(np.int32))
        np.testing.assert_array_equal(store.d_valid[r].numpy(), ms.kf_kp_valid[k])
        np.testing.assert_array_equal(store.d_octave[r].numpy(), ms.kf_octave[k])
        np.testing.assert_array_equal(store.d_angle[r].numpy(), ms.kf_angle[k])
    store.clear()
    assert store.kf_row == {} and store.row_of(ms, 7) == 0


def test_predicted_levels_match_jax_off_the_level_ties():
    """predict_scale_level is ceil(log(max_dist / dist) / log(1.2)). Off the
    ties both packages give the same level. A point seen from the distance
    at which its max_dist was set (from its reference keyframe: a ratio of
    fl(d * 1.2^k) / d) sits on a tie, where the level is k or k + 1 by the
    last ulp of a float32 log: the JAX package's XLA log and torch's part
    there, by one level (ROADMAP.md C.8)."""
    log_scale = float(np.log(1.2))
    rng = np.random.default_rng(0)
    dist = rng.uniform(0.3, 30.0, 4000).astype(np.float32)
    sf = (1.2 ** np.arange(8)).astype(np.float32)

    def levels(d, max_dist):
        lj = JM.predict_scale_level(jnp.asarray(d), jnp.asarray(max_dist), 8, log_scale)
        lt = TM.predict_scale_level(torch.from_numpy(d), torch.from_numpy(max_dist), 8, log_scale)
        return np.asarray(lj), lt.numpy()

    off = (dist * rng.uniform(0.5, 4.0, dist.size)).astype(np.float32)
    x = np.log(off.astype(np.float64) / dist) / log_scale
    away = np.abs(x - np.round(x)) > 1e-4
    lj, lt = levels(dist[away], off[away])
    np.testing.assert_array_equal(lt, lj)
    assert away.mean() > 0.99
    ties = (dist[:, None] * sf[None, :]).astype(np.float32)
    lj, lt = levels(np.repeat(dist[:, None], 8, 1).ravel(), ties.ravel())
    assert np.abs(lt.astype(int) - lj).max() <= 1
