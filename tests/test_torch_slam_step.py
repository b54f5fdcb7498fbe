"""Parity of the port's per-frame tracking program with the JAX package's:
the same inputs (numpy, from a seed) and the same local map (carried over
by interop.state_from_jax) through both, on the CPU.

Tolerances: Tcw atol 1e-3; n_inliers within 1% (at least 1); per
keypoint, the float columns (x, y, ur, depth, response, angle) within 1e-3
(depth 1e-3 relative) and the integer columns (octave, valid) exact; the
match slot and inlier flag may differ on at most 1% of keypoints, since a
float-eps difference in a projected coordinate can move one candidate
across a search-window edge. Visibility over the pad is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.models import slam_step as JS
from orb_slam2_detailed_comments_tpu_torch.interop import desc_to_numpy, state_from_jax
from orb_slam2_detailed_comments_tpu_torch.models import slam_step as TS

from torch_parity import jax_exact_modes, perturbed_pose, small_world


@pytest.fixture(scope="module", autouse=True)
def _jax_exact_modes():
    with jax_exact_modes():
        yield


@pytest.fixture(scope="module")
def world():
    return small_world(seed=0)


def _state(world):
    arrs, orb, cam = world
    Tcw = perturbed_pose()
    return Tcw, state_from_jax(Tcw, arrs["packed"], arrs["desc"], arrs["valid"], orb, cam,
                               device="cpu")


def _assert_inliers(n_jax, n_torch):
    assert abs(n_jax - n_torch) <= max(1, int(0.01 * n_jax)), (n_jax, n_torch)


def _compare_blobs(blob_j, blob_t, n_kp):
    bj, tsj, visj = JS.unpack_host_blob(np.asarray(blob_j), n_kp)
    bt, tst, vist = TS.unpack_host_blob(blob_t.numpy(), n_kp)
    np.testing.assert_allclose(tst[:16], tsj[:16], atol=1e-3)
    _assert_inliers(tsj[16], tst[16])       # stage-2 inliers
    _assert_inliers(tsj[20], tst[20])       # stage-1 inliers
    assert tsj[19] == tst[19]               # valid keypoints
    np.testing.assert_array_equal(vist, visj)
    for col in (6, 7):                      # octave, valid
        np.testing.assert_array_equal(bt[:, col], bj[:, col])
    for col in (0, 1, 2, 4, 5):             # x, y, ur, response, angle
        np.testing.assert_allclose(bt[:, col], bj[:, col], atol=1e-3)
    np.testing.assert_allclose(bt[:, 3], bj[:, 3], rtol=1e-3, atol=1e-3)   # depth
    for col in (8, 9):                      # slot, inlier
        assert (bt[:, col] != bj[:, col]).mean() <= 0.01
    return tsj


def test_fused_stereo_frame_matches_jax(world):
    arrs, orb, cam = world
    Tcw, st = _state(world)
    th_depth = 40.0 * cam.baseline
    pair = np.stack([arrs["img_l"], arrs["img_r"]])
    blob_j, desc_j = JS.fused_stereo_frame(
        jnp.asarray(pair), jnp.asarray(Tcw), jnp.asarray(arrs["packed"]),
        jnp.asarray(arrs["desc"]), jnp.asarray(arrs["valid"]),
        orb=orb, cam=cam, th_depth=th_depth)
    blob_t, desc_t = TS.fused_stereo_frame(
        torch.from_numpy(pair), st.Tcw, st.packed, st.mp_desc, st.mp_valid,
        orb=st.orb, cam=st.cam, th_depth=th_depth)
    ts = _compare_blobs(blob_j, blob_t, orb.max_keypoints)
    assert ts[16] > 20  # the frame really tracked
    # a float-eps angle difference can move one of 512 rotated samples
    # across a rounding edge: descriptors agree per keypoint, not per bit
    same = (desc_to_numpy(desc_t) == np.asarray(desc_j)).all(-1)
    assert same.mean() >= 0.99


def test_fused_mono_frame_matches_jax(world):
    arrs, orb, cam = world
    Tcw, st = _state(world)
    blob_j, _ = JS.fused_mono_frame(
        jnp.asarray(arrs["img_l"]), jnp.asarray(Tcw), jnp.asarray(arrs["packed"]),
        jnp.asarray(arrs["desc"]), jnp.asarray(arrs["valid"]), orb=orb, cam=cam)
    blob_t, _ = TS.fused_mono_frame(
        torch.from_numpy(arrs["img_l"]), st.Tcw, st.packed, st.mp_desc, st.mp_valid,
        orb=st.orb, cam=st.cam)
    assert _compare_blobs(blob_j, blob_t, orb.max_keypoints)[16] > 20


def test_fused_rgbd_frame_matches_jax(world):
    arrs, orb, cam = world
    Tcw, st = _state(world)
    th_depth = 40.0 * cam.baseline
    blob_j, _ = JS.fused_rgbd_frame(
        jnp.asarray(arrs["img_l"]), jnp.asarray(arrs["depth"]), jnp.asarray(Tcw),
        jnp.asarray(arrs["packed"]), jnp.asarray(arrs["desc"]),
        jnp.asarray(arrs["valid"]), orb=orb, cam=cam, th_depth=th_depth)
    blob_t, _ = TS.fused_rgbd_frame(
        torch.from_numpy(arrs["img_l"]), torch.from_numpy(arrs["depth"]), st.Tcw,
        st.packed, st.mp_desc, st.mp_valid, orb=st.orb, cam=st.cam, th_depth=th_depth)
    assert _compare_blobs(blob_j, blob_t, orb.max_keypoints)[16] > 20


def _map_args(arrs, st):
    pos, normal, mind, maxd = TS._unpack_pad(st.packed)
    jpad = jnp.asarray(arrs["packed"])
    jargs = (jpad[:, 0:3], jpad[:, 3:6], jpad[:, 6], jpad[:, 7],
             jnp.asarray(arrs["desc"]), jnp.asarray(arrs["valid"]))
    return jargs, (pos, normal, mind, maxd, st.mp_desc, st.mp_valid)


def test_stereo_tracking_step_matches_jax(world):
    arrs, orb, cam = world
    Tcw, st = _state(world)
    jargs, targs = _map_args(arrs, st)
    Tj, idx_j, ok_j, n_j, ur_j, depth_j, _ = JS.stereo_tracking_step(
        jnp.asarray(arrs["img_l"]), jnp.asarray(arrs["img_r"]), jnp.asarray(Tcw),
        *jargs, orb=orb, cam=cam)
    Tt, idx_t, ok_t, n_t, ur_t, depth_t, _ = TS.stereo_tracking_step(
        torch.from_numpy(arrs["img_l"]), torch.from_numpy(arrs["img_r"]), st.Tcw,
        *targs, orb=st.orb, cam=st.cam)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-3)
    _assert_inliers(int(n_j), int(n_t))
    assert int(n_j) > 20
    np.testing.assert_array_equal(ur_t.numpy() >= 0, np.asarray(ur_j) >= 0)
    np.testing.assert_allclose(ur_t.numpy(), np.asarray(ur_j), atol=1e-3)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j), rtol=1e-3, atol=1e-3)
    assert (ok_t.numpy() != np.asarray(ok_j)).mean() <= 0.01


def test_mono_tracking_step_matches_jax(world):
    arrs, orb, cam = world
    Tcw, st = _state(world)
    jargs, targs = _map_args(arrs, st)
    Tj, idx_j, ok_j, n_j, _ = JS.mono_tracking_step(
        jnp.asarray(arrs["img_l"]), jnp.asarray(Tcw), *jargs, orb=orb, cam=cam)
    Tt, idx_t, ok_t, n_t, _ = TS.mono_tracking_step(
        torch.from_numpy(arrs["img_l"]), st.Tcw, *targs, orb=st.orb, cam=st.cam)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-3)
    _assert_inliers(int(n_j), int(n_t))
    assert int(n_j) > 20
    assert (ok_t.numpy() != np.asarray(ok_j)).mean() <= 0.01


def test_pack_host_blob_roundtrip():
    rng = np.random.default_rng(3)
    bundle = torch.from_numpy(rng.normal(size=(7, 10)).astype(np.float32))
    ts = torch.from_numpy(rng.normal(size=21).astype(np.float32))
    vis = torch.from_numpy(rng.random(5) > 0.5)
    blob_t = TS.pack_host_blob(bundle, ts, vis)
    blob_j = JS.pack_host_blob(jnp.asarray(bundle.numpy()), jnp.asarray(ts.numpy()),
                               jnp.asarray(vis.numpy()))
    np.testing.assert_array_equal(blob_t.numpy(), np.asarray(blob_j))
    b, t, v = TS.unpack_host_blob(blob_t, 7)
    assert torch.equal(b, bundle) and torch.equal(t, ts) and torch.equal(v, vis)
