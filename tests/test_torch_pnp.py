"""Parity of the port's RANSAC PnP (solvers/pnp.py) with the JAX
package's, on the CPU: the same seeded 2D-3D sets through both.

  * solve_pnp_ransac with 0-40% outliers: the same inlier set (exact), R
    within POSE_TOL and t within T_TOL m (max abs entry). Both draw the
    same hypotheses from np.random.default_rng(seed); the P3P pool is the
    same numpy code, the DLT pool differs by float32 rounding: its 12x12
    SVD on unnormalized pixel coordinates is ill-conditioned, and LAPACK's
    and torch's float32 null vectors give translations up to ~1.1e-4 m
    apart (20% outliers, a DLT hypothesis wins);
  * _decompose_projection: P and -P give one pose (the SVD null vector's
    sign is arbitrary: LAPACK and cuSOLVER may return either), and it
    matches the JAX package's within POSE_TOL;
  * the DLT pose on exact correspondences: the true pose within
    DLT_TRUTH_TOL and the JAX package's within DLT_TOL (median).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.solvers import pnp as JP
from orb_slam2_detailed_comments_tpu_torch.solvers import pnp as TP

POSE_TOL = 1e-4
T_TOL = 2e-4
DLT_TOL = 5e-4
DLT_TRUTH_TOL = 5e-3
K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
INV_S2 = (1.0 / (1.2 ** np.arange(8)) ** 2).astype(np.float32)


def _rot(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _pnp_set(seed, outlier_share, n=300, noise=0.5):
    rng = np.random.default_rng(seed)
    R = _rot(rng.normal(0, 0.2, 3))
    t = rng.normal(0, 0.3, 3)
    uv = rng.uniform([20, 20], [620, 460], (n, 2))
    z = rng.uniform(2.0, 8.0, n)
    pc = np.concatenate([(uv - K[:2, 2]) / K[0, 0] * z[:, None], z[:, None]], 1)
    pts3d = (pc - t) @ R            # world = R^T (pc - t)
    octave = rng.integers(0, 3, n).astype(np.int32)
    uv = uv + rng.normal(0, noise, uv.shape)
    bad = rng.random(n) < outlier_share
    uv[bad] = rng.uniform([20, 20], [620, 460], (int(bad.sum()), 2))
    valid = rng.random(n) < 0.9
    Tcw = np.eye(4)
    Tcw[:3, :3], Tcw[:3, 3] = R, t
    return (pts3d.astype(np.float32), uv.astype(np.float32), valid, octave), Tcw, bad


@pytest.mark.parametrize("outlier_share", [0.0, 0.2, 0.4])
def test_solve_pnp_ransac_matches_jax(outlier_share):
    args, Tcw_true, bad = _pnp_set(seed=int(outlier_share * 10), outlier_share=outlier_share)
    rj = JP.solve_pnp_ransac(*args, K, INV_S2, min_inliers=10, seed=5)
    rt = TP.solve_pnp_ransac(*args, K, INV_S2, min_inliers=10, seed=5, device="cpu")
    assert rj is not None and rt is not None
    np.testing.assert_array_equal(rt.inliers, rj.inliers)
    assert rt.n_inliers == rj.n_inliers
    assert np.abs(rt.Tcw[:3, :3] - rj.Tcw[:3, :3]).max() < POSE_TOL
    assert np.abs(rt.Tcw[:3, 3] - rj.Tcw[:3, 3]).max() < T_TOL
    # the pose is right: the inliers are the valid clean correspondences
    valid = args[2]
    assert rt.inliers[valid & ~bad].mean() > 0.9 and not rt.inliers[bad].any()
    assert np.abs(rt.Tcw[:3, 3] - Tcw_true[:3, 3]).max() < 0.05


def test_solve_pnp_ransac_too_few_correspondences():
    args, _, _ = _pnp_set(seed=0, outlier_share=0.0, n=20)
    valid = np.zeros(20, bool)
    valid[:2] = True
    assert TP.solve_pnp_ransac(args[0], args[1], valid, args[3], K, INV_S2,
                               device="cpu") is None


def test_decompose_projection_absorbs_the_sign():
    rng = np.random.default_rng(3)
    Rt = np.zeros((4, 3, 4), np.float32)
    for b in range(4):
        Rt[b, :, :3] = _rot(rng.normal(0, 0.5, 3))
        Rt[b, :, 3] = rng.normal(0, 1.0, 3)
    P = (K @ Rt) * rng.uniform(0.5, 3.0, (4, 1, 1)).astype(np.float32)
    K_inv = torch.from_numpy(np.linalg.inv(K))
    R_p, t_p = TP._decompose_projection(torch.from_numpy(P), K_inv)
    R_n, t_n = TP._decompose_projection(torch.from_numpy(-P), K_inv)
    np.testing.assert_allclose(R_n.numpy(), R_p.numpy(), atol=POSE_TOL)
    np.testing.assert_allclose(t_n.numpy(), t_p.numpy(), atol=POSE_TOL)
    np.testing.assert_allclose(R_p.numpy(), Rt[:, :, :3], atol=POSE_TOL)
    np.testing.assert_allclose(t_p.numpy(), Rt[:, :, 3], atol=POSE_TOL)
    R_j, t_j = JP._decompose_projection(jnp.asarray(-P), jnp.asarray(np.linalg.inv(K)))
    np.testing.assert_allclose(R_n.numpy(), np.asarray(R_j), atol=POSE_TOL)
    np.testing.assert_allclose(t_n.numpy(), np.asarray(t_j), atol=POSE_TOL)


def test_dlt_pose_matches_jax():
    """The DLT pool on exact correspondences of 6 distinct points: both
    packages recover the true pose within DLT_TRUTH_TOL (the float32 SVD's
    conditioning, see above: the JAX package's own pose is 4.1e-3 m off on
    one sample) and agree within DLT_TOL in the median over the samples."""
    args, Tcw_true, _ = _pnp_set(seed=7, outlier_share=0.0, noise=0.0)
    pts3d, uv = args[0], args[1]
    rng = np.random.default_rng(0)
    idx = np.stack([rng.choice(len(uv), TP.MIN_SET, replace=False) for _ in range(50)])
    K_inv = np.linalg.inv(K)
    Rj, tj = JP._decompose_projection(
        JP._fit_projection_dlt(jnp.asarray(pts3d[idx]), jnp.asarray(uv[idx])), jnp.asarray(K_inv))
    Rt, tt = TP._decompose_projection(
        TP._fit_projection_dlt(torch.from_numpy(pts3d[idx]), torch.from_numpy(uv[idx])),
        torch.from_numpy(K_inv))
    for R, t in ((Rt.numpy(), tt.numpy()), (np.asarray(Rj), np.asarray(tj))):
        assert np.abs(R - Tcw_true[:3, :3]).max() < DLT_TRUTH_TOL
        assert np.abs(t - Tcw_true[:3, 3]).max() < DLT_TRUTH_TOL
    assert np.median(np.abs(Rt.numpy() - np.asarray(Rj)).max((1, 2))) < DLT_TOL
    assert np.median(np.abs(tt.numpy() - np.asarray(tj)).max(1)) < DLT_TOL
