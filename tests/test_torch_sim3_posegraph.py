"""Parity of the port's loop-closing solvers with the JAX package's, on the
CPU: the same numpy inputs through both.

  * geometry/sim3.py: exp_sim3 and log_sim3 on tangents with theta = 0,
    s = 1, both and neither, against the JAX package's (1e-5) and as a
    round trip (1e-5), sim3_inverse and sim3_to_se3 by their identities;
  * solvers/sim3_solver.py: Horn's method on the same samples gives the
    same R, t, s (1e-4; R, not the quaternion, whose sign is free), and
    RANSAC, drawing its samples as the JAX package does, the same R, t, s
    (1e-4) and the same inlier mask, with a free and a fixed scale;
  * optim/sim3_opt.py: optimize_sim3 from the RANSAC estimate, the same
    S12 (1e-4) and inliers;
  * optim/pose_graph.py: optimize_pose_graph per backend on a 64-keyframe
    circle graph (chip_smoke.circle_pose_graph: a 50 m circle, so the
    nondimensionalization runs; one loop edge, a covisibility edge every
    4 keyframes, which bands at W = 4 with the loop edge and one anchor in
    the Woodbury part): dense and banded within 1e-4 of the JAX package,
    cg within 2e-3 (JAX's own cg-against-dense tolerance,
    tests/test_sim3_posegraph.py:137); the backend routing;
  * optim/segments.SegmentSum against index_add_ (1e-5), and the new
    modules import no jax.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.geometry import sim3 as JS3
from orb_slam2_detailed_comments_tpu.optim import pose_graph as JPG, sim3_opt as JSO
from orb_slam2_detailed_comments_tpu.solvers import sim3_solver as JSS

from orb_slam2_detailed_comments_tpu_torch.geometry import sim3 as TS3
from orb_slam2_detailed_comments_tpu_torch.interop import pose_graph_problem_from_jax
from orb_slam2_detailed_comments_tpu_torch.optim import pose_graph as TPG, sim3_opt as TSO
from orb_slam2_detailed_comments_tpu_torch.optim.segments import SegmentSum
from orb_slam2_detailed_comments_tpu_torch.solvers import sim3_solver as TSS

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

# the JAX functions jitted whole: one compile each, not one per primitive
J_EXP, J_LOG = jax.jit(JS3.exp_sim3), jax.jit(JS3.log_sim3)
J_HORN = jax.jit(JSS._horn_batched, static_argnums=2)

TANGENTS = {
    "general": [0.3, -0.2, 0.5, 0.1, -0.3, 0.2, 0.25],
    "theta0": [0.3, -0.2, 0.5, 0.0, 0.0, 0.0, 0.25],
    "s1": [0.3, -0.2, 0.5, 0.1, -0.3, 0.2, 0.0],
    "theta0_s1": [0.3, -0.2, 0.5, 0.0, 0.0, 0.0, 0.0],
}


@pytest.mark.parametrize("case", sorted(TANGENTS))
def test_exp_log_sim3_match_jax(case):
    xi = np.asarray(TANGENTS[case], np.float32)
    S_t = TS3.exp_sim3(torch.from_numpy(xi))
    S_j = np.asarray(J_EXP(jnp.asarray(xi)))
    np.testing.assert_allclose(S_t.numpy(), S_j, atol=1e-5)
    back = TS3.log_sim3(S_t).numpy()
    assert np.isfinite(back).all()
    np.testing.assert_allclose(back, xi, atol=1e-5)
    np.testing.assert_allclose(back, np.asarray(J_LOG(jnp.asarray(S_j))), atol=1e-5)
    # inverse and SE3 recovery: S^-1 S = I and [sR | t] -> [R | t / s]
    np.testing.assert_allclose((TS3.sim3_inverse(S_t) @ S_t).numpy(), np.eye(4), atol=1e-5)
    s = np.exp(xi[6])
    T = TS3.sim3_to_se3(S_t).numpy()
    np.testing.assert_allclose(T[:3, :3], S_j[:3, :3] / s, atol=1e-5)
    np.testing.assert_allclose(T[:3, 3], S_j[:3, 3] / s, atol=1e-5)


def _ransac_inputs(fix_scale):
    p1, p2, uv1, uv2, o1, o2, R, t, s = chip_smoke.loop_matches(
        n=120, outlier_share=0.3, scale=1.0 if fix_scale else 1.3, seed=3)
    return p2, p1, uv2, uv1, np.ones(len(p1), bool), o2, o1


def test_horn_matches_jax():
    p2, p1, *_ = _ransac_inputs(False)
    rng = np.random.default_rng(0)          # 3-point samples, as RANSAC draws them
    idx = np.stack([rng.choice(len(p1), 3, replace=False) for _ in range(40)])
    a, b = p2[idx], p1[idx]
    for fix in (False, True):
        Rj, tj, sj = J_HORN(jnp.asarray(a), jnp.asarray(b), fix)
        Rt, tt, st = TSS._horn_batched(torch.from_numpy(a), torch.from_numpy(b), fix)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)


@pytest.fixture(scope="module", params=[False, True], ids=["scale", "fixed_scale"])
def ransac(request):
    fix = request.param
    args = _ransac_inputs(fix)
    kw = dict(sigma2_levels=chip_smoke.SIGMA2, K=chip_smoke.SIM3_K, fix_scale=fix, seed=5)
    return fix, args, JSS.solve_sim3_ransac(*args, **kw), TSS.solve_sim3_ransac(*args, **kw,
                                                                               device="cpu")


def test_sim3_ransac_matches_jax(ransac):
    fix, _, rj, rt = ransac
    assert rj is not None and rt is not None
    np.testing.assert_allclose(rt.R, rj.R, atol=1e-4)
    np.testing.assert_allclose(rt.t, rj.t, atol=1e-4)
    assert abs(rt.s - rj.s) < 1e-4 and (not fix or rt.s == 1.0)
    np.testing.assert_array_equal(rt.inliers, rj.inliers)
    assert rt.n_inliers == rj.n_inliers >= 70


def test_optimize_sim3_matches_jax(ransac):
    fix, (p2, p1, uv2, uv1, _, o2, o1), rj, _ = ransac
    S0 = np.eye(4, dtype=np.float32)
    S0[:3, :3], S0[:3, 3] = rj.s * rj.R, rj.t
    inv_s2 = 1.0 / chip_smoke.SIGMA2
    args = (S0, p1, p2, uv1, uv2, rj.inliers, inv_s2[o1], inv_s2[o2], chip_smoke.SIM3_K)
    oj = JSO.optimize_sim3(*(jnp.asarray(a) for a in args), fix_scale=fix)
    ot = TSO.optimize_sim3(*args, fix_scale=fix, device="cpu")
    np.testing.assert_allclose(ot.S12.numpy(), np.asarray(oj.S12), atol=1e-4)
    np.testing.assert_array_equal(ot.inliers.numpy(), np.asarray(oj.inliers))
    assert int(ot.n_inliers) == int(oj.n_inliers) >= 70


@pytest.fixture(scope="module")
def circle_graph():
    prob, S_true, S_est = chip_smoke.circle_pose_graph(64, seed=11, drift=0.01, covis_every=4)
    return JPG.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in prob.items()}), S_true, S_est


@pytest.mark.parametrize("backend,atol", [("dense", 1e-4), ("banded", 1e-4), ("cg", 2e-3)])
def test_optimize_pose_graph_matches_jax(circle_graph, backend, atol):
    pj, S_true, S_est = circle_graph
    Sj = np.asarray(JPG.optimize_pose_graph(pj, n_iters=6, backend=backend))
    St = TPG.optimize_pose_graph(pose_graph_problem_from_jax(pj), n_iters=6, backend=backend,
                                 device="cpu").numpy()
    np.testing.assert_allclose(St, Sj, atol=atol)
    err0 = np.linalg.norm(S_est[:, :3, 3] - S_true[:, :3, 3], axis=1).mean()
    err1 = np.linalg.norm(St[:, :3, 3] - S_true[:, :3, 3], axis=1).mean()
    assert err1 < 0.01 * err0, (err1, err0)


def test_pose_graph_backend_routing(circle_graph):
    pt = pose_graph_problem_from_jax(circle_graph[0])
    assert TPG.pose_graph_backend(pt) == "dense"             # K = 64 <= 256
    assert TPG.pose_graph_backend(pt, "banded") == "banded"
    W, short, long_, anchors = TPG._partition_edges_banded(
        pt.edge_i, pt.edge_j, pt.edge_valid, pt.vertex_valid, pt.vertex_fixed)
    assert (W, long_.size, anchors.size) == (4, 1, 1)
    jW, jshort, jlong, janc = JPG._partition_edges_banded(circle_graph[0])
    assert W == jW and all(np.array_equal(a, np.asarray(b)) for a, b in
                           ((short, jshort), (long_, jlong), (anchors, janc)))
    # a graph that does not band: every vertex tied to a far one
    K = 300
    far = pt._replace(vertex_fixed=np.arange(K) == 0, vertex_valid=np.ones(K, bool),
                      edge_i=np.arange(K, dtype=np.int32),
                      edge_j=((np.arange(K) + K // 2) % K).astype(np.int32),
                      edge_valid=np.ones(K, bool))
    assert TPG.pose_graph_backend(far) == "cg"
    with pytest.raises(ValueError, match="does not band"):
        TPG.pose_graph_backend(far, "banded")


@pytest.mark.parametrize("n_rows", [0, 1, 500])
def test_segment_sum_matches_index_add(n_rows):
    """The fixed-order sums that replace the JAX package's scatter-adds."""
    rng = np.random.default_rng(n_rows)
    keys = rng.integers(0, 40, n_rows)
    rows = torch.from_numpy(rng.normal(size=(n_rows, 7, 7)).astype(np.float32))
    want = torch.zeros(40, 7, 7).index_add_(0, torch.from_numpy(keys), rows)
    torch.testing.assert_close(SegmentSum(keys, 40, "cpu")(rows), want, rtol=1e-6, atol=1e-5)


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import orb_slam2_detailed_comments_tpu_torch.optim.global_ba_grouped\n"
            "import orb_slam2_detailed_comments_tpu_torch.optim.pose_graph\n"
            "import orb_slam2_detailed_comments_tpu_torch.optim.sim3_opt\n"
            "import orb_slam2_detailed_comments_tpu_torch.solvers.sim3_solver\n"
            "import orb_slam2_detailed_comments_tpu_torch.backend.local_mapping\n"
            "bad = [m for m in ('jax', 'orb_slam2_detailed_comments_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
