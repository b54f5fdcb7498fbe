"""Parity of the port's grouped global BA with the JAX package's, on the CPU.

The problem is tests/test_global_ba_grouped.py::build_problem(seed=0, C=16,
P=400) (about 1,800 edges, ten points seen by every camera, 25 invalid
edges), built once:

  * the layout (kp_cap=8, so the point spill is in use; kc_cap=16 for the
    camera spill) covers every valid edge once, and its point-major grid
    is the JAX package's, slot for slot;
  * the port's grouped solve against the JAX package's _solve_grouped
    (its exact-float32 "gather" formulation, called directly: under
    tests/conftest.py's 8 virtual devices the JAX solve_global_ba takes its
    mesh path at E >= 4096) and against the port's flat solve: cameras
    within 2e-3, points within 2e-2 (tests/test_global_ba_grouped.py:101-104:
    LM acceptance near its boundary can part two float32 solvers);
  * solve_global_ba routes E >= 4096 to the grouped solve and smaller maps
    to the flat one, in the port alone; a stop_check that never fires
    leaves the solve bit for bit as it is, one that fires stops it;
  * ROADMAP.md C.9: a monocular initialization whose two-view map holds
    4096 edges or more runs its global BA (LocalMapper.global_ba, as
    frontend/tracking.py calls it) on the grouped path instead of raising.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_detailed_comments_tpu.optim import global_ba_grouped as JG

from orb_slam2_detailed_comments_tpu_torch.backend import local_mapping as TLM
from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_detailed_comments_tpu_torch.interop import ba_problem_from_jax
from orb_slam2_detailed_comments_tpu_torch.optim import global_ba as TF, global_ba_grouped as TG
from orb_slam2_detailed_comments_tpu_torch.state.frame import FrameData
from orb_slam2_detailed_comments_tpu_torch.state.map_store import MapStore
from orb_slam2_detailed_comments_tpu_torch.utils.config import OrbConfig, SlamConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_global_ba_grouped import CAM as JCAM, INV_S2 as J_INV_S2, build_problem  # noqa: E402

CAM_TOL, PT_TOL = 2e-3, 2e-2
CAM = PinholeCamera(fx=JCAM.fx, fy=JCAM.fy, cx=JCAM.cx, cy=JCAM.cy, bf=JCAM.bf)
INV_S2 = torch.from_numpy(np.asarray(J_INV_S2))
N_ITERS, CG_ITERS = 6, 25


@pytest.fixture(scope="module")
def problem():
    pj = build_problem(seed=0, C=16, P=400)
    return pj, ba_problem_from_jax(pj, "cpu")


@pytest.fixture(scope="module")
def jax_solution(problem):
    gp = JG.group_global_problem(problem[0], J_INV_S2, kp_cap=8)
    cams, pts, _, _ = JG._solve_grouped(gp, JCAM, N_ITERS, CG_ITERS, 1e-5, "gather")
    return np.asarray(cams), np.asarray(pts)


@pytest.fixture(scope="module")
def port_solution(problem):
    gp = TG.group_global_problem(problem[1], kp_cap=8)
    cams, pts, _ = TG.solve_grouped(gp, CAM, INV_S2, N_ITERS, CG_ITERS, 1e-5)
    return cams.numpy(), pts.numpy()


def _close(a, b):
    np.testing.assert_allclose(a[0], b[0], atol=CAM_TOL)
    np.testing.assert_allclose(a[1], b[1], atol=PT_TOL)


def test_layout_covers_every_valid_edge_once(problem):
    pj, pt = problem
    gp = TG.group_global_problem(pt, kp_cap=8, kc_cap=16)
    Kp, P, Ks, Us = gp.shape
    assert Kp == 8 and Us == 10 and gp.cs_cam.numel() > 0     # both spills in use
    slot_edge = gp.slot_edge.numpy()
    covered = slot_edge[slot_edge >= 0]
    assert sorted(covered.tolist()) == np.nonzero(np.asarray(pj.edge_valid))[0].tolist()
    # the storage problem holds each edge's own data at its slot
    live = slot_edge >= 0
    for f in ("edge_cam", "edge_octave", "edge_obs"):
        np.testing.assert_array_equal(getattr(gp.prob, f).numpy()[live],
                                      np.asarray(getattr(pj, f))[covered])
    assert not gp.prob.edge_valid.numpy()[~live].any()
    # the point-major grid is the JAX package's, slot for slot
    jgp = JG.group_global_problem(pj, J_INV_S2, kp_cap=8, kc_cap=16)
    np.testing.assert_array_equal(slot_edge[:Kp * P].reshape(Kp, P), np.asarray(jgp.g_edge))
    # the camera selection reaches every stored slot once
    sel = np.concatenate([gp.c_sel.numpy()[gp.c_valid.numpy()],
                          gp.cs_sel.numpy()[gp.cs_valid.numpy()]])
    assert sorted(sel.tolist()) == np.nonzero(live)[0].tolist()


def test_grouped_matches_jax(jax_solution, port_solution):
    _close(port_solution, jax_solution)


@pytest.mark.parametrize("kp_cap,kc_cap", [(8, 1024), (64, 16)])
def test_grouped_matches_flat(problem, port_solution, kp_cap, kc_cap):
    pt = problem[1]
    flat = TF.global_bundle_adjustment(pt, CAM, INV_S2, n_iters=N_ITERS, cg_iters=CG_ITERS)
    grouped = TG.global_bundle_adjustment_grouped(pt, CAM, INV_S2, n_iters=N_ITERS,
                                                  cg_iters=CG_ITERS, kp_cap=kp_cap,
                                                  kc_cap=kc_cap)
    _close((grouped[0].numpy(), grouped[1].numpy()), (flat[0].numpy(), flat[1].numpy()))
    assert (grouped[2] == flat[2]).float().mean() > 0.995
    if kp_cap == 8:
        np.testing.assert_array_equal(grouped[0].numpy(), port_solution[0])


def _spy(monkeypatch):
    calls = []
    real = TLM.solve_grouped

    def spy(gp, *a):
        calls.append(int(gp.slot_edge.numel()))
        return real(gp, *a)

    monkeypatch.setattr(TLM, "solve_grouped", spy)
    return calls


def test_solve_global_ba_routes_by_edge_count(problem, monkeypatch):
    calls = _spy(monkeypatch)
    pt = problem[1]
    assert pt.edge_cam.shape[0] < TLM.FLAT_GBA_MAX_EDGES
    TLM.solve_global_ba(pt, CAM, INV_S2.numpy(), n_iters=2)
    assert calls == []
    big = ba_problem_from_jax(build_problem(seed=13, C=24, P=1000, n_invalid=40), "cpu")
    assert big.edge_cam.shape[0] >= TLM.FLAT_GBA_MAX_EDGES
    cams, pts = TLM.solve_global_ba(big, CAM, INV_S2.numpy(), n_iters=2)
    assert len(calls) == 1 and np.isfinite(cams).all() and np.isfinite(pts).all()
    # the grouped path runs the JAX package's schedule: 50 CG iterations, damping 1e-5
    ref = TG.solve_grouped(TG.group_global_problem(big), CAM, INV_S2, 2, 50, 1e-5)
    np.testing.assert_array_equal(cams, ref[0].numpy())
    np.testing.assert_array_equal(pts, ref[1].numpy())


def test_solve_global_ba_stop_check_raises(problem):
    """The name predates the interruptible solve, which raised here. A
    stop_check that never fires leaves the solve as it is, bit for bit; one
    that fires at the first poll stops it (tests/test_torch_async.py holds
    the chunks against the JAX package)."""
    pt = problem[1]
    whole = TLM.solve_global_ba(pt, CAM, INV_S2.numpy(), n_iters=2)
    polled = TLM.solve_global_ba(pt, CAM, INV_S2.numpy(), n_iters=2, stop_check=lambda: False)
    np.testing.assert_array_equal(polled[0], whole[0])
    np.testing.assert_array_equal(polled[1], whole[1])
    assert TLM.solve_global_ba(pt, CAM, INV_S2.numpy(), stop_check=lambda: True) is None


def _two_view_map(n_points, seed=0):
    """A monocular initialization's map as frontend/tracking.py builds it:
    two keyframes 0.3 m apart, n_points triangulated points seen in both
    (0.5 px noise on the keypoints, 1% noise on the points)."""
    cfg = SlamConfig(camera=PinholeCamera(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104,
                                          width=1226, height=370),
                     orb=OrbConfig(n_features=2000, max_keypoints=4096), fps=10.0)
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-8, 8, n_points), rng.uniform(-2, 2, n_points),
                  rng.uniform(8, 30, n_points)], -1)
    N = cfg.orb.max_keypoints
    mp = MapStore(cfg)
    kfs = []
    for b in (0.0, 0.3):
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[0, 3] = -b
        pc = X + Tcw[:3, 3]
        xy = np.zeros((N, 2), np.float32)
        xy[:n_points] = (pc[:, :2] / pc[:, 2:] * 707.0912 + [601.8873, 183.1104]
                         + rng.normal(0, 0.5, (n_points, 2)))
        f = FrameData(frame_id=len(kfs), timestamp=0.1 * len(kfs), xy=xy,
                      response=np.ones(N, np.float32), octave=np.zeros(N, np.int32),
                      angle=np.zeros(N, np.float32), desc=np.zeros((N, 8), np.uint32),
                      valid=np.arange(N) < n_points, ur=np.full(N, -1, np.float32),
                      depth=np.full(N, -1, np.float32), Tcw=Tcw)
        kfs.append(mp.add_keyframe(f))
    ids = mp.add_map_points_batch(X * (1 + rng.normal(0, 0.01, X.shape)), kfs[0],
                                  np.arange(n_points), first_kf=kfs[0])
    mp.add_observations_batch(ids, kfs[1], np.arange(n_points))
    return cfg, mp


def test_mono_init_global_ba_past_the_flat_limit(monkeypatch):
    """ROADMAP.md C.9: this raised NotImplementedError before the grouped solve."""
    calls = _spy(monkeypatch)
    cfg, mp = _two_view_map(2100)
    mapper = TLM.LocalMapper(cfg, mp, monocular=True, device="cpu")
    prob, _, _ = TLM.build_global_ba_problem(mp, "cpu")
    n_edges = int(prob.edge_cam.shape[0])
    assert n_edges == 4200 >= TLM.FLAT_GBA_MAX_EDGES
    chi2_before = TF.edge_chi2(prob.cam_Tcw, prob.points, prob, tuple(cfg.camera[i] for i in (
        0, 1, 2, 3)) + (0.0,), torch.from_numpy(mapper.inv_sigma2))[0]
    mapper.global_ba(n_iters=20)                 # what the mono initialization calls
    assert calls == [n_edges]
    after, _, _ = TLM.build_global_ba_problem(mp, "cpu")
    chi2_after = TF.edge_chi2(after.cam_Tcw, after.points, after, tuple(cfg.camera[i] for i in (
        0, 1, 2, 3)) + (0.0,), torch.from_numpy(mapper.inv_sigma2))[0]
    assert float(chi2_after.median()) < 0.5 * float(chi2_before.median())
    np.testing.assert_array_equal(mp.kf_Tcw[mp.origin_kf], np.eye(4, dtype=np.float32))
