"""The port's sharded global BA (orb_slam2_detailed_comments_tpu_torch/
parallel/) on the CPU, over Gloo, against its single-device solves and the
JAX package's sharded solvers on tests/conftest.py's 8-device CPU mesh.

  * sharding: the partition is the JAX package's, disjoint and complete;
    the shards cover every valid edge once (global edge ids) at one common
    shape; more shards than observed points get placeholder edges; shapes
    pinned at a problem's own dims build its own layout bit for bit;
  * a world of one rank (in this process, a FileStore under tmp_path):
    the grouped solve is solve_grouped bit for bit, fused and through the
    handle, whose phases run in chunks equal the fused solve; a stop
    check that fires returns None;
  * 2 and 4 spawned ranks (tests/torch_parallel_ranks.py, each group
    failed after RANKS_TIMEOUT_S): every rank holds the same result; the
    grouped solves ("gemm", "dense") of test_global_ba_grouped.py's
    problem (C=24, P=600, 4 LM x 25 CG, as tests/test_distributed_ba_grouped.py)
    within GROUPED_CAM_TOL / GROUPED_PT_TOL of the port's single-device
    solve and of JAX's distributed_global_ba_grouped; the flat edge-sharded
    solve of test_local_ba.py's problem (seed 7, noise-free, 10 x 50) within
    FLAT_CAM_TOL / FLAT_PT_TOL of the port's single-device flat solve and
    of JAX's distributed_global_ba; a stop on the last rank alone stops
    every rank at the same poll;
  * the scaling driver (examples/bench_scaling.py): one spawn of 2 ranks,
    a group a row, and a one-rank row on permuted points, each within the
    grouped tolerances of the first row; permute_points relabels the
    observations with their points;
  * routing: solve_global_ba takes the sharded solve exactly at a world
    above one rank and E >= 4096;
  * parallel/ imports no jax.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from orb_slam2_detailed_comments_tpu.parallel import distributed_ba as JDF
from orb_slam2_detailed_comments_tpu.parallel import distributed_ba_grouped as JDG

from orb_slam2_detailed_comments_tpu_torch.backend import local_mapping as TLM
from orb_slam2_detailed_comments_tpu_torch.examples import bench_scaling as BS
from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_detailed_comments_tpu_torch.interop import ba_problem_from_jax
from orb_slam2_detailed_comments_tpu_torch.optim import global_ba as TF, global_ba_grouped as TG
from orb_slam2_detailed_comments_tpu_torch.parallel import distributed_ba_grouped as TDG
from orb_slam2_detailed_comments_tpu_torch.parallel import multihost

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_global_ba_grouped as JGG  # noqa: E402
import test_local_ba as JLB  # noqa: E402
import torch_parallel_ranks  # noqa: E402

# tests/test_distributed_ba_grouped.py:60-71 (sharded against single-device
# grouped: LM near its accept boundary can part two reduction orders) and
# tests/test_distributed_ba.py:27-28 (flat sharded against single device)
GROUPED_CAM_TOL, GROUPED_PT_TOL = 2e-3, 2e-2
FLAT_CAM_TOL, FLAT_PT_TOL = 1e-4, 1e-3
GROUPED_ITERS, FLAT_ITERS = (4, 25), (10, 50)
RANKS_TIMEOUT_S = 120.0
REPO = Path(__file__).resolve().parents[1]


def _cam(c):
    return dict(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf)


GCAM, FCAM = _cam(JGG.CAM), _cam(JLB.CAM)
INV_S2 = np.array(JGG.INV_S2)


def _arrays(prob):
    return {f: np.array(getattr(prob, f)) for f in prob._fields}


@pytest.fixture(scope="module")
def problems():
    """(JAX grouped problem, JAX flat problem), each also as the port's."""
    jg = JGG.build_problem(C=24, P=600)
    jf = JLB.build_synthetic_ba(seed=7, noise_px=0.0)[0]
    return jg, jf, ba_problem_from_jax(jg, "cpu"), ba_problem_from_jax(jf, "cpu")


@pytest.fixture(scope="module")
def single_device(problems):
    """The port's single-device solves: grouped "gemm" (solve_grouped),
    grouped "dense" (its dense step on the unsharded layout), flat."""
    _, _, tg, tf = problems
    inv_s2 = torch.from_numpy(INV_S2)
    gp = TG.group_global_problem(tg)
    gemm = TG.solve_grouped(gp, PinholeCamera(**GCAM), inv_s2, *GROUPED_ITERS, 1e-5)
    dense = TF.solve_lm(gp.prob, PinholeCamera(**GCAM), inv_s2, *GROUPED_ITERS, 1e-5,
                        TG.layout_reducer(gp), step=TG.dense_step(gp))
    flat = TF.global_bundle_adjustment(tf, PinholeCamera(**FCAM), inv_s2, *FLAT_ITERS)
    return {k: (v[0].numpy(), v[1].numpy()) for k, v in
            dict(gemm=gemm, dense=dense, flat=flat).items()}


@pytest.fixture(scope="module")
def jax_sharded(problems):
    """JAX's sharded solvers on the 8-device CPU mesh."""
    jg, jf, _, _ = problems
    assert len(jax.devices()) == 8
    out = {b: JDG.distributed_global_ba_grouped(jg, JGG.CAM, JGG.INV_S2, JDG.make_grouped_mesh(),
                                                *GROUPED_ITERS, backend=b)
           for b in ("gemm", "dense")}
    out["flat"] = JDF.distributed_global_ba(jf, JLB.CAM, JLB.INV_SIGMA2, JDF.make_ba_mesh(),
                                            *FLAT_ITERS)
    return {k: (np.asarray(c), np.asarray(p)) for k, (c, p) in out.items()}


@pytest.fixture
def world_of_one(tmp_path):
    multihost.initialize(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        yield TDG.make_grouped_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _close(got, ref, tols):
    np.testing.assert_allclose(got[0], ref[0], atol=tols[0])
    np.testing.assert_allclose(got[1], ref[1], atol=tols[1])


# ---- sharding ------------------------------------------------------------------

def test_partition_is_the_jax_one_disjoint_and_complete(problems):
    jg = problems[0]
    e_pt, e_val = np.asarray(jg.edge_point), np.asarray(jg.edge_valid)
    parts = TDG.partition_points(e_pt, e_val, 600, 8)
    for a, b in zip(parts, JDG.partition_points(e_pt, e_val, 600, 8)):
        np.testing.assert_array_equal(a, b)
    allp = np.concatenate(parts)
    assert sorted(allp.tolist()) == list(range(600))
    np.testing.assert_array_equal(TDG.partition_points(e_pt, e_val, 600, 1)[0], np.arange(600))


@pytest.mark.parametrize("C,P", [(24, 600), (4, 5)])
def test_shards_cover_every_valid_edge_once_at_one_shape(C, P):
    """8 shards; at P=5, more shards than observed points (placeholders)."""
    prob = ba_problem_from_jax(JGG.build_problem(C=C, P=P, n_invalid=0 if P < 8 else 25), "cpu")
    shards, pmap = TDG.shard_grouped_problem(prob, 8, kp_cap=8, kc_cap=64)
    covered = np.concatenate([g.slot_edge.numpy()[g.slot_edge.numpy() >= 0] for g in shards])
    assert sorted(covered.tolist()) == np.nonzero(prob.edge_valid.numpy())[0].tolist()
    for g in shards:
        assert g.shape == shards[0].shape
        for f in ("c_sel", "cs_sel", "s_point", "slot_edge"):
            assert getattr(g, f).shape == getattr(shards[0], f).shape, f
        live = g.slot_edge.numpy() >= 0     # each slot holds its global edge's data
        np.testing.assert_array_equal(g.prob.edge_cam.numpy()[live],
                                      prob.edge_cam.numpy()[g.slot_edge.numpy()[live]])
    ids = pmap[pmap >= 0]
    assert sorted(ids.tolist()) == list(range(P))
    if P < 8:
        assert sum(not g.prob.edge_valid.any() for g in shards) == 8 - P


def test_layout_pinned_at_its_own_dims_is_the_natural_layout(problems):
    tg = problems[2]
    nat = TG.group_global_problem(tg, kp_cap=8, kc_cap=16)
    pinned = TG.group_global_problem(tg, kp_cap=8, kc_cap=16,
                                     dims=TG.layout_dims(tg, kp_cap=8, kc_cap=16))
    assert nat.shape == pinned.shape and nat.shape[3] > 0 and nat.cs_cam.numel() > 0
    for f in TG.GroupedGBA._fields:
        a, b = getattr(nat, f), getattr(pinned, f)
        for x, y in (zip(a, b) if f == "prob" else [(a, b)]):
            assert (x == y) if f == "shape" else torch.equal(x, y), f


# ---- a world of one rank --------------------------------------------------------

def test_world_of_one_is_solve_grouped_bit_for_bit(problems, single_device, world_of_one):
    mesh, tg = world_of_one, problems[2]
    cam, inv_s2 = PinholeCamera(**GCAM), torch.from_numpy(INV_S2)
    ref = single_device["gemm"]
    fused = TDG.distributed_global_ba_grouped(tg, cam, inv_s2, mesh, *GROUPED_ITERS,
                                              backend="gemm")
    h = TDG.DistributedGroupedGBA(tg, cam, inv_s2, mesh, GROUPED_ITERS[1], backend="gemm")
    polled = h.solve(GROUPED_ITERS[0], stop_check=lambda: False)
    for out in (fused, polled):
        np.testing.assert_array_equal(out[0].numpy(), ref[0])
        np.testing.assert_array_equal(out[1].numpy(), ref[1])
    # the handle's phases, in chunks of 1 and 1 (robust) then 2 (plain)
    h = TDG.DistributedGroupedGBA(tg, cam, inv_s2, mesh, GROUPED_ITERS[1], backend="gemm")
    lam0 = torch.full((), 1e-5)
    for chunks, use_kernel in (((1, 1), True), ((2,), False)):
        act = h.all_valid_activation() if use_kernel else h.activation()
        lam, c = lam0, h.cost(use_kernel, act)
        for n in chunks:
            lam, c = h.run_phase(n, use_kernel, act, lam, c)
    chunked = h.result()
    np.testing.assert_array_equal(chunked[0].numpy(), ref[0])
    np.testing.assert_array_equal(chunked[1].numpy(), ref[1])
    calls = []
    assert h.solve(GROUPED_ITERS[0], stop_check=lambda: calls.append(1) or len(calls) > 1) is None
    assert len(calls) == 2


# ---- spawned ranks --------------------------------------------------------------

@pytest.mark.parametrize("n_ranks", [2, 4])
def test_spawned_ranks_agree_with_one_device_and_jax(problems, single_device, jax_sharded,
                                                     n_ranks):
    jg, jf, _, _ = problems
    res = multihost.run_ranks(
        torch_parallel_ranks.sharded_solves, n_ranks,
        args=(_arrays(jg), _arrays(jf), (GCAM, FCAM), INV_S2, GROUPED_ITERS, FLAT_ITERS),
        device="cpu", timeout=RANKS_TIMEOUT_S)
    for r in res[1:]:               # replicated: every rank holds the same result
        for k in ("gemm", "dense", "flat"):
            np.testing.assert_array_equal(r[k][0], res[0][k][0])
            np.testing.assert_array_equal(r[k][1], res[0][k][1])
    tols = dict(gemm=(GROUPED_CAM_TOL, GROUPED_PT_TOL), dense=(GROUPED_CAM_TOL, GROUPED_PT_TOL),
                flat=(FLAT_CAM_TOL, FLAT_PT_TOL))
    for k, tol in tols.items():
        _close(res[0][k], single_device[k], tol)
        _close(res[0][k], jax_sharded[k], tol)
    # the last rank's check fired at its second poll: every rank stopped there
    assert all(r["stopped"] and r["polls"] == 2 for r in res)


def test_scaling_driver_rows_on_one_spawn():
    d = BS.problem_arrays(32, 600, 128)
    p, perm = BS.permute_points(d, 1)
    assert sorted(perm.tolist()) == list(range(600))
    np.testing.assert_array_equal(p["points"][p["edge_point"]], d["points"][d["edge_point"]])
    np.testing.assert_array_equal(p["edge_obs"], d["edge_obs"])
    rows, sols = BS.scaling_rows((1, 2), cams=32, points=600, obs_per_cam=128, iters=10, cg=50,
                                 reps=1, device="cpu", backend="gloo",
                                 timeout=RANKS_TIMEOUT_S, permuted=1)
    assert [(r["ranks"], r["point_order"], r["order_seed"]) for r in rows] == \
        [(1, "given", None), (2, "given", None), (1, "permuted", 1)]
    assert len(sols) == 3 and sols[0][1].shape == (600, 3)
    for r in rows:
        assert r["solver"] == "dense" and not r["shared_card"] and r["device"] == "cpu"
        assert r["cam_delta"] <= GROUPED_CAM_TOL and r["point_delta"] <= GROUPED_PT_TOL
        assert abs(r["cost_vs_first"]) < 1e-3 and r["ms_per_gn_iter"] > 0


# ---- routing --------------------------------------------------------------------

@pytest.mark.parametrize("world,edges,path", [
    (2, 4096, "sharded"), (2, 4095, "flat"), (1, 4096, "grouped"), (None, 4096, "grouped"),
    (4, 100000, "sharded")])
def test_solve_global_ba_shards_at_world_above_one_and_4096_edges(monkeypatch, world, edges,
                                                                 path):
    prob = TLM._problem("cpu", np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
                        np.ones(3, bool), np.ones(3, bool), np.zeros((5, 3), np.float32),
                        np.ones(5, bool), np.zeros(edges, np.int32), np.zeros(edges, np.int32),
                        np.zeros((edges, 3), np.float32), np.zeros(edges, np.int32),
                        np.ones(edges, bool))
    taken = []

    def spy(name):
        def f(*a, **k):
            taken.append((name, k.get("stop_check")))
            return torch.zeros(3, 4, 4), torch.zeros(5, 3)
        return f

    monkeypatch.setattr(dist, "is_initialized", lambda: world is not None)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(TDG, "distributed_global_ba_grouped", spy("sharded"))
    monkeypatch.setattr(TLM, "solve_grouped", spy("grouped"))
    monkeypatch.setattr(TLM, "group_global_problem", lambda p: None)
    monkeypatch.setattr(TLM, "global_bundle_adjustment", spy("flat"))
    check = object()
    TLM.solve_global_ba(prob, PinholeCamera(**GCAM), INV_S2, stop_check=check)
    assert [t[0] for t in taken] == [path]
    if path == "sharded":
        assert taken[0][1] is check


def test_parallel_imports_no_jax():
    mods = [f"orb_slam2_detailed_comments_tpu_torch.parallel.{m}"
            for m in ("multihost", "distributed_ba", "distributed_ba_grouped")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')"
            " or m.split('.')[0] == 'orb_slam2_detailed_comments_tpu']\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
