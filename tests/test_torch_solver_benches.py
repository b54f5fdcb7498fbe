"""The port's solver benches (examples/bench_local_ba.py, bench_gba.py,
bench_pose_graph.py) on the CPU: their problems are the JAX tools' own
numpy draws, array for array, and each runs at a tiny size.

  * bench_local_ba.problem_arrays equals the JAX make_problem's arrays for
    the same seed (at the tool's C=64, P=16384, E=49152 and at a small
    size), and run() times every case;
  * bench_gba.run() gives a row per solver (grouped PCG, "dense", flat) at
    16 cameras;
  * bench_pose_graph.circle_arrays equals the JAX circle_problem's arrays,
    and run() cuts the mean translation error 100x with each backend.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from orb_slam2_detailed_comments_tpu_torch.examples import bench_gba as TG
from orb_slam2_detailed_comments_tpu_torch.examples import bench_local_ba as TL
from orb_slam2_detailed_comments_tpu_torch.examples import bench_pose_graph as TP

REPO = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size", [(64, 16384, 49152), (16, 512, 1536), (8, 300, 2000)])
def test_local_ba_problem_is_the_jax_draws(size):
    ours = TL.problem_arrays(*size, seed=0)
    theirs = _jax_tool("bench_local_ba").make_problem(*size, seed=0)
    assert set(ours) == set(theirs._fields)
    for k, v in ours.items():
        ref = np.asarray(getattr(theirs, k))
        assert v.dtype == ref.dtype and np.array_equal(v, ref), k


def test_local_ba_bench_runs():
    out = TL.run(16, 512, 1536, reps=1, device="cpu")
    assert len(out) == 9 and all(np.isfinite(v) and v > 0 for v in out.values())


def test_gba_bench_rows():
    rows = TG.run(16, 600, 64, iters=1, cg=5, device="cpu")
    assert [r["solver"] for r in rows] == ["grouped-gemm", "grouped-dense", "flat"]
    assert all(r["ms_per_gn_iter"] > 0 for r in rows)


def test_pose_graph_problem_is_the_jax_draws():
    ours, S_true, S_est = TP.circle_arrays(64)
    theirs, J_true, J_est = _jax_tool("bench_pose_graph").circle_problem(64)
    assert np.array_equal(S_true, J_true) and np.array_equal(S_est, J_est)
    for k, v in ours.items():
        ref = np.asarray(getattr(theirs, k))
        assert np.array_equal(np.asarray(v, ref.dtype), ref), k


@pytest.mark.parametrize("backend", ["dense", "banded", "cg"])
def test_pose_graph_bench_cuts_the_error(backend):
    ms, E, err0, err1 = TP.run(32, backend, n_iters=10, device="cpu")
    assert ms > 0 and E == 32 + 7 and err1 < err0 / 100
