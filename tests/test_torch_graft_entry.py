"""The port's entry points (orb_slam2_detailed_comments_tpu_torch/
graft_entry.py, models/slam_step.example_tracking_args) on the CPU, against
the JAX package's __graft_entry__.py and models/slam_step.py.

  * example_tracking_args draws the JAX package's arrays from the same
    seed: the image, the map points' positions and descriptors exactly,
    the normals and distance band to float32 rounding;
  * entry()'s fused mono frame gives the JAX package's entry() result,
    run here on the same draws (torch_parity.jax_entry_anchor, in the
    JAX package's exact modes; about 40 s of it the jit compile): the
    valid keypoints, matched map points, both stages' inliers and the
    visible map points exactly, the pose within chip_smoke.py's
    POSE_TOL_M and POSE_TOL_DEG. chip_smoke.JAX_CPU_ENTRY, the card's
    anchor (chip_smoke.py imports no jax), must be this result too;
  * dryrun_multichip(2, device="cpu", backend="gloo") passes (each sharded
    solve within 1e-2 of the single-device one on two spawned ranks);
  * nothing falls back: more ranks than cards without backend="gloo",
    cpu_devices_per_process above 1, and NCCL where it is not built all
    raise; NCCL asked for a CUDA rank also brings Gloo for the stop poll.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from orb_slam2_detailed_comments_tpu.models import slam_step as JS

from orb_slam2_detailed_comments_tpu_torch import graft_entry as GE
from orb_slam2_detailed_comments_tpu_torch.interop import desc_to_numpy
from orb_slam2_detailed_comments_tpu_torch.models import slam_step as TS
from orb_slam2_detailed_comments_tpu_torch.parallel import multihost

import chip_smoke
import torch_parity


@pytest.fixture(scope="module")
def jax_entry():
    return torch_parity.jax_entry_anchor()


def test_example_tracking_args_draw_the_jax_arrays():
    j = JS.example_tracking_args()
    t = TS.example_tracking_args(device="cpu")
    img, Tcw, pos, normal, mind, maxd, desc, valid = (np.asarray(a) for a in j[:8])
    np.testing.assert_array_equal(t[0].numpy(), img)
    np.testing.assert_array_equal(t[1].numpy(), Tcw)
    np.testing.assert_array_equal(t[2].numpy(), pos)
    np.testing.assert_array_equal(desc_to_numpy(t[6]), desc)
    np.testing.assert_array_equal(t[7].numpy(), valid)
    for got, ref in ((t[3], normal), (t[4], mind), (t[5], maxd)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    for f in dataclasses.fields(j[8]):
        assert getattr(t[8], f.name) == getattr(j[8], f.name), f.name
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(t[9], f) == getattr(j[9], f), f


def _pose_off(T, T_ref):
    T, T_ref = (np.asarray(a, np.float64) for a in (T, T_ref))
    cos = (np.trace(T[:3, :3].T @ T_ref[:3, :3]) - 1) / 2
    return (np.linalg.norm(T[:3, 3] - T_ref[:3, 3]),
            math.degrees(math.acos(min(1.0, max(-1.0, cos)))))


def test_entry_matches_the_jax_entry(jax_entry):
    fn, args = GE.entry(device="cpu")
    blob, desc = fn(*args)
    b, ts, vis = (x.numpy() for x in TS.unpack_host_blob(blob, desc.shape[0]))
    ref = jax_entry
    got = dict(keypoints=int(b[:, 7].sum()), matched=int(((b[:, 8] >= 0) & (b[:, 9] > 0)).sum()),
               n_in=int(ts[16]), n_in1=int(ts[20]), visible=int(vis.sum()))
    assert got == {k: ref[k] for k in got}
    d_t, d_r = _pose_off(ts[:16].reshape(4, 4), ref["Tcw"])
    assert d_t < chip_smoke.POSE_TOL_M and d_r < chip_smoke.POSE_TOL_DEG


def test_card_anchor_is_the_jax_entry(jax_entry):
    anchor = chip_smoke.JAX_CPU_ENTRY
    assert {k: v for k, v in anchor.items() if k != "Tcw"} == \
        {k: v for k, v in jax_entry.items() if k != "Tcw"}
    d_t, d_r = _pose_off(anchor["Tcw"], jax_entry["Tcw"])
    assert d_t < 1e-6 and d_r < 1e-4


def test_dryrun_multichip_on_two_gloo_ranks():
    deltas = GE.dryrun_multichip(2, device="cpu", backend="gloo", timeout=120.0)
    assert set(deltas) == {"grouped-gemm", "grouped-dense", "flat-pcg"}
    assert all(max(d) < GE.DRYRUN_TOL for d in deltas.values())


@pytest.mark.parametrize("case", ["ranks_over_cards", "cpu_devices_per_process", "nccl"])
def test_no_silent_fallback(case, tmp_path):
    if case == "ranks_over_cards":
        with pytest.raises(ValueError, match="gloo"):
            GE.dryrun_multichip(torch.cuda.device_count() + 1, device="cuda")
    elif case == "cpu_devices_per_process":
        with pytest.raises(ValueError, match="one device"):
            multihost.initialize(f"file://{tmp_path}/store", 1, 0, device="cpu",
                                 cpu_devices_per_process=2)
    else:
        if dist.is_nccl_available():
            pytest.skip("NCCL is built here: nothing to refuse")
        with pytest.raises(RuntimeError, match="NCCL"):
            multihost.initialize(f"file://{tmp_path}/store", 1, 0, backend="nccl", device="cpu")
    assert not dist.is_initialized()


def test_nccl_on_a_card_polls_over_gloo(monkeypatch):
    """A CUDA rank asked for "nccl" (or nothing) joins a group that also has
    Gloo, so Mesh.any's stop poll stays on the host."""
    seen = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **k: seen.append(backend))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    for backend in (None, "nccl"):
        multihost.initialize("localhost:1", 1, 0, backend=backend, device="cuda:0")
    multihost.initialize("localhost:1", 1, 0, backend="gloo", device="cuda:0")
    assert seen == ["cpu:gloo,cuda:nccl", "cpu:gloo,cuda:nccl", "gloo"]
