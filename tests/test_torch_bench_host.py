"""The port's host-budget tool (examples/bench_host.py): record/replay of
the device boundaries, on the CPU at a small size (FRAMES stereo frames at
320x240, 500 features; the tool's defaults are 20 at 640x480, 1000).

  * the replay pass calls every boundary as many times as the record pass
    (the tool asserts it), the fused frame, the local BA and the local
    map's upload among them;
  * the replayed System's keyframes, map points and exported trajectory
    are bit-identical to the recorded run's;
  * a Memo returns what was returned in the record pass even when the
    caller changed it in place afterwards, keeps calls made inside a
    boundary out of its log, and a replay past the log raises.
"""
import numpy as np
import pytest
import torch

from orb_slam2_detailed_comments_tpu_torch.examples import bench_host as BH

FRAMES = 6


def test_replay_follows_the_record():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        out = BH.run(FRAMES, 320, 240, 500, device="cpu", warmup=False)
    finally:
        torch.set_num_threads(threads)
    ex = out["extra"]
    assert out["unit"] == "ms/frame" and out["value"] > 0
    assert ex["replay_identical"] == {"keyframes": True, "points": True, "trajectory": True}
    calls = ex["boundary_calls"]
    assert set(calls) == {attr for _, attr in BH.BOUNDARIES}
    assert calls["extract_stereo"] == FRAMES
    for name in ("track_extracted", "local_bundle_adjustment", "DeviceLocalMap._upload",
                 "search_by_projection"):
        assert calls[name] > 0, name
    assert 0 < ex["host_share_of_recorded"] < 1
    assert ex["replay_cuda_kernels"] == ex["replay_d2h_copies"] == 0   # no card here


def test_memo_snapshots_nesting_and_overrun():
    rec = BH.Recorder()
    inner = BH.Memo(lambda x: x + 1, rec, "inner")
    outer = BH.Memo(lambda x: (inner(x) * 2, np.arange(3)), rec, "outer")
    rec.mode = "record"
    t, a = outer(torch.ones(2))
    t += 100                                   # the caller changes its result in place
    a[:] = -1
    assert len(outer.log) == 1 and len(inner.log) == 0
    rec.mode = "replay"
    t2, a2 = outer(torch.zeros(2))
    assert torch.equal(t2, torch.full((2,), 4.0)) and np.array_equal(a2, np.arange(3))
    with pytest.raises(AssertionError, match="replay diverged"):
        outer(torch.zeros(2))
