"""Hygiene of the PyTorch port: it never imports jax, its kernel wrappers
count launches only for CUDA tensors and reject what their kernels do not
take, and two behaviours of the JAX package that the port reproduces on
purpose (ROADMAP faults C.5 and C.6) are pinned here under their names.
The kernel-against-plain checks need a CUDA card and skip without one
(`python3 chip_smoke.py` runs them on the card at full size). The module
imports jax only inside the tests that compare with it, so the card's
tests run where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port.py
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_detailed_comments_tpu_torch.interop import desc_to_numpy, state_from_jax
from orb_slam2_detailed_comments_tpu_torch.models.slam_step import match_to_kp
from orb_slam2_detailed_comments_tpu_torch.ops.fast_pyramid import (
    fast_pyramid, fast_pyramid_plain, fast_score_nms, fast_score_nms_plain, fast_score_nms_raw,
    fast_score_nms_raw_plain)
from orb_slam2_detailed_comments_tpu_torch.ops.matching import MatchResult
from orb_slam2_detailed_comments_tpu_torch.ops.patch_gather import patch_gather, patch_gather_plain
from orb_slam2_detailed_comments_tpu_torch.ops.pyramid import build_pyramid
from orb_slam2_detailed_comments_tpu_torch.ops.stereo import median_sad_cut

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "orb_slam2_detailed_comments_tpu_torch"


def test_port_imports_no_jax():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    assert "orb_slam2_detailed_comments_tpu_torch.models.slam_step" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')"
            " or m.startswith('orb_slam2_detailed_comments_tpu.')"
            " or m == 'orb_slam2_detailed_comments_tpu']\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _levels(B=2, seed=0):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 255, (B, 60, 80)).astype(np.float32))
    return [lv.contiguous() for lv in build_pyramid(img, 3, 1.2)]


def test_cpu_tensors_never_count_launches():
    before = (fast_pyramid.launches, patch_gather.launches)
    levels = _levels()
    got = fast_pyramid(levels, 7.0)
    ref = fast_pyramid_plain(levels, 7.0)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert torch.equal(a, b)
    src = torch.rand(2, 50, 60)
    xy = torch.randint(-5, 70, (9, 2), dtype=torch.int32)
    assert torch.equal(patch_gather(src, xy, 11, 21), patch_gather_plain(src, xy, 11, 21))
    assert (fast_pyramid.launches, patch_gather.launches) == before


@pytest.mark.parametrize("case", [
    "fp_float64", "fp_noncontig", "fp_rank", "fp_batch_mismatch",
    "pg_float64", "pg_int64_xy", "pg_noncontig", "pg_window_too_big", "pg_xy_shape"])
def test_wrappers_reject_bad_inputs(case):
    lv = _levels()
    src, xy = torch.rand(2, 50, 60), torch.zeros((4, 2), dtype=torch.int32)
    calls = {
        "fp_float64": lambda: fast_pyramid([x.double() for x in lv], 7.0),
        "fp_noncontig": lambda: fast_pyramid([x.transpose(1, 2) for x in lv], 7.0),
        "fp_rank": lambda: fast_pyramid([x[0] for x in lv], 7.0),
        "fp_batch_mismatch": lambda: fast_pyramid([lv[0], lv[1][:1]], 7.0),
        "pg_float64": lambda: patch_gather(src.double(), xy, 11),
        "pg_int64_xy": lambda: patch_gather(src, xy.long(), 11),
        "pg_noncontig": lambda: patch_gather(src.transpose(1, 2), xy, 11),
        "pg_window_too_big": lambda: patch_gather(src, xy, 51),
        "pg_xy_shape": lambda: patch_gather(src, xy[:, :1].contiguous(), 11),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()


def test_c5_match_to_kp_is_jax_cpu_last_write_wins():
    """ROADMAP fault C.5, the JAX package's current behaviour: in
    slam_step's match_to_kp, `.at[idx].set(where(ok, p, -1))` with duplicate
    keypoint indices keeps the LAST point's write under XLA on the CPU, so a
    matched keypoint loses its match when a later unmatched point shares its
    argmin. The port reproduces that deterministically."""
    import jax.numpy as jnp
    np.testing.assert_array_equal(
        np.asarray(jnp.full((4,), -1, jnp.int32).at[jnp.asarray([0, 0, 2, 2])].set(
            jnp.asarray([5, -1, -1, 7], jnp.int32))), [-1, -1, 7, -1])
    rng = np.random.default_rng(0)
    P, N = 500, 60
    idx = rng.integers(0, N, P).astype(np.int32)
    ok = rng.random(P) < 0.3
    ref = np.asarray(jnp.full((N,), -1, jnp.int32).at[jnp.asarray(idx)].set(
        jnp.where(jnp.asarray(ok), jnp.arange(P, dtype=jnp.int32), -1), mode="drop"))
    m = MatchResult(idx=torch.from_numpy(idx), dist=torch.zeros(P, dtype=torch.int32),
                    ok=torch.from_numpy(ok))
    np.testing.assert_array_equal(match_to_kp(m, N).numpy(), ref)
    assert (ref == -1).sum() > (np.bincount(idx[ok], minlength=N) == 0).sum()  # matches lost


def _jax_median_cut(best_sad, ok):
    # ops/stereo.py:137-140 of the JAX package
    import jax.numpy as jnp
    sad_valid = jnp.where(ok, best_sad, jnp.inf)
    med = jnp.median(jnp.where(jnp.isfinite(sad_valid), sad_valid, jnp.nan))
    med = jnp.nan_to_num(med, nan=jnp.inf)
    return np.asarray(ok & (best_sad <= 2.1 * med))


def test_c6_median_sad_cut_is_jax_nan_median():
    """ROADMAP fault C.6, the JAX package's current behaviour: jnp.median
    propagates NaN, and unmatched slots are NaN, so with any slot unmatched
    the median-SAD cut is `<= inf` and removes no outlier; with every slot
    matched it cuts at 2.1 x the median (the mean of the middle two)."""
    import jax.numpy as jnp
    sad = np.asarray([10.0, 12.0, 11.0, 400.0, 13.0, 9.0], np.float32)
    for ok in (np.ones(6, bool), np.asarray([1, 1, 1, 1, 1, 0], bool)):
        got = median_sad_cut(torch.from_numpy(sad), torch.from_numpy(ok)).numpy()
        np.testing.assert_array_equal(got, _jax_median_cut(jnp.asarray(sad), jnp.asarray(ok)))
    assert not median_sad_cut(torch.from_numpy(sad), torch.ones(6, dtype=torch.bool))[3]
    assert median_sad_cut(torch.from_numpy(sad), torch.from_numpy(ok))[3]   # C.6: kept


def test_state_from_jax_carries_bits_and_configs():
    from orb_slam2_detailed_comments_tpu.geometry.camera import PinholeCamera
    from orb_slam2_detailed_comments_tpu.utils.config import OrbConfig
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32)
    packed = rng.normal(size=(16, 8)).astype(np.float32)
    orb = OrbConfig(n_features=123, n_levels=5)
    cam = PinholeCamera(fx=1.0, fy=2.0, cx=3.0, cy=4.0, k1=0.1, bf=5.0, width=7, height=8)
    st = state_from_jax(np.eye(4), packed, desc, np.arange(16) % 2 == 0, orb, cam, device="cpu")
    assert st.mp_desc.dtype == torch.int32
    np.testing.assert_array_equal(desc_to_numpy(st.mp_desc), desc)
    np.testing.assert_array_equal(st.packed.numpy(), packed)
    assert st.orb.n_features == 123 and st.orb.n_levels == 5
    assert tuple(st.cam) == tuple(cam) and st.Tcw.dtype == torch.float32
    with pytest.raises(ValueError):
        state_from_jax(np.eye(4), packed[:, :7], desc, np.ones(16, bool), orb, cam, device="cpu")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fast_pyramid_kernel_matches_plain_on_card():
    dev = _need_cuda()
    levels = [lv.to(dev) for lv in _levels(B=2, seed=3)]
    before = fast_pyramid.launches
    got = fast_pyramid(levels, 7.0)
    ref = fast_pyramid_plain(levels, 7.0)
    torch.cuda.synchronize()
    assert fast_pyramid.launches == before + 1
    for g, r in zip(got[0] + got[1] + got[2], ref[0] + ref[1] + ref[2]):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_patch_gather_kernel_matches_plain_on_card():
    dev = _need_cuda()
    src = torch.rand(2, 3, 50, 60, device=dev)
    xy = torch.randint(-70, 70, (2, 33, 2), dtype=torch.int32, device=dev)
    before = patch_gather.launches
    for ph, pw in ((39, 39), (11, 11), (11, 21)):
        assert torch.equal(patch_gather(src, xy, ph, pw), patch_gather_plain(src, xy, ph, pw))
        assert torch.equal(patch_gather(src[0], xy[0], ph, pw),
                           patch_gather_plain(src[0], xy[0], ph, pw))
    assert patch_gather.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 80), (97, 131)])
def test_k4_k5_kernels_match_plain_on_card(shape):
    dev = _need_cuda()
    img = torch.from_numpy(np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)).to(dev)
    before = (fast_score_nms_raw.launches, fast_score_nms.launches)
    for g, r in zip(fast_score_nms_raw(img, 7.0), fast_score_nms_raw_plain(img, 7.0)):
        assert torch.equal(g, r)
    assert torch.equal(fast_score_nms(img, 7.0), fast_score_nms_plain(img, 7.0))
    assert (fast_score_nms_raw.launches, fast_score_nms.launches) == (before[0] + 1, before[1] + 1)
