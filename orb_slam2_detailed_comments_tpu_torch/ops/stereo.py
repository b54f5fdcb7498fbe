"""Stereo left-right keypoint matching + RGB-D depth synthesis.

Counterpart of orb_slam2_detailed_comments_tpu/ops/stereo.py (the
replacement of Frame::ComputeStereoMatches, reference: src/Frame.cc:
880-1176, and ComputeStereoFromRGBD, :1179-1215): a masked (N_left x
N_right) Hamming match with row-band, octave-window and disparity masks,
an 11x11 SAD refinement over +-5 px, parabolic sub-pixel interpolation and
the median-SAD outlier cut. The SAD refinement is one call of
ops/stereo_sad.py::stereo_sad (a CUDA kernel on the card), which reads the
template and strip windows from the images in place: no padded image and
no window tensor is made.

The median-SAD cut is ported as the JAX package runs it: jnp.median
propagates NaN and every unmatched slot is NaN, so whenever any slot is
unmatched the cut is `<= inf` and removes nothing. torch.quantile(x, 0.5)
propagates NaN and averages the two middle values as jnp.median does
(torch.median would return the lower one).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .hamming import hamming_distance_matrix
from .matching import masked_best_match
from .orb import Keypoints
from .stereo_sad import stereo_sad

TH_STEREO = 100  # ORBmatcher::TH_HIGH used for the coarse match


def median_sad_cut(best_sad, ok):
    """The median-SAD outlier cut (reference: Frame.cc:1145-1175, threshold
    1.5 * 1.4 * median) as the JAX package computes it: the median over
    all slots with NaN for the unmatched ones, so a single unmatched slot
    makes the median NaN -> inf and the cut keeps everything (ROADMAP fault
    C.6, ported as it behaves)."""
    sad_valid = torch.where(ok, best_sad, float("inf"))
    med = torch.quantile(torch.where(torch.isfinite(sad_valid), sad_valid, float("nan")), 0.5)
    med = torch.nan_to_num(med, nan=float("inf"))
    return ok & (best_sad <= 2.1 * med)


def coarse_match(kp_l: Keypoints, kp_r: Keypoints, cam, orb):
    """The coarse L/R match (a MatchResult): each left keypoint's best right
    keypoint by Hamming distance within the row band, octave window and
    disparity range."""
    dev = kp_l.xy.device
    sf = orb.scale_factor
    scale_r = torch.tensor([sf ** i for i in range(orb.n_levels)], dtype=torch.float32,
                           device=dev)[kp_r.octave.long()]

    yl = kp_l.xy[:, 1]
    yr = kp_r.xy[:, 1]
    xl = kp_l.xy[:, 0]
    xr = kp_r.xy[:, 0]

    min_d = 0.0
    max_d = cam.bf / max(cam.baseline, 1e-6)  # = fx (reference: Frame.cc:912-915)

    row_ok = torch.abs(yl[:, None] - yr[None, :]) <= 2.0 * scale_r[None, :]
    lvl_ok = torch.abs(kp_l.octave[:, None] - kp_r.octave[None, :]) <= 1
    disp = xl[:, None] - xr[None, :]
    disp_ok = (disp >= min_d) & (disp <= max_d)
    mask = kp_l.valid[:, None] & kp_r.valid[None, :] & row_ok & lvl_ok & disp_ok

    dist = hamming_distance_matrix(kp_l.desc, kp_r.desc)
    return masked_best_match(dist, mask, TH_STEREO)


def stereo_match(kp_l: Keypoints, kp_r: Keypoints, img_l, img_r, cam,
                 orb) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match left keypoints to the right image; returns (u_right, depth),
    both (N,) float32 with -1 where unmatched."""
    m = coarse_match(kp_l, kp_r, cam, orb)
    xl = kp_l.xy[:, 0]
    min_d = 0.0
    max_d = cam.bf / max(cam.baseline, 1e-6)

    # ---- SAD sub-pixel refine on the full-resolution image ----
    u_r, best_sad = stereo_sad(img_l, img_r, xl.contiguous(), kp_l.xy[:, 1].contiguous(),
                               kp_r.xy[:, 0].contiguous(), m.idx)

    disparity = xl - u_r
    ok = m.ok & (disparity > min_d) & (disparity < max_d)

    ok = median_sad_cut(best_sad, ok)

    disparity = torch.where(disparity <= 0.01, 0.01, disparity)
    depth = cam.bf / disparity
    return torch.where(ok, u_r, -1.0), torch.where(ok, depth, -1.0)


def depth_to_stereo(kp: Keypoints, xy_und, depth_img, cam) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB-D: sample the depth map at the RAW keypoint positions and
    synthesize a virtual right coordinate from the UNDISTORTED u
    (reference: Frame::ComputeStereoFromRGBD, Frame.cc:1179-1215)."""
    H, W = depth_img.shape
    xi = torch.clamp(torch.round(kp.xy[:, 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(kp.xy[:, 1]).long(), 0, H - 1)
    d = depth_img[yi, xi]
    ok = kp.valid & (d > 0.0)
    ur = xy_und[:, 0] - cam.bf / torch.clamp(d, min=1e-6)
    return torch.where(ok, ur, -1.0), torch.where(ok, d, -1.0)
