"""Clamped window gather: the counterpart of ops/pallas_patch.py.

`patch_gather` copies B (ph, pw) windows over the C channels of a
(C, H, W) float32 stack at int32 top-left (x, y), with lax.dynamic_slice
semantics: a negative start counts from the end (x + W), then the starts
are clamped to [0, W-pw] x [0, H-ph]. A leading
batch (N, C, H, W) with (N, B, 2) coordinates gathers from each stack
separately. It serves the 11x11 / 11x21 SAD template and strip of the
stereo matcher; at its other TPU call site, the (2, 39, 39) ORB windows,
it is fused with its consumer into ops/orb_desc.py.

For a CUDA tensor it launches csrc/patch_gather.cu; for a CPU tensor it
runs `patch_gather_plain`, the advanced-indexing version it is checked
against. `patch_gather.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _kernels


def patch_gather_plain(src, xy, ph: int, pw: int):
    """Plain PyTorch version: padded[c, y0 + iy, x0 + ix] with the starts
    wrapped and clamped as lax.dynamic_slice does."""
    squeeze = src.dim() == 3
    if squeeze:
        src, xy = src[None], xy[None]
    N, C, H, W = src.shape
    x, y = xy[..., 0].long(), xy[..., 1].long()                   # (N, B)
    x0 = torch.where(x < 0, x + W, x).clamp(0, W - pw)
    y0 = torch.where(y < 0, y + H, y).clamp(0, H - ph)
    rows = y0[..., :, None] + torch.arange(ph, device=src.device)  # (N, B, ph)
    cols = x0[..., :, None] + torch.arange(pw, device=src.device)  # (N, B, pw)
    n = torch.arange(N, device=src.device)[:, None, None, None, None]
    c = torch.arange(C, device=src.device)[None, None, :, None, None]
    out = src[n, c, rows[:, :, None, :, None], cols[:, :, None, None, :]]
    return out[0] if squeeze else out


def _check_inputs(src, xy, ph, pw):
    if src.dtype != torch.float32 or xy.dtype != torch.int32:
        raise TypeError(f"patch_gather takes float32 src and int32 xy, got "
                        f"{src.dtype} and {xy.dtype}")
    if src.dim() not in (3, 4) or xy.dim() != src.dim() - 1 or xy.shape[-1] != 2 \
            or (src.dim() == 4 and xy.shape[0] != src.shape[0]):
        raise ValueError(f"patch_gather shapes: src {tuple(src.shape)}, xy {tuple(xy.shape)}")
    if not (src.is_contiguous() and xy.is_contiguous()):
        raise ValueError("patch_gather takes contiguous src and xy")
    if src.device != xy.device:
        raise ValueError("src and xy lie on different devices")
    H, W = src.shape[-2:]
    if not (0 < ph <= H and 0 < pw <= W):
        raise ValueError(f"window ({ph}, {pw}) does not fit a ({H}, {W}) image")


def patch_gather(src, xy, ph: int, pw: int | None = None):
    """(C, H, W) + (B, 2) -> (B, C, ph, pw); (N, C, H, W) + (N, B, 2) ->
    (N, B, C, ph, pw). Square windows when pw is None."""
    pw = ph if pw is None else pw
    _check_inputs(src, xy, ph, pw)
    if src.device.type == "cpu":
        return patch_gather_plain(src, xy, ph, pw)
    if src.device.type != "cuda":
        raise ValueError(f"patch_gather runs on cpu or cuda, not {src.device}")
    N = src.shape[0] if src.dim() == 4 else 1
    C, H, W = src.shape[-3:]
    B = xy.shape[-2]
    out = torch.empty(xy.shape[:-1] + (C, ph, pw), dtype=torch.float32, device=src.device)
    lib = _kernels.library()
    rc = lib.patch_gather_launch(src.data_ptr(), xy.data_ptr(), out.data_ptr(), N, C, H, W,
                                 B, ph, pw, torch.cuda.current_stream(src.device).cuda_stream)
    _kernels.check(rc, "patch_gather")
    patch_gather.launches += 1
    return out


patch_gather.launches = 0
