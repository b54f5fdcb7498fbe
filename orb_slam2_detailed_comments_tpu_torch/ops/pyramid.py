"""Image pyramid + Gaussian blur.

Counterpart of orb_slam2_detailed_comments_tpu/ops/pyramid.py (which
replaces ORBextractor::ComputePyramid, reference: src/ORBextractor.cc:
2093-2168, and the 7x7 sigma=2 GaussianBlur at :2023).

The JAX package takes its resize weights from jax.image.resize(...,
"linear") applied to identity matrices. That call antialiases when it
downscales: its triangle kernel is widened by 1/scale. The weights are
rebuilt here in numpy float32 with the same operations in the same order
(jax/_src/image/scale.py::compute_weight_mat), so the composed matrices
agree; torch's interpolate uses other weights and cannot stand in.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _gauss_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def reflect101_index(n: int, r: int, device):
    """Source indices of a length-n axis padded by r on each side with
    BORDER_REFLECT_101 (numpy/jnp pad mode "reflect")."""
    i = torch.arange(-r, n + r, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def edge_pad(x, ph: int, pw: int):
    """Replicate-pad the last two axes of x by ph rows and pw columns per
    side (numpy/jnp pad mode "edge")."""
    H, W = x.shape[-2:]
    iy = torch.arange(-ph, H + ph, device=x.device).clamp(0, H - 1)
    ix = torch.arange(-pw, W + pw, device=x.device).clamp(0, W - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur of a (..., H, W) float32 image with
    BORDER_REFLECT_101 padding. The taps are summed in the JAX package's
    k0..k6 order, one rounded multiply and one rounded add per tap; the
    CUDA kernel in csrc/fast_pyramid.cu repeats exactly this order."""
    k = [float(v) for v in _gauss_kernel_1d(ksize, sigma)]
    r = ksize // 2
    H, W = img.shape[-2:]
    x = img.index_select(-2, reflect101_index(H, r, img.device))
    x = x.index_select(-1, reflect101_index(W, r, img.device))
    h = k[0] * x[..., :, 0:W]
    for i in range(1, ksize):
        h = h + k[i] * x[..., :, i:i + W]
    v = k[0] * h[..., 0:H, :]
    for i in range(1, ksize):
        v = v + k[i] * h[..., i:i + H, :]
    return v


@functools.lru_cache(maxsize=None)
def pyramid_shapes(height: int, width: int, n_levels: int, scale_factor: float) -> Tuple[Tuple[int, int], ...]:
    """Static per-level (H, W), scale = scale_factor**level (reference:
    ORBextractor.cc:2105-2109 rounds the scaled size)."""
    shapes = []
    for lv in range(n_levels):
        inv = 1.0 / (scale_factor ** lv)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return tuple(shapes)


def _xla_column_sum(w: np.ndarray) -> np.ndarray:
    """(n, m) float32 -> (1, m) column sums in XLA-on-CPU's order: a column
    longer than 32 is zero-padded evenly to a multiple of 32, summed in
    order within each block of 32, then over the block partials."""
    n = w.shape[0]
    if n > 32:
        pad = -(-n // 32) * 32 - n
        w = np.pad(w, ((pad // 2, pad - pad // 2), (0, 0)))
        w = np.cumsum(w.reshape(-1, 32, w.shape[1]), axis=1,
                      dtype=np.float32)[:, -1]
    return np.cumsum(w, axis=0, dtype=np.float32)[-1:]


def _linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of jax.image.resize(method="linear",
    antialias=True) along one axis, computed as compute_weight_mat does
    when run op by op: float32 throughout, one rounding per operation."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - x)                 # (n_in, n_out)
    total = _xla_column_sum(w)
    safe = np.where(total != 0, total, f32(1.0))
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / safe, f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(f32))


@functools.lru_cache(maxsize=None)
def _composed_resize_mats(height: int, width: int, n_levels: int,
                          scale_factor: float):
    """Per-level row/column resize matrices composed across the level chain
    (level-k = Acum_k @ img @ Bcum_k.T, Acum_k = A_k @ ... @ A_1), the
    compositions accumulated in float64 and cast to float32 once."""
    shapes = pyramid_shapes(height, width, n_levels, scale_factor)
    rows, cols = [], []
    acum = np.eye(height, dtype=np.float64)
    bcum = np.eye(width, dtype=np.float64)
    for lv in range(1, n_levels):
        h_in, w_in = shapes[lv - 1]
        h_out, w_out = shapes[lv]
        acum = _linear_resize_weights(h_in, h_out).astype(np.float64) @ acum
        bcum = _linear_resize_weights(w_in, w_out).astype(np.float64) @ bcum
        rows.append(acum.astype(np.float32))
        cols.append(bcum.astype(np.float32))
    return tuple(rows), tuple(cols)


@functools.lru_cache(maxsize=None)
def _resize_mats_on(height: int, width: int, n_levels: int,
                    scale_factor: float, device: torch.device):
    rows, cols = _composed_resize_mats(height, width, n_levels, scale_factor)
    return ([torch.from_numpy(a).to(device) for a in rows],
            [torch.from_numpy(b).T.contiguous().to(device) for b in cols])


def build_pyramid(img, n_levels: int = 8, scale_factor: float = 1.2) -> List[torch.Tensor]:
    """Scale pyramid of a (..., H, W) float32 image: level k is
    Acum_k @ img @ Bcum_k.T, every level straight from level 0."""
    H, W = img.shape[-2:]
    rows, cols_t = _resize_mats_on(H, W, n_levels, scale_factor, img.device)
    return [img] + [(A @ img) @ Bt for A, Bt in zip(rows, cols_t)]


def features_per_level(n_features: int, n_levels: int = 8, scale_factor: float = 1.2) -> np.ndarray:
    """Geometric feature budget per level (reference: ORBextractor.cc:826-845
    — desired features scale by 1/scaleFactor per level, remainder to the
    last level)."""
    factor = 1.0 / scale_factor
    n_desired = n_features * (1 - factor) / (1 - factor ** n_levels)
    counts = []
    total = 0
    for lv in range(n_levels - 1):
        c = int(round(n_desired))
        counts.append(c)
        total += c
        n_desired *= factor
    counts.append(max(n_features - total, 0))
    return np.asarray(counts, dtype=np.int32)
