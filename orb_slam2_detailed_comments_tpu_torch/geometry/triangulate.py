"""Batched two-view triangulation.

Counterpart of orb_slam2_detailed_comments_tpu/geometry/triangulate.py (the
replacement of the reference's per-point SVD triangulation, reference:
src/Initializer.cc Triangulate; src/LocalMapping.cc:516-530).
"""
from __future__ import annotations

import numpy as np
import torch

# eigh takes at most this many 4x4 matrices a call: on the H100 (torch
# 2.11, CUDA 12.8) cuSOLVER's batched eigensolver rejected 32,768 of them
# (CUSOLVER_STATUS_INVALID_VALUE, a monocular initialization at 4,000
# features: 8 hypotheses x 4,096 matches) and ran 16,384
EIGH_BATCH = 16384


def triangulate_dlt(P1, P2, uv1, uv2):
    """DLT triangulation.

    Args:
      P1, P2: (3, 4) or (..., 3, 4) projection matrices (K [R|t]).
      uv1, uv2: (..., 2) pixel observations in each view.

    Returns:
      (..., 3) world points (homogeneous-normalized).

    The rows u*P[2]-P[0], v*P[2]-P[1] of each view form A x = 0; the
    solution is the eigenvector of the 4x4 A^T A with the smallest
    eigenvalue (torch.linalg.eigh, ascending, EIGH_BATCH matrices a call).
    Its sign is arbitrary, and the division by w removes it.
    """
    P1 = P1.expand(uv1.shape[:-1] + (3, 4))
    P2 = P2.expand(uv2.shape[:-1] + (3, 4))
    rows = [
        uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)  # (..., 4, 4)
    # row-normalize for conditioning
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    AtA = (A.transpose(-1, -2) @ A).reshape(-1, 4, 4)
    vecs = torch.cat([torch.linalg.eigh(part)[1] for part in AtA.split(EIGH_BATCH)])
    x = vecs[:, :, 0].reshape(A.shape[:-2] + (4,))  # smallest eigenvalue's eigenvector
    w = x[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return x[..., :3] / w[..., None]



def triangulate_dlt_np(P1, P2, uv1, uv2):
    """Host (numpy) twin of triangulate_dlt for the call sites whose batch
    size depends on the data (local mapping's per-neighbor epipolar
    matches): a few hundred 4x4 eigendecompositions, not worth a device
    round trip."""
    P1 = np.broadcast_to(P1, uv1.shape[:-1] + (3, 4))
    P2 = np.broadcast_to(P2, uv2.shape[:-1] + (3, 4))
    rows = [
        uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = np.stack(rows, axis=-2).astype(np.float32)
    A = A / (np.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
    AtA = np.swapaxes(A, -1, -2) @ A
    _, vecs = np.linalg.eigh(AtA)
    x = vecs[..., :, 0]
    w = x[..., 3]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    return x[..., :3] / w[..., None]
