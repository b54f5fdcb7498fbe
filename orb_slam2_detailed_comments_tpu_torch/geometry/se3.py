"""SE(3) rigid transforms as (..., 4, 4) homogeneous matrices.

Counterpart of orb_slam2_detailed_comments_tpu/geometry/se3.py. Tcw maps
world points to camera coordinates, x_c = R_cw x_w + t_cw.
"""
from __future__ import annotations

import numpy as np
import torch

from .so3 import (exp_so3, log_so3, left_jacobian_so3, left_jacobian_inv_so3,
                  quat_to_rotmat, rotmat_to_quat)


def se3_identity(dtype=torch.float32, device="cuda"):
    return torch.eye(4, dtype=dtype, device=device)


def make_se3(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_rotation(T):
    return T[..., :3, :3]


def se3_translation(T):
    return T[..., :3, 3]


def se3_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_se3(Rt, -(Rt @ t[..., None])[..., 0])


def se3_compose(A, B):
    return A @ B


def se3_apply(T, p):
    """Apply transform to points: (..., 4, 4) x (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return p @ R.transpose(-1, -2) + t[..., None, :]


def se3_renormalize(T):
    """Project the rotation block back onto SO(3) via a quaternion
    round-trip (the float32 equivalent of g2o's SE3Quat normalization).
    Call this at every optimizer boundary: composed 4x4 poses otherwise
    accumulate orthonormality error multiplicatively."""
    R = quat_to_rotmat(rotmat_to_quat(T[..., :3, :3]))
    return make_se3(R, T[..., :3, 3])


def se3_inverse_np(T: np.ndarray):
    """Host-side (numpy) SE3 inverse for per-frame 4x4 bookkeeping."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def se3_renormalize_np(T: np.ndarray):
    """Host-side counterpart of se3_renormalize: quaternion round-trip in
    float64 numpy (Shepperd), cast back to the input dtype."""
    R = np.asarray(T[..., :3, :3], np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w, x, y, z = 0.25 * s, (R[2, 1] - R[1, 2]) / s, \
            (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w, x, y, z = (R[2, 1] - R[1, 2]) / s, 0.25 * s, \
            (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w, x, y, z = (R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, \
            0.25 * s, (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w, x, y, z = (R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, \
            (R[1, 2] + R[2, 1]) / s, 0.25 * s
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    Rn = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    out = np.asarray(T).copy()
    out[..., :3, :3] = Rn.astype(out.dtype)
    return out


def exp_se3(xi):
    """Twist (..., 6) = (upsilon, omega) [translation part first, rotation
    last] -> (..., 4, 4), the g2o convention of the reference's BA
    vertices."""
    rho = xi[..., :3]
    phi = xi[..., 3:]
    R = exp_so3(phi)
    J = left_jacobian_so3(phi)
    t = (J @ rho[..., None])[..., 0]
    return make_se3(R, t)


def log_se3(T):
    """(..., 4, 4) -> twist (..., 6) = (upsilon, omega)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = log_so3(R)
    Jinv = left_jacobian_inv_so3(phi)
    rho = (Jinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)
