"""Rigid transforms on padded point sets (PyTorch), and quaternion pose
interpolation (numpy, on the host).

Counterpart of ``lidar_transfer_tpu/ops/transforms.py``. The 3x3 products
are written out elementwise: the same order of operations on the CPU and on
the card, and no matrix-unit precision mode to choose. The quaternion
functions are copies of the original's numpy code; the rolling-shutter ray
generator (``ops/raycast.generate_rays_moving``) and the engine's rolling
shutter place each fired column at the sensor's pose at its firing time.
"""

from __future__ import annotations

import numpy as np
import torch


def transform_points(points: torch.Tensor,
                     transform: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 (or (...,4,4)) homogeneous transform to (...,N,3) points.

    Broadcasts over leading batch dims: points (S,N,3) with transforms
    (S,4,4) transforms each scan by its own pose.
    """
    rot = transform[..., None, :3, :3]              # (..., 1, 3, 3)
    trans = transform[..., None, :3, 3]             # (..., 1, 3)
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return (rot[..., 0] * x + rot[..., 1] * y + rot[..., 2] * z) + trans


def inverse_pose(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4: [R t]^-1 = [R^T, -R^T t]."""
    rot = pose[..., :3, :3]
    trans = pose[..., :3, 3]
    inv_rot = rot.transpose(-1, -2)
    inv_trans = -(inv_rot[..., 0] * trans[..., 0:1]
                  + inv_rot[..., 1] * trans[..., 1:2]
                  + inv_rot[..., 2] * trans[..., 2:3])
    inv = torch.zeros_like(pose)
    inv[..., :3, :3] = inv_rot
    inv[..., :3, 3] = inv_trans
    inv[..., 3, 3] = 1.0
    return inv


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> unit quaternion (w, x, y, z). Shepperd's method."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        return np.array([0.25 * s,
                         (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2.0
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """(…, 4) quaternions -> (…, 3, 3) rotations (batched)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    out = np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)
    return out


def quaternion_slerp(q0: np.ndarray, q1: np.ndarray,
                     t: np.ndarray) -> np.ndarray:
    """Spherical interpolation, vectorized over t -> (T, 4)."""
    q0 = np.asarray(q0, np.float64) / np.linalg.norm(q0)
    q1 = np.asarray(q1, np.float64) / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0.0:                      # shortest arc
        q1, d = -q1, -d
    t = np.atleast_1d(np.asarray(t, np.float64))
    if d > 0.9995:                   # nearly parallel: lerp
        out = q0[None] + t[:, None] * (q1 - q0)[None]
        return out / np.linalg.norm(out, axis=1, keepdims=True)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    a = np.sin((1.0 - t) * theta) / s
    b = np.sin(t * theta) / s
    return a[:, None] * q0[None] + b[:, None] * q1[None]


def interpolate_pose(pose0: np.ndarray, pose1: np.ndarray,
                     t: np.ndarray) -> np.ndarray:
    """Interpolate rigid 4x4 poses at fractions t in [0,1] -> (T,4,4):
    slerp on rotation, lerp on translation."""
    t = np.atleast_1d(np.asarray(t, np.float64))
    q = quaternion_slerp(rotation_to_quaternion(pose0[:3, :3]),
                         rotation_to_quaternion(pose1[:3, :3]), t)
    out = np.tile(np.eye(4), (t.shape[0], 1, 1))
    out[:, :3, :3] = quaternion_to_rotation(q)      # batched
    out[:, :3, 3] = ((1.0 - t)[:, None] * pose0[:3, 3][None]
                     + t[:, None] * pose1[:3, 3][None])
    return out
