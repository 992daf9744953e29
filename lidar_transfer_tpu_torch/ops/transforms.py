"""Rigid transforms on padded point sets (PyTorch).

Counterpart of ``lidar_transfer_tpu/ops/transforms.py``. The 3x3 products
are written out elementwise: the same order of operations on the CPU and on
the card, and no matrix-unit precision mode to choose.
"""

from __future__ import annotations

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
