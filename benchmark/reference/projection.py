"""Spherical projection and the z-buffer in plain PyTorch.

A frozen copy of the plain path of the port's ``ops/projection.py``
(``_pixel_keys`` without beam tables, ``zbuffer_winners_plain``,
``range_project``), written for any floating dtype: the float32 reference
and its lower-precision control run the same code. Each pixel takes the
valid point of the smallest depth, the lowest index on exact ties, by one
stable sort of (pixel, depth).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def fov_radians(fov_up_deg, fov_down_deg) -> tuple[float, float]:
    """-> (|fov_down|, |fov_up| + |fov_down|) in radians, rounded as
    float32 values."""
    f32 = np.float32
    up = f32(f32(fov_up_deg) * f32(np.pi / 180))
    down = f32(f32(fov_down_deg) * f32(np.pi / 180))
    return float(abs(down)), float(f32(abs(down) + abs(up)))


def pixel_keys(points, valid, fov_up_deg, fov_down_deg, H, W):
    """-> (pixel (N,) int32, H*W where the point cannot win; depth; the
    unclamped column coordinate; px; py; valid)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    depth = torch.sqrt(x * x + y * y + z * z)
    yaw = -torch.atan2(y, x)
    safe = torch.where(depth > 0, depth, 1.0)
    pitch = torch.asin(torch.clamp(z / safe, -1.0, 1.0))
    fov_down, fov = fov_radians(fov_up_deg, fov_down_deg)
    u = 0.5 * (yaw / math.pi + 1.0)
    v = 1.0 - (pitch + fov_down) / fov
    valid = valid & (depth > 0.0) & (v >= 0.0) & (v <= 1.0)
    uf, vf = u * W, v * H
    px = torch.clamp(torch.floor(uf), 0, W - 1).to(torch.int32)
    py = torch.clamp(torch.floor(vf), 0, H - 1).to(torch.int32)
    pix = torch.where(valid, py * W + px, H * W).to(torch.int32)
    return pix, depth, uf, vf, px, py, valid


def winners(pix, depth, valid, npix: int) -> torch.Tensor:
    """(npix,) int32 index of each pixel's winner, -1 where empty."""
    key = torch.where(valid, depth, math.inf).to(torch.float32)
    bits = key.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.sort((pix.to(torch.int64) << 32) | bits,
                       stable=True).indices
    sp = pix[order]
    first = torch.ones_like(sp, dtype=torch.bool)
    first[1:] = sp[1:] != sp[:-1]
    first &= sp < npix
    win = torch.full((npix,), -1, dtype=torch.int32, device=pix.device)
    win[sp[first].to(torch.int64)] = order[first].to(torch.int32)
    return win


def range_image(points, rem, labels, valid, fov_up_deg, fov_down_deg, H,
                W) -> dict:
    """The (H, W) range image of a padded point set: range, index, label,
    remission, mask, and each point's pixel, depth and validity."""
    pix, depth, uf, vf, px, py, valid = pixel_keys(
        points, valid, fov_up_deg, fov_down_deg, H, W)
    win = winners(pix, depth, valid, H * W)
    has = win >= 0
    g = torch.where(has, win, 0).to(torch.int64)

    def image(values, empty):
        return torch.where(has, values[g], empty).reshape(H, W)

    return dict(range=image(depth, 0.0), index=win.reshape(H, W),
                remission=image(rem, -1.0), label=image(labels, 0),
                mask=has.reshape(H, W), point_depth=depth, point_u=px,
                point_v=py, point_valid=valid)
