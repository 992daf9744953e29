"""Carry windows, volumes and range images between the two packages.

The JAX package's ``ScanWindow``, ``TSDFState`` and ``RangeImage`` (or any
object with the same fields holding numpy-convertible arrays) become the
port's tensors on a chosen device, and :func:`to_numpy` turns the port's
tensors and tuples of tensors back into numpy arrays. This module imports
no jax: it only reads the fields.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_transfer_tpu_torch.ops.projection import RangeImage
from lidar_transfer_tpu_torch.ops.tsdf import TSDFState
from lidar_transfer_tpu_torch.pipeline.multiscan import ScanWindow


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def window_from_numpy(window, device="cpu") -> ScanWindow:
    """A window with fields points/remissions/labels/valid/rel_pose (primary
    scan first) -> the port's ScanWindow."""
    return ScanWindow(
        points=_tensor(window.points, device),
        remissions=_tensor(window.remissions, device),
        labels=_tensor(window.labels, device),
        valid=_tensor(window.valid, device),
        rel_pose=_tensor(window.rel_pose, device))


def state_from_numpy(state, device="cpu") -> TSDFState:
    """A volume with fields tsdf/weight/label/rem -> the port's TSDFState
    (f32, f32, i32, f32)."""
    return TSDFState(
        tsdf=_tensor(np.asarray(state.tsdf, np.float32), device),
        weight=_tensor(np.asarray(state.weight, np.float32), device),
        label=_tensor(np.asarray(state.label, np.int32), device),
        rem=_tensor(np.asarray(state.rem, np.float32), device))


def range_image_from_numpy(ri, device="cpu") -> RangeImage:
    """A range image with the RangeImage fields -> the port's RangeImage."""
    return RangeImage(*(_tensor(getattr(ri, f), device)
                        for f in RangeImage._fields))


def to_numpy(x):
    """Tensor -> numpy array; NamedTuple / tuple / list -> the same
    container of numpy arrays (other values pass through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x
