"""Wrapper of the CUDA TSDF integrate kernel (``csrc/tsdf_integrate.cu``).

Replaces ``lidar_transfer_tpu/ops/tsdf_pallas.py::integrate_pallas`` on
the card. A CPU state takes the plain version (``ops/tsdf.integrate``); a
CUDA state launches the kernel, which updates the state in place (where
JAX donated the buffers) with the same float32 scalars as the plain
version (``ops/tsdf.integrate_params``).
"""

from __future__ import annotations

import torch

from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.ops import tsdf as TS

_STATE_DTYPES = (torch.float32, torch.float32, torch.int32, torch.float32)
_IMAGE_DTYPES = (torch.float32, torch.int32, torch.float32)


def integrate_cuda(state: TS.TSDFState, spec: TS.VolumeSpec,
                   depth_im: torch.Tensor, label_im: torch.Tensor,
                   rem_im: torch.Tensor, *, fov_up_deg, fov_down_deg,
                   obs_weight: float = 1.0, origin=None, active_dims=None,
                   reset: bool = False, write_weight: bool = True,
                   x_offset: int = 0) -> TS.TSDFState:
    """Fuse one range image into the volume (see ``ops/tsdf.integrate``
    for the arguments)."""
    if state.tsdf.device.type == "cpu":
        return TS.integrate(
            state, spec, depth_im, label_im, rem_im, fov_up_deg=fov_up_deg,
            fov_down_deg=fov_down_deg, obs_weight=obs_weight, origin=origin,
            active_dims=active_dims, reset=reset, write_weight=write_weight,
            x_offset=x_offset)
    dev = state.tsdf.device
    if dev.type != "cuda":
        raise ValueError(f"integrate_cuda: state on {dev}")
    images = (depth_im, label_im, rem_im)
    for name, t, dt in zip(TS.TSDFState._fields, state, _STATE_DTYPES):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"integrate_cuda: state.{name} must be a "
                             f"contiguous {dt} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(spec.dims):
            raise ValueError(f"integrate_cuda: state.{name} shape "
                             f"{tuple(t.shape)} != spec dims {spec.dims}")
    H, W = depth_im.shape
    for t, dt in zip(images, _IMAGE_DTYPES):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != (H, W)):
            raise ValueError(f"integrate_cuda: images must be contiguous "
                             f"(H,W) {_IMAGE_DTYPES} tensors on {dev}")
    prm = TS.integrate_params(spec, fov_up_deg, fov_down_deg, obs_weight,
                              origin, active_dims)
    X, Y, Z = spec.dims
    _build.launch(
        "tsdf_integrate", "lt_tsdf_integrate",
        *(t.data_ptr() for t in state), *(t.data_ptr() for t in images),
        H, W, X, Y, Z, int(x_offset),
        prm.ox, prm.oy, prm.oz, prm.vox, prm.fov_up, prm.fov_down,
        prm.fov_down_abs, prm.fov, prm.pi, prm.trunc, prm.obs_weight,
        *prm.active, int(reset), int(write_weight),
        _build.stream_handle(dev))
    return state
