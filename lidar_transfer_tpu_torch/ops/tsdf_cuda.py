"""Wrappers of the CUDA TSDF kernels (``csrc/tsdf_integrate.cu``,
``csrc/tsdf_geometry.cu``).

Replace ``lidar_transfer_tpu/ops/tsdf_pallas.py::integrate_pallas``,
``integrate_pallas_chain`` and ``precompute_geometry`` on the card. A CPU
state takes the plain version (``ops/tsdf.integrate``,
``integrate_chain``, ``precompute_geometry``); a CUDA state launches the
kernel, which updates the state in place (where JAX donated the buffers)
with the same float32 scalars as the plain version
(``ops/tsdf.integrate_params``). Any other device raises.
"""

from __future__ import annotations

import torch

from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.ops import tsdf as TS

_IMAGE_DTYPES = (torch.float32, torch.int32, torch.float32)


def _check(name: str, state: TS.TSDFState, spec: TS.VolumeSpec, images,
           v_tab) -> tuple[torch.device, bool]:
    """Raise unless the state, images and table are what the kernel takes;
    -> (device, compact)."""
    dev = state.tsdf.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: state on {dev}")
    compact = TS.state_dtypes(state) == TS.COMPACT_DTYPES
    for field, t in zip(TS.TSDFState._fields, state):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: state.{field} must be a contiguous "
                             f"tensor on {dev}, got {t.device}")
        if tuple(t.shape) != tuple(spec.dims):
            raise ValueError(f"{name}: state.{field} shape "
                             f"{tuple(t.shape)} != spec dims {spec.dims}")
    shape = images[0].shape
    if len(shape) < 2 or shape[-2] > 128:
        raise ValueError(f"{name}: images must be (..., H, W) with "
                         f"H <= 128, got {tuple(shape)}")
    for t, dt in zip(images, _IMAGE_DTYPES):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or t.shape != shape):
            raise ValueError(f"{name}: images must be contiguous "
                             f"{tuple(shape)} {_IMAGE_DTYPES} tensors on "
                             f"{dev}")
    if v_tab is not None and (
            v_tab.device != dev or v_tab.dtype != torch.int8
            or not v_tab.is_contiguous()
            or tuple(v_tab.shape) != tuple(spec.dims)):
        raise ValueError(f"{name}: v_tab must be a contiguous int8 "
                         f"{spec.dims} tensor on {dev}")
    return dev, compact


def _kernel_scalars(spec, fov_up_deg, fov_down_deg, obs_weight, origin,
                    active_dims):
    prm = TS.integrate_params(spec, fov_up_deg, fov_down_deg, obs_weight,
                              origin, active_dims)
    return (prm.ox, prm.oy, prm.oz, prm.vox, prm.fov_up, prm.fov_down,
            prm.fov_down_abs, prm.fov, prm.pi, prm.trunc, prm.obs_weight,
            *prm.active)


def integrate_cuda(state: TS.TSDFState, spec: TS.VolumeSpec,
                   depth_im: torch.Tensor, label_im: torch.Tensor,
                   rem_im: torch.Tensor, *, fov_up_deg, fov_down_deg,
                   obs_weight: float = 1.0, origin=None, active_dims=None,
                   reset: bool = False, write_weight: bool = True,
                   x_offset: int = 0,
                   v_tab: torch.Tensor | None = None) -> TS.TSDFState:
    """Fuse one range image into the volume (see ``ops/tsdf.integrate``
    for the arguments); float32 or compact state."""
    if state.tsdf.device.type == "cpu":
        return TS.integrate(
            state, spec, depth_im, label_im, rem_im, fov_up_deg=fov_up_deg,
            fov_down_deg=fov_down_deg, obs_weight=obs_weight, origin=origin,
            active_dims=active_dims, reset=reset, write_weight=write_weight,
            x_offset=x_offset, v_tab=v_tab)
    images = (depth_im, label_im, rem_im)
    dev, compact = _check("integrate_cuda", state, spec, images, v_tab)
    H, W = depth_im.shape
    X, Y, Z = spec.dims
    _build.launch(
        "tsdf_integrate", "lt_tsdf_integrate",
        *(t.data_ptr() for t in state), *(t.data_ptr() for t in images),
        None if v_tab is None else v_tab.data_ptr(), int(compact),
        H, W, X, Y, Z, int(x_offset),
        *_kernel_scalars(spec, fov_up_deg, fov_down_deg, obs_weight,
                         origin, active_dims),
        int(reset), int(write_weight), _build.stream_handle(dev))
    return state


def integrate_chain_cuda(state: TS.TSDFState, spec: TS.VolumeSpec,
                         depth_ims: torch.Tensor, label_ims: torch.Tensor,
                         rem_ims: torch.Tensor, *, fov_up_deg,
                         fov_down_deg, obs_weight: float = 1.0,
                         origin=None, active_dims=None,
                         write_weight: bool = True, x_offset: int = 0,
                         v_tab: torch.Tensor | None = None
                         ) -> TS.TSDFState:
    """The S-scan chain over (S,H,W) stacks sharing one fov and origin
    (see ``ops/tsdf.integrate_chain``): one kernel pass, one state
    write."""
    if state.tsdf.device.type == "cpu":
        return TS.integrate_chain(
            state, spec, depth_ims, label_ims, rem_ims,
            fov_up_deg=fov_up_deg, fov_down_deg=fov_down_deg,
            obs_weight=obs_weight, origin=origin, active_dims=active_dims,
            write_weight=write_weight, x_offset=x_offset, v_tab=v_tab)
    images = (depth_ims, label_ims, rem_ims)
    if depth_ims.dim() != 3 or depth_ims.shape[0] < 1:
        raise ValueError(f"integrate_chain_cuda: images must be (S,H,W) "
                         f"stacks, got {tuple(depth_ims.shape)}")
    dev, compact = _check("integrate_chain_cuda", state, spec, images,
                          v_tab)
    S, H, W = depth_ims.shape
    X, Y, Z = spec.dims
    _build.launch(
        "tsdf_integrate_chain", "lt_tsdf_integrate_chain",
        *(t.data_ptr() for t in state), *(t.data_ptr() for t in images),
        None if v_tab is None else v_tab.data_ptr(), int(compact),
        S, H, W, X, Y, Z, int(x_offset),
        *_kernel_scalars(spec, fov_up_deg, fov_down_deg, obs_weight,
                         origin, active_dims),
        int(write_weight), _build.stream_handle(dev))
    return state


def precompute_geometry_cuda(spec: TS.VolumeSpec, fov_up_deg, fov_down_deg,
                             H: int, origin=None,
                             device="cuda") -> torch.Tensor:
    """(X,Y,Z) int8 row table of a fixed placement, -1 out of FOV (see
    ``ops/tsdf.precompute_geometry``)."""
    device = torch.device(device)
    if device.type == "cpu":
        return TS.precompute_geometry(spec, fov_up_deg, fov_down_deg, H,
                                      origin=origin, device=device)
    if device.type != "cuda":
        raise ValueError(f"precompute_geometry_cuda: device {device}")
    if not 0 < H <= 128:
        raise ValueError(f"precompute_geometry_cuda: H must be in "
                         f"[1, 128], got {H}")
    v_tab = torch.empty(spec.dims, dtype=torch.int8, device=device)
    prm = TS.integrate_params(spec, fov_up_deg, fov_down_deg,
                              origin=origin)
    X, Y, Z = spec.dims
    _build.launch(
        "tsdf_geometry", "lt_tsdf_geometry", v_tab.data_ptr(), H, X, Y, Z,
        prm.ox, prm.oy, prm.oz, prm.vox, prm.fov_up, prm.fov_down,
        prm.fov_down_abs, prm.fov, _build.stream_handle(device))
    return v_tab
