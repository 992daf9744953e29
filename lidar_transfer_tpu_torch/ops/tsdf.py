"""Class-aware TSDF fusion of a range image into a voxel volume (PyTorch).

Counterpart of ``lidar_transfer_tpu/ops/tsdf.py``; :func:`integrate` is the
plain version of the CUDA integrate kernel (``ops/tsdf_cuda.py``). Every
voxel projects into the range image, reads one pixel and updates its own
state: a same-label observation averages in, a different label overwrites
only where ``dist < weight`` (the reference kernel reads the weight as
``dist_old``, a quirk both packages keep).

Where JAX donated the state buffers, the port updates the state tensors in
place and returns the same ``TSDFState``.

Every scalar is a 0-dim tensor on the state's device, so each division is a
true IEEE division on the card too (PyTorch turns a division by a host
scalar into a multiplication by its reciprocal there); the kernel then
repeats this arithmetic exactly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from lidar_transfer_tpu_torch.ops.projection import fov_radians


class TSDFState(NamedTuple):
    """Volume state, four (X,Y,Z) tensors.

    tsdf f32 (init 1), weight f32 (init 0; doubles as dist_old in the
    class-aware rule), label i32 (init 0), rem f32 (init 0).
    """

    tsdf: torch.Tensor
    weight: torch.Tensor
    label: torch.Tensor
    rem: torch.Tensor


@dataclasses.dataclass(frozen=True)
class VolumeSpec:
    """Static geometry of a voxel volume."""

    origin: tuple[float, float, float]
    voxel_size: float
    dims: tuple[int, int, int]

    @classmethod
    def from_bounds(cls, bounds, voxel_size: float) -> "VolumeSpec":
        bounds = np.asarray(bounds, np.float64).reshape(3, 2)
        dims = np.ceil((bounds[:, 1] - bounds[:, 0]) / voxel_size
                       ).astype(int)
        return cls(origin=tuple(float(v) for v in bounds[:, 0]),
                   voxel_size=float(voxel_size),
                   dims=tuple(int(d) for d in dims))

    @property
    def trunc_margin(self) -> float:
        # 5 voxels, as the reference
        return self.voxel_size * 5.0

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.dims))

    def init_state(self, device="cpu") -> TSDFState:
        d = self.dims
        return TSDFState(
            tsdf=torch.ones(d, dtype=torch.float32, device=device),
            weight=torch.zeros(d, dtype=torch.float32, device=device),
            label=torch.zeros(d, dtype=torch.int32, device=device),
            rem=torch.zeros(d, dtype=torch.float32, device=device))


class IntegrateParams(NamedTuple):
    """Float32 scalars of one integrate, shared by the plain version and
    the kernel so both compute with the same values."""

    ox: float
    oy: float
    oz: float
    vox: float
    fov_up: float
    fov_down: float
    fov_down_abs: float
    fov: float
    pi: float
    trunc: float
    obs_weight: float
    active: tuple[int, int, int]


def integrate_params(spec: VolumeSpec, fov_up_deg, fov_down_deg,
                     obs_weight=1.0, origin=None,
                     active_dims=None) -> IntegrateParams:
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    origin = spec.origin if origin is None else origin
    ox, oy, oz = (f32(v) for v in np.asarray(origin, np.float32))
    active = spec.dims if active_dims is None else active_dims
    fov_up, fov_down, fov = fov_radians(fov_up_deg, fov_down_deg)
    return IntegrateParams(
        ox=ox, oy=oy, oz=oz, vox=f32(spec.voxel_size),
        fov_up=fov_up, fov_down=fov_down, fov_down_abs=abs(fov_down),
        fov=fov, pi=f32(np.pi), trunc=f32(spec.voxel_size * 5.0),
        obs_weight=f32(obs_weight),
        active=tuple(int(a) for a in np.asarray(active)))


def auto_x_chunk(dims: tuple[int, int, int],
                 slab_voxels: int = 1 << 26) -> int | None:
    """X-slab size bounding the plain version's temporaries (~64M voxels
    per slab). None = one slab (small volumes)."""
    X, Y, Z = dims
    if X * Y * Z <= slab_voxels:
        return None
    chunk = max(8, (slab_voxels // (Y * Z)) // 8 * 8)
    return int(min(chunk, X))


def _integrate_block(block: TSDFState, depth_im, label_im, rem_im,
                     prm: IntegrateParams, gx0: int, reset: bool,
                     write_weight: bool) -> None:
    """Update one X-slab in place; ``gx0`` is its first global x index."""
    dev = depth_im.device
    c = {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in prm._asdict().items() if k != "active"}
    X, Y, Z = block.tsdf.shape
    H, W = depth_im.shape
    ax, ay, az = prm.active

    gx = torch.arange(gx0, gx0 + X, dtype=torch.float32, device=dev)
    gy = torch.arange(Y, dtype=torch.float32, device=dev)
    gz = torch.arange(Z, dtype=torch.float32, device=dev)
    px = (c["ox"] + gx * c["vox"])[:, None, None]
    py = (c["oy"] + gy * c["vox"])[None, :, None]
    pz = (c["oz"] + gz * c["vox"])[None, None, :]

    depth = torch.sqrt(px * px + py * py + pz * pz)
    safe = torch.maximum(depth, torch.tensor(1e-12, device=dev))
    yaw = -torch.atan2(py, px)                                  # (X,Y,1)
    pitch = torch.asin(torch.clamp(pz / safe, -1.0, 1.0))
    in_fov = (pitch <= c["fov_up"]) & (pitch >= c["fov_down"])

    u = 0.5 * (yaw / c["pi"] + 1.0) * W
    v = (1.0 - (pitch + c["fov_down_abs"]) / c["fov"]) * H
    pix_x = torch.clamp(torch.floor(u), 0, W - 1).to(torch.int64)
    pix_y = torch.clamp(torch.floor(v), 0, H - 1).to(torch.int64)
    flat = pix_y * W + pix_x
    depth_val = depth_im.reshape(-1)[flat]
    new_label = label_im.reshape(-1)[flat]
    new_rem = rem_im.reshape(-1)[flat]

    depth_diff = depth_val - depth
    dist = torch.clamp(depth_diff / c["trunc"], max=1.0)
    in_crop = ((gx < ax)[:, None, None] & (gy < ay)[None, :, None]
               & (gz < az)[None, None, :])
    active = (in_crop & in_fov & (depth_val > 0)
              & (depth_diff >= -c["trunc"]))

    if reset:
        # the prior state is the init constants: the buffers are only
        # written
        tsdf_f = torch.tensor(1.0, device=dev)
        weight_f = torch.tensor(0.0, device=dev)
        rem_f = torch.tensor(0.0, device=dev)
        label_i = torch.tensor(0, dtype=torch.int32, device=dev)
    else:
        tsdf_f, weight_f, label_i, rem_f = block

    same_class = label_i == new_label
    w_new = weight_f + c["obs_weight"]
    tsdf_avg = (tsdf_f * weight_f + dist) / w_new
    rem_avg = (rem_f * weight_f + new_rem) / w_new
    upd_same = active & same_class
    upd_diff = active & ~same_class & (dist < weight_f)

    new_tsdf = torch.where(upd_same, tsdf_avg,
                           torch.where(upd_diff, dist, tsdf_f))
    new_label_out = torch.where(upd_diff, new_label, label_i)
    new_rem_out = torch.where(upd_same, rem_avg,
                              torch.where(upd_diff, new_rem, rem_f))
    new_weight = torch.where(upd_same, w_new, weight_f)
    block.tsdf.copy_(new_tsdf)
    block.label.copy_(new_label_out)
    block.rem.copy_(new_rem_out)
    if write_weight:
        block.weight.copy_(new_weight)


def integrate(state: TSDFState, spec: VolumeSpec, depth_im: torch.Tensor,
              label_im: torch.Tensor, rem_im: torch.Tensor, *,
              fov_up_deg, fov_down_deg, obs_weight: float = 1.0,
              origin=None, active_dims=None, x_chunk: int | None = "auto",
              reset: bool = False, write_weight: bool = True,
              x_offset: int = 0) -> TSDFState:
    """Fuse one range image into the volume, in place (plain version).

    Args:
      depth_im: (H,W) f32 range image, 0 = no data; label_im (H,W) i32;
        rem_im (H,W) f32.
      fov_up_deg / fov_down_deg: FOV of the image's sensor spec.
      origin: optional (3,) world origin (defaults to spec.origin).
      active_dims: optional (3,) crop; voxels at or above it are inert.
      reset: the prior state is the init constants (it is not read).
      write_weight: False leaves the weight tensor untouched (valid when
        no further integrate reads this state).
      x_offset: the state is the X-slab starting at this global x index of
        a volume whose ``origin`` is given; ``spec.dims`` is the slab's.
    """
    prm = integrate_params(spec, fov_up_deg, fov_down_deg, obs_weight,
                           origin, active_dims)
    X = spec.dims[0]
    if x_chunk == "auto":
        x_chunk = auto_x_chunk(spec.dims)
    step = X if x_chunk is None else x_chunk
    label_im = label_im.to(torch.int32)
    for x0 in range(0, X, step):
        block = TSDFState(*(a[x0:x0 + step] for a in state))
        _integrate_block(block, depth_im, label_im, rem_im, prm,
                         x_offset + x0, reset, write_weight)
    return state
