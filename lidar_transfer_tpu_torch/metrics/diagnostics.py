"""Per-cause accounting of the target pixels a virtual scan leaves empty
(PyTorch).

Counterpart of ``lidar_transfer_tpu/metrics/diagnostics.py``. Every pixel
of the synthesized scan is a hit or falls into exactly one cause of a
miss, in precedence order:

  out_of_source_fov  the target row's pitch lies outside the SOURCE
                     sensor's vertical FOV: no source return can cover it;
  empty_direction    no source return projects into the pixel (sky, gaps
                     between beams, occlusion shadows);
  outside_volume     the pixel's nearest source return lies outside the
                     volume bounds, so fusion never saw the surface;
  synthesis_miss     a fusable in-volume return exists and the engine
                     still produced nothing: the only cause that indicts
                     the synthesis.

hit + the four causes == H * W. The projection of the source cloud into
the target grid is ``ops/projection.range_project`` (the z-buffer kernel
on the card); the rest is elementwise work and five sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_transfer_tpu_torch.ops import projection as P


class MissDecomposition(NamedTuple):
    """The pixel counts of each bucket, 0-dim int32 tensors."""

    hit: torch.Tensor
    out_of_source_fov: torch.Tensor
    empty_direction: torch.Tensor
    outside_volume: torch.Tensor
    synthesis_miss: torch.Tensor

    def as_dict(self) -> dict:
        return {k: int(v) for k, v in zip(self._fields, self)}

    def rates(self) -> dict:
        d = self.as_dict()
        total = sum(d.values())
        return {k: v / total for k, v in d.items()}


def miss_decomposition(points: torch.Tensor, valid: torch.Tensor,
                       vs_mask: torch.Tensor, *, target_H: int,
                       target_W: int, t_fov_up, t_fov_down, s_fov_up,
                       s_fov_down, vol_bounds, beam_angles=None,
                       workspace: P.ZBufferWorkspace | None = None
                       ) -> MissDecomposition:
    """Classify every pixel of a virtual scan (see the module docstring).

    points (N, 3) f32 / valid (N,) bool: the MERGED source cloud that was
    transferred, in the sensor frame; vs_mask (H, W) bool: the scan's hit
    mask; t_*: the target grid and FOV of the synthesis; s_*: the SOURCE
    sensor's vertical FOV in degrees; vol_bounds (3, 2): the volume's
    world bounds at fusion; beam_angles: the target's beam angles
    (radians), if it has them (rows are then beams); ``workspace`` is
    handed to the z-buffer."""
    dev = points.device
    H, W = target_H, target_W
    n = points.shape[0]
    ba = (None if beam_angles is None else
          torch.as_tensor(beam_angles, dtype=torch.float32, device=dev))
    ri = P.range_project(
        points, torch.zeros(n, dtype=torch.float32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev), valid, H=H, W=W,
        fov_up_deg=t_fov_up, fov_down_deg=t_fov_down, beam_angles=ba,
        beam_rows=ba is not None, workspace=workspace)
    has_src = ri.mask

    # each target row's pitch (radians): its beam, or the row's centre
    if ba is not None:
        pitch_row = -torch.sort(-ba).values
    else:
        fu, fd, fov = P.fov_radians(t_fov_up, t_fov_down)
        # a 0-dim divisor: a true division on the card too
        v = ((torch.arange(H, dtype=torch.float32, device=dev) + 0.5)
             / torch.tensor(float(H), device=dev))
        pitch_row = fu - v * fov
    sfu = P.deg2rad32(s_fov_up)
    sfd = P.deg2rad32(s_fov_down)
    out_fov = ((pitch_row > sfu) | (pitch_row < sfd))[:, None].expand(H, W)

    # the winning source point of each covered pixel, in the volume or not
    win = torch.clamp(ri.index.reshape(-1), min=0).to(torch.int64)
    wp = points[win].reshape(H, W, 3)
    vb = torch.as_tensor(np.asarray(vol_bounds, np.float32), device=dev)
    in_vol = ((wp >= vb[:, 0]) & (wp <= vb[:, 1])).all(dim=-1)

    miss = ~vs_mask
    fusable = miss & ~out_fov & has_src
    count = lambda m: m.sum().to(torch.int32)  # noqa: E731
    return MissDecomposition(
        hit=count(vs_mask), out_of_source_fov=count(miss & out_fov),
        empty_direction=count(miss & ~out_fov & ~has_src),
        outside_volume=count(fusable & ~in_vol),
        synthesis_miss=count(fusable & in_vol))
