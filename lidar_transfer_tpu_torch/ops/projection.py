"""Spherical range-image projection (PyTorch) and the z-buffer kernel.

Counterpart of ``lidar_transfer_tpu/ops/projection.py``. The JAX package
selects each pixel's winner with one stable (pixel, key) sort
(``_winner_sort``); here :func:`zbuffer_winners` does it with a hand-written
CUDA kernel (``csrc/zbuffer.cu``) on the card and with the same stable sort
(:func:`zbuffer_winners_plain`) on the CPU. Both give each pixel the valid
point with the smallest key, the lowest index on exact ties.

All point arrays are fixed-capacity padded; a boolean ``valid`` mask marks
real points. Zero-depth padding never wins a pixel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from lidar_transfer_tpu_torch import _build


class RangeImage(NamedTuple):
    """Result of projecting a point set into a spherical range image.

    Image-plane fields (H,W): range (0 where no data), index (-1 where no
    data), remission (-1 where no data), label (0 where no data), u_float /
    v_float (unclamped pixel coords of the winning point, 0 where no data).
    Per-point fields (N,): point_valid, point_u, point_v, point_depth.
    """

    range: torch.Tensor
    index: torch.Tensor
    remission: torch.Tensor
    label: torch.Tensor
    u_float: torch.Tensor
    v_float: torch.Tensor
    point_valid: torch.Tensor
    point_u: torch.Tensor
    point_v: torch.Tensor
    point_depth: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        """(H,W) bool: pixel has data."""
        return self.index >= 0


def deg2rad32(deg) -> float:
    """Degrees to radians in float32 arithmetic, as ``jnp.deg2rad`` on a
    float32 value computes it."""
    return float(np.float32(deg) * np.float32(np.pi / 180))


def fov_radians(fov_up_deg, fov_down_deg) -> tuple[float, float, float]:
    """-> (fov_up, fov_down, |fov_up| + |fov_down|), float32 values."""
    up = np.float32(deg2rad32(fov_up_deg))
    down = np.float32(deg2rad32(fov_down_deg))
    return float(up), float(down), float(np.abs(down) + np.abs(up))


def spherical_angles(points: torch.Tensor):
    """(N,3) points -> (depth, yaw, pitch); yaw = -atan2(y, x),
    pitch = asin(z / depth)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    depth = torch.sqrt(x * x + y * y + z * z)
    yaw = -torch.atan2(y, x)
    safe_depth = torch.where(depth > 0, depth, 1.0)
    pitch = torch.asin(torch.clamp(z / safe_depth, -1.0, 1.0))
    return depth, yaw, pitch


def snap_to_beams(pitch: torch.Tensor,
                  beam_angles: torch.Tensor) -> torch.Tensor:
    """Snap pitch angles to the nearest beam angle (radians, (B,))."""
    diff = torch.abs(pitch[..., None] - beam_angles)
    return beam_angles[torch.argmin(diff, dim=-1)]


def project_uv(points: torch.Tensor, fov_up_deg, fov_down_deg,
               beam_angles: torch.Tensor | None = None):
    """(N,3) points -> (u, v, depth) in normalized [0,1] image coords:
    u = 0.5*(yaw/pi + 1), v = 1 - (pitch + |fov_down|)/fov."""
    _, fov_down, fov = fov_radians(fov_up_deg, fov_down_deg)
    depth, yaw, pitch = spherical_angles(points)
    if beam_angles is not None:
        pitch = snap_to_beams(pitch, beam_angles)
    u = 0.5 * (yaw / math.pi + 1.0)
    v = 1.0 - (pitch + abs(fov_down)) / fov
    return u, v, depth


def _pixel_keys(points, valid, fov_up_deg, fov_down_deg, beam_angles,
                H, W, beam_rows, winner):
    """Per-point pixel and z-buffer key.

    Returns (pix, key, depth, uf, vf, px, py, valid): ``pix`` is ``H*W``
    for invalid points (they can never win a pixel), ``key`` is the depth
    (``winner="depth"``) or the squared distance of the float image coords
    to the pixel centre (``winner="pdist"``); +inf for invalid points.
    """
    if beam_rows:
        # row i IS beam i (descending pitch); points take the row of their
        # nearest beam
        depth, yaw, pitch = spherical_angles(points)
        ba_desc = -torch.sort(-beam_angles).values
        row = torch.argmin(torch.abs(pitch[:, None] - ba_desc[None, :]),
                           dim=1).to(torch.int32)
        valid = valid & (depth > 0.0)
        u = 0.5 * (yaw / math.pi + 1.0)
        uf = u * W
        vf = row.to(torch.float32) + 0.5
        px = torch.clamp(torch.floor(uf), 0, W - 1).to(torch.int32)
        py = row
    else:
        u, v, depth = project_uv(points, fov_up_deg, fov_down_deg,
                                 beam_angles)
        # zero-depth padding and points outside the vertical FOV drop out
        valid = valid & (depth > 0.0) & (v >= 0.0) & (v <= 1.0)
        uf = u * W
        vf = v * H
        px = torch.clamp(torch.floor(uf), 0, W - 1).to(torch.int32)
        py = torch.clamp(torch.floor(vf), 0, H - 1).to(torch.int32)

    npix = H * W
    pix = torch.where(valid, py * W + px, npix).to(torch.int32)
    if winner == "pdist":
        dyp = vf - (py.to(torch.float32) + 0.5)
        dxp = uf - (px.to(torch.float32) + 0.5)
        key = dyp * dyp + dxp * dxp
    else:
        key = depth
    key = torch.where(valid, key, math.inf)
    return pix, key, depth, uf, vf, px, py, valid


def zbuffer_winners_plain(pix: torch.Tensor, key: torch.Tensor,
                          npix: int) -> torch.Tensor:
    """Plain z-buffer: one stable sort by (pixel, key) and its run starts,
    the order ``jax.lax.sort(num_keys=2)`` gives ``_winner_sort``.

    The composite int64 key is ``(pix << 32) | float bits of key``; keys
    are non-negative floats, whose bit patterns order as the floats do.
    Returns win_idx (npix,) int32, -1 where no valid point falls.
    """
    n = pix.shape[0]
    bits = key.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    comp = (pix.to(torch.int64) << 32) | bits
    order = torch.sort(comp, stable=True).indices
    sp = pix[order]
    first = torch.ones(n, dtype=torch.bool, device=pix.device)
    first[1:] = sp[1:] != sp[:-1]
    first &= sp < npix
    win = torch.full((npix,), -1, dtype=torch.int32, device=pix.device)
    win[sp[first].to(torch.int64)] = order[first].to(torch.int32)
    return win


class ZBufferWorkspace:
    """The z-buffer kernel's scratch (npix 64-bit words), kept between
    calls so that a call allocates and initialises nothing.

    One workspace serves one device and any sequence of image sizes: it
    grows when a larger ``npix`` comes. It is used on PyTorch's current
    stream only: a call on another stream than the one the scratch was
    made on makes a new scratch there. A caller that shares one workspace
    between threads orders their calls itself. On the CPU it holds nothing.

    The scratch is filled with all-ones once, when it is allocated, and
    every call leaves it so: a call is the minimum kernel and a decode
    kernel that cleans up, two device operations.
    """

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self._scratch: torch.Tensor | None = None
        self._stream = None
        #: scratch allocations so far (a steady state makes none)
        self.allocations = 0

    def scratch(self, npix: int, device: torch.device) -> torch.Tensor:
        """>= npix int64 words on ``device``, all-ones; raises for another
        device than the workspace's."""
        if self.device is None:
            self.device = device
        if (device.type != self.device.type
                or None not in (device.index, self.device.index)
                and device.index != self.device.index):
            raise ValueError(f"ZBufferWorkspace of {self.device} used on "
                             f"{device}")
        stream = torch.cuda.current_stream(device).cuda_stream
        if (self._scratch is None or self._scratch.shape[0] < npix
                or self._stream != stream):
            self._scratch = torch.full((npix,), -1, dtype=torch.int64,
                                       device=device)
            self._stream = stream
            self.allocations += 1
        return self._scratch

    def drop(self) -> None:
        """Forget the scratch (after a failed launch, whose scratch may
        not be clean)."""
        self._scratch = None


def zbuffer_winners(pix: torch.Tensor, key: torch.Tensor, npix: int, *,
                    workspace: ZBufferWorkspace | None = None
                    ) -> torch.Tensor:
    """Per-pixel winner index (kernel A, ``csrc/zbuffer.cu``).

    pix (N,) int32 in [0, npix] (npix = invalid), key (N,) float32,
    non-negative for valid points. Returns (npix,) int32, -1 where empty.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream, with the scratch of ``workspace`` (see
    :class:`ZBufferWorkspace`) or, without one, a scratch allocated and
    initialised for this call.
    """
    if workspace is not None and not isinstance(workspace,
                                                ZBufferWorkspace):
        raise TypeError(f"zbuffer_winners: workspace is a "
                        f"{type(workspace).__name__}, not a "
                        "ZBufferWorkspace")
    if pix.device.type == "cpu" and key.device.type == "cpu":
        if workspace is not None and workspace.device not in (None,
                                                              pix.device):
            raise ValueError(f"ZBufferWorkspace of {workspace.device} used "
                             f"on {pix.device}")
        if pix.dtype != torch.int32 or key.dtype != torch.float32:
            raise TypeError(f"zbuffer_winners: need int32 pix and float32 "
                            f"key, got {pix.dtype} and {key.dtype}")
        return zbuffer_winners_plain(pix, key, npix)
    if pix.device.type != "cuda" or key.device != pix.device:
        raise ValueError(f"zbuffer_winners: pix on {pix.device}, key on "
                         f"{key.device}; both must be on one CUDA device")
    if pix.dtype != torch.int32 or key.dtype != torch.float32:
        raise TypeError(f"zbuffer_winners: need int32 pix and float32 key, "
                        f"got {pix.dtype} and {key.dtype}")
    if pix.dim() != 1 or key.shape != pix.shape:
        raise ValueError(f"zbuffer_winners: pix {tuple(pix.shape)} and key "
                         f"{tuple(key.shape)} must be one (N,) shape")
    if not (pix.is_contiguous() and key.is_contiguous()):
        raise ValueError("zbuffer_winners: inputs must be contiguous")
    if not 0 < npix < 2**31 or pix.shape[0] >= 2**31:  # int32 winners
        raise ValueError(f"zbuffer_winners: npix {npix} / N {pix.shape[0]} "
                         "out of range")
    ws = ZBufferWorkspace(pix.device) if workspace is None else workspace
    scratch = ws.scratch(npix, pix.device)
    win = torch.empty(npix, dtype=torch.int32, device=pix.device)
    try:
        _build.launch("zbuffer", "lt_zbuffer_winners", pix.data_ptr(),
                      key.data_ptr(), pix.shape[0], npix,
                      scratch.data_ptr(), win.data_ptr(),
                      _build.stream_handle(pix.device))
    except RuntimeError:
        ws.drop()
        raise
    return win


def _check_beam_rows(beam_rows, beam_angles, H):
    """beam_rows assigns row = nearest beam: the image height must equal
    the beam-table length."""
    if beam_rows:
        if beam_angles is None:
            raise ValueError("beam_rows=True requires beam_angles")
        if beam_angles.shape[0] != H:
            raise ValueError(
                f"beam_rows: image height H={H} != {beam_angles.shape[0]} "
                "beam angles")


def _check_winner(winner):
    if winner not in ("depth", "pdist"):
        raise ValueError(f"unknown winner rule {winner!r}")


def range_project(points: torch.Tensor, remissions: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor, *,
                  H: int, W: int, fov_up_deg, fov_down_deg,
                  beam_angles: torch.Tensor | None = None,
                  beam_rows: bool = False, winner: str = "depth",
                  workspace: ZBufferWorkspace | None = None) -> RangeImage:
    """Project a padded point set into an (H,W) spherical range image:
    the nearest valid point per pixel (``winner="depth"``) or the one
    closest to the pixel centre (``winner="pdist"``), first index on ties.

    points (N,3) f32, remissions (N,) f32, labels (N,) i32, valid (N,)
    bool; beam_angles optional (B,) radians; ``workspace`` is handed to
    :func:`zbuffer_winners`.
    """
    _check_winner(winner)
    _check_beam_rows(beam_rows, beam_angles, H)
    pix, key, depth, uf, vf, px, py, valid = _pixel_keys(
        points, valid, fov_up_deg, fov_down_deg, beam_angles,
        H, W, beam_rows, winner)
    win = zbuffer_winners(pix, key, H * W, workspace=workspace)
    has = win >= 0
    g = torch.where(has, win, 0).to(torch.int64)

    def image(values, empty):
        return torch.where(has, values[g], empty).reshape(H, W)

    return RangeImage(
        range=image(depth, 0.0), index=win.reshape(H, W),
        remission=image(remissions.to(torch.float32), -1.0),
        label=image(labels.to(torch.int32), 0),
        u_float=image(uf, 0.0), v_float=image(vf, 0.0),
        point_valid=valid, point_u=px, point_v=py, point_depth=depth)


def project_winner_order(points: torch.Tensor, valid: torch.Tensor, *,
                         H: int, W: int, fov_up_deg, fov_down_deg,
                         beam_angles: torch.Tensor | None = None,
                         beam_rows: bool = False, winner: str = "depth",
                         workspace: ZBufferWorkspace | None = None):
    """The z-buffer's winners in raster order, without assembling images.

    Returns ``(win_idx (H*W,) int32, depth (N,) f32)``: ``win_idx[p]`` is
    the index of pixel p's winning point, -1 where empty. The JAX
    function returns the same winners as the run starts of its sorted
    (pixel, depth) order (``si[is_first]``); that order is pixel order, so
    ``win_idx[win_idx >= 0]`` lists them in the same relative order.
    """
    _check_winner(winner)
    _check_beam_rows(beam_rows, beam_angles, H)
    pix, key, depth, *_ = _pixel_keys(
        points, valid, fov_up_deg, fov_down_deg, beam_angles,
        H, W, beam_rows, winner)
    return zbuffer_winners(pix, key, H * W, workspace=workspace), depth


def reverse_project(image: RangeImage, *, fov_up_deg, fov_down_deg,
                    preserve_float: bool = False) -> torch.Tensor:
    """Back-project a range image to 3D points (H*W, 3); pixels without
    data map to the origin."""
    H, W = image.range.shape
    _, fov_down, fov = fov_radians(fov_up_deg, fov_down_deg)
    if preserve_float:
        u = image.u_float / W
        v = image.v_float / H
    else:
        u = torch.clamp(torch.floor(image.u_float), 0, W - 1) / W
        v = torch.clamp(torch.floor(image.v_float), 0, H - 1) / H
        u = torch.where(image.mask, u, 0.0)
        v = torch.where(image.mask, v, 0.0)
    depth = image.range
    yaw = (u * 2.0 - 1.0) * math.pi
    pitch = math.pi / 2.0 - (fov - v * fov - abs(fov_down))
    x = depth * torch.sin(pitch) * torch.cos(-yaw)
    y = depth * torch.sin(pitch) * torch.sin(-yaw)
    z = depth * torch.cos(pitch)
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def mask_classes(labels: torch.Tensor, valid: torch.Tensor,
                 classes) -> torch.Tensor:
    """Invalidate points whose label is in ``classes`` (masked points can
    never win a pixel, which matches physical removal)."""
    valid = valid.clone()
    for c in classes:
        valid &= labels != c
    return valid
