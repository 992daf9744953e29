"""Wrappers of the raymarch kernel and its occupancy packing
(``csrc/raymarch.cu``).

Replaces the march of ``lidar_transfer_tpu/ops/raycast.py::_raycast_impl``
(an XLA ``while_loop``, not Pallas) on the card: one thread marches one
ray through the state in its storage dtype (float32, or the compact
bf16/int16/bf16) and the coarse occupancy, with the float32 scalars of
:class:`MarchParams`, which ``ops/raycast.raycast_plain`` uses too. The
thread walks :data:`AHEAD` samples of its ray by the occupancy alone, then
loads the tsdf of the occupied ones together and tests them in order. The
bool occupancy is packed into words of 4 x 4 x 2 cells first
(:func:`pack_occupancy_cuda`, the layout of
``ops/raycast.pack_occupancy_plain``), a launch of its own in every march.
A CUDA tensor launches the kernels; any other device raises
(``ops/raycast.raymarch`` sends a CPU tensor to the plain version).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_transfer_tpu_torch import _build


#: samples a thread walks ahead of their tsdf loads (``kAhead`` in
#: ``csrc/raymarch.cu``)
AHEAD = 16


class MarchParams(NamedTuple):
    """float32 scalars of one march: the box (``lo`` is the volume
    origin), the voxel size, the fine and coarse steps and the refinement
    margin."""

    lo: tuple[float, float, float]
    hi: tuple[float, float, float]
    vox: float
    dt_fine: float
    dt_coarse: float
    margin: float


def words_shape(cells) -> tuple[int, int, int]:
    """The packed occupancy's (wx, wy, wz) words of 4 x 4 x 2 cells for a
    grid of ``cells``."""
    cx, cy, cz = cells
    return -(-cx // 4), -(-cy // 4), -(-cz // 2)


def pack_occupancy_cuda(occ: torch.Tensor) -> torch.Tensor:
    """Launch the packing: the contiguous (cx, cy, cz) bool grid ``occ``
    on the card -> (wx, wy, wz) int32 words (:func:`words_shape`)."""
    if occ.device.type != "cuda":
        raise ValueError(f"pack_occupancy_cuda: occ on {occ.device}")
    if (occ.dtype != torch.bool or occ.dim() != 3
            or not occ.is_contiguous() or occ.numel() >= 2**31):
        raise ValueError("pack_occupancy_cuda: occ must be a contiguous "
                         "3-D bool tensor of fewer than 2^31 cells")
    words = torch.empty(words_shape(occ.shape), dtype=torch.int32,
                        device=occ.device)
    _build.launch("raymarch_pack", "lt_occupancy_bits", occ.data_ptr(),
                  *occ.shape, words.data_ptr(),
                  _build.stream_handle(occ.device))
    return words


def raymarch_cuda(state, occ: torch.Tensor, rays: torch.Tensor,
                  origin: torch.Tensor, prm: MarchParams, dims, block: int,
                  max_steps: int):
    """Launch the packing of ``occ`` and the march: ``state`` a TSDF state
    (tsdf, label and rem read), ``occ`` the bool occupancy of ``block``³
    cells, ``rays`` (R, 3), ``origin`` (3,) or (R, 3). -> (range, label
    i32, remission, endpoints (R, 3), hit), each per ray."""
    compact = _check(state, occ, rays, origin, dims, block)
    R = rays.shape[0]
    dev = rays.device
    words = pack_occupancy_cuda(occ)
    out = (torch.empty(R, dtype=torch.float32, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, dtype=torch.float32, device=dev),
           torch.empty((R, 3), dtype=torch.float32, device=dev),
           torch.empty(R, dtype=torch.bool, device=dev))
    _build.launch(
        "raymarch", "lt_raymarch", state.tsdf.data_ptr(),
        state.label.data_ptr(), state.rem.data_ptr(), words.data_ptr(),
        rays.data_ptr(), origin.data_ptr(), int(compact), R,
        3 if origin.dim() == 2 else 0, *dims, *occ.shape, block, max_steps,
        *prm.lo, *prm.hi, prm.vox, prm.dt_fine, prm.dt_coarse, prm.margin,
        *(t.data_ptr() for t in out), _build.stream_handle(dev))
    return out


def _check(state, occ, rays, origin, dims, block) -> bool:
    """Raise unless the inputs are what the kernel takes; -> compact."""
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"raymarch_cuda: rays on {dev}")
    dts = (state.tsdf.dtype, state.label.dtype, state.rem.dtype)
    compact = dts == (torch.bfloat16, torch.int16, torch.bfloat16)
    if not compact and dts != (torch.float32, torch.int32, torch.float32):
        raise ValueError(f"raymarch_cuda: state dtypes {dts} are neither "
                         "float32 nor compact")
    for name, t in (("tsdf", state.tsdf), ("label", state.label),
                    ("rem", state.rem)):
        if (t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != tuple(dims)):
            raise ValueError(f"raymarch_cuda: state.{name} must be a "
                             f"contiguous {tuple(dims)} tensor on {dev}")
    cells = tuple(-(-d // block) for d in dims)
    if (occ.device != dev or occ.dtype != torch.bool
            or not occ.is_contiguous() or tuple(occ.shape) != cells):
        raise ValueError(f"raymarch_cuda: occ must be a contiguous bool "
                         f"{cells} tensor on {dev}")
    if (rays.dtype != torch.float32 or rays.dim() != 2
            or rays.shape[1] != 3 or not rays.is_contiguous()):
        raise ValueError("raymarch_cuda: rays must be a contiguous (R, 3) "
                         "float32 tensor")
    if (origin.device != dev or origin.dtype != torch.float32
            or not origin.is_contiguous()
            or tuple(origin.shape) not in ((3,), (rays.shape[0], 3))):
        raise ValueError("raymarch_cuda: origin must be a contiguous (3,) "
                         "or (R, 3) float32 tensor on the rays' device")
    if (min(dims) < 2 or block < 1 or rays.shape[0] >= 2**31
            or dims[0] * dims[1] * dims[2] >= 2**32):
        raise ValueError(f"raymarch_cuda: dims {tuple(dims)}, block "
                         f"{block} or R out of range")
    return compact
