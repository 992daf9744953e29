"""Wrapper of the mesh raycast kernel (``csrc/mesh_raycast.cu``).

Replaces ``lidar_transfer_tpu/ops/triangles.py::_raycast_mesh_impl`` (an
XLA ``lax.scan`` over triangle chunks with the body ``_mt_chunk``, not
Pallas) on the card: one thread casts one ray against every triangle,
which the block stages through shared memory in tiles, and keeps the
nearest hit with the lowest index on a tie, in
``ops/triangles.raycast_mesh_plain``'s float32 arithmetic. A CUDA tensor
launches the kernel; any other device raises (``ops/triangles.
raycast_mesh`` sends a CPU tensor to the plain version).
"""

from __future__ import annotations

import torch

from lidar_transfer_tpu_torch import _build


def mesh_raycast_cuda(origins: torch.Tensor, dirs: torch.Tensor,
                      triangles: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``origins`` (1, 3), (3,) or (R, 3), ``dirs``
    (R, 3) and ``triangles`` (T, 3, 3), contiguous float32 on one card.
    -> (t (R,) f32, inf on a miss; tri (R,) i32, -1 on a miss)."""
    dev = dirs.device
    if dev.type != "cuda":
        raise ValueError(f"mesh_raycast_cuda: dirs on {dev}")
    for name, x in (("origins", origins), ("dirs", dirs),
                    ("triangles", triangles)):
        if (x.device != dev or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"mesh_raycast_cuda: {name} must be a "
                             f"contiguous float32 tensor on {dev}")
    R = dirs.shape[0]
    if dirs.dim() != 2 or dirs.shape[1] != 3 or R >= 2**31:
        raise ValueError("mesh_raycast_cuda: dirs must be (R, 3), "
                         "R < 2^31")
    if triangles.dim() != 3 or tuple(triangles.shape[1:]) != (3, 3) \
            or triangles.shape[0] >= 2**31:
        raise ValueError("mesh_raycast_cuda: triangles must be (T, 3, 3), "
                         "T < 2^31")
    rows = origins.reshape(-1, 3).shape[0] if origins.numel() else 0
    if origins.shape[-1] != 3 or rows not in (1, R):
        raise ValueError("mesh_raycast_cuda: origins must be (3,), (1, 3) "
                         "or (R, 3)")
    t = torch.empty(R, dtype=torch.float32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    _build.launch("mesh_raycast", "lt_mesh_raycast", triangles.data_ptr(),
                  triangles.shape[0], origins.data_ptr(),
                  3 if rows == R and R != 1 else 0, dirs.data_ptr(), R,
                  t.data_ptr(), tri.data_ptr(), _build.stream_handle(dev))
    return t, tri
