"""Wrappers of the mesh raycast's kernels (``csrc/mesh_bvh.cu``,
``csrc/mesh_raycast.cu``).

Replace ``lidar_transfer_tpu/ops/triangles.py::_raycast_mesh_impl`` (an
XLA ``lax.scan`` over triangle chunks with the body ``_mt_chunk``, not
Pallas) on the card: four build kernels make a linear BVH of the
triangles (keys, then ``torch.sort`` of them in ``ops/triangles.
build_bvh``, the hierarchy, the refit, the reorder), and the traversal
casts one ray a thread through it, keeping the nearest hit with the
lowest index on a tie in t, in ``ops/triangles.raycast_mesh_plain``'s
float32 arithmetic. The dense kernel, one thread a ray against every
triangle, is the design the BVH replaced: off the path, the full-frame
oracle on the card. Each wrapper takes CUDA tensors and raises for any
other device (``ops/triangles`` sends a CPU tensor to the plain
versions).
"""

from __future__ import annotations

import torch

from lidar_transfer_tpu_torch import _build

#: node ids are int32 and a BVH of T triangles has 2T - 1 nodes
MAX_TRIANGLES = 2 ** 30
#: entries of a ray's traversal stack (``kStack``; a tree over unique
#: keys below 2^62 has at most 62 internal levels: ``csrc/mesh_raycast.cu``)
STACK = 64
#: tensors the kernels read as float4 rows
_ROWS = ("nodes", "tris")


def _check(fn: str, dev, **tensors) -> None:
    """Each tensor of ``name=(tensor, dtype)`` has its dtype, is
    contiguous and aligned for the kernel's loads, and lies on ``dev``, a
    CUDA device; else ValueError."""
    for name, (x, dtype) in tensors.items():
        if x.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {dtype}, not {x.dtype}")
    if dev.type != "cuda":
        raise ValueError(f"{fn}: tensors on {dev}")
    for name, (x, dtype) in tensors.items():
        if (x.device != dev or not x.is_contiguous()
                or x.data_ptr() % (16 if name in _ROWS
                                   else x.element_size())):
            raise ValueError(f"{fn}: {name} must be a contiguous, aligned "
                             f"tensor on {dev}")


def _triangles(fn: str, triangles: torch.Tensor) -> int:
    if triangles.dim() != 3 or tuple(triangles.shape[1:]) != (3, 3) \
            or not 1 <= triangles.shape[0] < MAX_TRIANGLES:
        raise ValueError(f"{fn}: triangles must be (T, 3, 3), "
                         f"1 <= T < 2^30")
    return triangles.shape[0]


def _rays(fn: str, origins: torch.Tensor, dirs: torch.Tensor) -> int:
    """-> the origins' stride in floats (0: one row shared)."""
    R = dirs.shape[0]
    if dirs.dim() != 2 or dirs.shape[1] != 3 or R >= 2**31:
        raise ValueError(f"{fn}: dirs must be (R, 3), R < 2^31")
    rows = origins.reshape(-1, 3).shape[0] if origins.numel() else 0
    if origins.shape[-1] != 3 or rows not in (1, R):
        raise ValueError(f"{fn}: origins must be (3,), (1, 3) or (R, 3)")
    return 3 if rows == R and R != 1 else 0


def bvh_keys_cuda(triangles: torch.Tensor, scene: torch.Tensor,
                  reach: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The keys kernel: -> (keys (T,) i64 unsorted, padded leaf boxes
    (T, 6) f32), ``ops/triangles.bvh_keys_plain``'s rules."""
    f32 = torch.float32
    _check("bvh_keys_cuda", triangles.device, triangles=(triangles, f32),
           scene=(scene, f32), reach=(reach, f32))
    T = _triangles("bvh_keys_cuda", triangles)
    if scene.numel() != 6 or reach.numel() != 7:
        raise ValueError("bvh_keys_cuda: scene must hold 6 floats, reach 7")
    keys = torch.empty(T, dtype=torch.int64, device=triangles.device)
    boxes = torch.empty((T, 6), dtype=f32, device=triangles.device)
    _build.launch("mesh_bvh_keys", "lt_mesh_bvh_keys", triangles.data_ptr(),
                  T, scene.data_ptr(), reach.data_ptr(), keys.data_ptr(),
                  boxes.data_ptr(), _build.stream_handle(triangles.device))
    return keys, boxes


def bvh_hierarchy_cuda(keys: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hierarchy kernel on the sorted unique keys (T,) i64: -> (nodes
    (T - 1, 16) f32 with each node's child ids in words 12 and 13, the
    rest left to the refit; parents (2T - 1,) i32; arrival counters
    (T - 1,) i32 at 0). T = 1 launches nothing (the root is the leaf)."""
    dev = keys.device
    _check("bvh_hierarchy_cuda", dev, keys=(keys, torch.int64))
    n = keys.shape[0]
    if keys.dim() != 1 or not 1 <= n < MAX_TRIANGLES:
        raise ValueError("bvh_hierarchy_cuda: keys must be (T,), "
                         "1 <= T < 2^30")
    nodes = torch.empty((n - 1, 16), dtype=torch.float32, device=dev)
    counters = torch.empty(n - 1, dtype=torch.int32, device=dev)
    if n == 1:
        return nodes, torch.full((1,), -1, dtype=torch.int32,
                                 device=dev), counters
    parents = torch.empty(2 * n - 1, dtype=torch.int32, device=dev)
    _build.launch("mesh_bvh_hierarchy", "lt_mesh_bvh_hierarchy",
                  keys.data_ptr(), n, nodes.data_ptr(), parents.data_ptr(),
                  counters.data_ptr(), _build.stream_handle(dev))
    return nodes, parents, counters


def bvh_refit_cuda(nodes: torch.Tensor, parents: torch.Tensor,
                   counters: torch.Tensor, leaf_tri: torch.Tensor,
                   boxes: torch.Tensor) -> torch.Tensor:
    """The refit kernel: fills the records of ``nodes`` in place with the
    children's boxes (leaf j's ``boxes[leaf_tri[j]]``) and heights; ->
    the root's height (1,) i32."""
    dev = leaf_tri.device
    i32 = torch.int32
    _check("bvh_refit_cuda", dev, nodes=(nodes, torch.float32),
           parents=(parents, i32), counters=(counters, i32),
           leaf_tri=(leaf_tri, i32), boxes=(boxes, torch.float32))
    n = leaf_tri.shape[0]
    if (not 1 <= n < MAX_TRIANGLES or tuple(nodes.shape) != (n - 1, 16)
            or parents.shape[0] != 2 * n - 1
            or counters.shape[0] != n - 1 or boxes.dim() != 2
            or boxes.shape[1] != 6):
        raise ValueError("bvh_refit_cuda: shapes of a BVH of T leaves: "
                         "nodes (T - 1, 16), parents (2T - 1,), counters "
                         "(T - 1,), leaf_tri (T,), boxes (T, 6)")
    height = torch.empty(1, dtype=i32, device=dev)
    _build.launch("mesh_bvh_refit", "lt_mesh_bvh_refit", nodes.data_ptr(),
                  parents.data_ptr(), counters.data_ptr(),
                  leaf_tri.data_ptr(), boxes.data_ptr(), n,
                  height.data_ptr(), _build.stream_handle(dev))
    return height


def bvh_reorder_cuda(triangles: torch.Tensor, leaf_tri: torch.Tensor
                     ) -> torch.Tensor:
    """The reorder kernel: -> (T, 12) f32, leaf j's triangle as v0, e1,
    e2 and its index (int32 bits), two zeros."""
    dev = triangles.device
    _check("bvh_reorder_cuda", dev, triangles=(triangles, torch.float32),
           leaf_tri=(leaf_tri, torch.int32))
    T = _triangles("bvh_reorder_cuda", triangles)
    if leaf_tri.shape != (T,):
        raise ValueError("bvh_reorder_cuda: leaf_tri must be (T,)")
    out = torch.empty((T, 12), dtype=torch.float32, device=dev)
    _build.launch("mesh_bvh_reorder", "lt_mesh_bvh_reorder",
                  triangles.data_ptr(), leaf_tri.data_ptr(), T,
                  out.data_ptr(), _build.stream_handle(dev))
    return out


def mesh_raycast_cuda(origins: torch.Tensor, dirs: torch.Tensor, bvh
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the traversal: ``origins`` (1, 3), (3,) or (R, 3), ``dirs``
    (R, 3), contiguous float32 on one card, through ``bvh``
    (``ops/triangles.MeshBVH``, built by ``ops/triangles.build_bvh`` with
    these rays' reach). -> (t (R,) f32, inf on a miss; tri (R,) i32, -1 on
    a miss; the kernel's flag (1,) i32, set if a stack would have
    overflowed, which :func:`check_stack` reads)."""
    dev = dirs.device
    f32 = torch.float32
    _check("mesh_raycast_cuda", dev, origins=(origins, f32),
           dirs=(dirs, f32), nodes=(bvh.nodes, f32), tris=(bvh.tris, f32))
    stride = _rays("mesh_raycast_cuda", origins, dirs)
    T = bvh.tris.shape[0]
    if not 1 <= T < MAX_TRIANGLES or tuple(bvh.nodes.shape) != (T - 1, 16):
        raise ValueError("mesh_raycast_cuda: a BVH of T >= 1 triangles "
                         "has nodes (T - 1, 16) and tris (T, 12)")
    R = dirs.shape[0]
    t = torch.empty(R, dtype=f32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.launch("mesh_raycast", "lt_mesh_raycast", bvh.nodes.data_ptr(),
                  bvh.tris.data_ptr(), T, origins.data_ptr(), stride,
                  dirs.data_ptr(), R, t.data_ptr(), tri.data_ptr(),
                  flags.data_ptr(), _build.stream_handle(dev))
    return t, tri, flags


def check_stack(bvh, flags: torch.Tensor) -> None:
    """Wait for the card and raise if the BVH's height exceeds the
    traversal's stack or the kernel set its overflow flag."""
    height, overflow = torch.cat([bvh.height, flags]).tolist()
    if height > STACK or overflow:
        raise RuntimeError(f"mesh_raycast_cuda: the BVH's height {height} "
                           f"exceeds the traversal's stack of {STACK}")


def mesh_raycast_dense_cuda(origins: torch.Tensor, dirs: torch.Tensor,
                            triangles: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dense kernel: ``origins`` (1, 3), (3,) or (R, 3),
    ``dirs`` (R, 3) and ``triangles`` (T, 3, 3), contiguous float32 on one
    card. -> (t (R,) f32, inf on a miss; tri (R,) i32, -1 on a miss)."""
    dev = dirs.device
    f32 = torch.float32
    _check("mesh_raycast_dense_cuda", dev, origins=(origins, f32),
           dirs=(dirs, f32), triangles=(triangles, f32))
    stride = _rays("mesh_raycast_dense_cuda", origins, dirs)
    if triangles.dim() != 3 or tuple(triangles.shape[1:]) != (3, 3) \
            or triangles.shape[0] >= 2**31:
        raise ValueError("mesh_raycast_dense_cuda: triangles must be "
                         "(T, 3, 3), T < 2^31")
    R = dirs.shape[0]
    t = torch.empty(R, dtype=f32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    _build.launch("mesh_raycast_dense", "lt_mesh_raycast_dense",
                  triangles.data_ptr(), triangles.shape[0],
                  origins.data_ptr(), stride, dirs.data_ptr(), R,
                  t.data_ptr(), tri.data_ptr(), _build.stream_handle(dev))
    return t, tri
