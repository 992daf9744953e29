"""Batched ray/triangle intersection (Möller–Trumbore) and the mesh
raycast kernel's plain version (PyTorch).

Counterpart of ``lidar_transfer_tpu/ops/triangles.py``: the nearest hit of
each ray in a triangle soup, the lowest triangle index on a tie in t, with
the reference renderer's attribute conventions (label of the hit
triangle's vertex 0, remission the mean of its 3 vertices). The JAX
package sweeps the triangles in chunks under ``lax.scan`` (an XLA loop,
not Pallas); the port casts one ray a thread in a hand-written kernel
(``csrc/mesh_raycast.cu``, through :func:`raycast_mesh` on a CUDA tensor),
and :func:`raycast_mesh_plain` is the same sweep on tensors: what a CPU
tensor runs, and the kernel's oracle on the card. The native BVH of
``native/`` is a second, independent oracle.

Every float is float32 in ``_mt_chunk``'s order: each 3-term dot product is
``(a0*b0 + a1*b1) + a2*b2``, the cross products are ``jnp.cross``'s, and
``1/det`` is a true division; the kernel repeats this arithmetic
(``-fmad=false``), so the two agree bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_transfer_tpu_torch.ops.triangles_cuda import mesh_raycast_cuda

_EPS = 1e-6  # ≡ Triangle.h eps


class MeshHits(NamedTuple):
    t: torch.Tensor       # (R,) f32 nearest-hit distance; inf = miss
    tri: torch.Tensor     # (R,) i32 triangle index; -1 = miss
    hit: torch.Tensor     # (R,) bool


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _mt_chunk(origins, dirs, v0, e1, e2):
    """MT test of all rays against one triangle chunk: origins (R, 3) or
    (1, 3), dirs (R, 3); v0/e1/e2 (C, 3) -> t (R, C), inf for misses."""
    o = [origins[:, k:k + 1] for k in range(3)]
    d = [dirs[:, k:k + 1] for k in range(3)]
    a, b1, b2 = ([x[None, :, k] for k in range(3)] for x in (v0, e1, e2))
    pvec = _cross(d, b2)                           # dir x e2
    det = _dot(pvec, b1)
    big = det.abs() > _EPS
    inv_det = torch.where(big, torch.reciprocal(det), 0.0)
    tvec = [o[k] - a[k] for k in range(3)]
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, b1)
    v = _dot(qvec, d) * inv_det
    t = _dot(qvec, b2) * inv_det
    ok = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _EPS)
    return torch.where(ok, t, torch.inf)


def raycast_mesh_plain(origins: torch.Tensor, dirs: torch.Tensor,
                       triangles: torch.Tensor, chunk: int = 512
                       ) -> MeshHits:
    """Row C's plain version: the triangles swept in chunks of ``chunk``,
    a running min of t over the chunks with strict ``<`` and the first
    index of a chunk's minimum, so the lowest triangle index wins a tie.

    Args:
      origins:   (R, 3) or (3,) f32
      dirs:      (R, 3) f32 unit directions
      triangles: (T, 3, 3) f32 vertices
      chunk:     triangles a step (memory knob; the result is the same)
    """
    R = dirs.shape[0]
    origins = origins.reshape(-1, 3)
    # float32 on the triangles' device, as JAX's numpy forms them
    v0 = triangles[:, 0]
    e1, e2 = triangles[:, 1] - v0, triangles[:, 2] - v0
    best_t = torch.full((R,), torch.inf, dtype=torch.float32,
                        device=dirs.device)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=dirs.device)
    for base in range(0, triangles.shape[0], chunk):
        sl = slice(base, base + chunk)
        tmin, imin = _mt_chunk(origins, dirs, v0[sl], e1[sl],
                               e2[sl]).min(dim=1)
        closer = tmin < best_t
        best_t = torch.where(closer, tmin, best_t)
        best_i = torch.where(closer, imin.to(torch.int32) + base, best_i)
    hit = torch.isfinite(best_t)
    return MeshHits(t=best_t, tri=torch.where(hit, best_i, -1), hit=hit)


def raycast_mesh(origins, dirs, triangles, chunk: int = 512) -> MeshHits:
    """Nearest-hit raycast of R rays against a triangle soup: the kernel
    (``ops/triangles_cuda.mesh_raycast_cuda``) for CUDA tensors, which
    raises for any other device but the CPU, where
    :func:`raycast_mesh_plain` runs.

    Args:
      origins:   (R, 3) or (3,) f32 (moved to the rays' device)
      dirs:      (R, 3) f32 unit directions; their device decides
      triangles: (T, 3, 3) f32 triangle vertices (moved likewise)
      chunk:     the plain version's triangles a step
    """
    dirs = torch.as_tensor(dirs, dtype=torch.float32)
    dev = dirs.device
    R = dirs.shape[0]
    origins = torch.as_tensor(origins, dtype=torch.float32,
                              device=dev).reshape(-1, 3)
    tri = torch.as_tensor(triangles, dtype=torch.float32,
                          device=dev).reshape(-1, 3, 3)
    if tri.shape[0] == 0:
        return MeshHits(
            t=torch.full((R,), torch.inf, dtype=torch.float32, device=dev),
            tri=torch.full((R,), -1, dtype=torch.int32, device=dev),
            hit=torch.zeros((R,), dtype=torch.bool, device=dev))
    if dev.type == "cpu":
        return raycast_mesh_plain(origins, dirs, tri, chunk)
    t, i = mesh_raycast_cuda(origins.contiguous(), dirs.contiguous(),
                             tri.contiguous())
    return MeshHits(t=t, tri=i, hit=i >= 0)


def mesh_hit_attributes(hits: MeshHits, faces, vert_labels, vert_rems
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ray (label i32, remission f32) with the reference's conventions:
    label of vertex 0 (RayTracer.cpp:73-75), mean remission of the 3
    vertices (Triangle.h:63-70); 0 on a miss. On the hits' device."""
    dev = hits.tri.device
    faces = torch.as_tensor(faces, device=dev).to(torch.int64)
    vert_labels = torch.as_tensor(vert_labels, device=dev)
    vert_rems = torch.as_tensor(vert_rems, dtype=torch.float32, device=dev)
    safe = torch.where(hits.hit, hits.tri, 0).to(torch.int64)
    f = faces[safe]                                  # (R, 3)
    label = torch.where(hits.hit, vert_labels[f[:, 0]], 0)
    r = vert_rems[f]
    # numpy's float32 mean: ((r0 + r1) + r2) / 3, a true division (a 0-dim
    # divisor on the device)
    mean = ((r[:, 0] + r[:, 1]) + r[:, 2]) / torch.full(
        (), 3.0, dtype=torch.float32, device=dev)
    rem = torch.where(hits.hit, mean, 0.0)
    return label.to(torch.int32), rem
