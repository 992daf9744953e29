"""Batched ray/triangle intersection (Möller–Trumbore), the mesh BVH, and
the plain versions (PyTorch) of the mesh raycast's kernels.

Counterpart of ``lidar_transfer_tpu/ops/triangles.py``: the nearest hit of
each ray in a triangle soup, the lowest triangle index on a tie in t, with
the reference renderer's attribute conventions (label of the hit
triangle's vertex 0, remission the mean of its 3 vertices). The JAX
package sweeps the triangles in chunks under ``lax.scan`` (an XLA loop,
not Pallas). On the card the port builds a linear BVH every call (the
mesh is new every frame) with the kernels of ``csrc/mesh_bvh.cu`` and
casts one ray a thread through it (``csrc/mesh_raycast.cu``), through
:func:`raycast_mesh` on a CUDA tensor. :func:`raycast_mesh_plain` is the
dense sweep on tensors: what a CPU tensor runs, and the function's oracle
on the card. :func:`build_bvh_plain` and :func:`raycast_mesh_bvh_plain`
are the build's and the traversal's plain versions, which hold their
rules on the CPU. The native BVH of ``native/`` is a second, independent
oracle.

Every float is float32 in ``_mt_chunk``'s order: each 3-term dot product is
``(a0*b0 + a1*b1) + a2*b2``, the cross products are ``jnp.cross``'s, and
``1/det`` is a true division; the kernels repeat this arithmetic
(``-fmad=false``), so they agree with the plain versions bit for bit on
the card.

The BVH (Karras, "Maximizing parallelism in the construction of BVHs,
octrees, and k-d trees", HPG 2012) is a function of its inputs alone:
each triangle's key is the 30-bit Morton code of its box's centre over the
scene's box, shifted up 32 bits, with the triangle's index in the low 32
bits, so the keys are unique; the sorted keys give the leaf order, the
hierarchy follows from the keys' common prefixes, and each node's box is
the exact union of its children's. Each leaf's box is the triangle's
exact box padded by :func:`bvh_keys_plain`'s margin, which covers every
point ``o + t d`` at which the float32 test above accepts a hit (the
bound is derived there), and the slab test is made conservative, so a
node is skipped only when no triangle in it can give the nearest hit: the
traversal returns exactly what the dense sweep returns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_transfer_tpu_torch.ops import triangles_cuda as TC

_EPS = 1e-6  # ≡ Triangle.h eps
#: entries of a ray's traversal stack, the kernel's
STACK = TC.STACK
#: Morton cells an axis (10 bits)
MORTON_CELLS = 1024
#: the leaf margin's factors (:func:`bvh_keys_plain`): C1 covers
#: 7 eps / 1e-6 (0.41723) with room for the margin's own rounding, C2 and
#: C3 are 2^-22 (4 eps)
_C1, _C2, _C3 = 0.4375, 2.0 ** -22, 2.0 ** -22
#: the slab test's factors: t_near scaled down, t_far up, by 2^-20 (> the
#: 3 eps of (lo - o) * (1/d) and the eps of the scaling)
_NEAR, _FAR = 1.0 - 2.0 ** -20, 1.0 + 2.0 ** -20


class MeshHits(NamedTuple):
    t: torch.Tensor       # (R,) f32 nearest-hit distance; inf = miss
    tri: torch.Tensor     # (R,) i32 triangle index; -1 = miss
    hit: torch.Tensor     # (R,) bool


class MeshBVH(NamedTuple):
    """A linear BVH over T triangles: T - 1 internal nodes (0 is the root)
    and T leaves; node ids below T - 1 are internal, id T - 1 + j is leaf
    j. With T = 1 the root is leaf 0."""

    #: (T - 1, 16) f32, one row an internal node: its left child's box
    #: (lo xyz, hi xyz), its right child's, then as int32 bits the two
    #: child ids and the two children's heights (0 for a leaf)
    nodes: torch.Tensor
    parents: torch.Tensor    # (2T - 1,) i32 parent of each node; root -1
    leaf_tri: torch.Tensor   # (T,) i32 triangle index of leaf j
    #: (T, 12) f32 leaf j's triangle as v0, e1 = v1 - v0, e2 = v2 - v0,
    #: its index as int32 bits, two zeros
    tris: torch.Tensor
    keys: torch.Tensor       # (T,) i64 sorted keys
    height: torch.Tensor     # (1,) i32 edges from the root to its deepest leaf


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _mt(o, d, a, b1, b2):
    """The MT test on broadcast components (each argument three tensors):
    -> t, inf where the ray misses."""
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


def _mt_chunk(origins, dirs, v0, e1, e2):
    """MT test of all rays against one triangle chunk: origins (R, 3) or
    (1, 3), dirs (R, 3); v0/e1/e2 (C, 3) -> t (R, C), inf for misses."""
    return _mt([origins[:, k:k + 1] for k in range(3)],
               [dirs[:, k:k + 1] for k in range(3)],
               *([x[None, :, k] for k in range(3)] for x in (v0, e1, e2)))


def raycast_mesh_plain(origins: torch.Tensor, dirs: torch.Tensor,
                       triangles: torch.Tensor, chunk: int = 512
                       ) -> MeshHits:
    """Row C's plain version, the dense sweep: the triangles swept in chunks
    of ``chunk``, a running min of t over the chunks with strict ``<`` and
    the first index of a chunk's minimum, so the lowest triangle index wins
    a tie.

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


# ------------------------------------------------------------------ the BVH
def ray_reach(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """What the leaf margin needs of the rays: (7,) f32, the origins' box
    (lo xyz, hi xyz) and the largest |direction component|."""
    lo, hi = torch.aminmax(origins.reshape(-1, 3), dim=0)
    return torch.cat([lo, hi, dirs.abs().amax().reshape(1)])


def scene_scale(triangles: torch.Tensor) -> torch.Tensor:
    """The Morton grid over the vertices' box: (6,) f32, its lo corner and
    the cells a metre on each axis (0 on an axis of no extent)."""
    lo, hi = torch.aminmax(triangles.reshape(-1, 3), dim=0)
    scale = MORTON_CELLS / (hi - lo)
    scale = torch.where(torch.isfinite(scale) & (hi > lo), scale, 0.0)
    return torch.cat([lo, scale])


def _spread10(x):
    """The 10 low bits of int64 ``x`` spread to every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def bvh_keys_plain(triangles: torch.Tensor, scene: torch.Tensor,
                   reach: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The keys kernel's plain version: -> (keys (T,) i64 unsorted, padded
    leaf boxes (T, 6) f32 lo xyz, hi xyz), one a triangle.

    The key is the Morton code of the triangle's box centre on
    :func:`scene_scale`'s grid, shifted up 32 bits, or'd with its index.

    The margin. Where the float32 MT test of ``_mt`` accepts a ray (o, d)
    at t, the point X = o + t d (in exact arithmetic) lies within m_a of
    the triangle's exact box on each axis a. With the rounded inputs
    s = o - v0, e1, e2 (exact from there on), eps = 2^-24, and the
    identity det s + Nt d - Nu e1 - Nv e2 = 0 between the four triple
    products of the test (det = e1.(d x e2), Nu = s.(d x e2),
    Nv = d.(s x e1), Nt = e2.(s x e1), t = Nt/det and so on): each triple
    product, a cross product and a dot in that order, is computed within
    5 eps of the sum P of the absolute values of its six terms, and each
    of t, u, v is Nx * fl(1/det) within 2 eps, so the residual
    r = s + t d - u e1 - v e2 has
        |det| |r_a| <= 7 eps (P_det S_a + P_t D + P_u |e1_a| + P_v |e2_a|)
    (O(eps^2) dropped), where S_a bounds |s_a| over the origins, D every
    |d_a|, and P_det <= D Q12, P_u <= D Qs2, P_v <= D Qs1, P_t <= Tt with
    Q12 = sum over i != j of |e1_i| |e2_j|, Qs2 and Qs1 the same with S
    for e1, and Tt = sum over distinct i, j, k of S_i |e1_j| |e2_k|. A hit
    has |det| > 1e-6, and X - (v0 + u e1 + v e2) = r plus the inputs'
    rounding (eps |s_a| + eps (|e1_a| + |e2_a|)); u, v >= 0 and u + v <=
    1 + eps put v0 + u e1 + v e2 in the triangle, up to eps (|e1_a| +
    |e2_a|). Hence
        m_a = C1 D (Q12 S_a + Tt + Qs2 |e1_a| + Qs1 |e2_a|)
              + C2 (S_a + |e1_a| + |e2_a|)
    with C1 = 7/16 >= 7 eps / 1e-6 (0.41723; the rest is room for the
    margin's own rounding) and C2 = 4 eps, and the box's corners move out
    by m_a + 4 eps |corner|, which covers their rounding. (Finite inputs
    in float32's normal range; a grazing ray, |det| near 1e-6, is what
    makes the bound this large.)
    """
    T = triangles.shape[0]
    v0, v1, v2 = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    q = ((lo + hi) * 0.5 - scene[:3]) * scene[3:]
    q = q.clamp(0.0, MORTON_CELLS - 1).to(torch.int64)
    morton = ((_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1)
              | _spread10(q[:, 2]))
    keys = (morton << 32) | torch.arange(T, device=triangles.device)
    a1, a2 = (v1 - v0).abs(), (v2 - v0).abs()
    S = torch.maximum((reach[:3] - v0).abs(), (reach[3:6] - v0).abs())
    x, y, z = 0, 1, 2

    def pairs(p, w):
        """sum over i != j of p_i w_j"""
        return ((p[:, x] * (w[:, y] + w[:, z])
                 + p[:, y] * (w[:, x] + w[:, z]))
                + p[:, z] * (w[:, x] + w[:, y]))

    q12, qs2, qs1 = pairs(a1, a2), pairs(S, a2), pairs(S, a1)
    tt = ((S[:, x] * (a1[:, y] * a2[:, z] + a1[:, z] * a2[:, y])
           + S[:, y] * (a1[:, x] * a2[:, z] + a1[:, z] * a2[:, x]))
          + S[:, z] * (a1[:, x] * a2[:, y] + a1[:, y] * a2[:, x]))
    m = ((((q12[:, None] * S + tt[:, None]) + qs2[:, None] * a1)
          + qs1[:, None] * a2) * reach[6]) * _C1 + ((S + a1) + a2) * _C2
    boxes = torch.cat([lo - (m + lo.abs() * _C3),
                       hi + (m + hi.abs() * _C3)], dim=1)
    return keys, boxes


def _clz64(x):
    """Leading zeros of int64 ``x`` >= 0 (64 for 0)."""
    msb = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        msb = torch.where((x >> (msb + s)) != 0, msb + s, msb)
    return torch.where(x == 0, 64, 63 - msb)


def bvh_hierarchy_plain(keys: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hierarchy kernel's plain version on the sorted unique keys:
    -> (children (T - 1, 2) i64, parents (2T - 1,) i32). Karras's rules,
    every internal node at once: its direction from the keys' common
    prefixes with its neighbours, its range's far end by doubling and then
    halving steps, the split by halving steps."""
    n = keys.shape[0]
    m = n - 1
    dev = keys.device
    i = torch.arange(m, device=dev)

    def delta(j):
        ok = (j >= 0) & (j < n)
        return torch.where(ok, _clz64(keys[i] ^ keys[j.clamp(0, n - 1)]),
                           -1)

    d = torch.where(delta(i + 1) - delta(i - 1) >= 0, 1, -1)
    dmin = delta(i - d)
    lmax = torch.full_like(i, 2)
    grow = delta(i + lmax * d) > dmin
    while bool(grow.any()):
        lmax = torch.where(grow, lmax * 2, lmax)
        grow = grow & (delta(i + lmax * d) > dmin)
    ln = torch.zeros_like(i)
    t = lmax // 2
    while bool((t >= 1).any()):
        step = (t >= 1) & (delta(i + (ln + t) * d) > dmin)
        ln = torch.where(step, ln + t, ln)
        t = t // 2
    j = i + ln * d
    dnode = delta(j)
    s = torch.zeros_like(i)
    t = ln.clone()
    act = torch.ones_like(i, dtype=torch.bool)
    while bool(act.any()):
        t = torch.where(act, (t + 1) >> 1, t)
        step = act & (delta(i + (s + t) * d) > dnode)
        s = torch.where(step, s + t, s)
        act = act & (t > 1)
    gamma = i + s * d + torch.clamp(d, max=0)
    left = torch.where(torch.minimum(i, j) == gamma, gamma + m, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, gamma + 1 + m,
                        gamma + 1)
    children = torch.stack([left, right], dim=1)
    parents = torch.full((2 * n - 1,), -1, dtype=torch.int32, device=dev)
    parents[children.reshape(-1)] = i.repeat_interleave(2).to(torch.int32)
    return children, parents


def bvh_refit_plain(children: torch.Tensor, leaf_boxes: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The refit kernel's plain version, level by level from the deepest:
    each internal node's record holds its children's boxes (a leaf's from
    ``leaf_boxes``, (T, 6) in leaf order; an internal child's the union of
    its own two), the child ids and their heights. -> (nodes (T - 1, 16)
    f32, height (1,) i32)."""
    m = children.shape[0]
    dev = leaf_boxes.device
    nodes = torch.zeros((m, 16), dtype=torch.float32, device=dev)
    ints = nodes.view(torch.int32)
    ints[:, 12:14] = children.to(torch.int32)
    box = torch.zeros((m, 6), dtype=torch.float32, device=dev)
    height = torch.zeros(m, dtype=torch.int64, device=dev)
    levels = []
    front = torch.zeros(min(m, 1), dtype=torch.int64, device=dev)
    while front.numel():
        levels.append(front)
        c = children[front].reshape(-1)
        front = c[c < m]
    for lvl in reversed(levels):
        cb, ch = [], []
        for k in range(2):
            c = children[lvl, k]
            leaf = c >= m
            cb.append(torch.where(leaf[:, None],
                                  leaf_boxes[(c - m).clamp(min=0)],
                                  box[c.clamp(max=m - 1)]))
            ch.append(torch.where(leaf, 0, height[c.clamp(max=m - 1)]))
            nodes[lvl, 6 * k:6 * k + 6] = cb[k]
            ints[lvl, 14 + k] = ch[k].to(torch.int32)
        box[lvl] = torch.cat([torch.minimum(cb[0][:, :3], cb[1][:, :3]),
                              torch.maximum(cb[0][:, 3:], cb[1][:, 3:])], 1)
        height[lvl] = 1 + torch.maximum(ch[0], ch[1])
    top = height[:1] if m else torch.zeros(1, dtype=torch.int64, device=dev)
    return nodes, top.to(torch.int32)


def bvh_reorder_plain(triangles: torch.Tensor, leaf_tri: torch.Tensor
                      ) -> torch.Tensor:
    """The reorder kernel's plain version: -> (T, 12) f32, leaf j's
    triangle as v0, e1, e2 (formed as :func:`raycast_mesh_plain` forms
    them), its index as int32 bits and two zeros."""
    tri = triangles[leaf_tri.to(torch.int64)]
    v0 = tri[:, 0]
    out = torch.zeros((tri.shape[0], 12), dtype=torch.float32,
                      device=tri.device)
    out[:, 0:3], out[:, 3:6], out[:, 6:9] = v0, tri[:, 1] - v0, tri[:, 2] - v0
    out.view(torch.int32)[:, 9] = leaf_tri
    return out


def leaf_order(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort between the keys and the hierarchy (``torch.sort``, glue
    around the kernels): -> (sorted keys, leaf_tri (T,) i32)."""
    keys = torch.sort(keys).values
    return keys, (keys & 0xFFFFFFFF).to(torch.int32)


def _float32(fn: str, **tensors) -> None:
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, not {x.dtype}")


def build_bvh_plain(triangles: torch.Tensor, reach: torch.Tensor
                    ) -> MeshBVH:
    """The BVH on tensors, as the build kernels make it: keys, a sort,
    the hierarchy, the refit and the reorder. ``triangles`` (T, 3, 3) f32,
    T >= 1; ``reach`` (7,) f32, :func:`ray_reach` of the rays it will be
    cast with (any rays whose origins lie in its box and whose direction
    components are no larger)."""
    _float32("build_bvh_plain", triangles=triangles, reach=reach)
    keys, boxes = bvh_keys_plain(triangles, scene_scale(triangles), reach)
    keys, leaf_tri = leaf_order(keys)
    children, parents = bvh_hierarchy_plain(keys)
    nodes, height = bvh_refit_plain(children,
                                    boxes[leaf_tri.to(torch.int64)])
    return MeshBVH(nodes, parents, leaf_tri,
                   bvh_reorder_plain(triangles, leaf_tri), keys, height)


def build_bvh(triangles: torch.Tensor, reach: torch.Tensor) -> MeshBVH:
    """The BVH of ``triangles`` (T, 3, 3) f32, T >= 1: on a CUDA tensor by
    the build kernels (``csrc/mesh_bvh.cu``) with ``torch.sort`` between
    the keys and the hierarchy, which raise for any other device but the
    CPU, where :func:`build_bvh_plain` runs."""
    if triangles.device.type == "cpu":
        return build_bvh_plain(triangles, reach)
    keys, boxes = TC.bvh_keys_cuda(triangles, scene_scale(triangles), reach)
    keys, leaf_tri = leaf_order(keys)
    nodes, parents, counters = TC.bvh_hierarchy_cuda(keys)
    height = TC.bvh_refit_cuda(nodes, parents, counters, leaf_tri, boxes)
    return MeshBVH(nodes, parents, leaf_tri,
                   TC.bvh_reorder_cuda(triangles, leaf_tri), keys, height)


def _slab(lo, hi, o, inv, neg):
    """The conservative slab test of the traversal: -> (t_near, t_far) of
    the box on each ray. A direction component of 0 gives +-inf, and NaN
    where the origin lies on the box's plane, which ``fmax``/``fmin``
    drop (the plane constrains nothing then)."""
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    near, far = torch.where(neg, t1, t0), torch.where(neg, t0, t1)
    tn = torch.full_like(near[:, 0], -torch.inf)
    tf = torch.full_like(near[:, 0], torch.inf)
    for a in range(3):
        tn, tf = torch.fmax(tn, near[:, a]), torch.fmin(tf, far[:, a])
    return torch.fmax(tn * _NEAR, torch.zeros_like(tn)), tf * _FAR


def raycast_mesh_bvh_plain(origins: torch.Tensor, dirs: torch.Tensor,
                           bvh: MeshBVH, stats: dict | None = None
                           ) -> MeshHits:
    """The traversal kernel's plain version, a wavefront on tensors: each
    step every ray that is not done reads one internal node and tests its
    two children's boxes; a leaf whose box the ray enters no later than
    its best t is tested at once, and of two internal children the nearer
    is taken and the other pushed with its entry t on the ray's stack, an
    (R, ``STACK``) tensor; a ray that takes neither pops until an entry
    is no later than its best t. A hit replaces the best on a smaller t,
    or on an equal t with a smaller triangle index, so the result is the
    dense sweep's (:func:`raycast_mesh_plain`). ``stats`` receives the
    internal nodes read (``"nodes"``) and the triangles tested
    (``"tests"``) a ray, (R,) i64.

    Args:
      origins: (R, 3) or (3,) f32
      dirs:    (R, 3) f32
      bvh:     :func:`build_bvh_plain` of the triangles, with the
               :func:`ray_reach` of these rays
    """
    _float32("raycast_mesh_bvh_plain", origins=origins, dirs=dirs)
    dev = dirs.device
    R = dirs.shape[0]
    orig = origins.reshape(-1, 3)
    per_ray = orig.shape[0] != 1
    T = bvh.tris.shape[0]
    m = T - 1
    tri_idx = bvh.tris.view(torch.int32)[:, 9].to(torch.int64)
    best_t = torch.full((R,), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((R,), -1, dtype=torch.int64, device=dev)
    n_nodes = torch.zeros(R, dtype=torch.int64, device=dev)
    n_tests = torch.zeros(R, dtype=torch.int64, device=dev)
    inv = torch.reciprocal(dirs)
    neg = torch.signbit(inv)

    def origin(rays):
        return orig[rays] if per_ray else orig.expand(rays.shape[0], 3)

    def test(rays, leaf):
        row = bvh.tris[leaf]
        o, d = origin(rays), dirs[rays]
        t = _mt([o[:, k] for k in range(3)], [d[:, k] for k in range(3)],
                *([row[:, b + k] for k in range(3)] for b in (0, 3, 6)))
        idx = tri_idx[leaf]
        bt, bi = best_t[rays], best_i[rays]
        better = (t < bt) | ((t == bt) & (idx < bi))
        best_t[rays] = torch.where(better, t, bt)
        best_i[rays] = torch.where(better, idx, bi)
        n_tests[rays] += 1

    if m == 0:
        test(torch.arange(R, device=dev),
             torch.zeros(R, dtype=torch.int64, device=dev))
    else:
        ints = bvh.nodes.view(torch.int32)
        node = torch.zeros(R, dtype=torch.int64, device=dev)
        active = torch.ones(R, dtype=torch.bool, device=dev)
        stack = torch.zeros((R, STACK), dtype=torch.int64, device=dev)
        stack_t = torch.zeros((R, STACK), dtype=torch.float32, device=dev)
        sp = torch.zeros(R, dtype=torch.int64, device=dev)
        while True:
            a = active.nonzero().squeeze(1)
            if a.numel() == 0:
                break
            rec = bvh.nodes[node[a]]
            cl = ints[node[a], 12].to(torch.int64)
            cr = ints[node[a], 13].to(torch.int64)
            o, iv, ng = origin(a), inv[a], neg[a]
            n_nodes[a] += 1
            tnl, tfl = _slab(rec[:, 0:3], rec[:, 3:6], o, iv, ng)
            tnr, tfr = _slab(rec[:, 6:9], rec[:, 9:12], o, iv, ng)
            hl = (tnl <= tfl) & (tnl <= best_t[a])
            hr = (tnr <= tfr) & (tnr <= best_t[a])
            leaf = hl & (cl >= m)
            test(a[leaf], cl[leaf] - m)
            hl = hl & ~leaf
            leaf = hr & (cr >= m) & (tnr <= best_t[a])
            test(a[leaf], cr[leaf] - m)
            hr = hr & (cr < m)
            hl = hl & (tnl <= best_t[a])
            hr = hr & (tnr <= best_t[a])
            both = hl & hr
            near_l = tnl <= tnr
            nxt = torch.where(hl, cl, torch.where(hr, cr, -1))
            nxt = torch.where(both, torch.where(near_l, cl, cr), nxt)
            pb = a[both]
            if pb.numel():
                if bool((sp[pb] >= STACK).any()):
                    raise RuntimeError("raycast_mesh_bvh_plain: a ray's "
                                       f"stack exceeded {STACK} entries")
                far = torch.where(near_l, cr, cl)[both]
                far_t = torch.where(near_l, tnr, tnl)[both]
                stack[pb, sp[pb]] = far
                stack_t[pb, sp[pb]] = far_t
                sp[pb] += 1
            node[a] = nxt
            pop = a[nxt < 0]
            while pop.numel():
                empty = sp[pop] == 0
                active[pop[empty]] = False
                pop = pop[~empty]
                sp[pop] -= 1
                c, ct = stack[pop, sp[pop]], stack_t[pop, sp[pop]]
                ok = ct <= best_t[pop]
                node[pop[ok]] = c[ok]
                pop = pop[~ok]
    if stats is not None:
        stats["nodes"], stats["tests"] = n_nodes, n_tests
    hit = torch.isfinite(best_t)
    return MeshHits(t=best_t, tri=torch.where(hit, best_i, -1).to(
        torch.int32), hit=hit)


def raycast_mesh(origins, dirs, triangles, chunk: int = 512) -> MeshHits:
    """Nearest-hit raycast of R rays against a triangle soup. On a CUDA
    tensor the BVH of the triangles is built (:func:`build_bvh`) and the
    traversal kernel launched once (``ops/triangles_cuda.
    mesh_raycast_cuda``); both raise for any other device but the CPU,
    where the dense sweep :func:`raycast_mesh_plain` runs.

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
    if tri.shape[0] == 0 or R == 0:
        return MeshHits(
            t=torch.full((R,), torch.inf, dtype=torch.float32, device=dev),
            tri=torch.full((R,), -1, dtype=torch.int32, device=dev),
            hit=torch.zeros((R,), dtype=torch.bool, device=dev))
    if dev.type == "cpu":
        return raycast_mesh_plain(origins, dirs, tri, chunk)
    origins, dirs, tri = (x.contiguous() for x in (origins, dirs, tri))
    bvh = build_bvh(tri, ray_reach(origins, dirs))
    t, i, flags = TC.mesh_raycast_cuda(origins, dirs, bvh)
    TC.check_stack(bvh, flags)
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
