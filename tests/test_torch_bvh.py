"""Row C's BVH (``ops/triangles``: ``build_bvh_plain`` and
``raycast_mesh_bvh_plain``, the plain versions of ``csrc/mesh_bvh.cu``'s
build kernels and of ``csrc/mesh_raycast.cu``'s traversal) on the CPU.

The build is held to its rules: every triangle in one leaf, every node's
box the union of its children's, every leaf's box its triangle's padded by
at least the margin ``bvh_keys_plain`` derives, the height within the
traversal's stack, two builds equal. The traversal is held to
``raycast_mesh_plain``, the dense sweep and the function's oracle, bit for
bit (t, triangle index, hit), ties to the lower index included: on soups
with copies, degenerate triangles and triangles of one centroid, on a
heightfield with rays through its vertices and shared edges and along its
edges, on axis-aligned rays and rays with zero components, from origins
on box faces and inside boxes, on grazing rays, and on the catmesh oracle
engine's mesh at ``tests/test_torch_catmesh_oracle.py``'s size. Against
``lidar_transfer_tpu/ops/triangles.py::raycast_mesh`` it keeps
``tests/test_torch_triangles.py``'s tolerance: hit exact, t within
``RTOL`` relative (XLA's CPU code contracts ``_mt_chunk``'s products into
FMAs), tri exact except where JAX's t of the two winners lie within that
tolerance. The kernels run on the card only: ``chip_smoke.py`` holds them
to these plain versions there.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lidar_transfer_tpu.ops import triangles as JT
from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
from lidar_transfer_tpu_torch.datasets import kitti
from lidar_transfer_tpu_torch.ops import triangles as TT
from lidar_transfer_tpu_torch.ops import triangles_cuda as TC
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.pipeline import multiscan as TM
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import narrow_spec, shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


#: t against JAX's (``tests/test_torch_triangles.py``)
RTOL, ATOL = 1e-5, 1e-6
#: the margin the float32 test needs, 7 eps / 1e-6 on the products and
#: eps on the rest (``bvh_keys_plain``), evaluated in float64
NEED_C1, NEED_C2 = 7 * 2.0 ** -24 / 0.999999e-6, 2.0 ** -24
SIZES = (1, 2, 3, 512, 5003)


def _unit(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _soup(T, seed=0, spread=2.0, size=0.08):
    """T random triangles, every 11th degenerate (its three vertices on a
    line, or one point), every 5th moved to one centroid, then exact
    copies of every 7th: -> (T', 3, 3) f32, T' = T + ceil(T / 7)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (T, 3))
    tri = c[:, None, :] + rng.normal(0, size, (T, 3, 3))
    c0 = np.array([0.31, -0.17, 0.4])
    one = tri[::5] - tri[::5].mean(1, keepdims=True) + c0
    tri[::5] = one
    deg = tri[3::11]
    deg[:, 2] = deg[:, 0] + 0.5 * (deg[:, 1] - deg[:, 0])
    tri[3::11] = deg
    tri[7::11] = tri[7::11, :1]
    tri = tri.astype(np.float32)
    return np.concatenate([tri, tri[::7]])


def _rays(n, seed, per_ray):
    rng = np.random.default_rng(seed + 100)
    d = _unit(rng.normal(size=(n, 3)))
    o = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) if per_ray
         else np.zeros(3, np.float32))
    return torch.from_numpy(o), torch.from_numpy(d)


def _traverse(o, d, tri, reach=None, stats=None):
    """-> (BVH route on the CPU, dense sweep), both MeshHits."""
    tri = torch.as_tensor(tri)
    reach = TT.ray_reach(o, d) if reach is None else reach
    bvh = TT.build_bvh_plain(tri, reach)
    got = TT.raycast_mesh_bvh_plain(o, d, bvh, stats)
    return got, TT.raycast_mesh_plain(o, d, tri)


def _assert_equal(got, ref):
    for name, a, b in zip(("t", "tri", "hit"), got, ref):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), (name, int((a != b).sum()))


def _needed_margin(tri, reach):
    """(T, 3) float64: the margin the float32 MT test needs on each axis,
    from the rounded edges and the bound on |o - v0|."""
    t = tri.astype(np.float32)
    v0 = t[:, 0].astype(np.float64)
    a1 = np.abs(t[:, 1] - t[:, 0]).astype(np.float64)
    a2 = np.abs(t[:, 2] - t[:, 0]).astype(np.float64)
    r = np.asarray(reach, np.float64)
    S = np.maximum(np.abs(r[:3] - v0), np.abs(r[3:6] - v0)) * (1 + 2**-23)
    D = r[6]

    def pairs(p, w):
        return sum(p[:, i] * w[:, j] for i in range(3) for j in range(3)
                   if i != j)

    q12, qs2, qs1 = pairs(a1, a2), pairs(S, a2), pairs(S, a1)
    tt = sum(S[:, i] * a1[:, j] * a2[:, k] for i in range(3)
             for j in range(3) for k in range(3) if len({i, j, k}) == 3)
    return (NEED_C1 * D * (q12[:, None] * S + tt[:, None] + qs2[:, None] * a1
                           + qs1[:, None] * a2)
            + NEED_C2 * (S + 2 * a1 + 2 * a2))


def _check_tree(bvh, tri, reach):
    """The build's rules on ``bvh`` of the soup ``tri`` (numpy)."""
    T = tri.shape[0]
    m = T - 1
    leaf = bvh.leaf_tri.numpy()
    assert sorted(leaf.tolist()) == list(range(T))       # one leaf each
    keys = bvh.keys.numpy()
    assert (np.diff(keys) > 0).all()                     # sorted, unique
    np.testing.assert_array_equal(keys & 0xFFFFFFFF, leaf)
    _, boxes = TT.bvh_keys_plain(torch.from_numpy(tri),
                                 TT.scene_scale(torch.from_numpy(tri)),
                                 reach)
    lb = boxes.numpy()[leaf]                             # leaf order
    lo, hi = tri.min(1)[leaf], tri.max(1)[leaf]
    need = _needed_margin(tri, reach.numpy())[leaf]
    assert (lb[:, :3] <= lo - need).all() and (lb[:, 3:] >= hi + need).all()
    rows = bvh.tris.numpy()
    np.testing.assert_array_equal(rows[:, 0:3], tri[leaf, 0])
    np.testing.assert_array_equal(rows[:, 3:6], tri[leaf, 1] - tri[leaf, 0])
    np.testing.assert_array_equal(rows[:, 6:9], tri[leaf, 2] - tri[leaf, 0])
    np.testing.assert_array_equal(rows.view(np.int32)[:, 9], leaf)
    parents = bvh.parents.numpy()
    assert parents.shape == (2 * T - 1,) and parents[0] == -1
    nodes = bvh.nodes.numpy()
    ints = nodes.view(np.int32)
    assert nodes.shape == (m, 16)
    # every node but the root is the child of exactly one internal node
    kids = ints[:, 12:14].reshape(-1)
    assert sorted(kids.tolist()) == list(range(1, 2 * T - 1))
    np.testing.assert_array_equal(parents[kids], np.repeat(np.arange(m), 2))

    def box_of(c):
        if c >= m:
            return lb[c - m]
        r = nodes[c]
        return np.concatenate([np.minimum(r[0:3], r[6:9]),
                               np.maximum(r[3:6], r[9:12])])

    depth = np.zeros(2 * T - 1, np.int64)
    seen, order = [], [0] if m else []
    while order:
        i = order.pop()
        seen.append(i)
        for k in range(2):
            c = int(ints[i, 12 + k])
            np.testing.assert_array_equal(nodes[i, 6 * k:6 * k + 6],
                                          box_of(c))
            depth[c] = depth[i] + 1
            h = 0 if c >= m else 1 + max(ints[c, 14], ints[c, 15])
            assert ints[i, 14 + k] == h
            if c < m:
                order.append(c)
    height = int(depth[m:].max()) if m else 0
    assert int(bvh.height[0]) == height <= TT.STACK
    # each internal node covers a run of consecutive leaves
    first, last, count = {}, {}, {}
    for c in range(m, 2 * T - 1):
        first[c] = last[c] = c - m
        count[c] = 1
    for i in reversed(seen):
        cl, cr = (int(c) for c in ints[i, 12:14])
        first[i], last[i] = min(first[cl], first[cr]), max(last[cl],
                                                          last[cr])
        count[i] = count[cl] + count[cr]
        assert last[i] - first[i] + 1 == count[i]
    return height


@pytest.mark.parametrize("T", SIZES)
def test_build_is_valid(T):
    """``build_bvh_plain`` on soups with copies, degenerate triangles and
    many triangles of one centroid: each triangle in exactly one leaf, each
    internal node's record holding its children's exact boxes, each leaf's
    box its triangle's padded by at least the margin the float32 MT test
    needs, the height within ``STACK`` and equal to the deepest leaf's
    depth; a second build of the same input is equal."""
    tri = _soup(T, seed=T)
    o, d = _rays(64, T, per_ray=True)
    reach = TT.ray_reach(o, d)
    bvh = TT.build_bvh_plain(torch.from_numpy(tri), reach)
    height = _check_tree(bvh, tri, reach)
    assert height <= max(1, 3 * int(np.ceil(np.log2(tri.shape[0]))))
    again = TT.build_bvh_plain(torch.from_numpy(tri.copy()), reach)
    for a, b in zip(bvh, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("origin", ["shared", "per_ray"])
def test_single_triangle_root_is_a_leaf(origin):
    """T = 1: no internal node, the root is leaf 0 (parent -1, height 0);
    the traversal tests the one triangle and equals the dense sweep."""
    tri = _soup(1, seed=1)[:1]
    o, d = _rays(300, 1, per_ray=origin == "per_ray")
    rng = np.random.default_rng(1)
    aim = tri[0].mean(0) + rng.normal(0, 0.05, (300, 3))
    d = torch.from_numpy(_unit(aim - o.numpy()))
    reach = TT.ray_reach(o, d)
    bvh = TT.build_bvh_plain(torch.from_numpy(tri), reach)
    assert tuple(bvh.nodes.shape) == (0, 16)
    assert bvh.parents.tolist() == [-1] and bvh.leaf_tri.tolist() == [0]
    assert int(bvh.height[0]) == 0
    stats = {}
    got = TT.raycast_mesh_bvh_plain(o, d, bvh, stats)
    ref = TT.raycast_mesh_plain(o, d, torch.from_numpy(tri))
    _assert_equal(got, ref)
    assert 0 < int(ref.hit.sum()) < 300
    assert bool((stats["tests"] == 1).all() and (stats["nodes"] == 0).all())


@pytest.mark.parametrize("origin", ["shared", "per_ray"])
@pytest.mark.parametrize("T", SIZES)
def test_traversal_equals_dense_on_soups(T, origin):
    """``raycast_mesh_bvh_plain`` against ``raycast_mesh_plain`` on the
    soups, bit for bit; the exact copies tie with their originals, and
    the lower index keeps every tie."""
    tri = _soup(T, seed=T)
    o, d = _rays(1500, T, per_ray=origin == "per_ray")
    if T <= 3:   # rays near the triangles' centres, or few would hit
        rng = np.random.default_rng(T)
        c = tri.mean(1)[rng.integers(0, tri.shape[0], 1500)]
        c = c + rng.normal(0, 0.03, c.shape)
        d = torch.from_numpy(_unit(c - o.numpy()))
    stats = {}
    got, ref = _traverse(o, d, tri, stats=stats)
    _assert_equal(got, ref)
    hits = ref.tri[ref.hit]
    assert hits.numel() > 20
    assert bool((hits < T).all())                       # no copy won
    if T >= 512:
        assert bool((hits % 7 == 0).any())              # ties happened
        # the tree culls: a ray tests a fraction of the triangles
        assert float(stats["tests"].float().mean()) < 0.3 * tri.shape[0]


def _heightfield(n=24, cell=0.5, amp=0.3):
    """(2 n^2, 3, 3) f32 triangles of an n x n grid of cells, two a cell
    sharing its diagonal, on z = amp sin(x) cos(y) - 2; -> (triangles,
    vertices (n + 1, n + 1, 3))."""
    g = (np.arange(n + 1) - n // 2).astype(np.float32) * np.float32(cell)
    x, y = np.meshgrid(g, g, indexing="ij")
    z = (np.float32(amp) * np.sin(x) * np.cos(y) - np.float32(2)).astype(
        np.float32)
    v = np.stack([x, y, z], -1)
    q = np.stack([v[:-1, :-1], v[1:, :-1], v[1:, 1:], v[:-1, 1:]], 2)
    tri = np.concatenate([q[:, :, [0, 1, 2]], q[:, :, [0, 2, 3]]], 0)
    return np.ascontiguousarray(tri.reshape(-1, 3, 3)), v


def test_heightfield_vertices_and_shared_edges():
    """A heightfield of cells of two triangles: rays from above aimed
    exactly at every vertex (shared by up to six triangles), at the
    midpoints of the x edges and of the cells' diagonals (each shared by
    two), and rays from vertices on the surface along the edges that
    leave them, through the grid's shared edges: the traversal equals the
    dense sweep bit for bit."""
    tri, v = _heightfield()
    o = np.array([0.1, -0.2, 1.5], np.float32)
    q_mid = (v[:-1, :-1] + v[1:, 1:]) * np.float32(0.5)
    targets = np.concatenate([v.reshape(-1, 3), (
        (v[1:] + v[:-1]) * np.float32(0.5)).reshape(-1, 3),
        q_mid.reshape(-1, 3)])
    d = _unit(targets - o)
    got, ref = _traverse(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tri))
    _assert_equal(got, ref)
    assert float(ref.hit.float().mean()) > 0.9
    # from the vertices along their edges, in the surface: (R, 3) origins
    start = v[2:-2, 2:-2].reshape(-1, 3)
    steps = []
    for di, dj in ((1, 0), (0, 1), (1, 1), (-1, 0), (0, -1), (-1, -1)):
        end = v[2 + di:v.shape[0] - 2 + di, 2 + dj:v.shape[1] - 2 + dj]
        steps.append(end.reshape(-1, 3) - start)
    d = _unit(np.concatenate(steps))
    o = np.tile(start, (6, 1))
    got, ref = _traverse(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tri))
    _assert_equal(got, ref)
    assert bool(ref.hit.any())


def test_axis_aligned_rays_and_zero_components():
    """Rays along the six axes and with one or two zero components (1/d
    infinite, and NaN on a plane the origin lies on), from origins on the
    heightfield's grid lines: equal to the dense sweep bit for bit."""
    tri, v = _heightfield(n=16, amp=0.0)
    tri = np.concatenate([tri, _heightfield(n=16, amp=0.4)[0] + np.float32(
        [0.0, 0.0, 1.0])])
    dirs = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
            [0, 0, -1], [1, 1, 0], [1, 0, -1], [0, -1, -1], [0.0, -0.0, -1],
            [-0.0, 0.3, -1], [0.2, 0.0, 0.7]]
    d = np.repeat(_unit(dirs), 25, axis=0)
    # origins on the grid's vertical lines, in the flat sheet's plane
    # (z = -2), between the two sheets and above both
    xs = v[::4, 0, 0]
    xy = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    z = np.array([-2.0, -1.5, 3.0], np.float32)[np.arange(25) % 3]
    o = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    o = np.tile(o, (len(dirs), 1))
    got, ref = _traverse(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tri))
    _assert_equal(got, ref)
    assert float(ref.hit.float().mean()) > 0.2


def test_origins_on_box_faces_and_inside_boxes():
    """Origins placed exactly on the faces of the tree's boxes (the leaves'
    padded boxes and internal ones) with the direction's component across
    that face 0, and at the boxes' centres: equal to the dense sweep bit
    for bit. The tree is built for a reach that holds these origins."""
    tri = _soup(400, seed=3)
    t = torch.from_numpy(tri)
    reach = torch.tensor([-3.0, -3.0, -3.0, 3.0, 3.0, 3.0, 1.0])
    bvh = TT.build_bvh_plain(t, reach)
    boxes = bvh.nodes[:, :12].reshape(-1, 6)
    boxes = boxes[(boxes[:, :3] > -3).all(1) & (boxes[:, 3:] < 3).all(1)]
    rng = np.random.default_rng(9)
    pick = boxes[torch.from_numpy(rng.choice(boxes.shape[0], 200))]
    lo, hi = pick[:, :3], pick[:, 3:]
    u = torch.from_numpy(rng.uniform(0.2, 0.8, (200, 3)).astype(np.float32))
    inside = lo + (hi - lo) * u
    origins, dirs = [inside], [torch.from_numpy(_unit(rng.normal(
        size=(200, 3))))]
    for axis in range(3):
        for face in (lo, hi):
            o = inside.clone()
            o[:, axis] = face[:, axis]
            d = rng.normal(size=(200, 3))
            d[:, axis] = 0.0
            origins.append(o)
            dirs.append(torch.from_numpy(_unit(d)))
    o, d = torch.cat(origins), torch.cat(dirs)
    assert bool((d == 0).any())
    got = TT.raycast_mesh_bvh_plain(o, d, bvh)
    ref = TT.raycast_mesh_plain(o, d, t)
    _assert_equal(got, ref)
    assert int(ref.hit.sum()) > 50


def test_grazing_rays_within_the_margin():
    """Rays nearly in the plane of small far triangles (angles of 1e-6 to
    1e-2 rad, 30 m out), where the float32 MT test accepts points off the
    exact triangle: each point o + t d it accepts lies in the leaf's
    padded box (float64), and the traversal equals the dense sweep."""
    rng = np.random.default_rng(21)
    n = 400
    c = np.array([30.0, 5.0, -1.7]) + rng.uniform(-0.5, 0.5, (n, 3))
    e1 = rng.normal(0, 0.05, (n, 3))
    e2 = rng.normal(0, 0.05, (n, 3))
    tri = np.stack([c, c + e1, c + e2], 1).astype(np.float32)
    normal = np.cross(e1, e2)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    R = 4000
    k = rng.integers(0, n, R)
    target = (tri[k, 0] + rng.uniform(0, 0.5, (R, 1)) * (tri[k, 1] - tri[k, 0])
              + rng.uniform(0, 0.5, (R, 1)) * (tri[k, 2] - tri[k, 0]))
    d = target / np.linalg.norm(target, axis=1, keepdims=True)
    # tilt each ray into its triangle's plane, leaving an angle of 1e-6 to
    # 1e-2 rad, and start it 30 m back along itself
    along = d - (d * normal[k]).sum(1, keepdims=True) * normal[k]
    along /= np.linalg.norm(along, axis=1, keepdims=True)
    ang = 10.0 ** rng.uniform(-6, -2, R)
    d = along * np.cos(ang)[:, None] + normal[k] * np.sin(ang)[:, None]
    o = (target - 30.0 * d).astype(np.float32)
    d = _unit(d)
    tt = torch.from_numpy(tri)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    reach = TT.ray_reach(ot, dt)
    got, ref = _traverse(ot, dt, tt, reach)
    _assert_equal(got, ref)
    t = TT._mt_chunk(ot, dt, tt[:, 0], tt[:, 1] - tt[:, 0],
                     tt[:, 2] - tt[:, 0]).numpy()
    ray, j = np.nonzero(np.isfinite(t))
    assert ray.size > 500
    _, boxes = TT.bvh_keys_plain(tt, TT.scene_scale(tt), reach)
    b = boxes.numpy().astype(np.float64)[j]
    x = o[ray].astype(np.float64) + t[ray, j][:, None].astype(
        np.float64) * d[ray].astype(np.float64)
    assert ((x >= b[:, :3]) & (x <= b[:, 3:])).all()
    # the accepted points lie off the exact triangle's box, by more than
    # a few ulps of the coordinates
    out = np.maximum(tri[j].min(1) - x, x - tri[j].max(1)).max(1)
    assert out.max() > 1e-5


def _assert_hits_agree(j, t):
    """``tests/test_torch_triangles.py``'s tolerance against JAX."""
    jh, th = np.asarray(j.hit), t.hit.numpy()
    np.testing.assert_array_equal(jh, th)
    jt, tt = np.asarray(j.t), t.t.numpy()
    assert np.isinf(tt[~th]).all() and (t.tri.numpy()[~th] == -1).all()
    np.testing.assert_allclose(tt[th], jt[th], rtol=RTOL, atol=ATOL)
    for r in np.flatnonzero(np.asarray(j.tri) != t.tri.numpy()):
        assert abs(jt[r] - tt[r]) <= ATOL + RTOL * jt[r], r


@pytest.mark.parametrize("origin", ["shared", "per_ray"])
@pytest.mark.parametrize("seed", [0, 12345])
def test_traversal_matches_jax(origin, seed):
    """``raycast_mesh_bvh_plain`` against ``raycast_mesh`` of the JAX
    package on ``tests/test_torch_triangles.py``'s random soups (chunk 128
    on the JAX side)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, (1000, 3)).astype(np.float32)
    tri = centers[:, None, :] + rng.normal(0, 0.6, (1000, 3, 3)).astype(
        np.float32)
    d = _unit(rng.normal(size=(800, 3)))
    o = (np.zeros(3, np.float32) if origin == "shared" else
         rng.uniform(-1, 1, (d.shape[0], 3)).astype(np.float32))
    j = JT.raycast_mesh(o, d, tri, chunk=128)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    t = TT.raycast_mesh_bvh_plain(ot, dt, TT.build_bvh_plain(
        torch.from_numpy(tri), TT.ray_reach(ot, dt)))
    _assert_hits_agree(j, t)
    assert 0.2 < float(t.hit.float().mean()) < 0.95


def test_oracle_frame_mesh(synthetic_dataset, small_spec, narrow_spec):
    """The catmesh oracle engine's mesh of frame 2 of the shared synthetic
    dataset (``tests/test_torch_catmesh_oracle.py``'s size: 16 x 256,
    voxel 0.25 m, +-16/+-16/+-4 m) and its target rays, those of a 16 x 64
    target of the same fov (``narrow_spec``; the mesh is the same): the
    traversal equals the dense sweep on every ray, bit for bit."""
    cfg = TransferConfig(adaption="catmesh", number_of_scans=1,
                         preserve_float=True, voxel_size=0.25,
                         voxel_bounds=((-16.0, 16.0), (-16.0, 16.0),
                                       (-4.0, 4.0)))
    seq = kitti.KittiSequence.open(synthetic_dataset)
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    eng = TD.TransferEngine(SensorSpec(**dataclasses.asdict(small_spec)),
                            SensorSpec(**dataclasses.asdict(narrow_spec)),
                            cfg, device="cpu", catmesh_engine="oracle")
    eng.transfer_fast(TM.load_window(seq, cfg, 2, cap, "cpu"))
    mesh = eng._last_mesh
    tri = torch.from_numpy(mesh.verts)[torch.from_numpy(mesh.faces).to(
        torch.int64)].contiguous()
    assert tri.shape[0] > 1000
    stats = {}
    got, ref = _traverse(torch.zeros(3), eng.rays, tri, stats=stats)
    _assert_equal(got, ref)
    assert float(ref.hit.float().mean()) > 0.3
    assert float(stats["tests"].float().mean()) < 0.05 * tri.shape[0]


def test_cpu_route_stays_the_dense_sweep():
    """``raycast_mesh`` on a CPU tensor runs ``raycast_mesh_plain`` and
    launches nothing; ``build_bvh`` on a CPU tensor is
    ``build_bvh_plain``."""
    tri = torch.from_numpy(_soup(64, seed=4))
    o, d = _rays(200, 4, per_ray=False)
    _build.reset_launch_counts()
    _assert_equal(TT.raycast_mesh(o, d, tri), TT.raycast_mesh_plain(o, d,
                                                                    tri))
    reach = TT.ray_reach(o, d)
    for a, b in zip(TT.build_bvh(tri, reach), TT.build_bvh_plain(tri,
                                                                 reach)):
        assert torch.equal(a, b)
    assert not any(_build.launch_counts().values())


def test_wrappers_refuse_other_devices_and_dtypes():
    """The build kernels' and the traversal's wrappers raise for a tensor
    on neither the CPU nor a card and for a wrong dtype; the plain
    versions raise for a wrong dtype."""
    meta = torch.device("meta")
    tri = torch.zeros((4, 3, 3), device=meta)
    scene, reach = torch.zeros(6, device=meta), torch.zeros(7, device=meta)
    with pytest.raises(ValueError, match="meta"):
        TC.bvh_keys_cuda(tri, scene, reach)
    with pytest.raises(ValueError, match="meta"):
        TT.build_bvh(tri, reach)
    with pytest.raises(ValueError, match="meta"):
        TC.bvh_hierarchy_cuda(torch.zeros(4, dtype=torch.int64,
                                          device=meta))
    i32 = dict(dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="meta"):
        TC.bvh_refit_cuda(torch.zeros((3, 16), device=meta),
                          torch.zeros(7, **i32), torch.zeros(3, **i32),
                          torch.zeros(4, **i32), torch.zeros((4, 6),
                                                             device=meta))
    with pytest.raises(ValueError, match="meta"):
        TC.bvh_reorder_cuda(tri, torch.zeros(4, **i32))
    cpu = TT.build_bvh_plain(torch.from_numpy(_soup(8)),
                             torch.tensor([0, 0, 0, 0, 0, 0, 1.0]))
    on_meta = TT.MeshBVH(*(x.to(meta) for x in cpu))
    with pytest.raises(ValueError, match="meta"):
        TC.mesh_raycast_cuda(torch.zeros(3, device=meta),
                             torch.zeros((5, 3), device=meta), on_meta)
    with pytest.raises(ValueError, match="float32"):
        TC.bvh_keys_cuda(tri.double(), scene, reach)
    with pytest.raises(ValueError, match="int64"):
        TC.bvh_hierarchy_cuda(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        TC.mesh_raycast_cuda(torch.zeros(3), torch.zeros((5, 3),
                                                         dtype=torch.float64),
                             cpu)
    with pytest.raises(ValueError, match="float32"):
        TC.mesh_raycast_dense_cuda(torch.zeros(3), torch.zeros((5, 3)),
                                   torch.zeros((2, 3, 3), dtype=torch.float16))
    with pytest.raises(ValueError, match="float32"):
        TT.build_bvh_plain(torch.zeros((2, 3, 3), dtype=torch.float64),
                           torch.zeros(7))
    with pytest.raises(ValueError, match="float32"):
        TT.raycast_mesh_bvh_plain(torch.zeros(3, dtype=torch.float64),
                                  torch.zeros((5, 3)), cpu)
