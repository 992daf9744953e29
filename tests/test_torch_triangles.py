"""The port's mesh raycast (``ops/triangles``) against the JAX package
(CPU).

``raycast_mesh`` and ``mesh_hit_attributes`` of
``lidar_transfer_tpu/ops/triangles.py`` and of the port run on the same
numpy soups and rays, made from a seed: random soups with a shared origin
and with (R, 3) origins, the single-triangle and the nearer-triangle-
listed-second scenes of ``tests/test_native.py``, and the empty mesh. On a
CPU tensor the port runs ``raycast_mesh_plain``, the mesh raycast kernel's
plain version (the kernel runs on the card only; ``chip_smoke.py`` holds
it against this plain version there, bit for bit).

Tolerance: hit exact; tri exact, except on a ray whose two nearest t lie
within t's tolerance of each other; t within ``RTOL`` relative (and
``ATOL``) of JAX's. XLA's CPU code contracts ``_mt_chunk``'s products into
FMAs (each cross product component as fma(a1, b2, -(a2 b1)), each dot as
fma(a2, b2, fma(a1, b1, a0 b0))), and the cross products cancel, so its t
differs from the IEEE order by up to 41 ulp, 3.6e-6 relative, on these
soups (more where a cross product cancels harder);
``test_mt_chunk_is_the_ieee_order`` shows that this is
the whole difference: the port's ``_mt_chunk`` equals a numpy float32
transcription of JAX's bit for bit, and JAX's equals the same
transcription with the contraction.
"""

import jax
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.ops import triangles as JT
from lidar_transfer_tpu_torch.ops import triangles as TT
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


#: t against JAX's (the FMA contraction of XLA's CPU code, see above)
RTOL, ATOL = 1e-5, 1e-6


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _soup(seed, n_tris=1000, n_rays=800, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    tris = centers[:, None, :] + rng.normal(
        0, 0.6, (n_tris, 3, 3)).astype(np.float32)
    dirs = _unit(rng.normal(size=(n_rays, 3))).astype(np.float32)
    return rng, tris, dirs


def _both(origins, dirs, tris, chunk=512):
    j = JT.raycast_mesh(origins, dirs, tris, chunk=chunk)
    t = TT.raycast_mesh(torch.from_numpy(np.asarray(origins, np.float32)),
                        torch.from_numpy(dirs), torch.from_numpy(tris),
                        chunk=chunk)
    return j, t


def _assert_hits_agree(j, t):
    """-> the largest relative difference of t on hits."""
    jh, th = np.asarray(j.hit), t.hit.numpy()
    np.testing.assert_array_equal(jh, th)
    jt, tt = np.asarray(j.t), t.t.numpy()
    assert np.isinf(tt[~th]).all() and (t.tri.numpy()[~th] == -1).all()
    np.testing.assert_allclose(tt[th], jt[th], rtol=RTOL, atol=ATOL)
    jt_i, tt_i = np.asarray(j.tri), t.tri.numpy()
    differ = jt_i != tt_i
    # a different winner only where JAX's t of the port's winner ties
    # JAX's own winner within the tolerance
    for r in np.flatnonzero(differ):
        assert abs(jt[r] - tt[r]) <= ATOL + RTOL * jt[r], r
    return float((np.abs(tt[th] - jt[th]) / jt[th]).max()) if th.any() \
        else 0.0


@pytest.mark.parametrize("origin", ["shared", "per_ray"])
@pytest.mark.parametrize("seed", [0, 12345])
def test_random_soup_matches_jax(origin, seed):
    """Random soups against ``raycast_mesh`` of the JAX package (chunk 128,
    so the soup spans several chunks and a tail chunk of padding)."""
    rng, tris, dirs = _soup(seed)
    origins = (np.zeros(3, np.float32) if origin == "shared" else
               rng.uniform(-1, 1, (dirs.shape[0], 3)).astype(np.float32))
    j, t = _both(origins, dirs, tris, chunk=128)
    assert t.t.dtype == torch.float32 and t.tri.dtype == torch.int32
    rel = _assert_hits_agree(j, t)
    assert 0.2 < float(t.hit.float().mean()) < 0.95
    assert rel < RTOL


@pytest.mark.parametrize("chunk", [1, 7, 512, 4096])
def test_chunk_does_not_change_the_result(chunk):
    """The plain version's chunk is a memory knob: any chunk gives the
    same t, tri and hit bit for bit, the lowest index on an exact tie."""
    _, tris, dirs = _soup(3, n_tris=200, n_rays=300)
    # an exact duplicate of every 5th triangle later in the soup: the
    # first copy must win
    tris = np.concatenate([tris, tris[::5]])
    o = torch.zeros(3)
    a = TT.raycast_mesh_plain(o, torch.from_numpy(dirs),
                              torch.from_numpy(tris), chunk=chunk)
    b = TT.raycast_mesh_plain(o, torch.from_numpy(dirs),
                              torch.from_numpy(tris), chunk=tris.shape[0])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bool((a.tri[a.hit] < 200).all())


def test_mt_chunk_is_the_ieee_order():
    """The port's ``_mt_chunk`` equals a numpy float32 transcription of
    the JAX ``_mt_chunk`` (IEEE order, no contraction) bit for bit; the
    jitted JAX ``_mt_chunk`` equals the same transcription with XLA's FMA
    contraction, so that contraction is the whole difference."""
    rng, tris, dirs = _soup(7, n_tris=512, n_rays=1000)
    origins = rng.uniform(-1, 1, (dirs.shape[0], 3)).astype(np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    f32 = np.float32

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(f32)

    def ref(contract):
        o, d = ([x[:, None, k] for k in range(3)] for x in (origins, dirs))
        a, b1, b2 = ([x[None, :, k] for k in range(3)]
                     for x in (v0, e1, e2))
        if contract:
            def cross(x, y):
                return (fma(x[1], y[2], -(x[2] * y[1])),
                        fma(x[2], y[0], -(x[0] * y[2])),
                        fma(x[0], y[1], -(x[1] * y[0])))

            def dot(x, y):
                return fma(x[2], y[2], fma(x[1], y[1], x[0] * y[0]))
        else:
            def cross(x, y):
                return (x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],
                        x[0] * y[1] - x[1] * y[0])

            def dot(x, y):
                return (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]
        p = cross(d, b2)
        det = dot(p, b1)
        big = np.abs(det) > f32(1e-6)
        with np.errstate(divide="ignore"):
            inv = np.where(big, f32(1) / det, f32(0))
        s = [o[k] - a[k] for k in range(3)]
        u = dot(s, p) * inv
        q = cross(s, b1)
        v, t = dot(q, d) * inv, dot(q, b2) * inv
        ok = big & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > f32(1e-6))
        return np.where(ok, t, f32(np.inf))

    port = TT._mt_chunk(*(torch.from_numpy(x)
                          for x in (origins, dirs, v0, e1, e2))).numpy()
    jax_t = np.asarray(jax.jit(JT._mt_chunk)(origins, dirs, v0, e1, e2))
    np.testing.assert_array_equal(port, ref(False))
    np.testing.assert_array_equal(jax_t, ref(True))
    assert np.isfinite(port).sum() > 200


def test_single_triangle_and_nearer_listed_second():
    """The scenes of ``tests/test_native.py``: a hit through the triangle,
    a ray away from it and a parallel miss; two parallel triangles, the
    nearer one listed second wins."""
    tri = np.array([[[5.0, -1.0, -1.0], [5.0, 1.0, -1.0], [5.0, 0.0, 1.5]]],
                   np.float32)
    rays = _unit([[1, 0, 0], [-1, 0, 0], [0, 1, 0]])
    j, t = _both(np.zeros(3, np.float32), rays, tri)
    _assert_hits_agree(j, t)
    assert t.tri.tolist() == [0, -1, -1]
    assert float(t.t[0]) == pytest.approx(5.0, abs=1e-5)

    def quad_tri(x):
        return np.array([[x, -2, -2], [x, 2, -2], [x, 0, 2]], np.float32)

    pair = np.stack([quad_tri(9.0), quad_tri(3.0)])
    j, t = _both(np.zeros(3, np.float32), _unit([[1.0, 0, 0]]), pair)
    _assert_hits_agree(j, t)
    assert t.tri.tolist() == [1] and float(t.t[0]) == pytest.approx(3.0)


def test_empty_mesh():
    """No triangle: every ray misses (t inf, tri -1), as JAX."""
    rays = _unit([[1.0, 0, 0], [0, 0, 1.0]])
    j, t = _both(np.zeros(3, np.float32), rays,
                 np.zeros((0, 3, 3), np.float32))
    assert not t.hit.any() and t.tri.tolist() == [-1, -1]
    assert torch.isinf(t.t).all()
    np.testing.assert_array_equal(np.asarray(j.hit), t.hit.numpy())


def test_hit_attributes_match_jax():
    """``mesh_hit_attributes`` against JAX's on an indexed random mesh:
    label of vertex 0 and the mean remission of the 3 vertices, exact,
    and 0 on a miss."""
    rng, tris, dirs = _soup(11)
    verts = tris.reshape(-1, 3)
    faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    labels = rng.integers(1, 20, verts.shape[0]).astype(np.int32)
    rems = rng.uniform(0, 1, verts.shape[0]).astype(np.float32)
    j, t = _both(np.zeros(3, np.float32), dirs, verts[faces])
    jl, jr = JT.mesh_hit_attributes(j, faces, labels, rems)
    tl, tr = TT.mesh_hit_attributes(t, torch.from_numpy(faces),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(rems))
    same = np.asarray(j.tri) == t.tri.numpy()
    assert same.all()
    assert tl.dtype == torch.int32 and tr.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tr.numpy(), jr)
    miss = ~t.hit.numpy()
    assert miss.any() and (tl.numpy()[miss] == 0).all()
    assert (tr.numpy()[miss] == 0).all()


def test_other_devices_raise():
    """A ray tensor on neither the CPU nor a card raises: no fallback to
    the plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        TT.raycast_mesh(torch.zeros(3, device=meta),
                        torch.zeros((4, 3), device=meta),
                        torch.zeros((2, 3, 3), device=meta))
