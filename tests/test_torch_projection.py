"""The port's projection and z-buffer against the JAX package (CPU).

Inputs are made once in numpy and go through both packages: the JAX
functions of ``lidar_transfer_tpu/ops/projection.py`` and
``ops/transforms.py``, and their counterparts in
``lidar_transfer_tpu_torch``, which on CPU tensors run the plain versions
of the CUDA kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.datasets import kitti, synthetic
from lidar_transfer_tpu.ops import projection as JP
from lidar_transfer_tpu.ops import transforms as JT
from lidar_transfer_tpu_torch.ops import projection as TP
from lidar_transfer_tpu_torch.ops import transforms as TT
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


#: integer images are exact unless an atan2/asin ulp (XLA and PyTorch
#: round their libm differently) moves a point across a pixel boundary;
#: at most this fraction of pixels may differ
FLIP_FRACTION = 1e-3


def _jax_win_idx(pix, key, npix):
    """win_idx (npix,) of the JAX z-buffer (``_winner_sort`` run starts)."""
    sp, si, first = (np.asarray(a) for a in JP._winner_sort(
        jnp.asarray(pix), jnp.asarray(key), npix))
    win = np.full(npix, -1, np.int32)
    win[sp[first]] = si[first]
    return win


def _zbuffer_inputs(rng, kind):
    npix, n = 512, 6000
    pix = rng.integers(0, npix, n).astype(np.int32)
    if kind == "depth":
        key = rng.uniform(0.5, 80.0, n).astype(np.float32)
        # exact-key ties inside a pixel: copy (pixel, key) pairs onward
        src = rng.integers(0, n - 1, n // 4)
        pix[src + 1] = pix[src]
        key[src + 1] = key[src]
    else:
        # pdist-style squared distances on a coarse grid: many exact ties,
        # including +0 keys
        key = (rng.integers(0, 4, n) * 0.125).astype(np.float32) ** 2
    invalid = rng.random(n) < 0.2
    pix[invalid] = npix
    key[invalid] = np.inf
    return pix, key, npix


@pytest.mark.parametrize("kind", ["depth", "pdist"])
def test_zbuffer_matches_winner_sort(kind):
    """zbuffer_winners (plain) == JAX ``_winner_sort`` winners, bit-exact,
    with forced exact-key ties and invalid points."""
    pix, key, npix = _zbuffer_inputs(np.random.default_rng(3), kind)
    ref = _jax_win_idx(pix, key, npix)
    plain = TP.zbuffer_winners_plain(torch.from_numpy(pix),
                                     torch.from_numpy(key), npix)
    wrapped = TP.zbuffer_winners(torch.from_numpy(pix),
                                 torch.from_numpy(key), npix)
    np.testing.assert_array_equal(plain.numpy(), ref)
    np.testing.assert_array_equal(wrapped.numpy(), ref)
    assert (ref >= 0).sum() > npix // 2


def _random_cloud(rng, n, seed_labels=(0, 10, 40, 50, 71)):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * np.array(
        [20.0, 20.0, 2.0], np.float32)
    rem = rng.random(n).astype(np.float32)
    lbl = rng.choice(np.array(seed_labels, np.int32), size=n)
    p, r, l, m = kitti.pad_points(pts, rem, lbl, kitti.scan_capacity(n))
    m &= rng.random(m.shape[0]) > 0.05
    return p, r, l, m


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _assert_images_match(j, t, H, W):
    limit = max(2, int(FLIP_FRACTION * H * W))
    assert (np.asarray(j.mask) != t.mask.numpy()).sum() <= limit
    assert (np.asarray(j.label) != t.label.numpy()).sum() <= limit
    assert (np.asarray(j.index) != t.index.numpy()).sum() <= limit
    same = np.asarray(j.index) == t.index.numpy()
    for f in ("range", "remission", "u_float", "v_float"):
        np.testing.assert_allclose(np.asarray(getattr(j, f))[same],
                                   getattr(t, f).numpy()[same],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("H,W,fovs,winner,beams", [
    (16, 256, (8.0, -22.0), "depth", False),
    (64, 1024, (3.0, -25.0), "depth", False),
    (16, 256, (8.0, -22.0), "pdist", False),
    (8, 64, (6.0, -20.0), "depth", True),
])
def test_range_project_matches(H, W, fovs, winner, beams):
    """range_project: index/label/mask within FLIP_FRACTION of JAX's,
    float images within 1e-5 relative where the winner agrees."""
    rng = np.random.default_rng(11)
    jargs, targs = _both(_random_cloud(rng, 20000))
    kw = dict(H=H, W=W, fov_up_deg=fovs[0], fov_down_deg=fovs[1],
              winner=winner)
    ba = np.deg2rad(np.linspace(-20.0, 6.0, H)).astype(np.float32)
    j = JP.range_project(*jargs, **kw,
                         beam_angles=jnp.asarray(ba) if beams else None)
    t = TP.range_project(*targs, **kw,
                         beam_angles=torch.from_numpy(ba) if beams else None)
    _assert_images_match(j, t, H, W)
    np.testing.assert_array_equal(np.asarray(j.point_valid),
                                  t.point_valid.numpy())


def test_range_project_beam_rows():
    """beam_rows (row = nearest beam) against JAX, and its height check."""
    rng = np.random.default_rng(12)
    H, W = 8, 64
    ba = np.deg2rad(np.linspace(-20.0, 6.0, H)).astype(np.float32)
    jargs, targs = _both(_random_cloud(rng, 5000))
    kw = dict(H=H, W=W, fov_up_deg=6.0, fov_down_deg=-20.0, beam_rows=True)
    j = JP.range_project(*jargs, beam_angles=jnp.asarray(ba), **kw)
    t = TP.range_project(*targs, beam_angles=torch.from_numpy(ba), **kw)
    _assert_images_match(j, t, H, W)
    with pytest.raises(ValueError, match="beam"):
        TP.range_project(*targs, beam_angles=torch.from_numpy(ba),
                         **{**kw, "H": 16})


def test_zbuffer_depth_ties():
    """Equal-depth collisions: the first point in original order wins."""
    pts = np.array([[5.0, 0.0, 0.0], [5.0, 0.0, 0.0], [3.0, 0.0, 0.0]],
                   np.float32)
    rem = np.array([0.1, 0.2, 0.3], np.float32)
    lbl = np.array([10, 50, 40], np.int32)
    kw = dict(H=4, W=8, fov_up_deg=10.0, fov_down_deg=-10.0)
    for k, want in ((3, 40), (2, 10)):
        p, r, l, m = kitti.pad_points(pts[:k], rem[:k], lbl[:k], 8)
        ri = TP.range_project(*(torch.from_numpy(a) for a in (p, r, l, m)),
                              **kw)
        assert (ri.label.numpy() == want).sum() == 1
        assert (ri.label.numpy() > 0).sum() == 1


def test_project_winner_order_matches():
    """The port's raster-order winners == the JAX sorted run starts
    ``si[is_first]``, in the same relative (pixel) order."""
    rng = np.random.default_rng(13)
    p, r, l, m = _random_cloud(rng, 20000)
    kw = dict(H=16, W=256, fov_up_deg=8.0, fov_down_deg=-22.0)
    sp, si, first, jdepth = (np.asarray(a) for a in JP.project_winner_order(
        jnp.asarray(p), jnp.asarray(m), return_pixels=True, **kw))
    win, tdepth = TP.project_winner_order(torch.from_numpy(p),
                                          torch.from_numpy(m), **kw)
    win = win.numpy()
    jw = si[first]
    tw = win[win >= 0]
    limit = max(2, int(FLIP_FRACTION * 16 * 256))
    assert abs(len(jw) - len(tw)) <= limit
    jpix, tpix = sp[first], np.nonzero(win >= 0)[0]
    common = np.intersect1d(jpix, tpix)
    jmap = dict(zip(jpix, jw))
    tmap = dict(zip(tpix, tw))
    assert sum(jmap[q] != tmap[q] for q in common) <= limit
    assert len(common) >= len(jw) - limit
    np.testing.assert_allclose(jdepth, tdepth.numpy(), rtol=1e-6)


@pytest.mark.parametrize("preserve_float", [True, False])
def test_reverse_project_matches(preserve_float, small_spec):
    """reverse_project on the same RangeImage, to 1e-5 m."""
    pts, rem, lbl = synthetic.simulate_scan(synthetic.Scene.default(),
                                            small_spec, np.eye(4))
    p, r, l, m = kitti.pad_points(pts, rem, lbl,
                                  kitti.scan_capacity(pts.shape[0]))
    kw = dict(fov_up_deg=small_spec.fov_up,
              fov_down_deg=small_spec.fov_down)
    ri = JP.range_project(jnp.asarray(p), jnp.asarray(r), jnp.asarray(l),
                          jnp.asarray(m), H=small_spec.H, W=small_spec.W,
                          **kw)
    from lidar_transfer_tpu_torch import interop

    tri = interop.range_image_from_numpy(ri)
    j = np.asarray(JP.reverse_project(ri, preserve_float=preserve_float,
                                      **kw))
    t = TP.reverse_project(tri, preserve_float=preserve_float, **kw)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5)
    back = t.numpy().reshape(small_spec.H, small_spec.W, 3)
    np.testing.assert_array_equal(back[~tri.mask.numpy()], 0.0)


def test_mask_classes_and_transforms():
    """mask_classes exactly; transform_points / inverse_pose to 1e-5."""
    lbl = np.array([0, 1, 10, 40, 252], np.int32)
    out = TP.mask_classes(torch.from_numpy(lbl), torch.ones(5, dtype=bool),
                          (0, 1))
    np.testing.assert_array_equal(out.numpy(),
                                  [False, False, True, True, True])
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(3, 100, 3)).astype(np.float32) * 10
    ang = rng.uniform(-np.pi, np.pi, 3)
    pose = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    pose[:, 0, 0] = pose[:, 1, 1] = np.cos(ang)
    pose[:, 0, 1] = -np.sin(ang)
    pose[:, 1, 0] = np.sin(ang)
    pose[:, :3, 3] = rng.normal(size=(3, 3))
    j = np.asarray(JT.transform_points(jnp.asarray(pts), jnp.asarray(pose)))
    t = TT.transform_points(torch.from_numpy(pts), torch.from_numpy(pose))
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5)
    np.testing.assert_allclose(
        TT.inverse_pose(torch.from_numpy(pose)).numpy(),
        np.asarray(JT.inverse_pose(jnp.asarray(pose))), atol=1e-6)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_zbuffer_workspace_sequence_matches_winner_sort(device):
    """One workspace through a sequence of image sizes and back (CPU path:
    the plain version, the workspace accepted and left empty, made for
    the CPU or for the device of its first call): every call equals the JAX ``_winner_sort`` winners bit for bit."""
    rng = np.random.default_rng(21)
    ws = TP.ZBufferWorkspace(device)
    for npix, n in ((64 * 32, 3000), (32 * 32, 1500), (128 * 32, 6000),
                    (64 * 32, 0), (64 * 32, 3000)):
        pix = rng.integers(0, npix, n).astype(np.int32)
        key = rng.uniform(0.5, 80.0, n).astype(np.float32)
        if n:
            src = rng.integers(0, n - 1, n // 4)
            pix[src + 1], key[src + 1] = pix[src], key[src]
            pix[rng.random(n) < 0.2] = npix
        got = TP.zbuffer_winners(torch.from_numpy(pix),
                                 torch.from_numpy(key), npix, workspace=ws)
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_win_idx(pix, key, npix))
    assert ws.allocations == 0          # nothing is kept for CPU tensors


def test_zbuffer_workspace_one_pixel_and_invalid():
    """All points in one pixel with equal keys: the lowest index wins; all
    points invalid: every pixel empty (with a workspace, as without)."""
    ws = TP.ZBufferWorkspace()
    npix, n = 256, 500
    pix = torch.full((n,), 17, dtype=torch.int32)
    key = torch.full((n,), 7.5)
    for w in (None, ws):
        win = TP.zbuffer_winners(pix, key, npix, workspace=w)
        assert int(win[17]) == 0 and int((win >= 0).sum()) == 1
        win = TP.zbuffer_winners(torch.full((n,), npix, dtype=torch.int32),
                                 key, npix, workspace=w)
        assert int((win >= 0).sum()) == 0


def test_zbuffer_workspace_rejects_wrong_device_dtype_and_type():
    pix = torch.zeros(8, dtype=torch.int32)
    key = torch.ones(8)
    with pytest.raises(ValueError, match="ZBufferWorkspace of cuda"):
        TP.zbuffer_winners(pix, key, 4,
                           workspace=TP.ZBufferWorkspace("cuda"))
    with pytest.raises(TypeError, match="int32 pix and float32 key"):
        TP.zbuffer_winners(pix.long(), key, 4,
                           workspace=TP.ZBufferWorkspace("cpu"))
    with pytest.raises(TypeError, match="int32 pix and float32 key"):
        TP.zbuffer_winners(pix, key.double(), 4,
                           workspace=TP.ZBufferWorkspace("cpu"))
    with pytest.raises(TypeError, match="not a ZBufferWorkspace"):
        TP.zbuffer_winners(pix, key, 4, workspace=torch.empty(4))
    with pytest.raises(ValueError, match="used on"):
        TP.ZBufferWorkspace("cuda:1").scratch(4, torch.device("cuda:0"))


def test_range_project_and_winner_order_take_a_workspace():
    """range_project and project_winner_order with one workspace over two
    image sizes equal the calls without one."""
    rng = np.random.default_rng(5)
    p, r, l, m = (torch.from_numpy(a) for a in _random_cloud(rng, 8000))
    ws = TP.ZBufferWorkspace()
    for H, W in ((16, 256), (8, 128), (16, 256)):
        kw = dict(H=H, W=W, fov_up_deg=8.0, fov_down_deg=-22.0)
        a = TP.range_project(p, r, l, m, **kw)
        b = TP.range_project(p, r, l, m, workspace=ws, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        wa, da = TP.project_winner_order(p, m, **kw)
        wb, db = TP.project_winner_order(p, m, workspace=ws, **kw)
        assert torch.equal(wa, wb) and torch.equal(da, db)
