"""The port's raymarcher (``ops/raycast``) and its ``synthesis="raymarch"``
engine against the JAX package (CPU).

``generate_rays``, ``occupancy_grid``, ``occupancy_from_points`` and
``raycast_tsdf`` of ``lidar_transfer_tpu/ops/raycast.py`` and of the port
run on the same numpy volume and rays, made from a seed (a 64x64x32 TSDF of
a ground plane, a wall and a box; 16x256 rays), in float32 and in compact
storage, with a shared origin and with (R, 3) origins. The raymarch
kernel and its packing of the occupancy run on the card only;
``chip_smoke.py`` holds them against ``raycast_plain`` and
``pack_occupancy_plain`` there, and here the packing's plain version is
held to the grid it packs and ``raycast_plain``'s counts to its march.

Tolerance: occupancy exact; hit and label equal on >= 99.9 % of rays;
range within 1e-3 m on rays that both hit (a floor or an ulp of the
position can move a sample across a voxel boundary). The engine test holds
``TransferEngine(synthesis="raymarch")`` against the JAX engine to the
same bounds on label and mask per pixel.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_transfer_tpu.config import SensorSpec, TransferConfig
from lidar_transfer_tpu.datasets import kitti, synthetic
from lidar_transfer_tpu.ops import raycast as JR
from lidar_transfer_tpu.ops import tsdf as JT
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu.pipeline import multiscan as JM
from lidar_transfer_tpu_torch import _build, interop
from lidar_transfer_tpu_torch.ops import raycast as TR
from lidar_transfer_tpu_torch.ops import raycast_cuda as TRC
from lidar_transfer_tpu_torch.ops import tsdf as TT
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.pipeline import multiscan as TM
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


#: hit and label agreement of two marches, range error where both hit (m)
AGREE, RANGE_TOL = 0.999, 1e-3
DIMS, ORIGIN, VOX = (64, 64, 32), (-8.0, -8.0, -2.0), 0.25
H, W = 16, 256
FOV = (10.0, -30.0)


def _volume(seed=0):
    """A TSDF as the integrate leaves one: a ground plane, a wall and a
    box, tsdf = sdf / trunc inside the 5-voxel band and 1 elsewhere,
    labels 40 / 50 / 10 and random remissions in the band."""
    rng = np.random.default_rng(seed)
    g = [ORIGIN[i] + np.arange(DIMS[i]) * VOX for i in range(3)]
    x, y, z = np.meshgrid(*g, indexing="ij")
    box = np.maximum(np.maximum(np.abs(x + 3) - 1, np.abs(y - 4) - 1.5),
                     np.abs(z) - 1.2)
    sdfs = np.stack([z + 1.5, 6.0 - x, box])
    sdf = sdfs.min(0)
    trunc = 5 * VOX
    band = np.abs(sdf) < trunc
    tsdf = np.where(band, np.clip(sdf / trunc, -1, 1), 1.0)
    label = np.where(band, np.array([40, 50, 10])[sdfs.argmin(0)], 0)
    rem = np.where(band, rng.random(DIMS), 0.0)
    return (tsdf.astype(np.float32), np.zeros(DIMS, np.float32),
            label.astype(np.int32), rem.astype(np.float32))


@pytest.fixture(scope="module")
def volume():
    return _volume()


def _states(arrays, compact):
    """The same volume as a JAX and a port state, float32 or compact
    (both round to nearest even)."""
    j = JT.TSDFState(*(jnp.asarray(a) for a in arrays))
    t = TT.TSDFState(*(torch.from_numpy(a) for a in arrays))
    if compact:
        j = JT.TSDFState(j.tsdf.astype(jnp.bfloat16),
                         j.weight.astype(jnp.bfloat16),
                         j.label.astype(jnp.int16),
                         j.rem.astype(jnp.bfloat16))
        t = TT.TSDFState(*(a.to(dt) for a, dt in zip(t, TT.COMPACT_DTYPES)))
    return j, t


def _origins(per_ray):
    if per_ray:
        rng = np.random.default_rng(1)
        return rng.uniform(-0.3, 0.3, (H * W, 3)).astype(np.float32)
    return np.zeros(3, np.float32)


def _assert_marches_agree(j, t, min_hits=0.3):
    jh, th = np.asarray(j.hit), t.hit.numpy()
    jl, tl = np.asarray(j.label), t.label.numpy()
    assert (jh == th).mean() >= AGREE
    assert (jl == tl).mean() >= AGREE
    assert jh.mean() > min_hits
    both = jh & th & (jl == tl)
    np.testing.assert_allclose(t.range.numpy()[both],
                               np.asarray(j.range)[both], atol=RANGE_TOL)
    np.testing.assert_allclose(t.remission.numpy()[both],
                               np.asarray(j.remission)[both], atol=1e-6)
    np.testing.assert_allclose(t.endpoints.numpy()[both],
                               np.asarray(j.endpoints)[both], atol=RANGE_TOL)
    assert not t.range.numpy()[~th].any()


@pytest.mark.parametrize("beams", [False, True])
def test_generate_rays_matches(beams):
    """generate_rays == the JAX function's, with equidistant rows and with
    a beam table; a table of the wrong length raises."""
    ba = np.deg2rad(np.linspace(-28.0, 8.0, H)) if beams else None
    j = JR.generate_rays(H, W, *FOV, beam_angles=ba)
    t = TR.generate_rays(H, W, *FOV, beam_angles=ba)
    assert t.dtype == np.float32 and t.shape == (H * W, 3)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="beam angles"):
        TR.generate_rays(H + 1, W, *FOV, beam_angles=ba if beams else
                         np.zeros(H))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("dims,block", [(DIMS, 4), ((63, 62, 30), 4),
                                        ((63, 62, 30), 3)])
def test_occupancy_grid_matches(volume, compact, dims, block):
    """occupancy_grid == the JAX function's, exactly, in the storage dtype,
    for dims the block does and does not divide."""
    arrays = tuple(a[:dims[0], :dims[1], :dims[2]].copy() for a in volume)
    js, ts = _states(arrays, compact)
    j = np.asarray(JR.occupancy_grid(js.tsdf, block=block))
    t = TR.occupancy_grid(ts.tsdf, block=block)
    assert t.dtype == torch.bool
    np.testing.assert_array_equal(t.numpy(), j)
    assert 0.05 < j.mean() < 0.95


def _points(seed=2, n=8):
    """Points in the box, just outside each face (within and beyond the
    dilation), far away, and invalid ones."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(ORIGIN)
    hi = lo + np.asarray(DIMS) * VOX
    inside = rng.uniform(lo, hi, (n, 3))
    out = []
    for a in range(3):
        for side, edge in ((-1, lo[a]), (1, hi[a])):
            p = rng.uniform(lo, hi, (3, 3))
            p[:, a] = edge + side * rng.uniform(0.01, 4.0, 3)
            out.append(p)
    far = rng.uniform(-500, 500, (20, 3))
    pts = np.concatenate([inside, *out, far]).astype(np.float32)
    valid = rng.random(len(pts)) > 0.1
    return pts, valid


@pytest.mark.parametrize("kw", [dict(), dict(pixel_angle_rad=0.0076),
                                dict(dilate_cells=0), dict(dilate_cells=2),
                                dict(block=3, pixel_angle_rad=0.02),
                                dict(block=1, dilate_cells=5),
                                dict(block=1, dilate_cells=8)])
def test_occupancy_from_points_matches(kw):
    """occupancy_from_points == the JAX function's, exactly: the default
    dilation with and without the source pixel angle, none, two, another
    block, and one-voxel cells dilated by 5 and 8 (the engine's dilation
    at the reference volume; windows of 11 and 17 cells); points just
    outside the box mark its boundary cells."""
    pts, valid = _points()
    jspec = JT.VolumeSpec(ORIGIN, VOX, DIMS)
    tspec = TT.VolumeSpec(ORIGIN, VOX, DIMS)
    vo = np.asarray(ORIGIN, np.float32) + np.float32(0.1)
    j = np.asarray(JR.occupancy_from_points(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(vo), jspec, **kw))
    t = TR.occupancy_from_points(torch.from_numpy(pts),
                                 torch.from_numpy(valid), vo, tspec, **kw)
    assert t.dtype == torch.bool and tuple(t.shape) == j.shape
    np.testing.assert_array_equal(t.numpy(), j)
    assert 0.0 < j.mean() < 1.0


def test_occupancy_marks_boundary_cells_of_points_outside():
    """A lone point 0.3 m outside the -x face marks the boundary cell of
    its row (0, 8, 2), dilated by one cell inside the box only: 2x3x3
    cells."""
    spec = TT.VolumeSpec(ORIGIN, VOX, DIMS)
    p = torch.tensor([[ORIGIN[0] - 0.3, 0.1, 0.1]])
    occ = TR.occupancy_from_points(p, torch.ones(1, dtype=torch.bool),
                                   ORIGIN, spec, dilate_cells=1)
    assert int(occ.sum()) == 18 and bool(occ[0, 8, 2])
    assert bool(occ[:2, 7:10, 1:4].all())
    assert TR.dilate_cells_for(spec) == 3
    assert TR.dilate_cells_for(spec, pixel_angle_rad=0.05) == 4


@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_raycast_tsdf_matches(volume, compact, per_ray):
    """raycast_tsdf (the plain march on CPU tensors) against the JAX
    raycast_tsdf on the same volume and rays, the default occupancy and
    steps: hit and label on >= 99.9 % of rays, range and endpoints within
    1e-3 m and remission within 1e-6 where both hit; nothing launched."""
    js, ts = _states(volume, compact)
    rays = TR.generate_rays(H, W, *FOV)
    orig = _origins(per_ray)
    j = JR.raycast_tsdf(js, JT.VolumeSpec(ORIGIN, VOX, DIMS),
                        jnp.asarray(rays), jnp.asarray(orig), H, W)
    _build.reset_launch_counts()
    t = TR.raycast_tsdf(ts, TT.VolumeSpec(ORIGIN, VOX, DIMS),
                        torch.from_numpy(rays), torch.from_numpy(orig), H, W)
    assert _build.launch_counts()["raymarch"] == 0
    assert t.range.shape == (H, W) and t.endpoints.shape == (H, W, 3)
    assert t.label.dtype == torch.int32 and t.hit.dtype == torch.bool
    _assert_marches_agree(j, t)


def test_raycast_tsdf_options_match(volume):
    """A shifted vol_origin, fine_step 2 with the occupancy from points
    (the engine's call) and max_steps cut short (rays not done by then
    miss): each against the JAX function."""
    js, ts = _states(volume, True)
    rays = TR.generate_rays(H, W, *FOV)
    jspec = JT.VolumeSpec(ORIGIN, VOX, DIMS)
    tspec = TT.VolumeSpec(ORIGIN, VOX, DIMS)
    vo = np.asarray(ORIGIN, np.float32) + np.float32(0.3)
    pts = rays * 5.0
    valid = np.ones(len(pts), bool)
    hits = []
    for kw, occ_kw in ((dict(vol_origin=vo), None),
                       (dict(fine_step=2.0, vol_origin=vo),
                        dict(pixel_angle_rad=0.03)),
                       (dict(vol_origin=vo, max_steps=60), None)):
        jkw, tkw = dict(kw), dict(kw)
        if occ_kw is not None:
            jkw["occ"] = JR.occupancy_from_points(
                jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(vo), jspec,
                **occ_kw)
            tkw["occ"] = TR.occupancy_from_points(
                torch.from_numpy(pts), torch.from_numpy(valid), vo, tspec,
                **occ_kw)
        j = JR.raycast_tsdf(js, jspec, jnp.asarray(rays),
                            jnp.zeros(3, jnp.float32), H, W, **jkw)
        t = TR.raycast_tsdf(ts, tspec, torch.from_numpy(rays),
                            torch.zeros(3), H, W, **tkw)
        _assert_marches_agree(j, t)
        hits.append(float(t.hit.float().mean()))
    assert hits[2] < hits[0] - 0.02      # the cut march misses rays


def test_raycast_plain_counts_what_it_reads(volume):
    """raycast_plain's stats: every sample, those inside the box, those in
    an occupied block, and the hits, consistent with its outputs; the
    distinct 32-byte sectors each array gives the march, at most one a
    gather and the same when every ray is marched four times over."""
    _, ts = _states(volume, False)
    spec = TT.VolumeSpec(ORIGIN, VOX, DIMS)
    rays = torch.from_numpy(TR.generate_rays(H, W, *FOV))
    occ = TR.occupancy_grid(ts.tsdf)
    prm = TR.march_params(spec, ORIGIN, 4, 0.5)
    steps = TR.default_max_steps(spec, 0.5)
    stats, stats4 = {}, {}
    out = TR.raycast_plain(ts, occ, rays, torch.zeros(3), prm, DIMS, 4,
                           steps, stats)
    ref = TR.raymarch(ts, occ, rays, torch.zeros(3), prm, DIMS, 4, steps)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert stats["hits"] == int(out[4].sum()) > 0
    assert stats["steps"] >= stats["inside"] >= stats["occupied"] > 0
    assert stats["steps"] > H * W
    sec = stats["sectors"]
    assert 0 < sec["occupancy"] <= min(stats["inside"],
                                       -(-occ.numel() // TR.SECTOR))
    assert 0 < sec["tsdf"] <= stats["occupied"] + 12 * 8 * stats["hits"]
    assert 0 < sec["label"] <= stats["hits"]
    assert 0 < sec["remission"] <= stats["hits"]
    TR.raycast_plain(ts, occ, rays.repeat(4, 1), torch.zeros(3), prm, DIMS,
                     4, steps, stats4)
    assert stats4["sectors"] == sec
    assert stats4["steps"] == 4 * stats["steps"]
    assert stats4["hits"] == 4 * stats["hits"]
    assert prm.hi == tuple(float(np.float32(o) + np.float32(d * VOX))
                           for o, d in zip(ORIGIN, DIMS))


@pytest.mark.parametrize("max_steps", [None, 60, 1])
def test_raycast_plain_counts_samples_a_ray(volume, max_steps):
    """raycast_plain's per-ray sample counts (the seed sample included):
    they sum to ``steps``, none exceeds max_steps + 1, and their max and
    p99 are those of the counts."""
    _, ts = _states(volume, True)
    spec = TT.VolumeSpec(ORIGIN, VOX, DIMS)
    rays = torch.from_numpy(TR.generate_rays(H, W, *FOV))
    prm = TR.march_params(spec, ORIGIN, 4, 0.5)
    steps = max_steps or TR.default_max_steps(spec, 0.5)
    stats = {}
    TR.raycast_plain(ts, TR.occupancy_grid(ts.tsdf), rays, torch.zeros(3),
                     prm, DIMS, 4, steps, stats)
    per = stats["ray_samples"]
    assert per.shape == (H * W,) and int(per.min()) >= 1
    assert int(per.sum()) == stats["steps"]
    assert stats["samples_max"] == int(per.max()) <= steps + 1
    assert stats["samples_p99"] == int(np.quantile(per.numpy(), 0.99,
                                                   method="higher"))
    if max_steps == 1:
        assert stats["samples_max"] == 2


@pytest.mark.parametrize("cells", [(16, 16, 8), (5, 7, 3), (9, 6, 33),
                                   (1, 1, 1), (63, 62, 31), (8, 4, 52)])
def test_pack_occupancy_gives_the_grid_back(cells):
    """pack_occupancy_plain (the layout the march kernel reads): (wx, wy,
    wz) int32 words of 4 x 4 x 2 cells, cell (x, y, z) at bit
    ((x % 4) * 4 + y % 4) * 2 + z % 2 of word (x // 4, y // 4, z // 2);
    the words give back the grid for cell counts the brick does not
    divide (cz not a multiple of 32 or of 2); cells past the grid are 0;
    a CPU tensor launches nothing."""
    occ = torch.from_numpy(np.random.default_rng(sum(cells)).random(cells)
                           < 0.4)
    _build.reset_launch_counts()
    words = TR.pack_occupancy(occ)
    assert _build.launch_counts()["raymarch_pack"] == 0
    assert words.dtype == torch.int32
    assert tuple(words.shape) == TRC.words_shape(cells) == tuple(
        -(-c // b) for c, b in zip(cells, (4, 4, 2)))
    assert torch.equal(TR.occupancy_from_words(words, cells), occ)
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    for x, y, z in np.argwhere(np.ones(cells, bool))[::7]:
        bit = ((x % 4) * 4 + y % 4) * 2 + z % 2
        assert (w[x // 4, y // 4, z // 2] >> bit) & 1 == occ[x, y, z]
    full = TR.pack_occupancy(torch.ones(cells, dtype=torch.bool))
    assert int(TR.occupancy_from_words(full, [4 * s for s in (
        words.shape[0], words.shape[1])] + [2 * words.shape[2]]).sum()) \
        == int(np.prod(cells))


def test_raymarch_refuses_other_devices(volume):
    """The kernel's wrapper takes CUDA tensors only: a tensor on another
    device raises; so does a state of mixed dtypes."""
    meta = torch.device("meta")
    _, ts = _states(volume, False)
    spec = TT.VolumeSpec(ORIGIN, VOX, DIMS)
    prm = TR.march_params(spec, ORIGIN, 4, 0.5)
    occ = torch.zeros((16, 16, 8), dtype=torch.bool, device=meta)
    ms = TT.TSDFState(*(a.to(meta) for a in ts))
    rays = torch.zeros((8, 3), device=meta)
    with pytest.raises(ValueError, match="meta"):
        TR.raymarch(ms, occ, rays, torch.zeros(3, device=meta), prm, DIMS,
                    4, 10)
    with pytest.raises(ValueError, match="rays on cpu"):
        TRC.raymarch_cuda(ts, torch.zeros((16, 16, 8), dtype=torch.bool),
                          torch.zeros((8, 3)), torch.zeros(3), prm, DIMS, 4,
                          10)
    with pytest.raises(ValueError, match="occ on cpu"):
        TRC.pack_occupancy_cuda(torch.zeros((16, 16, 8), dtype=torch.bool))


# ------------------------------------------------------------ the engine
SOURCE = SensorSpec(name="src32", beams=32, fov_up=5.0, fov_down=-24.0,
                    angle_res_hor=360.0 / 512.0)
CROSS = SensorSpec(name="tgt16", beams=16, fov_up=8.0, fov_down=-22.0,
                   angle_res_hor=360.0 / 256.0)
BOUNDS = ((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A synthetic 32-beam sequence whose beams lie 0.5 deg inside the
    fov (``tests/test_torch_engine.py`` says why)."""
    root = str(tmp_path_factory.mktemp("raymarch_kitti"))
    beams = SensorSpec(name=SOURCE.name, beams=SOURCE.beams,
                       fov_up=SOURCE.fov_up - 0.5,
                       fov_down=SOURCE.fov_down + 0.5,
                       angle_res_hor=SOURCE.angle_res_hor)
    synthetic.write_kitti_dataset(root, synthetic.Scene.default(), beams,
                                  n_scans=4)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(SOURCE.to_dict(), f)
    seq = kitti.KittiSequence.open(root)
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    return seq, cap


@pytest.mark.parametrize("adaption,fixed,compact", [
    ("mergemesh", True, True), ("mergemesh", False, False),
    ("mesh", True, False)])
def test_raymarch_engine_matches_jax(dataset, adaption, fixed, compact):
    """TransferEngine(synthesis="raymarch").transfer_fast against the JAX
    engine's on the same window: label and mask on >= 99.9 % of pixels,
    range within 1e-3 m and remission within 1e-6 where both hit (the
    mesh adaption with float32 state: a compact chain is rounded once in
    the port and after every scan by the JAX engine, ROADMAP.md section
    3). The volume is integrated in the frame: fused_state() returns it."""
    seq, cap = dataset
    n = 3 if adaption == "mesh" else 1
    cfg = TransferConfig(voxel_size=0.25, voxel_bounds=BOUNDS,
                         adaption=adaption, number_of_scans=n)
    kw = dict(fixed_bounds=fixed, synthesis="raymarch",
              compact_volume=compact)
    je = JD.TransferEngine(SOURCE, CROSS, cfg, cap, **kw)
    te = TD.TransferEngine(SOURCE, CROSS, cfg, device="cpu", **kw)
    w = JM.load_window(seq, cfg, 1, cap)
    j = je.transfer_fast(w)
    t = te.transfer_fast(interop.window_from_numpy(w))
    jl, tl = np.asarray(j.label), t.label.numpy()
    jm, tm = np.asarray(j.mask), t.mask.numpy()
    agree = (jl == tl) & (jm == tm)
    assert agree.mean() >= AGREE and jm.mean() > 0.3
    both = agree & jm
    np.testing.assert_allclose(t.range.numpy()[both],
                               np.asarray(j.range)[both], atol=RANGE_TOL)
    np.testing.assert_allclose(t.remission.numpy()[both],
                               np.asarray(j.remission)[both], atol=1e-6)
    assert t.adaption == adaption
    state = te.fused_state()
    assert state is te.fused_state() and bool((state.tsdf < 1).any())


def test_raymarch_stream_equals_per_frame(dataset):
    """transfer_stream with raymarch synthesis == per-frame transfer_fast,
    bit for bit; each frame integrates its own volume, so fused_state()
    after the stream is the last frame's."""
    seq, cap = dataset
    cfg = TransferConfig(voxel_size=0.25, voxel_bounds=BOUNDS)
    te = TD.TransferEngine(SOURCE, CROSS, cfg, fixed_bounds=True,
                           device="cpu", synthesis="raymarch")
    tws = [interop.window_from_numpy(JM.load_window(seq, cfg, i, cap))
           for i in (0, 2)]
    per = [te.transfer_fast(w) for w in tws]
    last = TT.TSDFState(*(a.clone() for a in te.fused_state()))
    sv = te.transfer_stream(TM.stack_windows(tws))
    for k, vs in enumerate(per):
        for f in ("range", "label", "remission", "points", "mask"):
            assert torch.equal(getattr(sv, f)[k], getattr(vs, f)), f
    for a, b in zip(te.fused_state(), last):
        assert torch.equal(a, b)
