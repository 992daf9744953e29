"""The port's mesh adaption and materialised volume against the JAX package
(CPU).

``TransferEngine`` with ``adaption: mesh`` and three scans per window, in
``lidar_transfer_tpu/pipeline/deform.py`` and in the port, runs on the same
windows (loaded once by the JAX package, carried across with
``interop.window_from_numpy``): the fold and the materialised volume
(``mesh_attrs="volume"``), fixed and clipped bounds, ``fused_state()``
(float32 and compact), ``transfer_stream``, ``export_mesh`` and the CLI
with ``--ply``. The band attributes ``_band_samples_fold`` and
``_band_samples`` of ``lidar_transfer_tpu/ops/splat.py`` are held
against the port's on the same inputs.

As in ``tests/test_torch_engine.py`` the synthetic sensor's edge beams lie
0.5 deg inside the configured FOV; its ranges carry 1 cm of noise.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_transfer_tpu import cli as jcli
from lidar_transfer_tpu.config import SensorSpec, TransferConfig
from lidar_transfer_tpu.datasets import kitti, synthetic
from lidar_transfer_tpu.ops import splat as JSp
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu.pipeline import multiscan as JM
from lidar_transfer_tpu_torch import cli, interop
from lidar_transfer_tpu_torch.ops import splat as TSp
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.pipeline import multiscan as TM
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


#: label/mask agreement of two virtual scans or volumes (atan2/asin/sqrt
#: ulps move a few samples across pixel or voxel boundaries)
AGREE = 0.999

SOURCE = SensorSpec(name="src16", beams=16, fov_up=5.0, fov_down=-24.0,
                    angle_res_hor=360.0 / 256.0)
CROSS = SensorSpec(name="tgt8", beams=8, fov_up=8.0, fov_down=-22.0,
                   angle_res_hor=360.0 / 128.0)
CFG = TransferConfig(adaption="mesh", number_of_scans=3, voxel_size=0.25,
                     voxel_bounds=((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mesh_kitti"))
    beams = SensorSpec(name=SOURCE.name, beams=SOURCE.beams,
                       fov_up=SOURCE.fov_up - 0.5,
                       fov_down=SOURCE.fov_down + 0.5,
                       angle_res_hor=SOURCE.angle_res_hor)
    # 1 cm of range noise, as a real sensor has: a noiseless ground ring
    # has exactly equal ranges along a beam, and those exact depth ties
    # of fold candidates with different tsdf would go either way
    synthetic.write_kitti_dataset(root, synthetic.Scene.default(), beams,
                                  n_scans=5, range_noise=0.01)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(SOURCE.to_dict(), f)
    with open(os.path.join(root, "cfg.yaml"), "w") as f:
        yaml.safe_dump(CFG.to_dict(), f)
    seq = kitti.KittiSequence.open(root)
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    return root, seq, cap


def _engines(dataset, target=CROSS, fixed=True, cfg=CFG, **kw):
    """(JAX engine, port engine). The JAX engine keeps a float32 volume:
    on the CPU it chains S XLA integrates and would round a compact
    volume after every scan, where the port (as the Pallas chain) rounds
    once."""
    _, _, cap = dataset
    jkw = {k: v for k, v in kw.items() if k != "compact_volume"}
    return (JD.TransferEngine(SOURCE, target, cfg, cap, fixed_bounds=fixed,
                              **jkw),
            TD.TransferEngine(SOURCE, target, cfg, fixed_bounds=fixed,
                              device="cpu", **kw))


def _window(dataset, idx, cfg=CFG):
    _, seq, cap = dataset
    w = JM.load_window(seq, cfg, idx, cap)
    return w, interop.window_from_numpy(w)


def _assert_scans_agree(j, t, range_atol=1e-3):
    jl, tl = np.asarray(j.label), t.label.numpy()
    jm, tm = np.asarray(j.mask), t.mask.numpy()
    agree = (jl == tl) & (jm == tm)
    assert agree.mean() >= AGREE, agree.mean()
    assert jm.mean() > 0.3
    both = agree & jm
    np.testing.assert_allclose(t.range.numpy()[both],
                               np.asarray(j.range)[both], atol=range_atol)
    np.testing.assert_allclose(t.remission.numpy()[both],
                               np.asarray(j.remission)[both], atol=1e-5)


# ------------------------------------------------------- band attributes
@pytest.fixture(scope="module")
def mesh_sources(dataset):
    """The JAX engine's three source tuples of one window (numpy), the
    volume its chain fused from them, and that volume's placement."""
    je = JD.TransferEngine(SOURCE, CROSS, CFG, dataset[2],
                           fixed_bounds=True, mesh_attrs="volume")
    w, _ = _window(dataset, 2)
    je.transfer_fast(w)
    srcs = []
    for ri, fu, fd in je._last_sources:
        back = JD.P.reverse_project(ri, fov_up_deg=fu, fov_down_deg=fd,
                                    preserve_float=True)
        srcs.append(tuple(np.array(a) for a in (
            ri.range.reshape(-1), back, ri.mask.reshape(-1),
            ri.label.reshape(-1),
            jnp.maximum(ri.remission, 0.0).reshape(-1))))
    state = interop.to_numpy(je.fused_state())
    origin = np.asarray(je.vol_spec.origin, np.float32)
    return srcs, state, origin, je.vol_spec


def _torch(a):
    return torch.from_numpy(np.array(a))


def _assert_candidates_agree(j, t, found_at=5):
    j = [np.asarray(a) for a in j]
    t = [a.numpy() for a in t]
    both = j[found_at] & t[found_at]
    assert (j[found_at] == t[found_at]).mean() >= AGREE
    assert both.sum() > 1000
    np.testing.assert_allclose(t[0][both], j[0][both], atol=1e-5)
    np.testing.assert_allclose(t[1][both], j[1][both], atol=1e-5)
    np.testing.assert_allclose(t[2][both], j[2][both], atol=1e-5)
    np.testing.assert_array_equal(t[3][both], j[3][both])
    np.testing.assert_allclose(t[4][both], j[4][both], atol=1e-5)


def test_band_samples_fold_matches(mesh_sources):
    """_band_samples_fold: the class-aware fold of three aligned images
    gives the same candidates (found on >= 99.9 % of rays, positions,
    depths and tsdf within 1e-5, labels exact, rem within 1e-5)."""
    srcs, _, origin, spec = mesh_sources
    stacks = [np.stack([s[i] for s in srcs]) for i in range(5)]
    active = np.asarray(spec.dims, np.float32)
    j = JSp._band_samples_fold(
        *(jnp.asarray(a) for a in stacks), jnp.asarray(origin),
        jnp.asarray(active), dims=spec.dims, voxel_size=spec.voxel_size,
        samples_per_ray=8, trunc_margin=spec.trunc_margin)
    t = TSp._band_samples_fold(
        *(_torch(a) for a in stacks), _torch(origin), _torch(active),
        voxel_size=spec.voxel_size, samples_per_ray=8,
        trunc_margin=spec.trunc_margin)
    _assert_candidates_agree(j, t)


@pytest.mark.parametrize("label_probe", [False, True])
def test_band_samples_volume_matches(mesh_sources, label_probe):
    """_band_samples on the JAX engine's fused volume, carried across by
    interop: the same candidates per ray (as the fold test)."""
    srcs, state, origin, spec = mesh_sources
    tstate = interop.state_from_numpy(state)
    active = np.asarray(spec.dims, np.float32)
    for r, p, v, _, _ in srcs:
        j = JSp._band_samples(
            jnp.asarray(state.tsdf), jnp.asarray(state.label),
            jnp.asarray(state.rem), jnp.asarray(r), jnp.asarray(p),
            jnp.asarray(v), jnp.asarray(origin), jnp.asarray(active),
            dims=spec.dims, voxel_size=spec.voxel_size, samples_per_ray=8,
            label_probe=label_probe)
        t = TSp._band_samples(
            tstate.tsdf, tstate.label, tstate.rem, _torch(r), _torch(p),
            _torch(v), _torch(origin), _torch(active),
            voxel_size=spec.voxel_size, samples_per_ray=8,
            label_probe=label_probe)
        _assert_candidates_agree(j, t)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("attrs", ["fold", "volume"])
def test_mesh_transfer_matches(dataset, attrs, fixed):
    """transfer_fast of the mesh adaption, fold and materialised volume,
    fixed and clipped bounds: label/mask agree on >= 99.9 % of pixels,
    range within 1e-3 m where they agree."""
    je, te = _engines(dataset, fixed=fixed, mesh_attrs=attrs)
    w, tw = _window(dataset, 2)
    j, t = je.transfer_fast(w), te.transfer_fast(tw)
    _assert_scans_agree(j, t)
    assert t.adaption == "mesh"
    assert te._fused == (attrs == "volume")
    jt, tt = je.transfer(w), te.transfer(tw)
    _assert_scans_agree(jt[0], tt[0])
    np.testing.assert_array_equal(tt[1].label.numpy(),
                                  np.asarray(jt[1].label))


def _assert_volumes_agree(j, t, exact_weight=True):
    same = t.label == j.label
    assert same.mean() >= AGREE
    assert (t.tsdf < 1).sum() > 1000
    np.testing.assert_allclose(t.tsdf[same], j.tsdf[same], atol=1e-5)
    np.testing.assert_allclose(t.rem[same], j.rem[same], atol=1e-5)
    if exact_weight:
        assert (t.weight == j.weight).mean() >= AGREE


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 bits of mantissa)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("fixed", [True, False])
def test_mesh_fused_state_matches(dataset, fixed, compact):
    """fused_state() of a deferred mesh frame: the S-scan chain (with the
    geometry table under fixed bounds). Float32: equal to the JAX
    engine's sequential integrates on >= 99.9 % of voxels (label and
    weight), tsdf/rem within 1e-5. Compact: the JAX float32 chain cast
    once to bf16/int16, labels on >= 99.9 %, tsdf/rem within one bf16
    ulp."""
    je, te = _engines(dataset, fixed=fixed, compact_volume=compact)
    w, tw = _window(dataset, 1)
    je.transfer_fast(w)
    te.transfer_fast(tw)
    j = interop.to_numpy(je.fused_state())
    t = interop.to_numpy(te.fused_state())
    assert len(te._geoms) == int(fixed)
    assert te.fused_state() is te.fused_state()      # integrated once
    if not compact:
        _assert_volumes_agree(j, t)
        return
    assert t.tsdf.dtype == np.float32 and t.label.dtype == np.int16
    same = t.label == j.label.astype(np.int16)
    assert same.mean() >= AGREE
    for f in ("tsdf", "rem", "weight"):
        a, b = getattr(t, f)[same], getattr(j, f)[same]
        assert (np.abs(a - b) <= _bf16_ulp(b)).all(), f


def test_mergemesh_fused_state_with_table(dataset):
    """mergemesh fused_state() under fixed bounds reads the geometry
    table and equals the JAX engine's volume (as in
    tests/test_torch_engine.py), float32 and compact."""
    cfg = TransferConfig(voxel_size=CFG.voxel_size,
                         voxel_bounds=CFG.voxel_bounds)
    je, te = _engines(dataset, cfg=cfg)
    _, tc = _engines(dataset, cfg=cfg, compact_volume=True)
    w, tw = _window(dataset, 2, cfg)
    je.transfer_fast(w)
    te.transfer_fast(tw)
    tc.transfer_fast(tw)
    j = interop.to_numpy(je.fused_state())
    t = interop.to_numpy(te.fused_state())
    c = interop.to_numpy(tc.fused_state())
    assert list(te._geoms) == [(CROSS.fov_up, CROSS.fov_down, SOURCE.H)]
    _assert_volumes_agree(j, t, exact_weight=False)
    same = c.label == t.label
    assert same.mean() >= AGREE
    assert (np.abs(c.tsdf - t.tsdf)[same] <= _bf16_ulp(t.tsdf[same])).all()


def test_mergemesh_materialised_matches(dataset):
    """mergemesh() with defer_volume=False integrates in the frame: the
    virtual scan and the volume equal the JAX engine's."""
    cfg = TransferConfig(voxel_size=CFG.voxel_size,
                         voxel_bounds=CFG.voxel_bounds)
    je, te = _engines(dataset, cfg=cfg, defer_volume=False)
    w, tw = _window(dataset, 2, cfg)
    (jv, _), (tv, _) = je.transfer(w), te.transfer(tw)
    _assert_scans_agree(jv, tv, range_atol=1e-4)
    assert te._fused
    _assert_volumes_agree(interop.to_numpy(je.fused_state()),
                          interop.to_numpy(te.fused_state()))


def test_mesh_transfer_stream_equals_per_frame(dataset):
    """transfer_stream == per-frame transfer_fast, bit for bit, and
    fused_state(frame=i) integrates the i-th streamed frame's chain."""
    _, te = _engines(dataset)
    tws = [_window(dataset, i)[1] for i in (1, 2, 3)]
    per = [te.transfer_fast(w) for w in tws]
    ref = interop.to_numpy(te.fused_state())
    sv = te.transfer_stream(TM.stack_windows(tws))
    for k, vs in enumerate(per):
        for f in ("range", "label", "remission", "points", "mask"):
            np.testing.assert_array_equal(getattr(sv, f)[k].numpy(),
                                          getattr(vs, f).numpy())
    with pytest.raises(ValueError, match="frame"):
        te.fused_state()
    with pytest.raises(IndexError):
        te.fused_state(frame=3)
    got = interop.to_numpy(te.fused_state(frame=-1))
    for f in ("tsdf", "weight", "label", "rem"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


def test_export_mesh(dataset, tmp_path):
    """export_mesh: the cells extraction gives the host extraction's
    triangles, and the triangle count equals the JAX engine's."""
    je, te = _engines(dataset)
    w, tw = _window(dataset, 2)
    je.transfer_fast(w)
    te.transfer_fast(tw)
    lut = np.random.default_rng(0).integers(0, 255, (300, 3), np.uint8)
    n_host = te.export_mesh(str(tmp_path / "h.ply"), colorize=lut,
                            extract="host")
    n_cells = te.export_mesh(str(tmp_path / "c.ply"), colorize=lut,
                             extract="cells")
    n_jax = je.export_mesh(str(tmp_path / "j.ply"), colorize=lut,
                           extract="host")
    assert n_host == n_cells == n_jax > 1000
    # binary PLY: 3 vertices of 27 B and one 13 B face per triangle
    sizes = {(tmp_path / p).stat().st_size for p in ("h.ply", "c.ply")}
    assert len(sizes) == 1 and sizes.pop() > 94 * n_host


def test_cli_mesh_ply_matches_jax(dataset, tmp_path):
    """The port's CLI (--device cpu) with adaption mesh, 3 scans and --ply
    against ``lidar_transfer_tpu.cli --cpu`` on the same dataset: metrics
    within 2e-3 (IoU/Acc) and 2 % (MSE), point counts within 0.1 % of the
    pixels, triangle counts within 0.1 %, one PLY per frame."""
    root, seq, _ = dataset
    runs = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--cpu"])):
        mj = tmp_path / f"{name}.json"
        ply = tmp_path / f"{name}_ply"
        rc = main(["-d", root, "-c", os.path.join(root, "cfg.yaml"),
                   "--fixed-bounds", "-w", "-p", str(tmp_path / name),
                   "--ply", str(ply), "--stream", "2",
                   "--metrics-json", str(mj), *extra])
        assert rc == 0
        runs[name] = json.loads(mj.read_text())
        assert len(os.listdir(ply)) == len(seq) - 2
    for t, j in zip(runs["torch"], runs["jax"]):
        assert t["index"] == j["index"]
        assert t["iou"] == pytest.approx(j["iou"], abs=2e-3)
        assert t["acc"] == pytest.approx(j["acc"], abs=2e-3)
        assert t["mse"] == pytest.approx(j["mse"], rel=2e-2)
        assert abs(t["points_written"] - j["points_written"]) <= \
            1e-3 * SOURCE.H * SOURCE.W
        assert abs(t["triangles"] - j["triangles"]) <= 1e-3 * j["triangles"]


def test_mesh_engine_workspace_reused_over_frames_and_targets(dataset):
    """Two mesh engines (two targets) that each keep one z-buffer
    workspace over their frames (S source projections and a target
    assemble a frame) equal the JAX engines frame by frame, at the
    tolerances of ``_assert_scans_agree``."""
    for target in (CROSS, SOURCE):
        je, te = _engines(dataset, target=target)
        ws = te._zbuf
        for idx in (1, 2, 3):
            w, tw = _window(dataset, idx)
            _assert_scans_agree(je.transfer_fast(w), te.transfer_fast(tw))
            assert te._zbuf is ws
