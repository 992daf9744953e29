"""The port's ``parallel/sharding.py`` on torch.distributed against the JAX
package's ``lidar_transfer_tpu/parallel/sharding.py`` (CPU, gloo).

Each world size (2 and 4 ranks) is one process group of child processes
(``tests/torch_parallel_worker.py``, which imports the port alone), spawned
once for the module with a ``file://`` store under ``tmp_path``; every
check of that size runs in it on inputs this module writes with numpy, and
the ranks' results come back as files. The meshes: model 1 and the auto
layout (2x1 and 1x2 at two ranks, 4x1 and 2x2 at four). The JAX side runs
in this process on the conftest's 8-device CPU mesh.

Tolerances: the port's sharded fusion and synthesis, joined, equal the
port's single-process integrate and ``splat_synthesize(attrs="volume")``
bit for bit (the slabs use the global origin and an integer x offset);
against JAX's ``integrate`` and ``integrate_sharded`` the label is exact,
tsdf and weight within 1e-6; against JAX's ``splat_synthesize_sharded``
on JAX's volume carried into the slabs, mask and label on >= 99.9 % of
pixels, range within 1e-4 m and remission within 1e-5 where they agree
(``tests/test_torch_splat.py``); the fused volumes at 0.05 m, labels on
>= 1 - 1e-4 of voxels and tsdf within 1e-5 where they agree; confusion
counts exact; ``frame_parallel_transfer`` equal to the port's
``transfer_fast`` frame by frame and held to JAX's frame-parallel frames
as ``tests/test_torch_mesh.py`` holds frames of its dataset with 1 cm of
range noise (label and mask on >= 99.9 % of pixels, range within 1e-3 m
where they agree, and remission within 1e-5 on >= 99.9 % of those: two
chord candidates of an upsampling target within a millimetre of each
other can win either way, 2 of 22,095 pixels); the train steps (3 Adam
steps, batch 2, unequal masks) within the bounds of
``tests/test_torch_experiments.py``: every parameter within 2e-3,
>= 99.9 % within 1e-4,
losses within 1e-5 relative (``tests/test_torch_model.py``).
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_transfer_tpu.config import SensorSpec as JSensorSpec
from lidar_transfer_tpu.config import TransferConfig as JTransferConfig
from lidar_transfer_tpu.datasets import kitti as JK
from lidar_transfer_tpu.datasets import synthetic as JSY
from lidar_transfer_tpu.models import rangenet as JR
from lidar_transfer_tpu.ops import splat as JSp
from lidar_transfer_tpu.ops import tsdf as JT
from lidar_transfer_tpu.parallel import make_mesh as j_make_mesh
from lidar_transfer_tpu.parallel import sharding as JPS
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu.pipeline import multiscan as JM
from lidar_transfer_tpu_torch import interop
from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
from lidar_transfer_tpu_torch.experiments import segmentation as TSG
from lidar_transfer_tpu_torch.models import rangenet as TR
from lidar_transfer_tpu_torch.ops import raycast as TRC
from lidar_transfer_tpu_torch.ops import splat as TSp
from lidar_transfer_tpu_torch.ops import tsdf as TT
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


AGREE = 0.999
FOV = dict(fov_up_deg=30.0, fov_down_deg=-30.0)
H, W = 16, 64
INTEGRATE_SPEC = ((-4.0, -4.0, -2.0), 0.25, (32, 32, 16))
#: JAX's test_sharded_synthesis_matches_single geometries: 0.05 is not
#: exact in float32, so slab ownership must come from the global index
SYNTH_SPECS = {"coarse": ((-8.0, -8.0, -2.0), 0.25, (64, 64, 16)),
               "fine": ((-8.0, -8.0, -2.0), 0.05, (320, 320, 80))}
C = 7
TCFG = dataclasses.replace(TR.RangeNetConfig.tiny(num_classes=C),
                           compute_dtype=torch.float32)
JCFG = dataclasses.replace(JR.RangeNetConfig.tiny(num_classes=C),
                           compute_dtype=jnp.float32)
MAPPER = TSG.LabelMapper.from_labels(dict(TransferConfig().labels))
SEG_CFG = dataclasses.replace(
    TR.RangeNetConfig.tiny(num_classes=MAPPER.num_classes),
    compute_dtype=torch.float32)

# the frame-parallel dataset: as tests/test_torch_engine.py's, the
# synthetic beams 0.5 deg inside the configured FOV
SOURCE = JSensorSpec(name="src32", beams=32, fov_up=5.0, fov_down=-24.0,
                     angle_res_hor=360.0 / 512.0)
CROSS = JSensorSpec(name="tgt16", beams=16, fov_up=8.0, fov_down=-22.0,
                    angle_res_hor=360.0 / 256.0)
UP = JSensorSpec(name="up64", beams=64, fov_up=5.0, fov_down=-24.0,
                 angle_res_hor=360.0 / 512.0)
CFG = dict(voxel_size=0.25,
           voxel_bounds=((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0)))
#: engine name -> (target, adaption, number_of_scans, engine kw, frames)
ENGINES = {"mergemesh": (CROSS, "mergemesh", 1, {}, [0, 1, 2, 3]),
           "mesh": (CROSS, "mesh", 2, {}, [1, 2, 3, 4]),
           "upsample": (UP, "mergemesh", 1, {}, [0, 1, 2, 3]),
           "raymarch": (CROSS, "mergemesh", 1, {"synthesis": "raymarch"},
                        [0, 1, 2, 3]),
           "mesh_volume": (CROSS, "mesh", 2, {"mesh_attrs": "volume"},
                           [1, 2, 3, 4])}


def _port_spec(s):
    return SensorSpec(**dataclasses.asdict(s))


def _images(seed):
    rng = np.random.default_rng(seed)
    depth = (rng.random((H, W)) * 6 + 0.5).astype(np.float32)
    label = rng.choice(np.array([10, 40, 50], np.int32), size=(H, W))
    rem = rng.random((H, W)).astype(np.float32)
    return depth, label, rem


@pytest.fixture(scope="module")
def frames_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("par_kitti"))
    beams = JSensorSpec(name=SOURCE.name, beams=SOURCE.beams,
                        fov_up=SOURCE.fov_up - 0.5,
                        fov_down=SOURCE.fov_down + 0.5,
                        angle_res_hor=SOURCE.angle_res_hor)
    # 1 cm of range noise, as tests/test_torch_mesh.py: a noiseless ground
    # ring's exact depth ties of fold candidates would go either way
    JSY.write_kitti_dataset(root, JSY.Scene.default(), beams, n_scans=5,
                            range_noise=0.01)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(SOURCE.to_dict(), f)
    seq = JK.KittiSequence.open(root)
    cap = JK.scan_capacity(max(os.path.getsize(f) // 16
                               for f in seq.scan_files))
    return seq, cap


def _windows(frames_dataset, adaption, nscans, idxs):
    seq, cap = frames_dataset
    cfg = JTransferConfig(adaption=adaption, number_of_scans=nscans, **CFG)
    return cfg, [JM.load_window(seq, cfg, i, cap) for i in idxs]


@pytest.fixture(scope="module")
def inputs(frames_dataset, synthetic_dataset):
    image1, image2 = _images(1), _images(2)
    jspec = JT.VolumeSpec(*INTEGRATE_SPEC)
    jstate1 = types.SimpleNamespace(**jax.device_get(JT.integrate(
        jspec.init_state(), jspec, *(jnp.asarray(a) for a in image1),
        **FOV))._asdict())
    jax_volumes = {}
    for geom, args in SYNTH_SPECS.items():
        js = JT.VolumeSpec(*args)
        jax_volumes[geom] = types.SimpleNamespace(**jax.device_get(
            JT.integrate(js.init_state(), js,
                         *(jnp.asarray(a) for a in image1),
                         **FOV))._asdict())
    rays = np.asarray(TRC.generate_rays(H, W, 30.0, -30.0), np.float32)
    d_flat = image1[0].reshape(-1)
    rng = np.random.default_rng(3)
    conf = rng.integers(-2, 22, (2, 4, 5000)).astype(np.int32)
    frames = {}
    for name, (target, adaption, nscans, kw, idxs) in ENGINES.items():
        cfg, wins = _windows(frames_dataset, adaption, nscans, idxs)
        stacked = types.SimpleNamespace(**{
            f: np.stack([np.asarray(getattr(w, f)) for w in wins])
            for f in ("points", "remissions", "labels", "valid",
                      "rel_pose")})
        frames[name] = (_port_spec(SOURCE), _port_spec(target),
                        TransferConfig(**dataclasses.asdict(cfg)), kw,
                        stacked)
    jparams, _, _ = JR.make_train_state(JR.RangeNet(JCFG),
                                        jax.random.PRNGKey(3),
                                        (1, 16, 64, 5))
    jparams = jax.device_get(jparams)
    brng = np.random.default_rng(4)
    batch = dict(
        features=brng.normal(size=(2, 16, 64, 5)).astype(np.float32),
        labels=brng.integers(0, C, (2, 16, 64)).astype(np.int32),
        # unequal masks: 80 % and 30 % of the pixels carry weight
        weights=(brng.random((2, 16, 64))
                 < np.array([0.8, 0.3])[:, None, None]).astype(np.float32))
    return dict(
        fov=FOV, image1=image1, image2=image2,
        integrate_spec=INTEGRATE_SPEC, jax_state1=jstate1,
        sources=(d_flat, rays * d_flat[:, None], d_flat > 0),
        synth_specs=SYNTH_SPECS, jax_volumes=jax_volumes, confusion=(conf[0], conf[1]), n_classes=20,
        frames=frames, model_cfg=TCFG, jax_params=jparams,
        params=interop.rangenet_state_dict(jparams, TCFG), batch=batch,
        seg_dataset=synthetic_dataset, seg_cfg=SEG_CFG,
        grid_cfg=TransferConfig(adaption="mergemesh", number_of_scans=1,
                                **CFG))


def _spawn(world, inputs, tmp_path_factory):
    """Run the worker on ``world`` ranks; -> each rank's results."""
    d = tmp_path_factory.mktemp(f"world{world}")
    path = str(d / "inputs.pt")
    torch.save({k: v for k, v in inputs.items() if k != "jax_params"},
               path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(d / "pg"), path,
         str(d)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    return [torch.load(str(d / f"rank{r}.pt"), weights_only=False)
            for r in range(world)], d


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    return _spawn(2, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return _spawn(4, inputs, tmp_path_factory)


@pytest.fixture(params=["world2", "world4"])
def ranks(request):
    return request.getfixturevalue(request.param)[0]


@pytest.fixture(scope="module")
def mesh8():
    return j_make_mesh(8)


def _join(ranks, key):
    """The ranks' slabs in rank order, joined along X."""
    return [np.concatenate([r[key][i] for r in ranks]) for i in range(4)]


# ------------------------------------------------------------ band probe
def test_band_samples_x_offset_matches(inputs):
    """``_band_samples(x_offset=)`` against JAX's on four X-slabs of the
    0.05 m volume whose boundaries cut rays' samples: per slab the same
    candidates (found on >= 99.9 % of rays, positions, depths, tsdf and
    remission within 1e-5, labels exact, as ``tests/test_torch_mesh.py``);
    the nearest candidate over the slabs is the whole volume's, bit for
    bit."""
    origin, vox, dims = SYNTH_SPECS["fine"]
    jspec = JT.VolumeSpec(origin, vox, dims)
    st = jax.device_get(JT.integrate(
        jspec.init_state(), jspec,
        *(jnp.asarray(a) for a in inputs["image1"]), **FOV))
    r, p, v = inputs["sources"]
    org = np.asarray(origin, np.float32)
    slab = dims[0] // 4
    sdims = (slab,) + dims[1:]
    active = np.asarray(sdims, np.float32)
    # the sample positions' global x index: rays whose samples fall in two
    # slabs exist
    k = (np.arange(8, dtype=np.float32) + 0.5) * np.float32(vox * 0.5)
    dirs = p / np.maximum(r, 1e-6)[:, None]
    gx = np.round(((dirs[None, :, 0] * (r[None] + k[:, None])) - org[0])
                  / np.float32(vox)).astype(int) // slab
    assert ((gx.min(axis=0) != gx.max(axis=0)) & v).sum() > 10
    tmin = np.full(r.shape, np.inf, np.float32)
    for s in range(4):
        part = [a[s * slab:(s + 1) * slab] for a in (st.tsdf, st.label,
                                                     st.rem)]
        j = JSp._band_samples(
            *(jnp.asarray(a) for a in part), jnp.asarray(r),
            jnp.asarray(p), jnp.asarray(v), jnp.asarray(org),
            jnp.asarray(active), dims=sdims, voxel_size=vox,
            samples_per_ray=8, x_offset=s * slab)
        tst = interop.state_from_numpy(types.SimpleNamespace(
            tsdf=part[0], weight=part[0], label=part[1], rem=part[2]))
        t = TSp._band_samples(
            tst.tsdf, tst.label, tst.rem, torch.from_numpy(r),
            torch.from_numpy(p), torch.from_numpy(v), torch.from_numpy(org),
            torch.from_numpy(active), vox, 8, x_offset=s * slab)
        j = [np.asarray(a) for a in j]
        t = [a.numpy() for a in t]
        assert (j[5] == t[5]).mean() >= AGREE
        both = j[5] & t[5]
        assert both.sum() > 20
        for i in (0, 1, 2, 4):
            np.testing.assert_allclose(t[i][both], j[i][both], atol=1e-5)
        np.testing.assert_array_equal(t[3][both], j[3][both])
        tmin = np.minimum(tmin, np.where(t[5], t[1], np.inf))
    whole = [a.numpy() for a in TSp._band_samples(
        *(torch.from_numpy(np.array(a)) for a in (st.tsdf, st.label,
                                                  st.rem)),
        torch.from_numpy(r), torch.from_numpy(p), torch.from_numpy(v),
        torch.from_numpy(org), torch.tensor(dims, dtype=torch.float32), vox,
        8)]
    np.testing.assert_array_equal(np.isfinite(tmin), whole[5])
    np.testing.assert_array_equal(tmin[whole[5]], whole[1][whole[5]])


# --------------------------------------------------------------- fusion
def _port_integrate(spec_args, images, compact=False, state=None):
    spec = TT.VolumeSpec(*spec_args)
    st = spec.init_state(compact=compact) if state is None else state
    for im in images:
        st = TT.integrate(st, spec, *(torch.from_numpy(a) for a in im),
                          **FOV)
    return st


def _assert_volume_matches_jax(got, want):
    np.testing.assert_array_equal(got[2], np.asarray(want.label))
    np.testing.assert_allclose(got[0], np.asarray(want.tsdf), atol=1e-6)
    np.testing.assert_allclose(got[1], np.asarray(want.weight), atol=1e-6)


@pytest.mark.parametrize("mesh", ["model1", "auto"])
def test_integrate_sharded_matches(ranks, inputs, mesh8, mesh):
    """``integrate_sharded`` on 2 and 4 ranks, joined: the port's
    single-process integrate bit for bit, and JAX's ``integrate`` on one
    device and ``integrate_sharded`` on the 8-device mesh (label exact,
    tsdf and weight within 1e-6); a JAX volume split into the port's slabs
    and fused on carries on as JAX's does."""
    got = _join(ranks, f"integrate/{mesh}")
    want = _port_integrate(INTEGRATE_SPEC, [inputs["image1"]])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert (got[0] < 1).sum() > 500
    jspec = JT.VolumeSpec(*INTEGRATE_SPEC)
    im = [jnp.asarray(a) for a in inputs["image1"]]
    _assert_volume_matches_jax(got, JT.integrate(jspec.init_state(), jspec,
                                                 *im, **FOV))
    _assert_volume_matches_jax(got, JPS.integrate_sharded(
        JPS.shard_volume(jspec.init_state(), mesh8), jspec, mesh8, *im,
        **FOV))
    carried = _join(ranks, f"carried/{mesh}")
    j2 = JT.integrate(JT.TSDFState(**vars(inputs["jax_state1"])), jspec,
                      *(jnp.asarray(a) for a in inputs["image2"]), **FOV)
    _assert_volume_matches_jax(carried, j2)


# ------------------------------------------------------------ synthesis
def _hash(t: torch.Tensor) -> str:
    import hashlib

    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.fixture(scope="module")
def synth_refs(inputs, mesh8):
    """Per (geometry, compact): the port's single-process volume and its
    ``splat_synthesize(attrs="volume")`` scan, and JAX's
    ``splat_synthesize_sharded`` scan on the 8-device mesh."""
    refs = {}
    r, p, v = (torch.from_numpy(a) for a in inputs["sources"])
    z = torch.zeros_like(r)
    for geom, spec_args in SYNTH_SPECS.items():
        for compact in (False, True):
            state = _port_integrate(spec_args, [inputs["image1"]], compact)
            want = TSp.splat_synthesize(
                state, TT.VolumeSpec(*spec_args), [(r, p, v, z, z)],
                target_H=H, target_W=W, vol_origin=spec_args[0],
                attrs="volume", **FOV)
            jspec = JT.VolumeSpec(*spec_args)
            jinit = (jspec.init_state_compact() if compact
                     else jspec.init_state())
            jst = JPS.integrate_sharded(
                JPS.shard_volume(jinit, mesh8), jspec, mesh8,
                *(jnp.asarray(a) for a in inputs["image1"]), **FOV)
            j = JPS.splat_synthesize_sharded(
                jst, jspec, mesh8,
                [tuple(jnp.asarray(a) for a in inputs["sources"])],
                target_H=H, target_W=W, **FOV)
            refs[geom, compact] = (state, [a.numpy() for a in want],
                                   [np.asarray(a) for a in j])
    return refs


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("geom", ["coarse", "fine"])
def test_splat_synthesize_sharded_matches(ranks, inputs, synth_refs, geom,
                                          compact):
    """``integrate_sharded`` and ``splat_synthesize_sharded`` at (0.25,
    64x64x16) and (0.05, 320x320x80), float32 and compact, on every mesh:
    each rank's slab equal to its planes of the port's single-process
    volume, and the scan equal on every rank to the port's single-process
    ``splat_synthesize(attrs="volume")``, bit for bit. JAX's
    ``splat_synthesize_sharded`` on the 8-device mesh against the port's
    on JAX's volume carried into the slabs: mask and label on >= 99.9 %
    of pixels, range within 1e-4 m and remission within 1e-5 where they
    agree (``tests/test_torch_splat.py``). The port's fused volume against
    JAX's ``integrate``: label exact at 0.25 and on >= 1 - 1e-4 of voxels
    at 0.05 (an asin ulp moves a voxel's pixel; 110 of 8,192,000 voxels),
    tsdf within 1e-5 where the labels agree (``tests/test_torch_tsdf.py``),
    weight exact."""
    state, want, j = synth_refs[geom, compact]
    assert want[4].mean() > 0.05
    jvol = inputs["jax_volumes"][geom]
    if not compact:
        same = state.label.numpy() == jvol.label
        assert same.mean() >= (1.0 if geom == "coarse" else 1 - 1e-4)
        np.testing.assert_allclose(state.tsdf.numpy()[same],
                                   jvol.tsdf[same], atol=1e-5)
        np.testing.assert_array_equal(state.weight.numpy(), jvol.weight)
    slab = SYNTH_SPECS[geom][2][0] // len(ranks)
    for i, rank in enumerate(ranks):
        assert rank[f"slab_hash/{geom}/{compact}"] == [
            _hash(t[i * slab:(i + 1) * slab]) for t in state]
        for mesh in ("model1", "auto"):
            key = f"{geom}/{compact}/{mesh}"
            for g, w in zip(rank[f"synth/{key}"], want):
                np.testing.assert_array_equal(g, w)
            got = rank[f"synth_jax/{key}"]
            same = (j[4] == got[4]) & (j[1] == got[1])
            assert same.mean() >= AGREE, same.mean()
            both = same & j[4]
            np.testing.assert_allclose(got[0][both], j[0][both], atol=1e-4)
            np.testing.assert_allclose(got[2][both], j[2][both], atol=1e-5)


# ------------------------------------------------------------ confusion
def test_sharded_confusion_matches(ranks, inputs, mesh8):
    """``sharded_confusion`` against JAX's on the 8-device mesh (4 data
    rows): the counts exact on every rank and mesh."""
    pred, tgt = inputs["confusion"]
    want = np.asarray(JPS.sharded_confusion(mesh8, 20)(
        jnp.asarray(pred), jnp.asarray(tgt)))
    assert want.sum() > 10000
    for rank in ranks:
        for mesh in ("model1", "auto"):
            np.testing.assert_array_equal(rank[f"confusion/{mesh}"], want)


# ------------------------------------------------------ frame parallel
@pytest.mark.parametrize("name", ["mergemesh", "mesh", "upsample"])
def test_frame_parallel_transfer_matches(world2, frames_dataset, name):
    """``frame_parallel_transfer``, 4 frames on 2 ranks (the mergemesh fast
    body, the mesh fold and an upsampling target's deferred body): every
    rank holds every frame, each equal to the port's ``transfer_fast``
    bit for bit, and held to JAX's ``frame_parallel_transfer`` on a 2-device
    mesh as ``tests/test_torch_mesh.py`` holds frames."""
    ranks = world2[0]
    target_j, adaption, nscans, kw, idxs = ENGINES[name]
    jcfg, jwins = _windows(frames_dataset, adaption, nscans, idxs)
    teng = TD.TransferEngine(_port_spec(SOURCE), _port_spec(target_j),
                             TransferConfig(**dataclasses.asdict(jcfg)),
                             fixed_bounds=True, device="cpu", **kw)
    got = ranks[0][f"frames/{name}"]
    for rank in ranks[1:]:
        for a, b in zip(rank[f"frames/{name}"], got):
            np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] == 4
    jeng = JD.TransferEngine(SOURCE, target_j, jcfg, frames_dataset[1],
                             fixed_bounds=True, **kw)
    mesh2 = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                              ("data", "model"))
    j = [np.asarray(a) for a in JPS.frame_parallel_transfer(
        jeng, JM.stack_windows(jwins), mesh=mesh2)]
    for k, w in enumerate(jwins):
        vs = teng.transfer_fast(interop.window_from_numpy(w))
        for a, b in zip(got, vs[:5]):
            np.testing.assert_array_equal(a[k], b.numpy())
        agree = (j[1][k] == got[1][k]) & (j[4][k] == got[4][k])
        assert agree.mean() >= AGREE, (k, agree.mean())
        assert j[4][k].mean() > 0.3
        both = agree & j[4][k]
        np.testing.assert_allclose(got[0][k][both], j[0][k][both],
                                   atol=1e-3)
        rem_ok = np.abs(got[2][k][both] - j[2][k][both]) <= 1e-5
        assert rem_ok.mean() >= AGREE, rem_ok.mean()
    if name == "upsample":
        # the chords fill the interleaved rows
        assert got[4].mean() > 1.5 * TD.TransferEngine(
            _port_spec(SOURCE), _port_spec(target_j),
            TransferConfig(**dataclasses.asdict(jcfg)), fixed_bounds=True,
            device="cpu", upsample_interp=False).transfer_fast(
                interop.window_from_numpy(jwins[0])).mask.float().mean()


def test_frame_parallel_raymarch_equals_transfer_fast(world2,
                                                    frames_dataset):
    """A raymarch engine takes the body that fuses the volume in the frame
    (``_mergemesh_core``, as JAX's materialised body): every frame equal to
    the port's ``transfer_fast`` bit for bit."""
    target_j, adaption, nscans, kw, idxs = ENGINES["raymarch"]
    jcfg, jwins = _windows(frames_dataset, adaption, nscans, idxs)
    teng = TD.TransferEngine(_port_spec(SOURCE), _port_spec(target_j),
                             TransferConfig(**dataclasses.asdict(jcfg)),
                             fixed_bounds=True, device="cpu", **kw)
    got = world2[0][0]["frames/raymarch"]
    assert got[4].mean() > 0.3
    for k, w in enumerate(jwins):
        vs = teng.transfer_fast(interop.window_from_numpy(w))
        for a, b in zip(got, vs[:5]):
            np.testing.assert_array_equal(a[k], b.numpy())


def test_frame_parallel_refuses_what_jax_refuses(world2):
    """A mesh engine with ``mesh_attrs="volume"`` (a materialised volume
    per frame) raises, as JAX's ``frame_parallel_transfer`` does."""
    for rank in world2[0]:
        assert "fold body" in rank["frames/mesh_volume"]


# ------------------------------------------------------------- training
def _assert_params_close(got: dict, want: dict):
    diff = np.concatenate([np.abs(got[k] - v).reshape(-1)
                           for k, v in want.items()])
    assert diff.max() <= 2e-3, diff.max()
    assert (diff <= 1e-4).mean() >= 0.999, (diff <= 1e-4).mean()


@pytest.fixture(scope="module")
def one_process(inputs):
    """Three Adam steps of the port's single-process step at batch 2, and
    of JAX's ``sharded_train_step`` on a model-1 mesh of 2 devices."""
    model = TR.RangeNet(TCFG)
    model.load_state_dict(inputs["params"])
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tb = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    losses = [float(TR.train_step(model, opt, tb)) for _ in range(3)]
    jm = JR.RangeNet(JCFG)
    params, opt_state, tx = JR.make_train_state(jm, jax.random.PRNGKey(3),
                                                (1, 16, 64, 5))
    mesh = j_make_mesh(2, model=1)
    step = JPS.sharded_train_step(jm, tx, mesh)
    jb = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    jlosses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, jb)
        jlosses.append(float(loss))
    jparams = interop.rangenet_state_dict(jax.device_get(params), TCFG)
    return (losses, {k: v.numpy() for k, v in model.state_dict().items()},
            jlosses, {k: v.numpy() for k, v in jparams.items()})


def test_ddp_step_matches_jax_sharded_step(world2, one_process):
    """``sharded_train_step`` (DDP) on 2 ranks, one sample each, masks of
    80 % and 30 %: the global loss at every step and the parameters after
    three steps against JAX's ``sharded_train_step`` and the port's
    one-process step at batch 2. A mean of the ranks' own losses would
    weigh the sparse sample's pixels 8/3 as much."""
    losses, params, jlosses, jparams = one_process
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for rank in world2[0]:
        got_losses, got = rank["ddp"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        _assert_params_close(got, params)
        _assert_params_close(got, jparams)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_shard_params_tp_matches_unsharded(request, one_process, world):
    """``shard_params_tp`` (convolutions of >= 32 output channels split
    over "model") on the 1x2 mesh, and with DDP over "data" on the 2x2
    mesh: the full parameters after three steps against the one-process
    step."""
    losses, params, _, _ = one_process
    ranks = request.getfixturevalue(world)[0]
    key = "tp" if world == "world2" else "dptp"
    for rank in ranks:
        got_losses, got = rank[key]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        _assert_params_close(got, params)


def test_make_mesh_refuses_too_few_ranks(ranks):
    """``make_mesh(n)`` with fewer ranks than n raises (a smaller mesh
    would run unsharded), as JAX's ``make_mesh``; the auto layout takes a
    model axis of 2."""
    for rank in ranks:
        assert "rank mesh but the process group has" in rank["mesh_error"]
        n = len(ranks)
        assert rank["mesh_shapes"] == {"model1": (n, 1),
                                       "auto": (n // 2, 2)}
        assert rank["foreign_modules"] == []


# --------------------------------------------------------- experiments
def test_train_segmentation_under_two_ranks(world2):
    """``train_segmentation`` under 2 gloo ranks (batch 2, one frame a
    rank): rank 0 alone writes the checkpoint, which holds the model's own
    keys; a run resumed at step 2 ends where the straight 3-step run ends,
    bit for bit, on every rank."""
    ranks, d = world2
    assert ranks[0]["seg/saved"] == [2, 3, 3]
    assert ranks[1]["seg/saved"] == []
    resumed = torch.load(str(d / "resumed.pt"), weights_only=False)
    straight = torch.load(str(d / "straight.pt"), weights_only=False)
    assert resumed["step"] == straight["step"] == 3
    assert not any(k.startswith("module.") for k in resumed["model_state"])
    for k, v in straight["model_state"].items():
        assert torch.equal(resumed["model_state"][k], v), k
        for rank in ranks:
            np.testing.assert_array_equal(rank["seg/params"][k], v.numpy())
    model, _, _ = TSG.load_checkpoint(str(d / "resumed.pt"), "cpu")
    assert model.cfg == SEG_CFG


def test_grid_search_mesh_equals_sequential(world2):
    """``grid_search(mesh=...)`` with one mergemesh cell of 3 frames
    (padded to 4 over 2 ranks) scores what its sequential cell scores,
    on every rank; rank 0 writes the results."""
    ranks, d = world2
    for rank in ranks:
        res, seq = rank["grid/mesh"], rank["grid/sequential"]
        cell = res["cells"][0]["sequences"]["00"]
        assert cell["frames"] == seq["frames"] == 3
        for key in ("iou", "acc", "mse"):
            assert cell[key] == seq[key], key
        assert res["grid"]["device_parallel"] is True
    assert os.path.exists(d / "grid" / "grid_search.json")
