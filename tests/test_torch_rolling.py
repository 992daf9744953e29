"""The port's rolling shutter against the JAX package (CPU).

``transforms.rotation_to_quaternion`` / ``quaternion_to_rotation`` /
``quaternion_slerp`` / ``interpolate_pose``,
``raycast.generate_rays_moving``, ``raycast_tsdf`` with (R, 3) origins and
``TransferEngine.resynthesize_rolling_shutter`` (its three engines) of
``lidar_transfer_tpu`` and of the port run on the same numpy inputs, made
from a seed (the engines on windows of the shared synthetic scene for the
``small_spec`` sensor); the port's CLI runs with ``--rolling-shutter`` on
the shared ``synthetic_dataset``.

Tolerances: the quaternion functions and the moving rays are numpy in both
packages, so exact; the march with per-ray origins as
``tests/test_torch_raycast.py`` holds the march (hit and label on >= 99.9 %
of rays, range within 1e-3 m); the splat and volume engines as
``tests/test_torch_engine.py`` holds a splat frame (label and mask on
>= 99.9 % of pixels, range within 1e-4 m and remission within 1e-5 where
they agree), the raymarch engine as the raymarch engine of
``tests/test_torch_raycast.py`` (range within 1e-3 m, remission within
1e-6).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_transfer_tpu.config import SensorSpec, TransferConfig
from lidar_transfer_tpu.datasets import synthetic
from lidar_transfer_tpu.datasets.kitti import KittiSequence
from lidar_transfer_tpu.ops import raycast as JR
from lidar_transfer_tpu.ops import transforms as JT
from lidar_transfer_tpu.ops import tsdf as JTS
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu.pipeline import multiscan as JM
from lidar_transfer_tpu_torch import _build, cli, interop
from lidar_transfer_tpu_torch.datasets import kitti as TK
from lidar_transfer_tpu_torch.ops import raycast as TR
from lidar_transfer_tpu_torch.ops import transforms as TT
from lidar_transfer_tpu_torch.ops import tsdf as TTS
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.pipeline import multiscan as TM
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


#: label/mask (hit) agreement of two scans or marches
AGREE = 0.999
CFG = TransferConfig(adaption="mergemesh", number_of_scans=1,
                     voxel_size=0.25,
                     voxel_bounds=((-16.0, 16.0), (-16.0, 16.0),
                                   (-4.0, 4.0)))
CAP = 8192


def _rot(axis, angle):
    """4x4 rotation about a unit ``axis`` by ``angle`` (Rodrigues)."""
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
    return m


def _pose(kind):
    """Relative poses over one frame: none, a translation, a yaw with a
    translation, a tilted turn."""
    if kind == "identity":
        return np.eye(4)
    if kind == "forward":
        p = np.eye(4)
        p[:3, 3] = [1.0, 0.0, 0.0]
        return p
    if kind == "yaw":
        p = _rot([0, 0, 1], np.deg2rad(5.0))
        p[:3, 3] = [0.8, 0.2, 0.0]
        return p
    p = _rot([0.3, -0.2, 1.0], np.deg2rad(20.0))
    p[:3, 3] = [0.5, -0.4, 0.1]
    return p


POSES = ("identity", "forward", "yaw", "tilted")


@pytest.mark.parametrize("case", [
    ("identity", 0.0), ("z", 0.3), ("z", np.pi), ("x", np.pi),
    ("y", np.pi), ("tilted", 2.5), ("tilted", -3.0)])
def test_quaternions_match(case):
    """rotation_to_quaternion (every branch of Shepperd's method: trace
    > 0, and each diagonal element largest) and quaternion_to_rotation ==
    the JAX package's functions, exactly; the round trip gives the
    rotation back."""
    axis = {"identity": [0, 0, 1], "x": [1, 0, 0], "y": [0, 1, 0],
            "z": [0, 0, 1], "tilted": [0.4, -0.7, 0.2]}[case[0]]
    R = _rot(axis, case[1])[:3, :3]
    q = TT.rotation_to_quaternion(R)
    np.testing.assert_array_equal(q, JT.rotation_to_quaternion(R))
    qs = np.stack([q, -q, 2.0 * q])
    np.testing.assert_array_equal(TT.quaternion_to_rotation(qs),
                                  JT.quaternion_to_rotation(qs))
    np.testing.assert_allclose(TT.quaternion_to_rotation(q), R, atol=1e-12)


@pytest.mark.parametrize("angle", [1e-4, 0.5, 2.0, 3.1])
@pytest.mark.parametrize("flip", [False, True])
def test_quaternion_slerp_matches(angle, flip):
    """quaternion_slerp == the JAX function, exactly: nearly parallel
    quaternions (the lerp branch), wide arcs and the shortest-arc flip of
    a negated end."""
    q0 = TT.rotation_to_quaternion(_rot([0.2, 0.1, 1.0], 0.3)[:3, :3])
    q1 = TT.rotation_to_quaternion(_rot([0.2, 0.1, 1.0], 0.3 + angle)[:3, :3])
    q1 = -q1 if flip else q1
    t = np.linspace(0.0, 1.0, 7)
    np.testing.assert_array_equal(TT.quaternion_slerp(q0, q1, t),
                                  JT.quaternion_slerp(q0, q1, t))
    np.testing.assert_array_equal(TT.quaternion_slerp(q0, q1, 0.25),
                                  JT.quaternion_slerp(q0, q1, 0.25))


@pytest.mark.parametrize("kind", POSES)
def test_interpolate_pose_matches(kind):
    """interpolate_pose == the JAX function, exactly, from the identity
    and between two poses; its ends are the poses."""
    p1 = _pose(kind)
    p0 = _pose("yaw")
    t = np.linspace(0.0, 1.0, 9)
    for a, b in ((np.eye(4), p1), (p0, p1)):
        out = TT.interpolate_pose(a, b, t)
        np.testing.assert_array_equal(out, JT.interpolate_pose(a, b, t))
        np.testing.assert_allclose(out[0], a, atol=1e-12)
        np.testing.assert_allclose(out[-1], b, atol=1e-9)


@pytest.mark.parametrize("kind", POSES)
@pytest.mark.parametrize("beams,spin", [(False, 1.0), (True, 1.0),
                                        (False, 0.5)])
def test_generate_rays_moving_matches(kind, beams, spin):
    """generate_rays_moving == the JAX function: float32 rays and origins
    equal, with equidistant rows and a beam table, a whole and a half
    revolution a frame."""
    ba = np.deg2rad(np.linspace(-22.0, 6.0, 12)) if beams else None
    args = (12, 96, 8.0, -22.0, _pose(kind))
    t = TR.generate_rays_moving(*args, beam_angles=ba, spin_fraction=spin)
    j = JR.generate_rays_moving(*args, beam_angles=ba, spin_fraction=spin)
    for a, b in zip(t, j):
        assert a.dtype == np.float32 and a.shape == (12 * 96, 3)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.linalg.norm(t[0], axis=1), 1.0, atol=1e-6)


def test_rays_moving_identity_is_static():
    """With the identity pose the moving rays are generate_rays' and every
    origin is 0."""
    rays, origins = TR.generate_rays_moving(8, 64, 5.0, -20.0, np.eye(4))
    np.testing.assert_array_equal(rays, TR.generate_rays(8, 64, 5.0, -20.0))
    assert not origins.any()


def test_rays_moving_translation_ramps():
    """A 1 m translation over the frame: column w's origin is at w / W m,
    the first at 0, the last at 0.99 m; directions stay unit."""
    rays, origins = TR.generate_rays_moving(4, 100, 5.0, -20.0,
                                            _pose("forward"))
    o = origins.reshape(4, 100, 3)
    assert not o[:, 0].any()
    assert o[0, -1, 0] == pytest.approx(0.99, abs=1e-6)
    assert np.all(np.diff(o[0, :, 0]) > 0)
    np.testing.assert_array_equal(o[:, :, 1:], 0.0)
    np.testing.assert_allclose(np.linalg.norm(rays, axis=1), 1.0, atol=1e-6)


def _wall(compact):
    """The wall of ``tests/test_rolling_shutter.py``: x = 10 m, tsdf
    clipped distance / (5 voxels), label 9."""
    dims, voxel = (64, 16, 16), 0.25
    origin = (0.0, -2.0, -2.0)
    gx = np.arange(dims[0])[:, None, None] * voxel
    tsdf = np.broadcast_to(np.clip((10.0 - gx) / (5 * voxel), -1, 1),
                           dims).astype(np.float32)
    arrays = (tsdf, np.ones(dims, np.float32), np.full(dims, 9, np.int32),
              np.zeros(dims, np.float32))
    j = JTS.TSDFState(*(jnp.asarray(a) for a in arrays))
    t = TTS.TSDFState(*(torch.from_numpy(a.copy()) for a in arrays))
    if compact:
        j = JTS.TSDFState(j.tsdf.astype(jnp.bfloat16),
                          j.weight.astype(jnp.bfloat16),
                          j.label.astype(jnp.int16),
                          j.rem.astype(jnp.bfloat16))
        t = TTS.TSDFState(*(a.to(dt) for a, dt in
                            zip(t, TTS.COMPACT_DTYPES)))
    return (j, JTS.VolumeSpec(origin, voxel, dims)), \
        (t, TTS.VolumeSpec(origin, voxel, dims))


@pytest.mark.parametrize("compact", [False, True])
def test_raycast_per_ray_origins_matches(compact):
    """raycast_tsdf with (R, 3) origins on the wall: rays along +x from
    0.5, 3 and 6 m and a tilted one, against the JAX raycast_tsdf: hits
    equal, range within 1e-3 m; the ranges differ by the origins' shift."""
    (js, jspec), (ts, tspec) = _wall(compact)
    rays = np.array([[1.0, 0, 0], [1.0, 0, 0], [1.0, 0, 0],
                     [0.96, 0.28, 0.0]], np.float32)
    origins = np.array([[0.5, 0, 0], [3.0, 0, 0], [6.0, 0.1, -0.2],
                        [1.0, -1.0, 0.3]], np.float32)
    j = JR.raycast_tsdf(js, jspec, jnp.asarray(rays), jnp.asarray(origins),
                        H=1, W=4)
    t = TR.raycast_tsdf(ts, tspec, torch.from_numpy(rays),
                        torch.from_numpy(origins), H=1, W=4)
    assert t.hit.all() and np.asarray(j.hit).all()
    r = t.range.numpy().reshape(-1)
    np.testing.assert_allclose(r, np.asarray(j.range).reshape(-1),
                               atol=1e-3)
    np.testing.assert_array_equal(t.label.numpy(), 9)
    assert r[0] - r[1] == pytest.approx(2.5, abs=0.05)
    assert r[0] - r[2] == pytest.approx(5.5, abs=0.05)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, scene, small_spec):
    """The scene of the shared ``synthetic_dataset`` for the ``small_spec``
    sensor, with its beams 0.5 deg inside the fov: the shared dataset's
    top beam lies exactly on fov_up, where XLA's and PyTorch's asin differ
    by an ulp and move whole edge rows (its static transfer agrees on
    97.9 % of pixels; ``tests/test_torch_engine.py`` and ROADMAP.md
    section 3 say why)."""
    root = str(tmp_path_factory.mktemp("rolling_kitti"))
    beams = SensorSpec(name=small_spec.name, beams=small_spec.beams,
                       fov_up=small_spec.fov_up - 0.5,
                       fov_down=small_spec.fov_down + 0.5,
                       angle_res_hor=small_spec.angle_res_hor)
    synthetic.write_kitti_dataset(root, scene, beams, n_scans=5)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(small_spec.to_dict(), f)
    return root


@pytest.fixture(scope="module")
def windows(dataset):
    """Windows 1 to 3 (JAX, port) and the relative pose from scan 2 to
    scan 3."""
    seq = KittiSequence.open(dataset)
    ws = [JM.load_window(seq, CFG, i, CAP) for i in (1, 2, 3)]
    pose = np.linalg.inv(seq.poses[2]) @ seq.poses[3]
    return ws, [interop.window_from_numpy(w) for w in ws], pose


def _engines(spec, engine):
    kw = dict(fixed_bounds=True)
    if engine == "volume":
        kw["defer_volume"] = False
    if engine == "raymarch":
        kw["synthesis"] = "raymarch"
    return (JD.TransferEngine(spec, spec, CFG, CAP, **kw),
            TD.TransferEngine(spec, spec, CFG, device="cpu", **kw))


def _assert_rolling_agree(j, t, range_tol, rem_tol):
    assert t.adaption == j.adaption == "mergemesh-rolling"
    jl, tl = np.asarray(j.label), t.label.numpy()
    jm, tm = np.asarray(j.mask), t.mask.numpy()
    agree = (jl == tl) & (jm == tm)
    assert agree.mean() >= AGREE, agree.mean()
    assert jm.mean() > 0.3
    both = agree & jm
    np.testing.assert_allclose(t.range.numpy()[both],
                               np.asarray(j.range)[both], atol=range_tol)
    np.testing.assert_allclose(t.remission.numpy()[both],
                               np.asarray(j.remission)[both], atol=rem_tol)
    np.testing.assert_allclose(t.points.numpy()[both],
                               np.asarray(j.points)[both], atol=range_tol)
    assert not t.range.numpy()[~tm].any()


@pytest.mark.parametrize("motion", [False, True])
@pytest.mark.parametrize("engine", ["splat", "volume", "raymarch"])
def test_rolling_engines_match(windows, small_spec, engine, motion):
    """resynthesize_rolling_shutter against the JAX engine's, for each of
    its engines: "auto" after the splat path's transfer_fast
    (_rolling_splat_core), "auto" on a materialised volume
    (_rolling_volume_core, defer_volume=False), and "raymarch" (the march
    with one origin a ray, through the raymarch engine's volume); with the
    identity pose and with the dataset's next pose. Nothing launches."""
    jw, tw, pose = windows
    pose = pose if motion else np.eye(4)
    je, te = _engines(small_spec, engine)
    if engine == "splat":
        je.transfer_fast(jw[1])
        te.transfer_fast(tw[1])
    else:
        je.transfer(jw[1])
        te.transfer(tw[1])
    eng = "raymarch" if engine == "raymarch" else "auto"
    _build.reset_launch_counts()
    j = je.resynthesize_rolling_shutter(pose, engine=eng)
    t = te.resynthesize_rolling_shutter(pose, engine=eng)
    assert not any(_build.launch_counts().values())
    if engine == "raymarch":
        _assert_rolling_agree(j, t, 1e-3, 1e-6)
    else:
        _assert_rolling_agree(j, t, 1e-4, 1e-5)


def test_rolling_splat_identity_is_static(windows, small_spec):
    """With the identity pose the splat engine's rolling frame is the
    static frame: the same winners, exact surface ranges (within 1e-3 m of
    the band candidate's zero crossing) and labels; the port's own."""
    _, tw, _ = windows
    te = _engines(small_spec, "splat")[1]
    static = te.transfer_fast(tw[1])
    rs = te.resynthesize_rolling_shutter(np.eye(4))
    ms, mr = static.mask.numpy(), rs.mask.numpy()
    assert (ms == mr).mean() > 0.97
    both = ms & mr
    np.testing.assert_allclose(rs.range.numpy()[both],
                               static.range.numpy()[both], atol=1e-3)
    np.testing.assert_array_equal(rs.label.numpy()[both],
                                  static.label.numpy()[both])


def test_rolling_frame_after_stream(windows, small_spec):
    """After transfer_stream, rolling shutter needs frame=i: without it
    ValueError; frame=1 and frame=-2 equal the per-frame engine's rolling
    frame of that window, bit for bit."""
    _, tw, pose = windows
    te = _engines(small_spec, "splat")[1]
    te.transfer_stream(TM.stack_windows(tw))
    with pytest.raises(ValueError, match="frame=i"):
        te.resynthesize_rolling_shutter(pose)
    got = [te.resynthesize_rolling_shutter(pose, frame=f) for f in (1, -2)]
    ref = _engines(small_spec, "splat")[1]
    ref.transfer_fast(tw[1])
    want = ref.resynthesize_rolling_shutter(pose)
    for g in got:
        for f in ("range", "label", "remission", "points", "mask"):
            assert torch.equal(getattr(g, f), getattr(want, f)), f


def test_rolling_errors(windows, small_spec):
    """An unknown engine raises ValueError, as does frame= without a
    preceding transfer_stream (the JAX engine's errors)."""
    jw, tw, pose = windows
    je, te = _engines(small_spec, "splat")
    je.transfer_fast(jw[0])
    te.transfer_fast(tw[0])
    for e in (je, te):
        with pytest.raises(ValueError, match="engine"):
            e.resynthesize_rolling_shutter(pose, engine="mesh")
        with pytest.raises(ValueError, match="transfer_stream"):
            e.resynthesize_rolling_shutter(pose, frame=0)


def test_cli_rolling_shutter(synthetic_dataset, small_spec, tmp_path):
    """lt-transfer (torch) --rolling-shutter on the CPU: --stream is turned
    off, every frame but the sequence's last is a rolling frame
    ("mergemesh-rolling" in the metrics JSON), and each written frame holds
    the points of the engine's rolling frame over the next scan's
    pose."""
    cfg = tmp_path / "cfg.yaml"
    CFG.to_yaml(str(cfg))
    mj = tmp_path / "m.json"
    rc = cli.main(["-d", synthetic_dataset, "-c", str(cfg), "--fixed-bounds",
                   "-w", "-p", str(tmp_path / "out"), "--rolling-shutter",
                   "--stream", "2", "--device", "cpu", "--frames", "5",
                   "--metrics-json", str(mj)])
    assert rc == 0
    metrics = json.loads(mj.read_text())
    seq = KittiSequence.open(synthetic_dataset)
    assert [m["index"] for m in metrics] == list(range(len(seq)))
    assert [m["adaption"] for m in metrics] == \
        ["mergemesh-rolling"] * (len(seq) - 1) + ["mergemesh"]
    written = sorted(os.listdir(tmp_path / "out" / "sequences" / "00"
                                / "velodyne"))
    assert len(written) == len(seq)
    te = TD.TransferEngine(small_spec, small_spec, CFG, fixed_bounds=True,
                           device="cpu")
    w = TM.load_window(TK.KittiSequence.open(synthetic_dataset), CFG, 1,
                       CAP, "cpu")
    te.transfer_fast(w)
    rs = te.resynthesize_rolling_shutter(
        np.linalg.inv(seq.poses[1]) @ seq.poses[2])
    assert metrics[1]["points_written"] == int(rs.mask.sum()) > 0
