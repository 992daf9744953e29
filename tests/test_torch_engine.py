"""The port's transfer slice against the JAX package (CPU).

``TransferEngine.transfer_fast`` / ``transfer_stream`` / ``fused_state``
of ``lidar_transfer_tpu/pipeline/deform.py`` and of the port run on the
same windows (loaded once by the JAX package, carried across with
``interop.window_from_numpy``), and the port's CLI runs against the JAX
engine plus ``compare_scans`` on the same frames.

The synthetic sensor here puts its edge beams 0.5 deg inside the
configured FOV, as real sensors' beams lie inside theirs. A beam exactly on
the FOV limit (``synthetic.sensor_rays`` at the configured spec) is kept or
dropped by the last ulp of asin, which XLA and PyTorch round differently,
so an identity transfer would differ in whole edge rows for no other
reason.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from lidar_transfer_tpu.config import SensorSpec, TransferConfig
from lidar_transfer_tpu.datasets import kitti, synthetic
from lidar_transfer_tpu.metrics import compare as JC
from lidar_transfer_tpu.ops import projection as JP
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu.pipeline import multiscan as JM
from lidar_transfer_tpu_torch import cli, interop
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.pipeline import multiscan as TM
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


#: label/mask agreement of two virtual scans (atan2/asin/sqrt ulps move a
#: few candidates across pixel or voxel boundaries, or break depth ties)
AGREE = 0.999

SOURCE = SensorSpec(name="src32", beams=32, fov_up=5.0, fov_down=-24.0,
                    angle_res_hor=360.0 / 512.0)
CROSS = SensorSpec(name="tgt16", beams=16, fov_up=8.0, fov_down=-22.0,
                   angle_res_hor=360.0 / 256.0)
CFG = TransferConfig(voxel_size=0.25,
                     voxel_bounds=((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_kitti"))
    beams = SensorSpec(name=SOURCE.name, beams=SOURCE.beams,
                       fov_up=SOURCE.fov_up - 0.5,
                       fov_down=SOURCE.fov_down + 0.5,
                       angle_res_hor=SOURCE.angle_res_hor)
    synthetic.write_kitti_dataset(root, synthetic.Scene.default(), beams,
                                  n_scans=4)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(SOURCE.to_dict(), f)
    with open(os.path.join(root, "cfg.yaml"), "w") as f:
        yaml.safe_dump(CFG.to_dict(), f)
    seq = kitti.KittiSequence.open(root)
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    return root, seq, cap


def _engines(dataset, target, fixed):
    _, _, cap = dataset
    return (JD.TransferEngine(SOURCE, target, CFG, cap, fixed_bounds=fixed),
            TD.TransferEngine(SOURCE, target, CFG, fixed_bounds=fixed,
                              device="cpu"))


def _window(dataset, idx):
    _, seq, cap = dataset
    w = JM.load_window(seq, CFG, idx, cap)
    return w, interop.window_from_numpy(w)


def _assert_scans_agree(j, t):
    jl, tl = np.asarray(j.label), t.label.numpy()
    jm, tm = np.asarray(j.mask), t.mask.numpy()
    agree = (jl == tl) & (jm == tm)
    assert agree.mean() >= AGREE, agree.mean()
    assert jm.mean() > 0.3
    both = agree & jm
    np.testing.assert_allclose(t.range.numpy()[both],
                               np.asarray(j.range)[both], atol=1e-4)
    np.testing.assert_allclose(t.remission.numpy()[both],
                               np.asarray(j.remission)[both], atol=1e-5)


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("cross", [False, True])
def test_transfer_fast_matches(dataset, cross, fixed):
    """transfer_fast, identity and cross, fixed and clipped bounds:
    label/mask agree on >= 99.9 % of pixels, range within 1e-4 m and
    remission within 1e-5 where they agree."""
    je, te = _engines(dataset, CROSS if cross else SOURCE, fixed)
    w, tw = _window(dataset, 1)
    j, t = je.transfer_fast(w), te.transfer_fast(tw)
    _assert_scans_agree(j, t)
    assert t.adaption == "mergemesh"


@pytest.mark.parametrize("fixed", [True, False])
def test_fused_state_matches(dataset, fixed):
    """fused_state(): the deferred volume integrated on demand equals the
    JAX engine's on >= 99.9 % of voxels (label), tsdf/rem within 1e-5
    elsewhere (the weight is not written on this path)."""
    je, te = _engines(dataset, CROSS, fixed)
    w, tw = _window(dataset, 2)
    je.transfer_fast(w)
    te.transfer_fast(tw)
    j = interop.to_numpy(je.fused_state())
    t = interop.to_numpy(te.fused_state())
    assert t.tsdf.shape == j.tsdf.shape == te.vol_dims
    same = t.label == j.label
    assert same.mean() >= AGREE
    assert (t.tsdf < 1).sum() > 1000
    np.testing.assert_allclose(t.tsdf[same], j.tsdf[same], atol=1e-5)
    np.testing.assert_allclose(t.rem[same], j.rem[same], atol=1e-5)
    assert te.fused_state() is te.fused_state()      # integrated once


def test_transfer_stream_equals_per_frame(dataset):
    """transfer_stream == per-frame transfer_fast, bit for bit, and
    fused_state(frame=i) selects a streamed frame's volume."""
    _, te = _engines(dataset, CROSS, True)
    tws = [_window(dataset, i)[1] for i in (0, 1, 2)]
    per = [te.transfer_fast(w) for w in tws]
    ref = interop.to_numpy(te.fused_state())
    sv = te.transfer_stream(TM.stack_windows(tws))
    for k, vs in enumerate(per):
        for f in ("range", "label", "remission", "points", "mask"):
            assert torch.equal(getattr(sv, f)[k], getattr(vs, f)), f
    with pytest.raises(ValueError, match="frame"):
        te.fused_state()
    with pytest.raises(IndexError):
        te.fused_state(frame=3)
    got = interop.to_numpy(te.fused_state(frame=-1))
    for a, b in zip((got.tsdf, got.label, got.rem),
                    (ref.tsdf, ref.label, ref.rem)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stream", [0, 2])
def test_cli_matches_jax_engine(dataset, tmp_path, capsys, stream):
    """The port's CLI (--device cpu) on every frame: the JAX engine's
    transfer_fast + compare_scans give the same metrics (IoU/Acc within
    2e-3, MSE within 2 %: a 0.1 % pixel flip moves them that far) and
    point counts within 0.1 % of the target pixels."""
    root, seq, cap = dataset
    out = tmp_path / "out"
    mj = tmp_path / "m.json"
    rc = cli.main(["-d", root, "-c", os.path.join(root, "cfg.yaml"), "-b",
                   "-w", "-p", str(out), "--fixed-bounds", "--device", "cpu",
                   "--stream", str(stream), "--metrics-json", str(mj)])
    assert rc == 0
    printed = capsys.readouterr().out
    for key in ("IoU: ", "Acc: ", "MSE: ", "Took: "):
        assert printed.count(key) == len(seq)
    metrics = json.loads(mj.read_text())
    assert [m["index"] for m in metrics] == list(range(len(seq)))
    je = JD.TransferEngine(SOURCE, SOURCE, CFG, cap, fixed_bounds=True)
    for m in metrics:
        w = JM.load_window(seq, CFG, m["index"], cap)
        vs = je.transfer_fast(w)
        src = JP.range_project(
            w.points[0], w.remissions[0], w.labels[0], w.valid[0],
            H=SOURCE.H, W=SOURCE.W, fov_up_deg=SOURCE.fov_up,
            fov_down_deg=SOURCE.fov_down)
        res = JC.compare_scans(src.label, src.mask, src.range,
                               np.maximum(np.asarray(src.remission), 0.0),
                               vs.label, vs.range, vs.remission)
        assert m["iou"] == pytest.approx(float(res.mean_iou), abs=2e-3)
        assert m["acc"] == pytest.approx(float(res.mean_acc), abs=2e-3)
        assert m["mse"] == pytest.approx(float(res.mse), rel=2e-2)
        n_ref = int((np.asarray(vs.mask)
                     & (np.asarray(vs.points).sum(-1) != 0)).sum())
        assert abs(m["points_written"] - n_ref) <= 1e-3 * SOURCE.H * SOURCE.W
        lbl = kitti.read_label_file(str(
            out / "sequences" / "00" / "labels" / f"{m['index']:06d}.label"))
        assert lbl.shape[0] == m["points_written"]


@pytest.mark.parametrize("adaption,nscans", [("mergemesh", 1), ("cp", 1)])
def test_engine_workspace_reused_over_frames_and_targets(dataset, adaption,
                                                         nscans):
    """Two engines (two targets, so two image sizes) that each keep one
    z-buffer workspace over several frames equal the JAX engines frame by
    frame, at the tolerances of ``_assert_scans_agree``; the workspace is
    the engine's own and the same object on every frame."""
    import dataclasses

    _, seq, cap = dataset
    cfg = dataclasses.replace(CFG, adaption=adaption, number_of_scans=nscans)
    first = JM.min_start_index(nscans)
    frames = list(range(first, JM.max_end_index(nscans, len(seq))))[:3]
    assert len(frames) >= 2
    seen = []
    for target in (CROSS, SOURCE):
        je = JD.TransferEngine(SOURCE, target, cfg, cap, fixed_bounds=True)
        te = TD.TransferEngine(SOURCE, target, cfg, fixed_bounds=True,
                               device="cpu")
        ws = te._zbuf
        seen.append(ws)
        for idx in frames:
            w = JM.load_window(seq, cfg, idx, cap)
            tw = interop.window_from_numpy(w)
            if adaption == "cp":
                j, t = je.transfer(w)[0], te.transfer(tw)[0]
            else:
                j, t = je.transfer_fast(w), te.transfer_fast(tw)
            _assert_scans_agree(j, t)
            assert te._zbuf is ws
    assert seen[0] is not seen[1]
