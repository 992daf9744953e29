"""The port's cp and catmesh adaptions and its upsampling route against the
JAX package (CPU).

``TransferEngine`` of ``lidar_transfer_tpu/pipeline/deform.py`` and of the
port run on the same windows (loaded once by the JAX package, carried
across with ``interop.window_from_numpy``) at the small configuration of
``tests/test_upsample.py``: a 16x256 source, voxel 0.25 m, bounds
+-16/+-16/+-4 m; the upsampling target has twice the beams over the same
fov. ``_interp_candidates`` of ``lidar_transfer_tpu/ops/splat.py`` and of
the port get the same source image.

As in ``tests/test_torch_engine.py`` the synthetic sensor's edge beams lie
0.5 deg inside the configured FOV; its ranges carry 1 cm of noise (as in
``tests/test_torch_mesh.py``), so no two chord candidates tie in depth to
the last ulp.
"""

import dataclasses
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_transfer_tpu.config import SensorSpec, TransferConfig
from lidar_transfer_tpu.datasets import kitti, synthetic
from lidar_transfer_tpu.ops import projection as JP
from lidar_transfer_tpu.ops import splat as JSp
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu.pipeline import multiscan as JM
from lidar_transfer_tpu_torch import cli, interop
from lidar_transfer_tpu_torch.ops import projection as TP
from lidar_transfer_tpu_torch.ops import splat as TSp
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


#: label/mask agreement of two virtual scans (atan2/asin/sqrt ulps move a
#: few candidates across pixel or voxel boundaries)
AGREE = 0.999

SOURCE = SensorSpec(name="test16", beams=16, fov_up=8.0, fov_down=-22.0,
                    angle_res_hor=360.0 / 256.0)
UP = dataclasses.replace(SOURCE, name="up32", beams=32)
# a target grid whose pixel edges fall on no source ray: the synthetic rays
# are exact, and a ray on a pixel edge goes either way by an atan2 ulp
CROSS = SensorSpec(name="tgt12", beams=12, fov_up=6.3, fov_down=-19.7,
                   angle_res_hor=360.0 / 181.0)
CFG = TransferConfig(voxel_size=0.25,
                     voxel_bounds=((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0)))


def _cfg(**kw):
    return dataclasses.replace(CFG, **kw)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_adapt_kitti"))
    beams = dataclasses.replace(SOURCE, fov_up=SOURCE.fov_up - 0.5,
                                fov_down=SOURCE.fov_down + 0.5)
    synthetic.write_kitti_dataset(root, synthetic.Scene.default(), beams,
                                  n_scans=4, range_noise=0.01)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(SOURCE.to_dict(), f)
    seq = kitti.KittiSequence.open(root)
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    return root, seq, cap


@pytest.fixture(autouse=True)
def _classic_interp_body(monkeypatch):
    """The JAX engine's default body for upsampling targets (the fast
    interpolating body is an A/B the port leaves out)."""
    monkeypatch.delenv("LT_INTERP_STREAM_BODY", raising=False)


def _engines(dataset, target, cfg=CFG, fixed=True, **kw):
    _, _, cap = dataset
    return (JD.TransferEngine(SOURCE, target, cfg, cap, fixed_bounds=fixed,
                              **kw),
            TD.TransferEngine(SOURCE, target, cfg, fixed_bounds=fixed,
                              device="cpu", **kw))


def _window(dataset, idx, cfg=CFG):
    _, seq, cap = dataset
    w = JM.load_window(seq, cfg, idx, cap)
    return w, interop.window_from_numpy(w)


def _assert_scans_agree(j, t, min_fill=0.3):
    jl, tl = np.asarray(j.label), t.label.numpy()
    jm, tm = np.asarray(j.mask), t.mask.numpy()
    agree = (jl == tl) & (jm == tm)
    assert agree.mean() >= AGREE, agree.mean()
    assert jm.mean() > min_fill
    both = agree & jm
    np.testing.assert_allclose(t.range.numpy()[both],
                               np.asarray(j.range)[both], atol=1e-4)
    np.testing.assert_allclose(t.remission.numpy()[both],
                               np.asarray(j.remission)[both], atol=1e-5)
    np.testing.assert_allclose(t.points.numpy()[both],
                               np.asarray(j.points)[both], atol=1e-4)


def _assert_equal_scans(a, b):
    for f in ("range", "label", "remission", "points", "mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# -------------------------------------------------------------------- cp
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_cp_identity_is_exact(dataset, package):
    """An identity cp transfer reproduces the source projection bit for
    bit, in both packages."""
    w, tw = _window(dataset, 1, _cfg(adaption="cp"))
    je, te = _engines(dataset, SOURCE, _cfg(adaption="cp"))
    if package == "jax":
        vs, _ = je.transfer(w)
        src = JP.range_project(w.points[0], w.remissions[0], w.labels[0],
                               w.valid[0], H=SOURCE.H, W=SOURCE.W,
                               fov_up_deg=SOURCE.fov_up,
                               fov_down_deg=SOURCE.fov_down)
        vs = interop.to_numpy(vs)
        src = tuple(np.asarray(a) for a in (src.range, src.label,
                                            src.remission, src.index >= 0))
    else:
        vs, _ = te.transfer(tw)
        src = TP.range_project(tw.points[0], tw.remissions[0],
                               tw.labels[0], tw.valid[0], H=SOURCE.H,
                               W=SOURCE.W, fov_up_deg=SOURCE.fov_up,
                               fov_down_deg=SOURCE.fov_down)
        vs = interop.to_numpy(vs)
        src = tuple(a.numpy() for a in (src.range, src.label,
                                         src.remission, src.mask))
    assert vs.adaption == "cp"
    np.testing.assert_array_equal(vs.range, src[0])
    np.testing.assert_array_equal(vs.label, src[1])
    np.testing.assert_array_equal(vs.remission, np.maximum(src[2], 0.0))
    np.testing.assert_array_equal(vs.mask, src[3])
    assert vs.mask.mean() > 0.5


@pytest.mark.parametrize("target", ["identity", "cross"])
def test_cp_matches_jax(dataset, target):
    """cp, identity and cross: label/mask agree with the JAX engine on
    >= 99.9 % of pixels; transfer_fast and transfer_stream give transfer's
    scan; cp has no volume, so fused_state() raises."""
    cfg = _cfg(adaption="cp")
    je, te = _engines(dataset, SOURCE if target == "identity" else CROSS,
                      cfg)
    w, tw = _window(dataset, 2, cfg)
    j, _ = je.transfer(w)
    t, _ = te.transfer(tw)
    _assert_scans_agree(j, t)
    _assert_equal_scans(te.transfer_fast(tw), t)
    sv = te.transfer_stream(TM.stack_windows([tw, tw]))
    assert sv.range.shape[0] == 2 and sv.adaption == "cp"
    _assert_equal_scans(type(t)(*(f[1] for f in sv[:5]), "cp"), t)
    with pytest.raises(RuntimeError, match="no fused volume"):
        te.fused_state()


# --------------------------------------------------------------- catmesh
@pytest.mark.parametrize("entry", ["transfer", "transfer_fast",
                                   "transfer_stream"])
def test_catmesh_equals_mergemesh(dataset, entry):
    """catmesh on its splat engine is the mergemesh body: its scans equal
    mergemesh's bit for bit, labelled "catmesh", and agree with the JAX
    catmesh on >= 99.9 % of pixels; its volume is mergemesh's."""
    cat_cfg = _cfg(adaption="catmesh")
    je, te = _engines(dataset, CROSS, cat_cfg)
    _, me = _engines(dataset, CROSS)
    w, tw = _window(dataset, 1)
    if entry == "transfer_stream":
        ws = TM.stack_windows([tw, tw])
        t, m = te.transfer_stream(ws), me.transfer_stream(ws)
        j = je.transfer_stream(JM.stack_windows([w, w]))
        j, t, m = (type(x)(*(f[0] for f in x[:5]), x.adaption)
                   for x in (j, t, m))
        state, mstate = te.fused_state(frame=0), me.fused_state(frame=0)
    else:
        t, m = (getattr(e, entry)(tw) for e in (te, me))
        j = getattr(je, entry)(w)
        if entry == "transfer":
            (t, _), (m, _), (j, _) = t, m, j
        state, mstate = te.fused_state(), me.fused_state()
    assert t.adaption == j.adaption == "catmesh"
    assert m.adaption == "mergemesh"
    _assert_equal_scans(t, m)
    _assert_scans_agree(j, t)
    for a, b in zip(state, mstate):
        assert torch.equal(a, b)


# ------------------------------------------------------- interp candidates
@pytest.fixture(scope="module")
def source_image(dataset):
    """(range, points, valid, label, rem) flat arrays of one scan projected
    at the source spec, in numpy."""
    w, _ = _window(dataset, 1)
    ri = JP.range_project(w.points[0], w.remissions[0], w.labels[0],
                          w.valid[0], H=SOURCE.H, W=SOURCE.W,
                          fov_up_deg=SOURCE.fov_up,
                          fov_down_deg=SOURCE.fov_down)
    back = JP.reverse_project(ri, fov_up_deg=SOURCE.fov_up,
                              fov_down_deg=SOURCE.fov_down,
                              preserve_float=True)
    return tuple(np.array(a) for a in (
        ri.range.reshape(-1), back, ri.mask.reshape(-1),
        ri.label.reshape(-1), jnp.maximum(ri.remission, 0.0).reshape(-1)))


@pytest.mark.parametrize("m_v,m_u,v_span", [(1, 0, 1), (0, 1, 1), (1, 1, 1),
                                            (1, 0, 2)])
def test_interp_candidates_match(source_image, m_v, m_u, v_span):
    """The chord candidates, in the JAX order (vertical d = 1..v_span,
    horizontal with the yaw wrap, the diagonal): validity on >= 99.9 %,
    labels exact, positions and remissions to float ulps where both are
    valid."""
    origin = np.array([-16.0, -16.0, -4.0], np.float32)
    active = np.array([128.0, 128.0, 32.0], np.float32)
    kw = dict(H=SOURCE.H, W=SOURCE.W, m_v=m_v, m_u=m_u, voxel_size=0.25,
              v_span=v_span)
    tan_min = np.float32(np.tan(np.radians(3.0)))
    j = JSp._interp_candidates(
        *(jnp.asarray(a) for a in source_image), jnp.asarray(origin),
        jnp.asarray(active), jnp.float32(1.25), jnp.float32(tan_min), **kw)
    t = TSp._interp_candidates(
        *(torch.from_numpy(a) for a in source_image),
        torch.from_numpy(origin), torch.from_numpy(active),
        torch.tensor(1.25), torch.tensor(tan_min), **kw)
    j = [np.asarray(a) for a in j]
    t = [a.numpy() for a in t]
    H, W = SOURCE.H, SOURCE.W
    n = (sum(((m_v + 1) * d - 1) * (H - d) * W for d in range(1, v_span + 1))
         * bool(m_v) + m_u * H * W + (min(m_v, m_u) * (H - 1) * W
                                      if m_v and m_u else 0))
    assert all(a.shape[0] == n for a in t)
    assert (j[5] == t[5]).mean() >= AGREE
    both = j[5] & t[5]
    assert both.sum() > 0.2 * n
    np.testing.assert_allclose(t[0][both], j[0][both], atol=1e-5)
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_allclose(t[4][both], j[4][both], atol=1e-6)
    assert not t[1].any() and not t[2].any()


# ------------------------------------------------------- upsampling route
@pytest.mark.parametrize("fixed", [True, False])
def test_upsample_transfer_fast_matches(dataset, fixed):
    """A denser target (twice the beams): transfer_fast agrees with the JAX
    engine's on >= 99.9 % of pixels, equals the port's transfer(), fills
    every target row and covers far more than without the chords."""
    je, te = _engines(dataset, UP, fixed=fixed)
    assert te._interp_active and te._interp_mv == 1
    w, tw = _window(dataset, 1)
    j, t = je.transfer_fast(w), te.transfer_fast(tw)
    _assert_scans_agree(j, t)
    _assert_equal_scans(t, te.transfer(tw)[0])
    off = TD.TransferEngine(SOURCE, UP, CFG, fixed_bounds=fixed,
                            device="cpu", upsample_interp=False)
    base = off.transfer_fast(tw)
    assert t.mask.float().mean() > 1.7 * base.mask.float().mean()
    assert bool(t.mask.any(dim=1).all())


def test_upsample_stream_matches(dataset):
    """transfer_stream of an upsampling target == per-frame transfer_fast
    bit for bit, agrees with the JAX stream on >= 99.9 % of pixels, and
    fused_state(frame=i) selects a streamed frame's volume."""
    je, te = _engines(dataset, UP)
    pairs = [_window(dataset, i) for i in (0, 2)]
    per = [te.transfer_fast(tw) for _, tw in pairs]
    ref = interop.to_numpy(te.fused_state())
    sv = te.transfer_stream(TM.stack_windows([tw for _, tw in pairs]))
    jv = je.transfer_stream(JM.stack_windows([w for w, _ in pairs]))
    for k, vs in enumerate(per):
        _assert_equal_scans(type(vs)(*(f[k] for f in sv[:5]), sv.adaption),
                            vs)
        _assert_scans_agree(type(vs)(*(f[k] for f in jv[:5]), jv.adaption),
                            vs)
    with pytest.raises(ValueError, match="frame"):
        te.fused_state()
    got = interop.to_numpy(te.fused_state(frame=1))
    for a, b in zip((got.tsdf, got.label, got.rem),
                    (ref.tsdf, ref.label, ref.rem)):
        np.testing.assert_array_equal(a, b)


def _beam_table(lo_frac, hi_frac):
    """SOURCE with 16 beams crowded into the bottom and top of its fov."""
    span = SOURCE.fov_up - SOURCE.fov_down
    lo = np.linspace(SOURCE.fov_down, SOURCE.fov_down + lo_frac * span, 8)
    hi = np.linspace(SOURCE.fov_up - hi_frac * span, SOURCE.fov_up, 8)
    return dataclasses.replace(
        SOURCE, beam_angles=np.radians(np.concatenate([lo, hi])).tolist())


@pytest.mark.filterwarnings("ignore:source beam table leaves")
@pytest.mark.parametrize("case", ["identity", "up", "down", "wide", "both",
                                  "off", "narrow_mergemesh", "narrow_mesh",
                                  "snapped_gaps"])
def test_interp_counts_match_jax(dataset, case):
    """The engine's chord counts (rows, columns, row span) equal the JAX
    engine's for each gating case of tests/test_upsample.py."""
    source, target, cfg, kw = SOURCE, UP, CFG, {}
    wide = dataclasses.replace(SOURCE, angle_res_hor=SOURCE.angle_res_hor / 2)
    narrow = SensorSpec(name="narrow16", beams=16, fov_up=4.0,
                        fov_down=-10.0, angle_res_hor=360.0 / 256.0)
    if case == "identity":
        target = SOURCE
    elif case == "down":
        source, target = UP, SOURCE
    elif case == "wide":
        target = wide
    elif case == "both":
        target = dataclasses.replace(wide, beams=32)
    elif case == "off":
        kw = dict(upsample_interp=False)
    elif case.startswith("narrow"):
        target = narrow
        if case == "narrow_mesh":
            cfg = _cfg(adaption="mesh", number_of_scans=2)
    elif case == "snapped_gaps":
        source = _beam_table(0.36, 0.36)
    j = JD.TransferEngine(source, target, cfg, dataset[2], **kw)
    t = TD.TransferEngine(source, target, cfg, device="cpu", **kw)
    got = (t._interp_mv, t._interp_mu, t._interp_vspan, t._interp_active)
    assert got == (j._interp_mv, j._interp_mu, j._interp_vspan,
                   j._interp_active)
    if case == "snapped_gaps":
        assert t._interp_vspan > 1


def test_interp_vspan_cap_warns():
    """A beam table whose occupied-row gaps exceed 4 rows warns and caps
    the chord span at 4; a table within the cap stays silent."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = TD.TransferEngine(_beam_table(0.1, 0.1), UP, CFG,
                                device="cpu")
    assert eng._interp_vspan == 4
    assert any("bridges at most 4" in str(w.message) for w in rec)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        TD.TransferEngine(SOURCE, UP, CFG, device="cpu")
    assert not any("bridges at most" in str(w.message) for w in rec)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("case", ["cp", "catmesh", "upsample"])
def test_cli_adaptions(dataset, tmp_path, capsys, case):
    """The port's CLI (--device cpu) with a cp or catmesh config and with a
    target denser than the source: every frame written; cp's identity
    metrics are exact (IoU and Acc 1, MSE 0); catmesh scores what the
    mergemesh CLI scores; --ply writes meshes for mesh and mergemesh only;
    the per-frame scans agree with the JAX engine's."""
    root, seq, cap = dataset
    adaption = "mergemesh" if case == "upsample" else case
    cfg = _cfg(adaption=adaption)
    cfg_path = tmp_path / "cfg.yaml"
    cfg.to_yaml(str(cfg_path))
    args = ["-d", root, "-c", str(cfg_path), "-b", "-w", "--fixed-bounds",
            "--device", "cpu", "--ply", str(tmp_path / "ply")]
    target = SOURCE
    if case == "upsample":
        target = UP
        up_path = tmp_path / "up.yaml"
        with open(up_path, "w") as f:
            yaml.safe_dump(UP.to_dict(), f)
        args += ["-t", str(up_path)]

    def run(name, argv):
        mj = tmp_path / f"{name}.json"
        assert cli.main(argv + ["-p", str(tmp_path / name),
                                "--metrics-json", str(mj)]) == 0
        return json.loads(mj.read_text())

    metrics = run(case, args)
    assert [m["index"] for m in metrics] == list(range(len(seq)))
    assert capsys.readouterr().out.count("Took: ") == len(seq)
    assert (tmp_path / "ply").exists() == (case == "upsample")
    je = JD.TransferEngine(SOURCE, target, cfg, cap, fixed_bounds=True)
    for m in metrics:
        w = JM.load_window(seq, cfg, m["index"], cap)
        vs = je.transfer(w)[0] if case == "cp" else je.transfer_fast(w)
        n_ref = int((np.asarray(vs.mask)
                     & (np.asarray(vs.points).sum(-1) != 0)).sum())
        assert abs(m["points_written"] - n_ref) <= 1e-3 * target.H * target.W
        assert "triangles" not in m or case == "upsample"
    if case == "cp":
        assert all(m["iou"] == 1.0 and m["acc"] == 1.0 and m["mse"] == 0.0
                   for m in metrics)
    elif case == "catmesh":
        mm_path = tmp_path / "mm.yaml"
        CFG.to_yaml(str(mm_path))
        mm = run("mergemesh", ["-d", root, "-c", str(mm_path), "-b", "-w",
                               "--fixed-bounds", "--device", "cpu"])
        for a, b in zip(metrics, mm):
            assert (a["iou"], a["acc"], a["mse"]) == (b["iou"], b["acc"],
                                                      b["mse"])
    else:
        assert all("iou" not in m for m in metrics)
