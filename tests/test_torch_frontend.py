"""The port's front end (``utils/jscheck.py``, ``webviewer.py``,
``utils/images.py``, ``interactive.py``, ``visualize.py``, the CLI's
``--png``/``--html``/``--profile`` and ``experiments/multiscene.py``)
against the JAX package on the CPU.

``jscheck.py`` and ``webviewer.py`` are the originals byte for byte.
``images.py`` and ``interactive.py`` are the originals after the import
substitution apart from the functions named here: the viridis table and the
PNG writer of ``images.py``, ``frame_payload`` of ``interactive.py``.
Tolerances: label images and diffs of the two packages equal on >= 99.9 %
of pixels (the atan2/asin/sqrt ulps of the projection move a point across a
pixel boundary now and then); the viridis renders of range and remission
within one step of the colour scale on every pixel and equal on >= 99 % (a
range an ulp apart can fall on the other side of a step: the session
dataset's scan 1 has 22 pixels of one range at the image's maximum, which
an ulp puts in the top step or the one below, 0.54 % of its pixels); the
title metrics within 1e-6 (MSE within 1e-5 relative); the virtual clouds'
points within 1e-4 m (the same ulps).
"""

import ast
import base64
import io
import json
import os
import re
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from lidar_transfer_tpu import cli as jcli
from lidar_transfer_tpu import interactive as JI
from lidar_transfer_tpu import visualize as JV
from lidar_transfer_tpu import webviewer as JW
from lidar_transfer_tpu.config import TransferConfig as JTransferConfig
from lidar_transfer_tpu.ops import projection as JP
from lidar_transfer_tpu.utils import images as JIM
from lidar_transfer_tpu_torch import cli, interactive, visualize, webviewer
from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
from lidar_transfer_tpu_torch.datasets import kitti, synthetic
from lidar_transfer_tpu_torch.experiments import multiscene
from lidar_transfer_tpu_torch.ops import projection as TP
from lidar_transfer_tpu_torch.utils import images
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGREE = 0.999


def _agree(a, b) -> float:
    """Share of pixels of two (H, W, 3) images that are equal."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float((a == b).all(-1).mean())


_STEP = {tuple(c): i for i, c in enumerate(images.VIRIDIS.tolist())}


def _same_row(name, a, b):
    """Two renders of one canvas row: a viridis row within one colour step
    on every pixel and equal on >= 99 %, any other on >= 99.9 %."""
    if "range" in name or "remission" in name:
        ia, ib = (np.array([_STEP[tuple(c)] for c in
                            np.asarray(x).reshape(-1, 3).tolist()])
                  for x in (a, b))
        assert np.abs(ia - ib).max() <= 1, name
        assert _agree(a, b) >= 0.99, name
    else:
        assert _agree(a, b) >= AGREE, name


def _read(rel):
    with open(os.path.join(REPO, rel), "rb") as f:
        return f.read()


def _nodes(rel, substitute):
    """Top-level statements of a module after its docstring, by name (an
    import by its text), as ``ast.unparse`` gives them; with
    ``substitute`` the JAX package's imports are read as the port's."""
    src = _read(rel).decode()
    if substitute:
        src = src.replace("lidar_transfer_tpu.", "lidar_transfer_tpu_torch.")
    out = {}
    for node in ast.parse(src).body[1:]:
        text = ast.unparse(node)
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = text
        elif isinstance(node, ast.Assign):
            out[node.targets[0].id] = text
        else:
            out[text] = text
    return out


@pytest.mark.parametrize("rel", ["utils/jscheck.py", "webviewer.py"])
def test_copies_byte_identical(rel):
    assert _read(f"lidar_transfer_tpu_torch/{rel}") \
        == _read(f"lidar_transfer_tpu/{rel}")


@pytest.mark.parametrize("rel,differs,added", [
    ("utils/images.py", {"get_mpl_colormap", "save_virtual_scan_pngs"},
     {"VIRIDIS"}),
    ("interactive.py", {"frame_payload", "_colorize_range"},
     {"_host", "import torch"}),
])
def test_copies_equal_after_import_substitution(rel, differs, added):
    """Every statement of the original is the port's after
    ``lidar_transfer_tpu.`` -> ``lidar_transfer_tpu_torch.``, apart from
    the functions named: the viridis table and the PNG writer
    (``images``), and ``frame_payload`` on the port's tensors
    (``interactive``); ``FrameStepper`` and ``InteractiveViewer`` are
    among the equal ones."""
    j = _nodes(f"lidar_transfer_tpu/{rel}", substitute=True)
    t = _nodes(f"lidar_transfer_tpu_torch/{rel}", substitute=False)
    assert set(t) - set(j) == added
    assert set(j) <= set(t)
    assert [k for k in j if k not in differs and j[k] != t[k]] == []
    assert all(j[k] != t[k] for k in differs)


def test_viridis_table_is_matplotlibs():
    """``get_mpl_colormap("viridis")`` is the constant, equal to the table
    ``images.py:26`` of the JAX package builds from matplotlib."""
    import matplotlib

    cmap = matplotlib.colormaps["viridis"].resampled(256)
    ref = (cmap(np.arange(256))[:, :3] * 255).astype(np.uint8)
    got = images.get_mpl_colormap("viridis")
    assert got is images.VIRIDIS and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, JIM.get_mpl_colormap("viridis"))
    np.testing.assert_array_equal(images.get_mpl_colormap("magma"),
                                  JIM.get_mpl_colormap("magma"))


def test_other_colormap_needs_matplotlib(monkeypatch):
    """Without matplotlib viridis still works and any other map raises
    ImportError, as the original does for every map."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    images.get_mpl_colormap.cache_clear()
    try:
        assert images.get_mpl_colormap("viridis") is images.VIRIDIS
        with pytest.raises(ImportError):
            images.get_mpl_colormap("plasma")
    finally:
        images.get_mpl_colormap.cache_clear()


def test_image_helpers_equal():
    """``convert_range``, ``range_image_rgb`` and ``label_image_rgb`` of
    both packages on the same arrays (``images.py:30-61``)."""
    rng = np.random.default_rng(3)
    r = rng.uniform(0, 80, (16, 64)).astype(np.float32)
    r[::3] = 0
    lbl = rng.choice([0, 10, 40, 48, 50, 70, 252, 259], (16, 64))
    np.testing.assert_array_equal(images.convert_range(r),
                                  JIM.convert_range(r))
    np.testing.assert_array_equal(images.range_image_rgb(r),
                                  JIM.range_image_rgb(r))
    np.testing.assert_array_equal(
        images.label_image_rgb(lbl, TransferConfig()),
        JIM.label_image_rgb(lbl, JTransferConfig()))


def test_save_virtual_scan_pngs_pixels_equal(tmp_path):
    """The port's PNGs (``webviewer.png_bytes``) and the original's (PIL)
    of one scan decode, by PIL, to the same pixels."""
    rng = np.random.default_rng(4)
    vs = types.SimpleNamespace(
        label=rng.choice([0, 10, 40, 50, 70], (16, 64)).astype(np.int32),
        range=rng.uniform(0, 50, (16, 64)).astype(np.float32))
    JIM.save_virtual_scan_pngs(str(tmp_path / "j"), 3, vs, JTransferConfig())
    images.save_virtual_scan_pngs(str(tmp_path / "t"), 3, vs,
                                  TransferConfig())
    for sub in ("labels_png", "velodyne_png"):
        a, b = (np.asarray(Image.open(tmp_path / d / sub / "000003.png"))
                for d in ("j", "t"))
        assert a.shape == (16, 64, 3)
        np.testing.assert_array_equal(a, b)


def _title_numbers(title):
    return [float(x) for x in re.findall(r"[-0-9.]+(?:e[-+]?\d+)?", title)]


def _same_titles(a, b):
    ja, tb = _title_numbers(a), _title_numbers(b)
    assert len(ja) == len(tb) == 3
    assert tb[0] == pytest.approx(ja[0], abs=1e-6)
    assert tb[1] == pytest.approx(ja[1], abs=1e-6)
    assert tb[2] == pytest.approx(ja[2], rel=1e-5)


def _same_payloads(j, t):
    assert [n for n, _ in j["rows"]] == [n for n, _ in t["rows"]]
    for (name, a), (_, b) in zip(j["rows"], t["rows"]):
        _same_row(name, a, b)
    assert (j["diff"] is None) == (t["diff"] is None)
    if j["diff"] is not None:
        assert _agree(j["diff"], t["diff"]) >= AGREE
        assert t["diff"].any()
        _same_titles(j["title"], t["title"])
    for k in ("points_3d", "colors_3d", "virtual_points_3d",
              "virtual_colors_3d"):
        assert (k in j) == (k in t)
    if "points_3d" in j:
        np.testing.assert_array_equal(j["points_3d"], t["points_3d"])
        np.testing.assert_array_equal(j["colors_3d"], t["colors_3d"])


@pytest.fixture(scope="module")
def payloads(synthetic_dataset, small_spec):
    """``frame_payload`` of both packages on scan 1 of the session
    dataset (each package projects the same padded scan) with a virtual
    scan of the same arrays: the source image with every 5th pixel's
    label changed and the range moved by 0.25 m on every 3rd."""
    seq = kitti.KittiSequence.open(synthetic_dataset)
    pts, rem, lbl = seq.read(1)
    p, r, l, m = kitti.pad_points(pts, rem, lbl, kitti.scan_capacity(
        len(pts)))
    kw = dict(H=small_spec.H, W=small_spec.W, fov_up_deg=small_spec.fov_up,
              fov_down_deg=small_spec.fov_down)
    jri = JP.range_project(*map(jnp.asarray, (p, r, l, m)), **kw)
    tri = TP.range_project(*map(torch.as_tensor, (p, r, l, m)), **kw)
    v_lbl = np.asarray(jri.label).copy()
    v_lbl.reshape(-1)[::5] = 40
    v_rng = np.asarray(jri.range).copy()
    v_rng.reshape(-1)[::3] += 0.25
    back = np.asarray(JP.reverse_project(jri, fov_up_deg=small_spec.fov_up,
                                         fov_down_deg=small_spec.fov_down))
    fields = dict(range=v_rng, remission=np.asarray(jri.remission),
                  label=v_lbl, points=back, mask=np.asarray(jri.mask))
    jv = types.SimpleNamespace(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    tv = types.SimpleNamespace(**{k: torch.tensor(v)
                                  for k, v in fields.items()})
    src = dict(source_points=pts, source_labels=lbl)
    shared = TP.RangeImage(*(torch.tensor(np.asarray(f)) for f in jri))
    return {
        "shared image": (
            JI.frame_payload(jri, JTransferConfig(), virtual=jv, **src),
            interactive.frame_payload(shared, TransferConfig(), virtual=tv,
                                      **src)),
        "source": (JI.frame_payload(jri, JTransferConfig(), **src),
                   interactive.frame_payload(tri, TransferConfig(), **src)),
        "virtual": (JI.frame_payload(jri, JTransferConfig(), virtual=jv,
                                     **src),
                    interactive.frame_payload(tri, TransferConfig(),
                                              virtual=tv, **src))}


@pytest.mark.parametrize("case", ["source", "virtual", "shared image"])
def test_frame_payload_matches_jax(payloads, case):
    """``interactive.frame_payload`` of the port against the JAX one's
    (``interactive.py:88``), each on its own projection of the scan: rows
    and diff to the module's tolerances, the title metrics within 1e-6
    (MSE 1e-5 relative), the clouds equal; given the JAX projection's
    arrays as its source image, every row and the diff equal."""
    j, t = payloads[case]
    _same_payloads(j, t)
    if case == "shared image":
        for (_, a), (_, b) in zip(j["rows"] + [("diff", j["diff"])],
                                  t["rows"] + [("diff", t["diff"])]):
            np.testing.assert_array_equal(a, b)
    if case != "source":
        assert len(t["rows"]) == 6
        assert t["title"].startswith("IoU ") and "MSE " in t["title"]
        assert float(_title_numbers(t["title"])[0]) < 1.0
        np.testing.assert_array_equal(j["virtual_colors_3d"],
                                      t["virtual_colors_3d"])
        np.testing.assert_allclose(t["virtual_points_3d"],
                                   j["virtual_points_3d"], atol=1e-4)
    else:
        assert t["title"] == "" and t["diff"] is None


def test_export_html_byte_identical(payloads, tmp_path):
    """One numpy payload through both ``webviewer.export_html`` gives the
    same file."""
    pay = payloads["virtual"][0]
    JW.export_html([("a", pay)], str(tmp_path / "j.html"), title="t",
                   max_points=500)
    webviewer.export_html([("a", pay)], str(tmp_path / "t.html"), title="t",
                          max_points=500)
    assert (tmp_path / "j.html").read_bytes() \
        == (tmp_path / "t.html").read_bytes()


def _frames(path):
    with open(path) as f:
        doc = f.read()
    webviewer.check_js(webviewer.extract_script(doc))
    m = re.search(r"^const FRAMES = (.*);$", doc, re.M)
    return json.loads(m.group(1))


def _png(uri):
    return np.asarray(Image.open(io.BytesIO(
        base64.b64decode(uri.split(",", 1)[1]))))


def _cloud(rec):
    return np.frombuffer(base64.b64decode(rec["xyz"]), np.float32)


def _same_records(a, b):
    """Two embedded frame lists: names, titles, row names, cloud sizes and
    colours equal; row images on >= 99.9 % of pixels; points within
    1e-4 m."""
    assert [f["name"] for f in a] == [f["name"] for f in b]
    for x, y in zip(a, b):
        assert x["title"] == y["title"]
        assert [r["name"] for r in x["rows"]] == [r["name"] for r in y["rows"]]
        for rx, ry in zip(x["rows"], y["rows"]):
            _same_row(rx["name"], _png(rx["png"]), _png(ry["png"]))
        for k in ("src", "virt"):
            assert (x[k] is None) == (y[k] is None)
            if x[k] is not None:
                assert x[k]["n"] == y[k]["n"] and x[k]["rgb"] == y[k]["rgb"]
                np.testing.assert_allclose(_cloud(y[k]), _cloud(x[k]),
                                           atol=1e-4)


@pytest.fixture(scope="module")
def inset_dataset(tmp_path_factory, small_spec):
    """A 3-scan dataset of the session sensor whose edge beams lie 0.5 deg
    inside its FOV (``tests/test_torch_engine.py``: a beam on the limit
    is kept or dropped by the last ulp of asin), and a small mergemesh
    config."""
    root = str(tmp_path_factory.mktemp("inset_kitti"))
    inset = SensorSpec(name=small_spec.name, beams=small_spec.beams,
                       fov_up=small_spec.fov_up - 0.5,
                       fov_down=small_spec.fov_down + 0.5,
                       angle_res_hor=small_spec.angle_res_hor)
    synthetic.write_kitti_dataset(root, synthetic.Scene.default(), inset,
                                  n_scans=3)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(small_spec.to_dict(), f)
    cfg = os.path.join(root, "cfg.yaml")
    TransferConfig(voxel_size=0.25, voxel_bounds=(
        (-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0))).to_yaml(cfg)
    return root, cfg


@pytest.fixture(scope="module")
def cli_runs(inset_dataset, tmp_path_factory):
    """The port's CLI with ``--png --html --profile --device cpu`` and the
    JAX CLI with ``--png --html`` on 2 frames."""
    root, cfg = inset_dataset
    tmp = tmp_path_factory.mktemp("frontend_cli")
    base = ["-d", root, "-c", cfg, "--fixed-bounds", "-b", "--frames", "2",
            "--png"]
    assert cli.main(base + ["-p", str(tmp / "t"), "--html",
                            str(tmp / "t.html"), "--profile",
                            str(tmp / "prof"), "--device", "cpu"]) == 0
    assert jcli.main(base + ["-p", str(tmp / "j"), "--html",
                             str(tmp / "j.html"), "--cpu"]) == 0
    return tmp


@pytest.mark.parametrize("sub", ["labels_png", "velodyne_png"])
def test_cli_png_matches_jax(cli_runs, sub):
    """``--png`` without ``-w``: one PNG a frame, pixels equal to the JAX
    CLI's on >= 99.9 %."""
    for i in range(2):
        a, b = (np.asarray(Image.open(cli_runs / d / "sequences" / "00" / sub
                                      / f"{i:06d}.png")) for d in "jt")
        assert a.shape == b.shape == (16, 256, 3)
        assert _agree(a, b) >= AGREE
        if sub == "velodyne_png":
            _same_row("range", a, b)
    assert sorted(os.listdir(cli_runs / "t" / "sequences" / "00" / sub)) \
        == ["000000.png", "000001.png"]


def test_cli_html_and_profile(cli_runs):
    """``--html``: the embedded frame records equal the JAX CLI's;
    ``--profile``: a Chrome trace with events."""
    a, b = _frames(cli_runs / "j.html"), _frames(cli_runs / "t.html")
    assert len(b) == 2 and b[0]["title"].startswith("IoU 0.")
    _same_records(a, b)
    with open(cli_runs / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_cli_profile_holds_the_port_spans(cli_runs):
    """``--profile``'s trace holds two ``lt.clock`` anchors and, between
    them, the loader thread's ``prefetch.load`` and ``loader.read`` spans
    on a row of their own."""
    with open(cli_runs / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    anchors = sorted(e["ts"] for e in events
                     if e.get("name") == "lt.clock" and e.get("ph") == "X")
    assert len(anchors) == 2
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for name in ("prefetch.load", "loader.read"):
        spans = [e for e in events if e.get("cat") == "port_span"
                 and e["name"] == name]
        assert spans, name
        for e in spans:
            assert rows[e["tid"]] == "port spans: lt-prefetch"
            assert anchors[0] <= e["ts"] <= anchors[1]


def test_cli_flags_change_no_result(inset_dataset, tmp_path):
    """The port's written scans with and without the new flags are equal
    byte for byte; ``--html`` turns ``--stream`` off."""
    root, cfg = inset_dataset
    base = ["-d", root, "-c", cfg, "--fixed-bounds", "-b", "-w",
            "--frames", "2", "--device", "cpu"]
    assert cli.main(base + ["-p", str(tmp_path / "a")]) == 0
    assert cli.main(base + ["-p", str(tmp_path / "b"), "--png", "--stream",
                            "2", "--html", str(tmp_path / "v.html")]) == 0
    for sub in ("velodyne", "labels"):
        d = [tmp_path / x / "sequences" / "00" / sub for x in "ab"]
        names = sorted(os.listdir(d[0]))
        assert names == sorted(os.listdir(d[1])) and len(names) == 2
        for n in names:
            assert (d[0] / n).read_bytes() == (d[1] / n).read_bytes()


@pytest.fixture(scope="module")
def predictions(synthetic_dataset, tmp_path_factory):
    """A predictions tree: the labels with every 7th point's changed."""
    root = tmp_path_factory.mktemp("preds")
    pred_dir = root / "sequences" / "00" / "predictions"
    pred_dir.mkdir(parents=True)
    seq = kitti.KittiSequence.open(synthetic_dataset)
    for i in range(len(seq)):
        lbl = seq.read(i)[2].copy()
        lbl[::7] = 40
        kitti.write_label_file(str(pred_dir / f"{i:06d}.label"), lbl)
    return str(root)


@pytest.mark.parametrize("mode", ["figure", "html"])
@pytest.mark.parametrize("with_pred", [False, True])
def test_visualize_matches_jax(synthetic_dataset, predictions, tmp_path,
                               mode, with_pred):
    """``lt-visualize-torch`` against ``lidar_transfer_tpu.visualize.main``
    on 1 frame: the figure panel's pixels on >= 99.9 %, or the embedded
    frame records (with predictions the title metrics and the diff)."""
    argv = ["-d", synthetic_dataset, "--offset", "1"]
    if with_pred:
        argv += ["-p", predictions]
    outs = {}
    for name, main, extra in (("j", JV.main, []),
                              ("t", visualize.main, ["--device", "cpu"])):
        if mode == "figure":
            out = tmp_path / name
            assert main(argv + ["--out", str(out)] + extra) == 0
            assert os.listdir(out) == ["00_000001.png"]
            outs[name] = np.asarray(Image.open(out / "00_000001.png"))
        else:
            out = tmp_path / f"{name}.html"
            assert main(argv + ["--html", str(out)] + extra) == 0
            outs[name] = _frames(out)
    if mode == "figure":
        assert outs["t"].shape == outs["j"].shape
        assert _agree(outs["j"], outs["t"]) >= AGREE
    else:
        _same_records(outs["j"], outs["t"])
        rec = outs["t"][0]
        assert (rec["virt"] is not None) == with_pred
        assert rec["title"].startswith("IoU ") == with_pred


def test_multiscene_rows(tmp_path):
    """``experiments.multiscene`` at 2 scenes of 2 frames, 1 step, 128
    columns, +-8 m bounds (the volume at the default voxel is then
    320x320x208): the keys of the JAX package's row JSON
    (``experiments_artifacts/workflow_multiscene_r05``), and mean, std,
    min and max numpy's over ``per_scene``."""
    assert multiscene.main([
        "--rows", "real_on_fake_identity", "--scenes", "2", "--steps", "1",
        "--frames", "2", "--width", "128", "--bounds", "8", "--device",
        "cpu", "--work", str(tmp_path / "w")]) == 0
    assert os.listdir(tmp_path / "w" / "rows") \
        == ["real_on_fake_identity.json"]
    got = json.loads((tmp_path / "w" / "rows" /
                      "real_on_fake_identity.json").read_text())
    ref = json.loads(_read("experiments_artifacts/workflow_multiscene_r05/"
                           "real_on_fake_identity.json"))
    assert sorted(got) == sorted(ref)
    assert len(got["per_scene"]) == 2
    for g in got["per_scene"]:
        assert sorted(g) == sorted(ref["per_scene"][0])
    assert (got["scenes"], got["steps"], got["width"], got["bounds"],
            got["backend"], got["target"]) == (2, 1, 128, 8.0, "cpu", None)
    for key in ("miou", "miou_present", "acc"):
        vals = [r[key] for r in got["per_scene"]]
        assert got[key] == float(np.mean(vals))
        assert got[key + "_std"] == float(np.std(vals))
        assert got[key + "_min"] == float(np.min(vals))
        assert got[key + "_max"] == float(np.max(vals))


def test_multiscene_rows_and_defaults_match_the_script():
    """``ROWS`` and every flag's default equal those of
    ``scripts/run_workflow_multiscene.py`` (read from its source), apart
    from ``--cpu``/``--device``, ``--work`` and ``--out``."""
    tree = ast.parse(_read("scripts/run_workflow_multiscene.py").decode())
    rows = next(n for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "ROWS")
    assert ast.literal_eval(rows.value) == multiscene.ROWS
    ref = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            ref[node.args[0].value] = (ast.literal_eval(kw["default"])
                                       if "default" in kw else None)
    got = {a.option_strings[0]: a.default
           for a in multiscene.build_parser()._actions if a.option_strings}
    for flag in set(ref) - {"--cpu", "--work", "--out"}:
        assert got[flag] == ref[flag], flag
    assert got["--device"] == "cuda"


@pytest.mark.parametrize("entry", ["transfer", "visualize", "multiscene"])
def test_entry_points_need_a_card(monkeypatch, synthetic_dataset, tmp_path,
                                  entry):
    """Without a CUDA device each new entry point exits 2 at its default
    ``--device cuda``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = {
        "transfer": (cli.main, ["-d", synthetic_dataset]),
        "visualize": (visualize.main, ["-d", synthetic_dataset]),
        "multiscene": (multiscene.main, ["--work", str(tmp_path)]),
    }[entry]
    assert main(argv) == 2
    assert main(argv + ["--device", "cuda"]) == 2
    assert os.listdir(tmp_path) == []


def test_interactive_without_vispy_exits_2(monkeypatch, synthetic_dataset):
    """``--interactive`` without vispy fails with exit 2 and a message,
    never a PNG export."""
    monkeypatch.setitem(sys.modules, "vispy", None)
    assert visualize.main(["-d", synthetic_dataset, "--interactive",
                           "--device", "cpu"]) == 2


def test_pyproject_scripts():
    """The three new entry points, and the eleven earlier ones as they
    were."""
    text = _read("pyproject.toml").decode()
    body = text.split("[project.scripts]")[1].split("\n[")[0]
    scripts = dict(re.findall(r'^(\S+) = "([^"]+)"$', body, re.M))
    assert len(scripts) == 14
    assert scripts["lt-transfer-torch"] == "lidar_transfer_tpu_torch.cli:main"
    assert scripts["lt-visualize-torch"] \
        == "lidar_transfer_tpu_torch.visualize:main"
    assert scripts["lt-convert-torch"] \
        == "lidar_transfer_tpu_torch.datasets.convert:main"
    assert scripts["lt-transfer"] == "lidar_transfer_tpu.cli:main"
    assert scripts["lt-seg-torch"] \
        == "lidar_transfer_tpu_torch.experiments.segmentation:main"


def test_cli_help_lists_the_new_flags():
    """The module docstring's usage block names every new flag."""
    out = subprocess.run([sys.executable, "-m", "lidar_transfer_tpu_torch.cli",
                          "--help"], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    for flag in ("--png", "--html", "--html-frames", "--html-max-points",
                 "--profile"):
        assert flag in out.stdout and flag in cli.__doc__
