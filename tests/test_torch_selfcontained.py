"""The port stands alone: it imports nothing of the JAX package and no jax,
and each module it keeps a copy of gives what the original gives.

The copies (``lidar_transfer_tpu_torch/config.py``, ``datasets/kitti.py``,
``datasets/synthetic.py``, ``utils/plyio.py``, ``utils/prefetch.py``,
``utils/runtime.py``) are numpy only; the same numpy inputs go through the
original in ``lidar_transfer_tpu`` and through the copy, and the results
must be equal exactly (no arithmetic differs, so no tolerance).
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from lidar_transfer_tpu import config as JC
from lidar_transfer_tpu.datasets import kitti as JK
from lidar_transfer_tpu.datasets import synthetic as JSY
from lidar_transfer_tpu.ops import marching as JMA
from lidar_transfer_tpu.utils import plyio as JPLY
from lidar_transfer_tpu.utils import prefetch as JPF
from lidar_transfer_tpu.utils import runtime as JRT
from lidar_transfer_tpu_torch import config as TC
from lidar_transfer_tpu_torch.datasets import kitti as TK
from lidar_transfer_tpu_torch.datasets import synthetic as TSY
from lidar_transfer_tpu_torch.ops import marching as TMA
from lidar_transfer_tpu_torch.utils import plyio as TPLY
from lidar_transfer_tpu_torch.utils import prefetch as TPF
from lidar_transfer_tpu_torch.utils import runtime as TRT
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    TRT.cpu_warmup()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lidar_transfer_tpu_torch")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("lidar_transfer_tpu", "jax", "jaxlib", "flax", "optax")


def test_no_import_of_the_jax_package():
    """An AST walk over every .py of the port and over chip_smoke.py finds
    no import of ``lidar_transfer_tpu`` or ``jax``."""
    files = _port_sources()
    assert len(files) > 30
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), node.lineno, n)
                    for n in names if _foreign(n)]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "lidar_transfer_tpu_torch.cli", "lidar_transfer_tpu_torch.probes",
    "lidar_transfer_tpu_torch.probes.cases",
    "lidar_transfer_tpu_torch.pipeline.deform",
    "lidar_transfer_tpu_torch.experiments.segmentation",
    "lidar_transfer_tpu_torch.experiments.workflows",
    "lidar_transfer_tpu_torch.experiments.compare_datasets",
    "lidar_transfer_tpu_torch.interop", "lidar_transfer_tpu_torch.parallel",
    "lidar_transfer_tpu_torch.parallel.multihost",
    "lidar_transfer_tpu_torch.visualize", "lidar_transfer_tpu_torch.webviewer",
    "lidar_transfer_tpu_torch.interactive",
    "lidar_transfer_tpu_torch.datasets.convert",
    "lidar_transfer_tpu_torch.experiments.multiscene",
    "lidar_transfer_tpu_torch.experiments.grids",
    "lidar_transfer_tpu_torch.experiments.upsample",
    "lidar_transfer_tpu_torch.probes.train_levers"])
def test_fresh_interpreter_loads_neither(module):
    """Importing the port's entry modules in a fresh interpreter leaves
    neither package, nor flax or optax, in ``sys.modules``."""
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('lidar_transfer_tpu', 'jax', 'jaxlib', 'flax', 'optax')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("module", [
    "lidar_transfer_tpu_torch.cli", "lidar_transfer_tpu_torch.visualize",
    "lidar_transfer_tpu_torch.webviewer"])
def test_front_end_loads_no_matplotlib_or_pil(module):
    """The front end's entry modules, imported in a fresh interpreter, load
    neither matplotlib nor PIL (the card machine has neither): the viridis
    table is a constant of ``utils/images`` and PNGs go through
    ``webviewer.png_bytes``; a viridis render and a PNG written do not
    load them either."""
    code = (f"import sys, {module}\n"
            "import numpy as np\n"
            "from lidar_transfer_tpu_torch.utils import images\n"
            "from lidar_transfer_tpu_torch.webviewer import png_bytes\n"
            "png_bytes(images.range_image_rgb(np.ones((4, 8))))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'PIL')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("name", ["hdl32", "hdl64", "vlp16"])
def test_config_sensor_yaml(name):
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    j, t = JC.SensorSpec.from_yaml(path), TC.SensorSpec.from_yaml(path)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.H, j.W) == (t.H, t.W)
    assert j.to_dict() == t.to_dict()


def test_config_presets_transfer_config_and_lut(tmp_path):
    for preset in ("HDL32", "HDL64", "VLP16"):
        assert (dataclasses.asdict(getattr(JC, preset))
                == dataclasses.asdict(getattr(TC, preset)))
    path = os.path.join(REPO, "configs", "lidar_transfer.yaml")
    j, t = JC.TransferConfig.from_yaml(path), TC.TransferConfig.from_yaml(path)
    assert j.to_dict() == t.to_dict()
    assert j.nclasses == t.nclasses
    np.testing.assert_array_equal(j.voxel_bounds_array, t.voxel_bounds_array)
    np.testing.assert_array_equal(j.transformation_matrix,
                                  t.transformation_matrix)
    t.to_yaml(str(tmp_path / "t.yaml"))
    assert JC.TransferConfig.from_yaml(str(tmp_path / "t.yaml")).to_dict() \
        == j.to_dict()
    np.testing.assert_array_equal(JC.make_color_lut(j.color_map_bgr),
                                  TC.make_color_lut(t.color_map_bgr))


@pytest.mark.parametrize("scene", ["default", "urban", "default_dynamic"])
def test_synthetic_scans_equal(scene):
    """Scans of one scene, pose and seed: points, remissions and labels
    equal bit for bit, with and without range noise and dropout."""
    spec_j = JC.SensorSpec(name="t", beams=16, fov_up=5.0, fov_down=-24.0,
                           angle_res_hor=360.0 / 256.0)
    spec_t = TC.SensorSpec(**dataclasses.asdict(spec_j))
    poses_j, poses_t = (JSY.straight_line_poses(3),
                        TSY.straight_line_poses(3))
    np.testing.assert_array_equal(poses_j, poses_t)
    np.testing.assert_array_equal(JSY.sensor_rays(spec_j),
                                  TSY.sensor_rays(spec_t))
    sj, st = getattr(JSY.Scene, scene)(), getattr(TSY.Scene, scene)()
    for kw in (dict(), dict(range_noise=0.02, dropout=0.1, seed=5,
                            frame=1.0)):
        a = JSY.simulate_scan(sj, spec_j, poses_j[1], **kw)
        b = TSY.simulate_scan(st, spec_t, poses_t[1], **kw)
        assert len(a[0]) > 500
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_kitti_dataset_written_and_read_back(tmp_path):
    """A KITTI tree written by each package is equal byte for byte, and
    each reader reads the other's tree alike (scan, labels, poses, calib,
    padding and capacity)."""
    spec = dict(name="t", beams=16, fov_up=5.0, fov_down=-24.0,
                angle_res_hor=360.0 / 256.0)
    JSY.write_kitti_dataset(str(tmp_path / "j"), JSY.Scene.default(),
                            JC.SensorSpec(**spec), n_scans=3)
    TSY.write_kitti_dataset(str(tmp_path / "t"), TSY.Scene.default(),
                            TC.SensorSpec(**spec), n_scans=3)
    tj, tt = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert sorted(tj) == sorted(tt) and len(tj) >= 8
    assert tj == tt
    sj = JK.KittiSequence.open(str(tmp_path / "t"))
    st = TK.KittiSequence.open(str(tmp_path / "j"))
    assert len(sj) == len(st) == 3
    np.testing.assert_array_equal(sj.poses, st.poses)
    for i in range(3):
        a, b = sj.read(i), st.read(i)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        cap = JK.scan_capacity(len(a[0]))
        assert cap == TK.scan_capacity(len(b[0]))
        for x, y in zip(JK.pad_points(*a, cap), TK.pad_points(*b, cap)):
            np.testing.assert_array_equal(x, y)
    # the writers, on their own
    pts, rem, lbl = sj.read(0)
    for mod, name in ((JK, "j"), (TK, "t")):
        mod.write_scan_file(str(tmp_path / f"{name}.bin"), pts, rem)
        mod.write_label_file(str(tmp_path / f"{name}.label"), lbl)
        mod.write_poses(str(tmp_path / f"{name}.txt"), sj.poses,
                        sj.calibration)
    for ext in ("bin", "label", "txt"):
        assert (tmp_path / f"j.{ext}").read_bytes() \
            == (tmp_path / f"t.{ext}").read_bytes()
    for x, y in zip(JK.read_scan_file(str(tmp_path / "t.bin")),
                    TK.read_scan_file(str(tmp_path / "j.bin"))):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        JK.read_label_file(str(tmp_path / "t.label")),
        TK.read_label_file(str(tmp_path / "j.label")))


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("attrs", [True, False])
def test_ply_written_byte_for_byte(tmp_path, binary, attrs):
    rng = np.random.default_rng(11)
    verts = rng.normal(size=(50, 3))
    faces = rng.integers(0, 50, (80, 3))
    kw = dict(binary=binary)
    if attrs:
        kw.update(normals=rng.normal(size=(50, 3)),
                  colors=rng.integers(0, 256, (50, 3)))
    JPLY.write_ply(str(tmp_path / "j.ply"), verts, faces, **kw)
    TPLY.write_ply(str(tmp_path / "t.ply"), verts, faces, **kw)
    assert (tmp_path / "j.ply").read_bytes() \
        == (tmp_path / "t.ply").read_bytes()
    if binary:
        for x, y in zip(JPLY.read_ply(str(tmp_path / "t.ply")),
                        TPLY.read_ply(str(tmp_path / "j.ply"))):
            np.testing.assert_array_equal(x, y)


def test_stage_timer_in_order(capsys):
    outs = []
    for mod in (JRT, TRT):
        timer = mod.StageTimer()
        for name, items in (("load", 1), ("transfer", 3), ("load", 2)):
            with timer.span(name, items):
                pass
        rep = timer.report()
        assert list(rep) == ["load", "transfer"]
        assert [rep[k]["items"] for k in rep] == [3.0, 3.0]
        assert timer.rate("missing") == 0.0
        timer.print_reference_style()
        lines = capsys.readouterr().out.splitlines()
        outs.append([ln.split("]")[0] for ln in lines])
        mod.StageTimer(verbose=False).print_reference_style()
        assert capsys.readouterr().out == ""
    assert outs[0] == outs[1] == ["[load", "[transfer"]
    assert not hasattr(TRT, "setup_compile_cache")   # jax's, not the port's


def test_prefetcher_in_order_and_errors():
    def load(i):
        if i == 7:
            raise OSError("scan 7 unreadable")
        return i * i

    for mod in (JPF, TPF):
        with mod.Prefetcher(load, range(5), depth=2) as pf:
            assert list(pf) == [(i, i * i) for i in range(5)]
        got = []
        with pytest.raises(RuntimeError, match="index 7") as err:
            with mod.Prefetcher(load, [5, 6, 7, 8], depth=1) as pf:
                for item in pf:
                    got.append(item)
        assert got == [(5, 25), (6, 36)]
        assert isinstance(err.value.__cause__, OSError)
        pf = mod.Prefetcher(load, range(100), depth=2)
        assert next(pf) == (0, 0)
        pf.close()


def test_native_source_is_the_original():
    """The port's ``native/raytracer.cpp`` is the JAX package's byte for
    byte; the port keeps no prebuilt library beside it."""
    src = os.path.join(REPO, "lidar_transfer_tpu", "native", "raytracer.cpp")
    copy = os.path.join(PORT, "native", "raytracer.cpp")
    with open(src, "rb") as a, open(copy, "rb") as b:
        assert a.read() == b.read()
    assert not [n for n in os.listdir(os.path.join(PORT, "native"))
                if n.endswith(".so")]


@pytest.mark.parametrize("return_index", [False, True])
def test_dedupe_mesh_equal(return_index):
    """``ops/marching.dedupe_mesh`` of both packages on one soup with
    shared vertices (and vertices that differ below the rounding):
    vertices, faces and soup indices equal."""
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(60, 3)).astype(np.float32)
    tri = pool[rng.integers(0, 60, (200, 3))]
    tri[::7, 0] += np.float32(1e-7)
    a = JMA.dedupe_mesh(tri, return_index=return_index)
    b = TMA.dedupe_mesh(tri, return_index=return_index)
    assert len(a) == len(b) == (3 if return_index else 2)
    assert a[0].shape[0] < 100       # of 600 soup vertices
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
