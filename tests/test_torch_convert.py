"""The port's dataset converters (``lidar_transfer_tpu_torch/datasets/
convert.py``, ``lt-convert-torch``) against the JAX package's on the inputs
``tests/test_convert.py`` builds.

The port's module is the original after ``lidar_transfer_tpu.`` ->
``lidar_transfer_tpu_torch.`` (its docstring apart), so the trees the two
write are equal byte for byte and no tolerance applies.
"""

import os
import struct

import numpy as np
import pytest

from lidar_transfer_tpu.datasets import convert as JCV
from lidar_transfer_tpu_torch.datasets import convert as TCV
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pack_nclt(points_xyz, intensities):
    """Encode points the NCLT way (``tests/test_convert.py``'s encoder)."""
    out = bytearray()
    for (x, y, z), i in zip(points_xyz, intensities):
        xs = int(round((x - (-100.0)) / 0.005))
        ys = int(round((y - (-100.0)) / 0.005))
        zs = int(round((-z - (-100.0)) / 0.005))   # stored z is pre-flip
        out += struct.pack("<HHHBB", xs, ys, zs, int(i), 3)
    return bytes(out)


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _body(rel, substitute):
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    body = src[src.index('"""', 3) + 3:]
    return (body.replace("lidar_transfer_tpu.", "lidar_transfer_tpu_torch.")
            if substitute else body)


def test_source_is_the_original_after_import_substitution():
    """Everything after the docstring equals the original's text with the
    JAX package's imports read as the port's; the port's copy imports its
    own ``datasets/kitti``."""
    port = _body("lidar_transfer_tpu_torch/datasets/convert.py", False)
    assert port == _body("lidar_transfer_tpu/datasets/convert.py", True)
    assert port.count("from lidar_transfer_tpu_torch.datasets.kitti") == 3


@pytest.fixture
def nclt_src(tmp_path):
    src = tmp_path / "nclt_src"
    src.mkdir()
    pts = np.array([[5.0, 1.0, -1.5], [-3.25, 0.5, 2.0]] * 5, np.float64)
    (src / "0001.bin").write_bytes(_pack_nclt(pts, np.arange(10)))
    (src / "0002.bin").write_bytes(_pack_nclt(pts * 0.5, np.arange(10))
                                   + b"\x01\x02\x03")
    return str(src)


def test_nclt_tree_byte_for_byte(nclt_src, tmp_path):
    """``convert_nclt`` (``convert.py:81``) of both packages: the same
    count and the same KITTI tree (scans, poses, calib)."""
    n_j = JCV.convert_nclt(nclt_src, str(tmp_path / "j"), "77", verbose=False)
    n_t = TCV.convert_nclt(nclt_src, str(tmp_path / "t"), "77", verbose=False)
    assert n_j == n_t == 2
    tj, tt = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert len(tj) == 4 and tj == tt
    with open(os.path.join(nclt_src, "0002.bin"), "rb") as f:
        raw = f.read()
    for a, b in zip(JCV.nclt_decode(raw), TCV.nclt_decode(raw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_ford_tree_byte_for_byte(tmp_path):
    """``convert_ford`` (``convert.py:134``) of both packages on .mat scans
    with a corrupt one in between: the same count and tree."""
    scipy_io = pytest.importorskip("scipy.io")
    src = tmp_path / "ford"
    (src / "SCANS").mkdir(parents=True)
    xyz = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.5], [3.0, -1.0, 1.5]]).T
    for i, heading in enumerate([0.0, 0.1, 0.35]):
        scipy_io.savemat(str(src / "SCANS" / f"Scan{i:04d}.mat"), {"SCAN": {
            "XYZ": xyz * (1 + i),
            "X_wv": np.array([[i * 1.0], [0.5 * i], [0.0], [0.01 * i],
                              [0.0], [heading]])}})
    (src / "SCANS" / "Scan0001b.mat").write_bytes(b"not a mat file")
    n_j = JCV.convert_ford(str(src), str(tmp_path / "j"), "10",
                           verbose=False)
    n_t = TCV.convert_ford(str(src), str(tmp_path / "t"), "10",
                           verbose=False)
    assert n_j == n_t == 3
    tj, tt = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert len(tj) == 5 and tj == tt
    np.testing.assert_array_equal(
        JCV.ford_pose([1, 2, 3, 0.1, -0.2, 0.3]),
        TCV.ford_pose([1, 2, 3, 0.1, -0.2, 0.3]))


def test_nuscenes_gate_raises_the_same_error():
    """Without the nuScenes devkit both raise the same error."""
    errs = []
    for mod in (JCV, TCV):
        with pytest.raises((ImportError, ValueError)) as err:
            mod.convert_nuscenes("/nonexistent", "/nonexistent/out")
        errs.append((type(err.value), str(err.value)))
    assert errs[0] == errs[1]


def test_cli_nclt_byte_for_byte(nclt_src, tmp_path, capsys):
    """``lt-convert-torch nclt`` writes the tree ``lt-convert nclt``
    writes, and prints the same count line."""
    outs = []
    for mod, name in ((JCV, "j"), (TCV, "t")):
        assert mod.main(["nclt", nclt_src, str(tmp_path / name),
                         "--scene", "00"]) == 0
        outs.append(capsys.readouterr().out.splitlines()[-1])
    assert outs[0] == outs[1] == "2 scans converted."
    assert _tree(tmp_path / "j") == _tree(tmp_path / "t")
    with pytest.raises(SystemExit):
        TCV.main(["ford", nclt_src, str(tmp_path / "x")])
