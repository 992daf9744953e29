"""The port's native BVH raytracer (``lidar_transfer_tpu_torch/native``)
against the JAX package's (CPU).

Both build the same ``raytracer.cpp`` (byte for byte,
``tests/test_torch_selfcontained.py``) with the same g++ flags, so
``trace_mesh`` of both gives equal outputs on every ray (exact): random
soups, the scenes of ``tests/test_native.py`` and the empty mesh. The
port's library is built from the port's source into
``lidar_transfer_tpu_torch/_build/`` and nowhere else, and a build that
fails raises with the compiler's message instead of returning.
"""

import os

import numpy as np
import pytest

from lidar_transfer_tpu import native as JN
from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch import native as TN
from torch_suite import shared_cores, time_limit  # noqa: F401


def _soup(seed, n_tris=400, n_rays=1000):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, (n_tris, 3)).astype(np.float32)
    tris = centers[:, None, :] + rng.normal(
        0, 0.6, (n_tris, 3, 3)).astype(np.float32)
    verts = tris.reshape(-1, 3)
    faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    labels = rng.integers(1, 20, verts.shape[0]).astype(np.int32)
    rems = rng.uniform(0, 1, verts.shape[0]).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return dirs, verts, faces, labels, rems


def _assert_equal(a, b):
    for f in ("endpoints", "labels", "remissions", "range", "tri"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.hits == b.hits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_mesh_equals_jax_native(seed):
    """Random soups from a shared origin and from an offset one: every
    output of both libraries equal."""
    if not JN.available():
        pytest.skip("the JAX package's native raytracer does not build")
    args = _soup(seed)
    for origin in (np.zeros(3, np.float32),
                   np.array([0.3, -0.7, 0.2], np.float32)):
        t = TN.trace_mesh(args[0], origin, *args[1:])
        _assert_equal(t, JN.trace_mesh(args[0], origin, *args[1:]))
        assert 100 < t.hits < 1000


def test_scenes_of_the_native_tests():
    """One triangle (hit, away, parallel miss), the nearer of two parallel
    triangles listed second, and the empty mesh, as ``tests/
    test_native.py``: equal to the JAX library's."""
    if not JN.available():
        pytest.skip("the JAX package's native raytracer does not build")
    verts = np.array([[5.0, -1.0, -1.0], [5.0, 1.0, -1.0], [5.0, 0.0, 1.5]],
                     np.float32)
    scenes = [
        (np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0]], np.float32), verts,
         np.array([[0, 1, 2]], np.int32), np.array([7, 8, 9], np.int32),
         np.array([0.3, 0.6, 0.9], np.float32)),
        (np.array([[1.0, 0, 0]], np.float32),
         np.concatenate([verts + [4.0, 0, 0], verts - [2.0, 0, 0]]),
         np.array([[0, 1, 2], [3, 4, 5]], np.int32),
         np.array([1, 1, 1, 2, 2, 2], np.int32), np.zeros(6, np.float32)),
        (np.array([[1.0, 0, 0]], np.float32), np.zeros((0, 3), np.float32),
         np.zeros((0, 3), np.int32), np.zeros((0,), np.int32),
         np.zeros((0,), np.float32)),
    ]
    got = []
    for rays, *mesh in scenes:
        t = TN.trace_mesh(rays, np.zeros(3), *mesh)
        _assert_equal(t, JN.trace_mesh(rays, np.zeros(3), *mesh))
        got.append(t)
    assert got[0].tri.tolist() == [0, -1, -1] and got[0].labels[0] == 7
    assert got[1].tri.tolist() == [1] and got[1].labels[0] == 2
    assert got[2].hits == 0 and got[2].tri.tolist() == [-1]


def test_bad_inputs_raise():
    dirs, verts, faces, labels, rems = _soup(0, n_tris=4, n_rays=2)
    with pytest.raises(ValueError, match="face index"):
        TN.trace_mesh(dirs, np.zeros(3), verts, faces + 100, labels, rems)
    with pytest.raises(ValueError, match="length"):
        TN.trace_mesh(dirs, np.zeros(3), verts, faces, labels[:-1], rems)


def test_builds_from_its_own_source_into_the_build_dir():
    """The library is named after the port's ``raytracer.cpp`` and lives
    in ``lidar_transfer_tpu_torch/_build/``; it is not the JAX package's
    library."""
    assert TN.available()
    path = TN.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("_ltnative-") and path.suffix == ".so"
    assert TN.SRC.parent.name == "native"
    assert TN.SRC.parent.parent.name == "lidar_transfer_tpu_torch"
    assert os.path.realpath(TN._load()._name) == os.path.realpath(path)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """With no compiler on the PATH the build raises with the failure and
    leaves nothing behind: ``trace_mesh`` does not return, and
    ``available()`` says False."""
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(TN, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    dirs, verts, faces, labels, rems = _soup(0, n_tris=4, n_rays=2)
    with pytest.raises(RuntimeError, match="g\\+\\+ build"):
        TN.trace_mesh(dirs, np.zeros(3), verts, faces, labels, rems)
    assert not TN.available()
    assert list((tmp_path / "_build").iterdir()) == []
