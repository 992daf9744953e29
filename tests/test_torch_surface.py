"""The port's surface cells (``ops/surface``) and mesh extraction
(``ops/marching.extract_mesh``) against the JAX package (CPU).

``extract_surface_cells`` of ``lidar_transfer_tpu/ops/surface.py`` and of
the port run on the same numpy volumes, made from a seed (random tsdf,
labels and remissions, float32 and the compact bf16/int16/bf16 storage),
with the seam-aware candidates of catmesh's oracle engine (``seams``) and
the corner labels and remissions (``want_labels``, ``want_rems``), in
slabs of several widths: every output equal (exact; no arithmetic
differs). The per-category fields marched from the seam cells give the
triangles that the JAX package's marching gives each category's whole
field. ``extract_mesh`` of both packages on the same state: equal.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.ops import marching as JMa
from lidar_transfer_tpu.ops import surface as JS
from lidar_transfer_tpu.ops.tsdf import TSDFState as JState
from lidar_transfer_tpu.ops.tsdf import VolumeSpec as JSpec
from lidar_transfer_tpu_torch.ops import marching as TMa
from lidar_transfer_tpu_torch.ops import surface as TS
from lidar_transfer_tpu_torch.ops.tsdf import TSDFState, VolumeSpec
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


def _random_volume(seed=0, dims=(19, 23, 17), compact=False):
    """tsdf in [-1, 1] with a third of the voxels at +1 (outside), labels
    of 4 categories (0 = none), remissions in [0, 1)."""
    rng = np.random.default_rng(seed)
    tsdf = np.clip(rng.standard_normal(dims), -1, 1).astype(np.float32)
    tsdf[rng.random(dims) < 0.33] = 1.0
    labels = rng.integers(0, 4, dims).astype(np.int16 if compact
                                             else np.int32)
    rem = rng.random(dims).astype(np.float32)
    if compact:
        tsdf = tsdf.astype(ml_dtypes.bfloat16)
        rem = rem.astype(ml_dtypes.bfloat16)
    return tsdf, labels, rem


def _tensor(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _tri_keys(t):
    """Winding-independent triangle identity."""
    return np.sort(t.reshape(t.shape[0], 9).round(5), axis=1)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("x_chunk", [1, 6, 256])
@pytest.mark.parametrize("seams", [False, True])
def test_cells_match_jax(seams, x_chunk, compact):
    """Indices, corner values, labels and remissions equal to JAX's, in
    the volume's C order."""
    tsdf, labels, rem = _random_volume(compact=compact)
    kw = dict(seams=seams, want_labels=True, want_rems=True,
              x_chunk=x_chunk)
    j = JS.extract_surface_cells(jnp.asarray(tsdf), jnp.asarray(labels),
                                 jnp.asarray(rem), **kw)
    t = TS.extract_surface_cells(_tensor(tsdf), _tensor(labels),
                                 _tensor(rem), **kw)
    assert j.idx.shape[0] > 100
    for f in ("idx", "vals", "labels", "rems"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if seams:
        plain = TS.extract_surface_cells(_tensor(tsdf), x_chunk=x_chunk)
        assert plain.labels is None and plain.rems is None
        assert set(map(tuple, plain.idx.tolist())) < set(
            map(tuple, t.idx.tolist()))


def test_seam_cells_give_every_category_surface():
    """Each category's field (its voxels' tsdf, +1 elsewhere) marched from
    the seam-aware cells gives the triangles of the JAX package's
    marching of the whole field."""
    tsdf, labels, rem = _random_volume(seed=2)
    cs = TS.extract_surface_cells(_tensor(tsdf), _tensor(labels),
                                  seams=True, want_labels=True, x_chunk=6)
    for c in np.unique(labels[labels > 0]):
        field = np.where(labels == c, tsdf, np.float32(1.0))
        t_ref = JMa.marching_tetrahedra(field, 0.0)
        fv = np.where(cs.labels == c, cs.vals, np.float32(1.0))
        sub = (fv.min(1) < 0) & (fv.max(1) >= 0)
        t_dev = TMa.marching_tetrahedra_cells(cs.idx[sub], fv[sub], 0.0)
        assert t_ref.shape == t_dev.shape and t_ref.shape[0] > 50
        assert np.array_equal(_tri_keys(t_ref), _tri_keys(t_dev))


def test_empty_volume_and_missing_volumes():
    """No candidate: empty arrays of the requested fields; seams or labels
    without a label volume, or remissions without one, raise."""
    tsdf = torch.ones((9, 9, 9))
    lab = torch.zeros((9, 9, 9), dtype=torch.int32)
    cells = TS.extract_surface_cells(tsdf, lab, tsdf, want_labels=True,
                                     want_rems=True, seams=True, x_chunk=4)
    assert cells.idx.shape == (0, 3) and cells.vals.shape == (0, 8)
    assert cells.labels.shape == (0, 8) and cells.rems.shape == (0, 8)
    with pytest.raises(ValueError, match="label"):
        TS.extract_surface_cells(tsdf, seams=True)
    with pytest.raises(ValueError, match="rem"):
        TS.extract_surface_cells(tsdf, lab, want_rems=True)


def _sphere_state(compact=False):
    """A truncated sphere SDF with labels by octant and remission by
    height, as numpy (float32, or compact values held in float32)."""
    n = 24
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), 0)
    d = np.sqrt(((g - 11.5) ** 2).sum(0)) - 7.3
    tsdf = np.clip(d / 3.0, -1, 1).astype(np.float32)
    labels = (1 + (g[0] > 11) + 2 * (g[1] > 11)).astype(np.int32)
    rem = (g[2] / n).astype(np.float32)
    if compact:
        tsdf = tsdf.astype(ml_dtypes.bfloat16).astype(np.float32)
        rem = rem.astype(ml_dtypes.bfloat16).astype(np.float32)
    return tsdf, np.ones_like(tsdf), labels, rem


@pytest.mark.parametrize("compact", [False, True])
def test_extract_mesh_matches_jax(compact):
    """``extract_mesh`` on the same state (the port's as tensors, compact
    in its storage dtypes): vertices, faces, normals, labels and
    remissions equal to JAX's."""
    tsdf, w, labels, rem = _sphere_state(compact)
    j = JMa.extract_mesh(JState(tsdf, w, labels, rem),
                         JSpec((-1.0, 2.0, -3.0), 0.1, tsdf.shape))
    if compact:
        state = TSDFState(torch.from_numpy(tsdf).to(torch.bfloat16),
                          torch.from_numpy(w).to(torch.bfloat16),
                          torch.from_numpy(labels).to(torch.int16),
                          torch.from_numpy(rem).to(torch.bfloat16))
    else:
        state = TSDFState(*(torch.from_numpy(a)
                            for a in (tsdf, w, labels, rem)))
    t = TMa.extract_mesh(state, VolumeSpec((-1.0, 2.0, -3.0), 0.1,
                                           tsdf.shape))
    assert j[1].shape[0] > 500
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
