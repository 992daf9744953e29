"""The port's catmesh ``"oracle"`` engine against the JAX package (CPU).

``TransferEngine(adaption="catmesh", catmesh_engine="oracle")`` of
``lidar_transfer_tpu/pipeline/deform.py`` (``catmesh``) and of the port
transfer the same window of the shared synthetic dataset
(``synthetic_dataset``, ``small_spec``: 16x256, voxel 0.25 m, bounds
+-16/+-16/+-4 m, as ``tests/test_pipeline.py``), with the per-category
meshes marched from the whole volume on the host and from the seam-aware
surface cells, with clipped and with fixed bounds (the geometry table).
On the CPU the port casts with ``raycast_mesh_plain``.

Against the JAX engine's dense Möller–Trumbore branch (``native.available``
set to False, as ``tests/test_pipeline.py`` does): mask and label agree on
>= 99.9 % of pixels; range within 1e-4 m on >= 99 % of the pixels both hit.
The rest are rays that pass through a shared triangle edge (the synthetic
scene's planes and the ray grid line up), where whether MT's u >= 0 or
v >= 0 holds rides on the last bit, and XLA's FMA contraction and the IEEE
order decide it apart (``tests/test_torch_triangles.py``): 7 of 1,494
pixels on frame 2, the nearer surface hit by one and a farther one by the
other. Against the JAX engine's native BVH, within the seam budget that
JAX states (``deform.py:1562-1567``: about 0.7 % of hit pixels). The port's
own frame against its native copy's trace of the same mesh: mask on
>= 99.9 % of pixels, and where both pick the same triangle, range within
1e-5 m (the library is built as the JAX package builds it, and g++
contracts its products into FMAs), label and remission equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_transfer_tpu import native as JN
from lidar_transfer_tpu.config import TransferConfig
from lidar_transfer_tpu.datasets import KittiSequence
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu.pipeline import multiscan as JM
from lidar_transfer_tpu_torch import _build, config as TC, interop
from lidar_transfer_tpu_torch import native as TN
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.pipeline import multiscan as TM
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import narrow_spec, shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


CAP = 8192
BASE = dict(adaption="catmesh", number_of_scans=1, preserve_float=True,
            voxel_size=0.25,
            voxel_bounds=((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0)))
#: mask/label agreement; share of both-hit pixels whose range agrees
AGREE, RANGE_SHARE, RANGE_TOL = 0.999, 0.99, 1e-4
#: the JAX engine's own seam budget between its native and dense casters
SEAM = 0.007


def _engines(small_spec, extract="host", fixed=False, target=None, **kw):
    """Both packages' oracle engines from ``small_spec`` to ``target``
    (``small_spec`` itself by default)."""
    target = target or small_spec
    je = JD.TransferEngine(small_spec, target, TransferConfig(**BASE),
                           CAP, fixed_bounds=fixed, catmesh_engine="oracle",
                           **kw)
    te = TD.TransferEngine(TC.SensorSpec(**dataclasses.asdict(small_spec)),
                           TC.SensorSpec(**dataclasses.asdict(target)),
                           TC.TransferConfig(**BASE), fixed_bounds=fixed,
                           device="cpu", catmesh_engine="oracle", **kw)
    if extract == "cells":
        je._CELLS_EXTRACT_MIN_VOX = te._CELLS_EXTRACT_MIN_VOX = 0
    return je, te


def _window(synthetic_dataset, idx=2):
    seq = KittiSequence.open(synthetic_dataset)
    w = JM.load_window(seq, TransferConfig(**BASE), idx, CAP)
    return w, interop.window_from_numpy(w)


def _np(vs):
    """A virtual scan of either package as numpy arrays."""
    return {f: np.asarray(getattr(vs, f)) for f in
            ("range", "label", "remission", "points", "mask")}


@pytest.mark.parametrize("extract,fixed", [("host", False),
                                           ("cells", False),
                                           ("host", True)])
def test_oracle_matches_jax_dense(synthetic_dataset, small_spec,
                                  monkeypatch, extract, fixed):
    monkeypatch.setattr(JN, "available", lambda: False)
    je, te = _engines(small_spec, extract, fixed)
    w, tw = _window(synthetic_dataset)
    jv, jri = je.transfer(w)
    tv, tri = te.transfer(tw)
    assert tv.adaption == jv.adaption == "catmesh"
    j, t = _np(jv), _np(tv)
    # the source projection at the target's fov (sqrt ulps apart)
    np.testing.assert_allclose(tri.range.numpy(), np.asarray(jri.range),
                               atol=1e-5)
    agree = (j["mask"] == t["mask"]) & (j["label"] == t["label"])
    assert agree.mean() >= AGREE, agree.mean()
    both = j["mask"] & t["mask"]
    assert both.mean() > 0.3
    close = both & (np.abs(j["range"] - t["range"]) <= RANGE_TOL)
    assert close.sum() >= RANGE_SHARE * both.sum(), (close.sum(),
                                                     both.sum())
    np.testing.assert_allclose(t["points"][close], j["points"][close],
                               atol=1e-4)
    miss = ~t["mask"]
    assert (t["range"][miss] == 0).all() and (t["label"][miss] == 0).all()
    assert (t["remission"][miss] == 0).all()
    assert (t["points"][miss] == 0).all()
    # the frame's volume is kept, as the JAX branch keeps it
    assert te._fused and te._last_mesh is not None
    js, ts = je.fused_state(), te.fused_state()
    np.testing.assert_array_equal(ts.label.numpy(), np.asarray(js.label))
    np.testing.assert_allclose(ts.tsdf.numpy(), np.asarray(js.tsdf),
                               atol=1e-5)


def test_oracle_within_jax_native_seam_budget(synthetic_dataset, small_spec):
    """Against the JAX engine with its native BVH (its default where the
    library builds): within the seam budget JAX states for its own two
    casters."""
    if not JN.available():
        pytest.skip("the JAX package's native raytracer does not build")
    je, te = _engines(small_spec, "cells")
    w, tw = _window(synthetic_dataset)
    j, t = _np(je.transfer(w)[0]), _np(te.transfer(tw)[0])
    assert (j["mask"] == t["mask"]).mean() >= 1 - SEAM
    both = j["mask"] & t["mask"]
    assert (j["label"] == t["label"])[both].mean() >= 1 - SEAM


def test_oracle_frame_against_its_native_copy(synthetic_dataset,
                                              small_spec):
    """The port's frame against the port's native BVH tracing the frame's
    own mesh (``engine._last_mesh``) with the same rays: every hit and
    label attribute of a ray that both give the same triangle agrees
    (``mesh_hit_attributes`` against ``lt_trace``'s attributes)."""
    _, te = _engines(small_spec, "cells", fixed=True)
    _, tw = _window(synthetic_dataset, 4)
    tv, _ = te.transfer(tw)
    m = te._last_mesh
    assert m.faces.shape[0] > 1000 and m.faces.dtype == np.int32
    assert len(np.unique(m.labels)) > 2
    nat = TN.trace_mesh(te.rays.numpy(), np.zeros(3), m.verts, m.faces,
                        m.labels, m.rems)
    mask = tv.mask.numpy().reshape(-1)
    assert ((nat.tri >= 0) == mask).mean() >= AGREE
    from lidar_transfer_tpu_torch.ops.triangles import raycast_mesh
    hits = raycast_mesh(torch.zeros(3), te.rays,
                        torch.from_numpy(m.verts[m.faces]))
    assert torch.equal(hits.hit, tv.mask.reshape(-1))
    same = (nat.tri == hits.tri.numpy()) & mask
    assert same.sum() >= 0.98 * mask.sum()
    np.testing.assert_allclose(tv.range.numpy().reshape(-1)[same],
                               nat.range[same], atol=1e-5)
    np.testing.assert_array_equal(tv.label.numpy().reshape(-1)[same],
                                  nat.labels[same])
    np.testing.assert_array_equal(tv.remission.numpy().reshape(-1)[same],
                                  nat.remissions[same])


@pytest.mark.parametrize("entry", ["transfer_fast", "transfer_stream"])
def test_fast_paths_route_the_oracle_through_transfer(synthetic_dataset,
                                                      small_spec, narrow_spec,
                                                      entry):
    """``transfer_fast`` and ``transfer_stream`` send catmesh to the splat
    body only on its splat engine: the oracle's frames equal
    ``transfer``'s bit for bit, their volume is integrated in the frame,
    and the CPU launches no kernel. ``spans`` times every
    stage (``TransferEngine.spans``). The target is ``narrow_spec``: the
    routes are compared on a quarter of the rays, against the same mesh."""
    _, te = _engines(small_spec, target=narrow_spec)
    _, ref = _engines(small_spec, target=narrow_spec)
    assert not te._mm_family_fast
    windows = [_window(synthetic_dataset, i)[1] for i in (1, 2)]
    _build.reset_launch_counts()
    if entry == "transfer_fast":
        got = [te.transfer_fast(w) for w in windows]
    else:
        s = te.transfer_stream(TM.stack_windows(windows))
        got = [TD.VirtualScan(*(f[i] for f in s[:5]), s.adaption)
               for i in range(2)]
    assert not any(_build.launch_counts().values())
    for g, w in zip(got, windows):
        ref.spans = spans = {}
        want, _ = ref.catmesh(w)
        assert g.adaption == "catmesh"
        for f in ("range", "label", "remission", "points", "mask"):
            assert torch.equal(getattr(g, f), getattr(want, f)), f
    assert {"projection", "integrate", "volume", "dedupe", "upload",
            "raycast", "attributes"} <= set(spans)
    assert any(k.startswith("march[") for k in spans)
    assert all(v >= 0 for v in spans.values())
    state = te.fused_state()
    for a, b in zip(state, ref.fused_state()):
        assert torch.equal(a, b)
    splat = TD.TransferEngine(te.source, te.target, te.cfg, device="cpu")
    assert splat.catmesh_engine == "splat" and splat._mm_family_fast


def test_empty_mesh_gives_the_zero_scan(small_spec):
    """A window whose points are all invalid has no surface: the all-zero
    scan, as the JAX engine gives."""
    je, te = _engines(small_spec, fixed=True)
    n = 256
    w = JM.ScanWindow(
        points=np.zeros((1, n, 3), np.float32),
        remissions=np.zeros((1, n), np.float32),
        labels=np.zeros((1, n), np.int32),
        valid=np.zeros((1, n), bool),
        rel_pose=np.eye(4, dtype=np.float32)[None],
        primary_index=0)
    j = _np(je.transfer(w)[0])
    tv, _ = te.transfer(interop.window_from_numpy(w))
    assert te._last_mesh is None
    for f, a in _np(tv).items():
        assert not a.any(), f
        np.testing.assert_array_equal(a, j[f])
