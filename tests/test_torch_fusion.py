"""The port's S-scan chain, compact state and geometry table against the
JAX package (CPU).

Held against ``lidar_transfer_tpu/ops/tsdf.py::integrate`` (the XLA
version, the semantics the CUDA kernels implement): the chain against S
sequential integrates, the compact state against the JAX compact state and
against the JAX float32 chain rounded once. Held against
``ops/tsdf_pallas.py::integrate_pallas_chain`` and ``precompute_geometry``
in interpret mode, whose atan polynomial and 14-bit remission make them
looser oracles. States cross over with ``interop.state_from_numpy``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.ops import tsdf as JS
from lidar_transfer_tpu.ops.tsdf_pallas import (integrate_pallas_chain,
                                                precompute_geometry)
from lidar_transfer_tpu_torch import interop
from lidar_transfer_tpu_torch.ops import tsdf as TS
from lidar_transfer_tpu_torch.ops.tsdf_cuda import (integrate_chain_cuda,
                                                    integrate_cuda,
                                                    precompute_geometry_cuda)
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup

S, H, W = 3, 16, 256
DIMS = (16, 128, 32)
FOV = dict(fov_up_deg=8.0, fov_down_deg=-22.0)
SPEC = JS.VolumeSpec(origin=(-10.0, -12.0, -3.0), voxel_size=0.3, dims=DIMS)
PSPEC = TS.VolumeSpec(SPEC.origin, SPEC.voxel_size, SPEC.dims)


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


@pytest.fixture(scope="module")
def images():
    """(S,H,W) depth / label / rem stacks; labels from a few classes, so
    that both rules (same class, closer other class) fire."""
    rng = np.random.default_rng(11)
    depth = (rng.uniform(2.0, 14.0, (S, H, W))
             * (rng.random((S, H, W)) > 0.2)).astype(np.float32)
    label = rng.integers(0, 4, (S, H, W)).astype(np.int32)
    rem = rng.uniform(0, 1, (S, H, W)).astype(np.float32)
    return depth, label, rem


def _jax_sequential(images, state=None):
    """S sequential ``ops/tsdf.integrate`` calls, reset on the first."""
    state = state if state is not None else SPEC.init_state()
    for s in range(S):
        state = JS.integrate(state, SPEC, *(jnp.asarray(a[s])
                                            for a in images),
                             reset=s == 0, **FOV)
    return interop.to_numpy(state)


def _torch(images):
    return tuple(torch.from_numpy(a) for a in images)


def _bf16(x):
    """float32 -> bf16 values (round to nearest even), as float32."""
    return torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("write_weight", [True, False])
def test_chain_matches_sequential_xla(images, write_weight, table):
    """Plain integrate_chain (S=3) == 3 sequential XLA integrates: label
    and weight exact, tsdf and rem within 1e-5; the geometry table changes
    nothing; without write_weight the weight buffer is left untouched."""
    j = _jax_sequential(images)
    v_tab = (TS.precompute_geometry(PSPEC, FOV["fov_up_deg"],
                                    FOV["fov_down_deg"], H)
             if table else None)
    state = PSPEC.init_state()
    state.weight.fill_(7.0)
    t = interop.to_numpy(integrate_chain_cuda(
        state, PSPEC, *_torch(images), write_weight=write_weight,
        v_tab=v_tab, **FOV))
    np.testing.assert_array_equal(t.label, j.label)
    np.testing.assert_allclose(t.tsdf, j.tsdf, atol=1e-5)
    np.testing.assert_allclose(t.rem, j.rem, atol=1e-5)
    if write_weight:
        np.testing.assert_array_equal(t.weight, j.weight)
    else:
        assert (t.weight == 7.0).all()
    assert (t.tsdf < 1).sum() > 1000 and (j.weight > 1).sum() > 100


def test_chain_equals_sequential_port_integrates(images):
    """For a float32 state the chain equals S sequential port integrates
    bit for bit, in X-slabs too."""
    imgs = _torch(images)
    seq = PSPEC.init_state()
    for s in range(S):
        TS.integrate(seq, PSPEC, *(a[s] for a in imgs), reset=s == 0,
                     **FOV)
    chain = TS.integrate_chain(PSPEC.init_state(), PSPEC, *imgs,
                               x_chunk=5, **FOV)
    for a, b in zip(seq, chain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("reset", [True, False])
def test_table_integrate_equals_no_table(images, reset):
    """One integrate with the geometry table == without it, bit for bit
    (same asin expression), on a carried and on a reset state."""
    imgs = [a[0] for a in _torch(images)]
    v_tab = precompute_geometry_cuda(PSPEC, FOV["fov_up_deg"],
                                     FOV["fov_down_deg"], H, device="cpu")
    assert v_tab.dtype == torch.int8 and int(v_tab.max()) == H - 1
    prior = TS.integrate(PSPEC.init_state(), PSPEC,
                         *[a[1] for a in _torch(images)], **FOV)
    a = integrate_cuda(TS.TSDFState(*(t.clone() for t in prior)), PSPEC,
                       *imgs, reset=reset, **FOV)
    b = integrate_cuda(TS.TSDFState(*(t.clone() for t in prior)), PSPEC,
                       *imgs, reset=reset, v_tab=v_tab, **FOV)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("reset", [True, False])
def test_compact_integrate_matches_xla(images, reset):
    """A single integrate on a compact state == ops/tsdf.integrate on
    init_state_compact() (reset) or on a compact prior (carried): labels
    and weight exact, tsdf and rem within one bf16 ulp."""
    prior = SPEC.init_state_compact()
    if not reset:
        prior = JS.integrate(prior, SPEC, *(jnp.asarray(a[1])
                                            for a in images), **FOV)
    prior_np = JS.TSDFState(*(np.array(a) for a in prior))  # donated
    j = interop.to_numpy(JS.integrate(
        prior, SPEC, *(jnp.asarray(a[0]) for a in images), reset=reset,
        **FOV))
    t = interop.to_numpy(TS.integrate(
        interop.state_from_numpy(prior_np, compact=True), PSPEC,
        *(a[0] for a in _torch(images)), reset=reset, **FOV))
    assert t.label.dtype == np.int16
    np.testing.assert_array_equal(t.label, j.label)
    np.testing.assert_array_equal(t.weight, j.weight)
    for f in ("tsdf", "rem"):
        a, b = getattr(t, f), getattr(j, f)
        assert (np.abs(a - b) <= _bf16_ulp(b)).all(), f
    assert (t.tsdf < 1).sum() > 1000


def test_compact_chain_matches_f32_chain_rounded_once(images):
    """The compact chain == the JAX float32 chain (3 sequential
    integrates) cast once to bf16/int16: labels exact, weight exact,
    tsdf and rem within one bf16 ulp."""
    j = _jax_sequential(images)
    t = interop.to_numpy(TS.integrate_chain(
        PSPEC.init_state(compact=True), PSPEC, *_torch(images), **FOV))
    np.testing.assert_array_equal(t.label, j.label.astype(np.int16))
    np.testing.assert_array_equal(t.weight, _bf16(j.weight))
    for f in ("tsdf", "rem"):
        a, b = getattr(t, f), getattr(j, f)
        assert (np.abs(a - b) <= _bf16_ulp(b)).all(), f
    # rounded once, not after every scan: the port's own float32 chain,
    # cast once, is the compact chain exactly
    f = interop.to_numpy(TS.integrate_chain(
        PSPEC.init_state(), PSPEC, *_torch(images), **FOV))
    for name in ("tsdf", "weight", "rem"):
        np.testing.assert_array_equal(getattr(t, name),
                                      _bf16(getattr(f, name)))


@pytest.mark.parametrize("table", [False, True])
def test_chain_matches_pallas_interpret(images, table):
    """Against integrate_pallas_chain(interpret=True): its atan polynomial
    moves the FOV edge by ~1e-5 rad, so a thin band of voxels (<= 0.5 %)
    may differ; elsewhere tsdf within 1e-5 and rem within its 14-bit
    quantisation (1e-4). With the tables of both packages (each its own)
    the same holds."""
    geom = (precompute_geometry(SPEC, FOV["fov_up_deg"],
                                FOV["fov_down_deg"], H, interpret=True)
            if table else None)
    v_tab = (TS.precompute_geometry(PSPEC, FOV["fov_up_deg"],
                                    FOV["fov_down_deg"], H)
             if table else None)
    j = interop.to_numpy(integrate_pallas_chain(
        SPEC.init_state(), SPEC, *(jnp.asarray(a) for a in images),
        geom=geom, interpret=True, **FOV))
    t = interop.to_numpy(TS.integrate_chain(
        PSPEC.init_state(), PSPEC, *_torch(images), v_tab=v_tab, **FOV))
    agree = (t.label == j.label) & (t.weight == j.weight)
    assert agree.mean() >= 1 - 5e-3
    np.testing.assert_allclose(t.tsdf[agree], j.tsdf[agree], atol=1e-5)
    np.testing.assert_allclose(t.rem[agree], j.rem[agree], atol=1e-4)


@pytest.mark.parametrize("origin", [None, (-9.5, -11.0, -2.5)])
def test_geometry_table_matches_pallas_interpret(origin):
    """The plain table against precompute_geometry(interpret=True): rows
    agree on >= 1 - 5e-3 of voxels (the Pallas atan polynomial), and
    differ by at most one row elsewhere."""
    jo = None if origin is None else jnp.asarray(origin, jnp.float32)
    j = np.asarray(precompute_geometry(SPEC, FOV["fov_up_deg"],
                                       FOV["fov_down_deg"], H, origin=jo,
                                       interpret=True))
    t = TS.precompute_geometry(PSPEC, FOV["fov_up_deg"],
                               FOV["fov_down_deg"], H, origin=origin,
                               x_chunk=4).numpy()
    assert t.dtype == np.int8 and t.shape == DIMS
    assert (t == j).mean() >= 1 - 5e-3
    both = (t >= 0) & (j >= 0)
    assert np.abs(t[both].astype(int) - j[both]).max() <= 1
    assert 0.2 < (t >= 0).mean() < 0.9


def test_interop_compact_round_trip(images):
    """A JAX compact state crosses to the port and back unchanged: bf16
    values as float32, int16 labels; init_state_compact has the dtypes of
    the JAX package's."""
    j = JS.integrate(SPEC.init_state_compact(), SPEC,
                     *(jnp.asarray(a[0]) for a in images), reset=True,
                     **FOV)
    jn = interop.to_numpy(j)
    t = interop.state_from_numpy(jn, compact=True)
    assert tuple(a.dtype for a in t) == TS.COMPACT_DTYPES
    assert tuple(a.dtype for a in PSPEC.init_state_compact()) == \
        TS.COMPACT_DTYPES
    back = interop.to_numpy(t)
    for f in TS.TSDFState._fields:
        a, b = getattr(back, f), np.asarray(getattr(j, f)).astype(
            getattr(back, f).dtype)
        np.testing.assert_array_equal(a, b)
    assert back.tsdf.dtype == np.float32 and back.label.dtype == np.int16
    with pytest.raises(ValueError, match="dtypes"):
        TS.integrate(TS.TSDFState(t.tsdf.float(), *t[1:]), PSPEC,
                     *(a[0] for a in _torch(images)), **FOV)


# --- the decision rule of the geometry kernel's fast mode ------------------

HDL64_FOV, HDL32_FOV = (3.0, -25.0), (10.67, -30.67)
#: the last origin puts voxel (8, 64, 16) on the sensor itself: a column
#: with px = py = 0, and in it a voxel with depth 0
RULE_ORIGINS = [None, (-9.5, -11.0, -2.5), (-2.4, -19.2, -4.8)]


def _perturbation(kind, fov, H, spec=PSPEC):
    """Errors of the estimate as large as the kernel states: -> (relative,
    absolute), the latter estimate_walk_err at the least distance of two
    edges."""
    if kind == "none":
        return None, None
    dims = spec.dims
    prm = TS.integrate_params(spec, *fov)
    hi = TS.geometry_edges(prm, H, dims[2])[1]
    step = TS.estimate_walk_err(prm, dims[2], TS.edge_min_gap(hi))
    if kind == "random":
        rng = np.random.default_rng(5)
        u, v = (torch.from_numpy(rng.uniform(-1.0, 1.0, dims)
                                 .astype(np.float32)) for _ in range(2))
        return u * TS.ESTIMATE_REL_ERR, v * step
    sign = {"plus": 1.0, "minus": -1.0}[kind]
    return (torch.full(dims, sign * TS.ESTIMATE_REL_ERR),
            torch.full(dims, sign * step))


@pytest.mark.parametrize("perturb", ["none", "plus", "minus", "random"])
@pytest.mark.parametrize("origin", RULE_ORIGINS)
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("fov", [HDL64_FOV, HDL32_FOV])
def test_geometry_rule_equals_exact_expression(fov, H, origin, perturb):
    """The fast geometry kernel's rule (estimate of tan(pitch) against the
    edges, the exact expression inside the guard bands), emulated in plain
    PyTorch, gives precompute_geometry's table at every voxel, also with
    the estimate off by the stated errors either way (4 ulp of itself and
    the step error); under 1 % of the voxels lie in a band."""
    ref = TS.precompute_geometry(PSPEC, *fov, H, origin=origin)
    rel, shift = _perturbation(perturb, fov, H)
    table, exact = TS.geometry_by_rule(PSPEC, *fov, H, origin=origin,
                                       perturb=rel, shift=shift, exact=ref)
    assert table.dtype == torch.int8 and torch.equal(table, ref)
    share = float(exact.float().mean())
    assert share < 0.01, share
    # the estimate decided voxels of several rows and of both sides of
    # the FOV
    decided = ref[~exact]
    assert (decided >= 0).any() and (decided < 0).any()
    assert decided.unique().numel() > 5
    if origin == RULE_ORIGINS[2]:
        prm = TS.integrate_params(PSPEC, *fov, origin=origin)
        assert prm.ox + np.float32(8) * np.float32(prm.vox) == 0.0
        assert exact[8, 64].all()      # the column through the sensor


@pytest.mark.parametrize("H", [1, 16, 64, 128])
@pytest.mark.parametrize("fov", [HDL64_FOV, HDL32_FOV, (60.0, -60.0)])
def test_geometry_edges_layout(fov, H):
    """geometry_edges: rising, disjoint safe ranges, the outer intervals
    never safe, rows falling from H - 1 to 0 between the FOV limits, and
    room for the kernel's padding in its 152 entries."""
    prm = TS.integrate_params(PSPEC, *fov)
    lo, hi, val = TS.geometry_edges(prm, H, DIMS[2])
    n = len(lo)
    assert lo.dtype == hi.dtype == np.float32 and val.dtype == np.int8
    assert len(hi) == len(val) == n <= H - 1 + 2 + 2 + 1
    assert n + TS.EDGE_PADDING + 2 <= 152
    assert np.isinf(lo[0]) and np.isinf(lo[-1]) and np.isinf(hi[-1])
    assert (lo[1:-1] < hi[1:-1]).all()            # every inner range open
    assert (hi[:-2] < lo[1:-1]).all()             # a band between two
    assert val[0] == val[-1] == -1
    rows = val[val >= 0]
    assert rows[0] == H - 1 and rows[-1] == 0
    assert (np.diff(rows.astype(int)) == -1).all()


def test_geometry_wrapper_modes_on_cpu():
    """On the CPU both modes of precompute_geometry_cuda are the plain
    version; a CUDA-only argument of the wrong kind raises on the card
    only."""
    a = precompute_geometry_cuda(PSPEC, *HDL64_FOV, H, device="cpu")
    b = precompute_geometry_cuda(PSPEC, *HDL64_FOV, H, device="cpu",
                                 exact=True)
    assert torch.equal(a, b)
    assert torch.equal(a, TS.precompute_geometry(PSPEC, *HDL64_FOV, H))
    with pytest.raises(ValueError, match="device"):
        precompute_geometry_cuda(PSPEC, *HDL64_FOV, H, device="meta")


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("fov", [HDL64_FOV, HDL32_FOV])
def test_geometry_rule_at_the_reference_voxel(fov, H, sign):
    """The same at the reference voxel size, 0.05 m, 8 to 9.6 m from the
    sensor, where 1.7 M voxels put several on every edge: without the
    guard band the estimate, off by the stated error, misplaces voxels in
    each of these cases."""
    spec = TS.VolumeSpec((8.0, -6.4, -5.0), 0.05, (32, 256, 208))
    ref = TS.precompute_geometry(spec, *fov, H)
    rel, shift = _perturbation("plus" if sign > 0 else "minus", fov, H,
                               spec)
    table, exact = TS.geometry_by_rule(spec, *fov, H, perturb=rel,
                                       shift=shift, exact=ref)
    assert torch.equal(table, ref)
    assert 0 < float(exact.float().mean()) < 0.01


@pytest.mark.parametrize("perturb", ["none", "plus", "minus"])
@pytest.mark.parametrize("x0,oz", [(16.0, -5.0), (16.0, -9.0),
                                   (70.0, -33.0)])
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("fov", [HDL64_FOV, HDL32_FOV])
def test_geometry_rule_with_the_lane_walk(fov, H, x0, oz, perturb):
    """The rule with the estimates taken as a lane of the kernel takes them
    away from the sensor, t0 + j * dt from the first of 16 voxels: every
    column here lies that far off (16 m and more). The exact pz of a voxel
    is rounded twice, at most 2 ulp of the volume's largest height off the
    lane's line; the band has a term for that, which grows with |oz|, and
    for the sum's own rounding (the relative perturbation)."""
    spec = TS.VolumeSpec((x0, -3.2, oz), 0.05, (32, 128, 208))
    prm = TS.integrate_params(spec, *fov)
    hi = TS.geometry_edges(prm, H, 208)[1]
    assert 0.05 / 16.0 < TS.edge_min_gap(hi)     # every column walks so
    ref = TS.precompute_geometry(spec, *fov, H)
    rel, _ = _perturbation(perturb, fov, H, spec)
    table, exact = TS.geometry_by_rule(spec, *fov, H, perturb=rel,
                                       walk=True, exact=ref)
    assert torch.equal(table, ref)
    assert 0 < float(exact.float().mean()) < 0.01


@pytest.mark.parametrize("origin", RULE_ORIGINS[:2])
def test_geometry_rule_matches_pallas_interpret(origin):
    """The rule's table against the JAX precompute_geometry in interpret
    mode, as test_geometry_table_matches_pallas_interpret holds the plain
    table: rows agree on >= 1 - 5e-3 of voxels (the Pallas atan
    polynomial) and differ by at most one row elsewhere."""
    jo = None if origin is None else jnp.asarray(origin, jnp.float32)
    j = np.asarray(precompute_geometry(SPEC, FOV["fov_up_deg"],
                                       FOV["fov_down_deg"], H, origin=jo,
                                       interpret=True))
    t, exact = TS.geometry_by_rule(PSPEC, FOV["fov_up_deg"],
                                   FOV["fov_down_deg"], H, origin=origin)
    t = t.numpy()
    assert float(exact.float().mean()) < 0.01
    assert (t == j).mean() >= 1 - 5e-3
    both = (t >= 0) & (j >= 0)
    assert np.abs(t[both].astype(int) - j[both]).max() <= 1
