"""The port's plain TSDF integrate against the JAX package (CPU).

Held against ``lidar_transfer_tpu/ops/tsdf.py::integrate`` (the XLA
version, the semantics the CUDA kernel implements) and against
``ops/tsdf_pallas.py::integrate_pallas`` in interpret mode, whose atan
polynomial and 14-bit remission make it a looser oracle. The prior state
crosses over with ``interop.state_from_numpy``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.ops import tsdf as JS
from lidar_transfer_tpu.ops.tsdf_pallas import integrate_pallas
from lidar_transfer_tpu_torch import interop
from lidar_transfer_tpu_torch.ops import tsdf as TS
from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


H, W = 16, 256
DIMS = (16, 128, 30)
FOV = dict(fov_up_deg=8.0, fov_down_deg=-22.0)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    depth = (rng.uniform(2.0, 14.0, (H, W))
             * (rng.random((H, W)) > 0.2)).astype(np.float32)
    label = rng.integers(0, 30, (H, W)).astype(np.int32)
    rem = rng.uniform(0, 1, (H, W)).astype(np.float32)
    prior = JS.TSDFState(
        tsdf=rng.uniform(-1, 1, DIMS).astype(np.float32),
        weight=rng.integers(0, 3, DIMS).astype(np.float32),
        label=rng.integers(0, 30, DIMS).astype(np.int32),
        rem=rng.uniform(0, 1, DIMS).astype(np.float32))
    return depth, label, rem, prior


def _spec():
    return JS.VolumeSpec(origin=(-10.0, -12.0, -3.0), voxel_size=0.3,
                         dims=DIMS)


def _port(spec):
    return TS.VolumeSpec(origin=spec.origin, voxel_size=spec.voxel_size,
                         dims=spec.dims)


def _run_both(inputs, reset, write_weight, **kw):
    depth, label, rem, prior = inputs
    spec = _spec()
    j = JS.integrate(JS.TSDFState(*(jnp.asarray(a) for a in prior)), spec,
                     jnp.asarray(depth), jnp.asarray(label),
                     jnp.asarray(rem), reset=reset,
                     write_weight=write_weight, **FOV, **kw)
    t = integrate_cuda(interop.state_from_numpy(prior), _port(spec),
                       torch.from_numpy(depth), torch.from_numpy(label),
                       torch.from_numpy(rem), reset=reset,
                       write_weight=write_weight, **FOV, **kw)
    return interop.to_numpy(j), interop.to_numpy(t)


@pytest.mark.parametrize("reset", [True, False])
@pytest.mark.parametrize("write_weight", [True, False])
def test_integrate_matches_xla(inputs, reset, write_weight):
    """Plain integrate == ops/tsdf.integrate: label and weight exact,
    tsdf and rem within 1e-5."""
    j, t = _run_both(inputs, reset, write_weight)
    np.testing.assert_array_equal(t.label, j.label)
    np.testing.assert_array_equal(t.weight, j.weight)
    np.testing.assert_allclose(t.tsdf, j.tsdf, atol=1e-5)
    np.testing.assert_allclose(t.rem, j.rem, atol=1e-5)
    if not write_weight:
        np.testing.assert_array_equal(t.weight, inputs[3].weight)


def test_integrate_crop_origin_and_slabs(inputs):
    """A shifted origin and an active crop match JAX; X-slab chunks and an
    x_offset slab give the unchunked result bit for bit."""
    kw = dict(origin=np.array([-9.5, -11.0, -2.5], np.float32),
              active_dims=np.array([12, 100, 25]))
    j, t = _run_both(inputs, False, True, **kw)
    np.testing.assert_array_equal(t.label, j.label)
    np.testing.assert_allclose(t.tsdf, j.tsdf, atol=1e-5)
    depth, label, rem, prior = inputs
    spec = _port(_spec())
    imgs = (torch.from_numpy(depth), torch.from_numpy(label),
            torch.from_numpy(rem))
    whole = TS.integrate(interop.state_from_numpy(prior), spec, *imgs,
                         **FOV, **kw)
    chunked = TS.integrate(interop.state_from_numpy(prior), spec, *imgs,
                           x_chunk=3, **FOV, **kw)
    slab = TS.VolumeSpec(spec.origin, spec.voxel_size, (5,) + DIMS[1:])
    part = TS.integrate(
        TS.TSDFState(*(a[6:11].clone() for a in
                       interop.state_from_numpy(prior))),
        slab, *imgs, x_offset=6, **FOV, **kw)
    for a, b, c in zip(whole, chunked, part):
        assert torch.equal(a, b)
        assert torch.equal(a[6:11], c)


@pytest.mark.parametrize("reset", [True, False])
def test_integrate_matches_pallas_interpret(inputs, reset):
    """Against integrate_pallas(interpret=True): its atan polynomial moves
    the FOV edge by ~1e-5 rad, so a thin band of voxels (<= 0.5 %) may
    differ in label; elsewhere tsdf within 1e-5 and rem within its 14-bit
    quantisation (1e-4)."""
    depth, label, rem, prior = inputs
    spec = _spec()
    state = JS.TSDFState(*(jnp.asarray(a) for a in prior))
    j = interop.to_numpy(integrate_pallas(
        state, spec, jnp.asarray(depth), jnp.asarray(label),
        jnp.asarray(rem), reset=reset, interpret=True, **FOV))
    t = interop.to_numpy(TS.integrate(
        interop.state_from_numpy(prior), _port(spec),
        torch.from_numpy(depth), torch.from_numpy(label),
        torch.from_numpy(rem), reset=reset, **FOV))
    agree = (t.label == j.label) & (t.weight == j.weight)
    assert agree.mean() >= 1 - 5e-3
    np.testing.assert_allclose(t.tsdf[agree], j.tsdf[agree], atol=1e-5)
    np.testing.assert_allclose(t.rem[agree], j.rem[agree], atol=1e-4)


def test_volume_spec_and_chunking():
    """VolumeSpec geometry and auto_x_chunk equal the JAX package's."""
    bounds = np.array([[-50, 50], [-50, 50], [-5, 5]], np.float64)
    j = JS.VolumeSpec.from_bounds(bounds, 0.05)
    t = TS.VolumeSpec.from_bounds(bounds, 0.05)
    assert (t.origin, t.dims, t.trunc_margin, t.num_voxels) == (
        j.origin, j.dims, j.trunc_margin, j.num_voxels)
    for dims in [(2048, 2048, 208), (128, 128, 32), (64, 4096, 512)]:
        assert TS.auto_x_chunk(dims) == JS.auto_x_chunk(dims)
    s = TS.VolumeSpec((0.0, 0.0, 0.0), 0.5, (2, 3, 4)).init_state()
    assert [a.dtype for a in s] == [torch.float32, torch.float32,
                                    torch.int32, torch.float32]
    assert float(s.tsdf.min()) == 1.0 and int(s.label.abs().max()) == 0


@pytest.mark.parametrize("S,h,w", [(1, 16, 256), (3, 16, 256), (2, 13, 40),
                                   (4, 128, 64)])
def test_pack_columns_is_a_transpose(S, h, w):
    """The kernel's column-major image record against a numpy transpose:
    ``out[u, s, 0/1/2, v]`` is depth, label bits, remission of pixel
    (v, u) of image s; contiguous float32; the labels come back exactly."""
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import pack_columns

    rng = np.random.default_rng(S * 1000 + h)
    depth = rng.uniform(0, 50, (S, h, w)).astype(np.float32)
    label = rng.integers(-5, 70000, (S, h, w)).astype(np.int32)
    rem = rng.uniform(0, 1, (S, h, w)).astype(np.float32)
    out = pack_columns(*(torch.from_numpy(a) for a in (depth, label, rem)))
    assert out.shape == (w, S, 3, h) and out.dtype == torch.float32
    assert out.is_contiguous()
    want = np.stack([depth, label.view(np.float32), rem], axis=1)
    want = want.transpose(3, 0, 1, 2)            # (S,3,H,W) -> (W,S,3,H)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  np.ascontiguousarray(want).view(np.int32))
    np.testing.assert_array_equal(
        out[:, :, 1].contiguous().view(torch.int32).numpy(),
        label.transpose(2, 0, 1))
    # non-contiguous inputs (one image of a stack) pack alike
    one = pack_columns(*(torch.from_numpy(a)[S - 1][None]
                         for a in (depth, label, rem)))
    assert torch.equal(one.view(torch.int32),
                       out[:, S - 1:S].contiguous().view(torch.int32))


def test_integrate_chain_matches_xla_sequence(inputs):
    """The port's chain (through the wrapper, CPU path) == the JAX
    ``ops/tsdf.integrate`` applied image by image, reset on the first:
    label and weight exact, tsdf and rem within 1e-5."""
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_chain_cuda

    depth, label, rem, prior = inputs
    rng = np.random.default_rng(17)
    depths = np.stack([depth, np.roll(depth, 3, axis=1),
                       (depth * rng.uniform(0.9, 1.1, depth.shape))
                       .astype(np.float32)])
    labels = np.stack([label, label, np.roll(label, 1, axis=0)])
    rems = np.stack([rem, rem[::-1].copy(), rem])
    spec = _spec()
    j = JS.TSDFState(*(jnp.asarray(a) for a in prior))
    for s in range(3):
        j = JS.integrate(j, spec, jnp.asarray(depths[s]),
                         jnp.asarray(labels[s]), jnp.asarray(rems[s]),
                         reset=s == 0, **FOV)
    t = integrate_chain_cuda(
        interop.state_from_numpy(prior), _port(spec),
        *(torch.from_numpy(a) for a in (depths, labels, rems)), **FOV)
    j, t = interop.to_numpy(j), interop.to_numpy(t)
    np.testing.assert_array_equal(t.label, j.label)
    np.testing.assert_array_equal(t.weight, j.weight)
    np.testing.assert_allclose(t.tsdf, j.tsdf, atol=1e-5)
    np.testing.assert_allclose(t.rem, j.rem, atol=1e-5)
    assert (t.tsdf < 1).sum() > 500
