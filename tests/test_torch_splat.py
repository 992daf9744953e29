"""The port's band-splat image path against the JAX package (CPU).

``_band_samples_image`` and ``_target_assemble`` of
``lidar_transfer_tpu/ops/splat.py`` and of the port get the same candidate
arrays (one synthetic scan, projected once). Outputs agree up to float
ulps; integer images may differ only where an atan2/asin ulp moves a
candidate across a pixel boundary (at most 0.1 % of pixels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.datasets import kitti, synthetic
from lidar_transfer_tpu.ops import projection as JP
from lidar_transfer_tpu.ops import splat as JSp
from lidar_transfer_tpu_torch.ops import splat as TSp
from lidar_transfer_tpu_torch.ops import tsdf as TS
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


VOX = 0.25
ORIGIN = np.array([-16.0, -16.0, -4.0], np.float32)
ACTIVE = np.array([128.0, 120.0, 30.0], np.float32)


@pytest.fixture(scope="module")
def sources(mid_spec):
    """(range, points, valid, label, rem) flat arrays of one projected
    scan, in numpy."""
    pose = np.eye(4)
    pose[:3, 3] = [1.3, -0.4, 0.0]
    pts, rem, lbl = synthetic.simulate_scan(synthetic.Scene.default(),
                                            mid_spec, pose)
    p, r, l, m = kitti.pad_points(pts, rem, lbl,
                                  kitti.scan_capacity(pts.shape[0]))
    kw = dict(fov_up_deg=mid_spec.fov_up, fov_down_deg=mid_spec.fov_down)
    ri = JP.range_project(jnp.asarray(p), jnp.asarray(r), jnp.asarray(l),
                          jnp.asarray(m), H=mid_spec.H, W=mid_spec.W, **kw)
    back = JP.reverse_project(ri, preserve_float=True, **kw)
    return tuple(np.array(a) for a in (
        ri.range.reshape(-1), back, ri.mask.reshape(-1),
        ri.label.reshape(-1), jnp.maximum(ri.remission, 0.0).reshape(-1)))


def _band_both(sources):
    r, p, v, lf, rf = sources
    j = JSp._band_samples_image(
        jnp.asarray(lf), jnp.asarray(rf), jnp.asarray(r), jnp.asarray(p),
        jnp.asarray(v), jnp.asarray(ORIGIN), jnp.asarray(ACTIVE),
        dims=(128, 128, 32), voxel_size=VOX, samples_per_ray=8,
        trunc_margin=VOX * 5)
    t = TSp._band_samples_image(
        torch.from_numpy(lf), torch.from_numpy(rf), torch.from_numpy(r),
        torch.from_numpy(p), torch.from_numpy(v), torch.from_numpy(ORIGIN),
        torch.from_numpy(ACTIVE), voxel_size=VOX, samples_per_ray=8,
        trunc_margin=VOX * 5)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def test_band_samples_image_matches(sources):
    """One candidate per pixel: valid/label exact except ulp-flipped
    voxel-boundary steps (<= 0.1 %), positions/depths to 1e-5 m."""
    j, t = _band_both(sources)
    same = j[5] == t[5]
    assert same.mean() >= 1 - 1e-3
    assert j[5].sum() > 0.5 * sources[2].sum()
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(t[4], j[4])
    ok = same & j[5]
    close = np.isclose(t[1], j[1], atol=1e-5)
    assert (~close[ok]).mean() <= 1e-3           # a flipped first step k
    np.testing.assert_allclose(t[0][ok & close], j[0][ok & close],
                               atol=1e-5)
    np.testing.assert_allclose(t[2][ok & close], j[2][ok & close],
                               atol=1e-6)


@pytest.mark.parametrize("target", ["plain", "beams"])
def test_target_assemble_matches(sources, small_spec, target):
    """The target z-buffer + attribute fetch + zero crossing, fed the
    same (JAX-made) candidates: mask/label within 0.1 % of pixels, range,
    remission and endpoints to 1e-5 m where the winner agrees."""
    j_band, _ = _band_both(sources)
    pos, _, tsdf_v, lbl, rem, valid = j_band
    H, W = small_spec.H, small_spec.W
    ba = (np.deg2rad(np.linspace(small_spec.fov_down, small_spec.fov_up, H)
                     ).astype(np.float32) if target == "beams" else None)
    args = (pos, tsdf_v, lbl, rem, valid)
    kw = dict(H=H, W=W, beam_rows=ba is not None, trunc=VOX * 5)
    j = JSp._target_assemble(
        *(jnp.asarray(a) for a in args), jnp.float32(small_spec.fov_up),
        jnp.float32(small_spec.fov_down),
        None if ba is None else jnp.asarray(ba), **kw)
    t = TSp._target_assemble(
        *(torch.from_numpy(a) for a in args), small_spec.fov_up,
        small_spec.fov_down, None if ba is None else torch.from_numpy(ba),
        **kw)
    j = [np.asarray(a) for a in j]
    t = [a.numpy() for a in t]
    same = (j[4] == t[4]) & (j[1] == t[1])
    assert same.mean() >= 1 - 1e-3
    assert j[4].mean() > 0.3
    np.testing.assert_allclose(t[0][same], j[0][same], atol=1e-4)
    # Ground points of one beam lie at one range, so adjacent candidates
    # tie in depth to the last ulp, which XLA's and PyTorch's sqrt round
    # differently: such a tie may go to the neighbouring (equally near)
    # candidate. Endpoints and remission are compared where both
    # packages pick the same winner.
    win_kw = dict(H=H, W=W, fov_up_deg=small_spec.fov_up,
                  fov_down_deg=small_spec.fov_down, beam_rows=ba is not None)
    sp, si, first, _ = (np.asarray(a) for a in JP.project_winner_order(
        jnp.asarray(pos), jnp.asarray(valid), return_pixels=True,
        beam_angles=None if ba is None else jnp.asarray(ba), **win_kw))
    jwin = np.full(H * W, -1)
    jwin[sp[first]] = si[first]
    from lidar_transfer_tpu_torch.ops import projection as TP

    twin, _ = TP.project_winner_order(
        torch.from_numpy(pos), torch.from_numpy(valid),
        beam_angles=None if ba is None else torch.from_numpy(ba), **win_kw)
    won = same.reshape(-1) & (jwin == twin.numpy())
    assert won.mean() >= 0.95
    won = won.reshape(H, W)
    np.testing.assert_allclose(t[2][won], j[2][won], atol=1e-6)
    np.testing.assert_allclose(t[3][won], j[3][won], atol=1e-5)


def test_splat_synthesize_refuses_unported_paths(sources, mid_spec):
    """An unknown attrs raises ValueError; the upsampling chords (interp)
    run: a target with twice the source's rows over its fov fills every
    row and far more pixels than the band candidates alone, and equals
    the JAX splat_synthesize with the same interp on >= 99.9 % of
    pixels."""
    srcs = [tuple(torch.from_numpy(a) for a in sources)]
    spec = TS.VolumeSpec(tuple(ORIGIN.tolist()), VOX, (128, 128, 32))
    kw = dict(target_H=16, target_W=256, fov_up_deg=8.0,
              fov_down_deg=-22.0, vol_origin=ORIGIN)
    with pytest.raises(ValueError, match="attrs"):
        TSp.splat_synthesize(None, spec, srcs, attrs="Fold", **kw)
    rng, lbl, rem, ends, mask = TSp.splat_synthesize(None, spec, srcs, **kw)
    assert rng.shape == (16, 256) and ends.shape == (16, 256, 3)
    assert bool(mask.any()) and bool(torch.isfinite(ends).all())
    H, W = mid_spec.H, mid_spec.W
    up = dict(kw, target_H=2 * H, target_W=W, fov_up_deg=mid_spec.fov_up,
              fov_down_deg=mid_spec.fov_down)
    interp = (H, W, 1, 0, float(np.tan(np.radians(3.0))), 1)
    base = TSp.splat_synthesize(None, spec, srcs, **up)[4]
    t = TSp.splat_synthesize(None, spec, srcs, interp=interp, **up)
    assert t[4].float().mean() > 1.7 * base.float().mean()
    assert bool(t[4][2:-2].any(dim=1).all())
    jspec = JSp.VolumeSpec(tuple(ORIGIN.tolist()), VOX, (128, 128, 32))
    j = JSp.splat_synthesize(None, jspec,
                             [tuple(jnp.asarray(a) for a in sources)],
                             interp=interp, **up)
    agree = (np.asarray(j[4]) == t[4].numpy()) & (np.asarray(j[1])
                                                  == t[1].numpy())
    assert agree.mean() >= 1 - 1e-3
