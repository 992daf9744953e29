"""``lidar_transfer_tpu_torch/probes/bounds.py`` (pure Python) against
figures worked out by hand from the kernels' shapes: bytes a voxel or a
call, and the bound in ms at an H100 SXM's 3.35 TB/s, to the digits the
figures are stated in."""

import pytest

from lidar_transfer_tpu_torch.probes import bounds

BIG = (2048, 2048, 208)            # 872,415,232 voxels
SMALL = (1024, 1024, 256)


def test_rates_and_bound_ms():
    assert bounds.H100_TB_PER_S == 3.35
    assert bounds.bound_ms(3.35e12) == pytest.approx(1000.0)
    assert bounds.bound_ms(1e12, tb_per_s=1.0) == pytest.approx(1000.0)
    assert bounds.flops_ms(67e12) == pytest.approx(1000.0)
    b = bounds.bound(3.35e9, flops=67e9 * 2)
    assert b.by == "operations" and b.ms == pytest.approx(2.0)
    b = bounds.bound(3.35e9 * 3, flops=67e9 * 2)
    assert b.by == "bytes" and b.ms == pytest.approx(3.0)
    assert bounds.bound(0).ms == 0.0


@pytest.mark.parametrize("dims,kw,per_voxel,ms", [
    # row 1: single image, reset, weight not written
    (BIG, dict(compact=False, write_weight=False), 12, 3.13),
    (BIG, dict(compact=False, write_weight=False, table=True), 13, 3.39),
    (BIG, dict(compact=True, write_weight=False), 6, 1.56),
    (BIG, dict(compact=True, write_weight=False, table=True), 7, 1.82),
    (SMALL, dict(compact=True, write_weight=False, table=True), 7, 0.56),
    # row 1b: the chain, weight written, whatever S is
    (BIG, dict(compact=False, S=3), 16, 4.17),
    (BIG, dict(compact=False, S=3, table=True), 17, 4.43),
    (BIG, dict(compact=True, S=3), 8, 2.08),
    (BIG, dict(compact=True, S=3, table=True), 9, 2.34),
    (BIG, dict(compact=True, S=5, table=True), 9, 2.34),
    # carried, every voxel read and changed: the four arrays both ways
    (BIG, dict(compact=False, reset=False), 32, 8.33),
    (BIG, dict(compact=True, reset=False, table=True), 17, 4.43),
])
def test_integrate_bytes_and_bound(dims, kw, per_voxel, ms):
    nvox = dims[0] * dims[1] * dims[2]
    b = bounds.integrate(dims, **kw)
    assert b.bytes == per_voxel * nvox
    assert bounds.bound_ms(b.bytes) == pytest.approx(ms, abs=0.005)
    assert b.by == "bytes" and b.ms == bounds.bound_ms(b.bytes)
    # the images (12 B a pixel and image) are a few MB beside GBs
    with_images = bounds.integrate(dims, image_hw=(64, 2048), **kw)
    assert with_images.bytes - b.bytes == kw.get("S", 1) * 64 * 2048 * 12
    assert with_images.ms == pytest.approx(ms, abs=0.007)


def test_integrate_carried_counts_what_the_data_needs():
    nvox = BIG[0] * BIG[1] * BIG[2]
    act, chg = nvox // 2, nvox // 100
    b = bounds.integrate(BIG, compact=True, reset=False, table=True,
                         active_voxels=act, changed_voxels=chg)
    assert b.bytes == act * 8 + chg * 8 + nvox
    b = bounds.integrate(BIG, compact=False, reset=False,
                         write_weight=False, active_voxels=act,
                         changed_voxels=0)
    assert b.bytes == act * 16


@pytest.mark.parametrize("got,nbytes,ms", [
    # row 2: one int8 row a voxel
    (bounds.geometry(BIG), 872415232, 0.26),
    # row A: 8 B a point read, 4 B a pixel written: under a microsecond
    (bounds.zbuffer(139264, 64 * 2048), 8 * 139264 + 4 * 131072, 0.00049),
    # row 3: 8 B a point read, 260 x 260 int32 written
    (bounds.confusion(131072, 260), 8 * 131072 + 4 * 260 * 260, 0.0004),
    # rows 6 and 7: the written bytes
    (bounds.probe_write(SMALL, (2, 2, 2)), 6 * 2**28, 0.48),
    (bounds.probe_write(SMALL, (4,)), 4 * 2**28, 0.32),
    # rows 4 and 5: 6 B a voxel written, two (X, 64, Y) f32 columns read,
    # and the table's byte for row 4
    (bounds.probe_parts(SMALL, 64, 3), 6 * 2**28 + 2 * 2**26 * 4, 0.64),
    (bounds.probe_ablate(SMALL, 64), 7 * 2**28 + 2 * 2**26 * 4, 0.72),
])
def test_other_rows(got, nbytes, ms):
    assert got.bytes == nbytes
    assert bounds.bound_ms(got.bytes) == pytest.approx(ms, rel=0.02)
    assert got.by == "bytes"


def test_zbuffer_scratch_figure():
    """With the scratch's npix 64-bit words written and read once, a call
    at N = 139,264 and 64 x 2048 pixels moves about 3.7 MB."""
    with_scratch = bounds.zbuffer(139264, 64 * 2048, scratch=True)
    assert with_scratch.bytes == pytest.approx(3.7e6, rel=0.02)
    assert bounds.confusion(131072, 260).bytes == pytest.approx(1.3e6,
                                                                rel=0.02)
    assert with_scratch.ms < 0.0015        # about a microsecond: one launch
