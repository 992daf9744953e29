"""``lidar_transfer_tpu_torch/probes/bounds.py`` (pure Python) against
figures worked out by hand from the kernels' shapes: bytes a voxel or a
call, and the bound in ms at an H100 SXM's 3.35 TB/s, to the digits the
figures are stated in."""

import pytest

from lidar_transfer_tpu_torch.probes import bounds
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


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


def test_raymarch_counts_sectors_of_what_the_march_read():
    """Row B: 32 B for each distinct sector that the march's gathers
    touch, 12 B of ray and of each origin row and 25 B of outputs a ray;
    a sample's 20 float32 operations and a hit's 12 trilinear samples of
    40. The reference raymarch frame's counts (65,536 rays, one origin,
    9,165,518 samples, 38,515 hits; 397,418 occupancy, 1,685,450 tsdf,
    20,751 label and 20,751 remission sectors) -> 70,404,684 bytes,
    0.0210 ms."""
    b = bounds.raymarch(65536, 1, 9165518, 38515,
                        397418 + 1685450 + 20751 + 20751)
    assert b.bytes == 32 * 2124370 + 12 * 65537 + 25 * 65536 == 70404684
    assert b.by == "bytes"
    assert b.ms == pytest.approx(0.02102, abs=5e-6)
    assert bounds.raymarch(10, 10, 0, 0, 0).bytes == 490
    assert bounds.raymarch(10, 1, 0, 0, 0).bytes == 382
    assert bounds.raymarch(1, 1, 100, 0, 0).flops == 2000
    assert bounds.raymarch(1, 1, 0, 1, 0).flops == 480


@pytest.mark.parametrize("W", [32, 30])
def test_conv_flops_count_every_convolution(W):
    """``conv_flops`` of the tiny RangeNet, by hand: 2 x out x (in x kh x
    kw) for each convolution at its width (the input padded to a multiple
    of 4, the stride-2 stages at half and quarter width); the train step
    3x that at the bf16 rate."""
    import torch

    from lidar_transfer_tpu_torch.models import RangeNet, RangeNetConfig

    m = RangeNet(RangeNetConfig.tiny(num_classes=7))
    Wp = W + (-W) % 4
    H, B = 8, 2
    px = [B * H * Wp, B * H * Wp // 2, B * H * Wp // 4]
    layers = [  # (pixels, cout, cin * kh * kw)
        (px[0], 16, 5 * 9), (px[1], 32, 16 * 9),
        (px[1], 16, 32), (px[1], 32, 16 * 9),             # block 0
        (px[2], 64, 32 * 9),
        (px[2], 32, 64), (px[2], 64, 32 * 9),             # block 1
        (px[1], 32, 64 * 9), (px[0], 32, 64 * 9),         # decoder
        (px[0], 7, 48)]                                   # head
    want = sum(2 * p * co * k for p, co, k in layers)
    got = bounds.conv_flops(m, torch.zeros(B, H, W, 5))
    assert got == want
    b = bounds.train_step(got)
    assert b.flops == 3 * got and b.by == "operations"
    assert b.ms == pytest.approx(3 * got / 989e12 * 1e3)


@pytest.mark.parametrize("origin_rows", [1, 65536])
def test_mesh_raycast_counts_every_test(origin_rows):
    """Row C's dense design (``mesh_raycast_dense``, the parent's kernel):
    36 B a triangle, 12 B a ray and an origin row read, 8 B a ray written;
    46 float32 operations for each ray/triangle pair (the two cross
    products 9 each, four dots 5 each, 1/det, o - v0, the three products
    by 1/det and u + v), so the oracle frame's mesh is bound by its
    operations."""
    assert bounds.MT_FLOPS == 46
    R, T = 65536, 6_312_231
    b = bounds.mesh_raycast_dense(R, T, origin_rows)
    assert b.bytes == 36 * T + 12 * (R + origin_rows) + 8 * R
    assert b.flops == 46 * R * T
    assert b.by == "operations"
    assert b.ms == pytest.approx(284.02, abs=0.01)
    small = bounds.mesh_raycast_dense(2, 1, origin_rows=1)
    assert small.by == "bytes" and small.bytes == 36 + 12 * 3 + 16


def test_mesh_raycast_is_the_bytes_bound():
    """Row C, whatever the design, reads every triangle once (an unread one
    could be the nearest), the rays and origins, and writes t and the
    index: 228,551,048 bytes, 0.0682 ms at 3.35 TB/s on the oracle frame,
    and no operations; the build's stages each move their bytes once."""
    R, T = 65536, 6_312_231
    b = bounds.mesh_raycast(R, T, 1)
    assert (b.bytes, b.flops, b.by) == (228_551_048, 0, "bytes")
    assert b.ms == pytest.approx(0.0682, abs=5e-5)
    assert bounds.mesh_raycast(R, T, R).bytes == b.bytes + 12 * (R - 1)
    assert bounds.bvh_keys(T).bytes == 68 * T + 52
    assert bounds.bvh_sort(T).bytes == 24 * T
    assert bounds.bvh_hierarchy(T).bytes == 8 * T + 12 * (T - 1) + 4 * (
        2 * T - 1)
    assert bounds.bvh_refit(T).bytes == 28 * T + 4 * (2 * T - 1) + 72 * (
        T - 1) + 4
    assert bounds.bvh_reorder(T).bytes == 88 * T
    for f in (bounds.bvh_keys, bounds.bvh_sort, bounds.bvh_hierarchy,
              bounds.bvh_refit, bounds.bvh_reorder):
        assert f(T).by == "bytes" and 0 < f(T).ms < 1
