"""The least time the card could take for one call of each kernel.

Pure Python: for each kernel entry, the bytes one call must move as a
function of its shapes and modes (each input read once, each output
written once, whatever the kernel reads again) and the floating-point
operations it must do, and from them the bound: the larger of bytes over
the card's memory rate and operations over its float32 rate. The rates are
the published ones of an H100 SXM at its full power limit of 700 W:
3.35 TB/s of device memory, 67 TFLOP/s in float32 outside the tensor cores.
Where the work depends on the data (the integrate's carried mode) the
caller passes the counts its data gives.
"""

from __future__ import annotations

from typing import NamedTuple

#: published device-memory rate of an H100 SXM, TB/s
H100_TB_PER_S = 3.35
#: published float32 rate of an H100 SXM outside the tensor cores, TFLOP/s
H100_F32_TFLOPS = 67.0
#: published dense bf16 rate of an H100 SXM on its tensor cores, TFLOP/s
H100_BF16_TFLOPS = 989.0


class Bound(NamedTuple):
    """bytes and float32 operations of one call, the bound in ms and which
    of the two sets it ("bytes" or "operations")."""

    bytes: int
    flops: int
    ms: float
    by: str


def bound_ms(nbytes: float, tb_per_s: float = H100_TB_PER_S) -> float:
    """ms to move ``nbytes`` at ``tb_per_s`` TB/s."""
    return nbytes / (tb_per_s * 1e12) * 1e3


def flops_ms(flops: float, tflops: float = H100_F32_TFLOPS) -> float:
    """ms for ``flops`` float32 operations at ``tflops`` TFLOP/s."""
    return flops / (tflops * 1e12) * 1e3


def bound(nbytes: int, flops: int = 0) -> Bound:
    b, f = bound_ms(nbytes), flops_ms(flops)
    return Bound(int(nbytes), int(flops), max(b, f),
                 "bytes" if b >= f else "operations")


def integrate_flops(nvox: int, S: int = 1, table: bool = False) -> int:
    """Float32 operations of the integrate: a voxel's height, squared
    range and sqrt (6), without the table its pitch and row (a division,
    an asin, the clamps and the row: 12; a division, a square root and an
    asin each count as one), and for each image the difference, the
    comparisons and the two averages with their divisions (12)."""
    return nvox * (6 + (0 if table else 12) + 12 * S)


def integrate(dims, *, compact: bool, reset: bool = True,
              write_weight: bool = True, table: bool = False, S: int = 1,
              image_hw=None, active_voxels: int | None = None,
              changed_voxels: int | None = None) -> Bound:
    """Rows 1 and 1b at volume ``dims``: the state's arrays written once
    (tsdf, label, remission, and the weight where it is written; 4 B a
    voxel each, 2 B compact), the four read once when the state is
    carried, and the table's byte a voxel. ``image_hw`` adds the S images
    (depth, label, remission, 12 B a pixel). In carried mode
    (``reset=False``) only ``active_voxels`` (in the crop and the FOV) are
    read and only ``changed_voxels`` written; both default to every
    voxel."""
    nvox = dims[0] * dims[1] * dims[2]
    width = 2 if compact else 4
    arrays = 4 if write_weight else 3
    if reset:
        nbytes = nvox * arrays * width
    else:
        act = nvox if active_voxels is None else active_voxels
        chg = nvox if changed_voxels is None else changed_voxels
        nbytes = act * 4 * width + chg * arrays * width
    if table:
        nbytes += nvox
    if image_hw is not None:
        nbytes += S * image_hw[0] * image_hw[1] * 12
    return bound(nbytes, integrate_flops(nvox, S, table))


def geometry(dims) -> Bound:
    """Row 2: one int8 row a voxel written; a voxel's range, sqrt, division,
    asin and row (18 operations, as :func:`integrate_flops` counts them;
    the kernel's fast mode does without most of them, the function's
    definition does not)."""
    nvox = dims[0] * dims[1] * dims[2]
    return bound(nvox, nvox * 18)


def zbuffer(n: int, npix: int, scratch: bool = False) -> Bound:
    """Row A: N pixel indices and N keys read (4 B each), npix winners
    written (4 B). ``scratch`` adds the npix 64-bit words of the kernel's
    scratch, written once and read once, which the function itself does
    not need."""
    nbytes = 8 * n + 4 * npix + (16 * npix if scratch else 0)
    return bound(nbytes)


def confusion(n: int, C: int) -> Bound:
    """Row 3: N predictions and N targets read (4 B each), C x C int32
    counts written."""
    return bound(8 * n + 4 * C * C)


def group_norm(n: int) -> Bound:
    """Row D: ``n`` bf16 elements read once and written once, 4 B an
    element (the statistics' second read is the kernel's own); 8
    operations an element (the statistics' difference, square and two
    sums; the apply's multiply-add, comparison and slope)."""
    return bound(4 * n, 8 * n)


def ptv3_serialize(n: int) -> Bound:
    """Row F: ``n`` points' int32 cells and cloud ids read (16 B), their
    four int64 codes written (32 B); integer work only."""
    return bound(48 * n, 0)


def ptv3_neighbor_map(n: int, k: int) -> Bound:
    """Row E: ``n`` cells and cloud ids read (16 B each), the (n, k^3)
    int32 map written; the table's own traffic is the kernel's choice."""
    return bound(n * (16 + 4 * k ** 3), 0)


def probe_parts(dims, cw: int, n_out: int = 3) -> Bound:
    """Row 5: two (X, CW, Y) float32 column arrays read, ``n_out`` compact
    (2 B) outputs a voxel written; the body's arithmetic as the
    integrate's single image without the table."""
    X, Y, Z = dims
    return bound(2 * X * cw * Y * 4 + X * Y * Z * 2 * n_out,
                 integrate_flops(X * Y * Z, 1, False))


def probe_ablate(dims, cw: int) -> Bound:
    """Row 4: two (X, CW, Y) float32 column arrays and the int8 table read,
    three compact outputs written."""
    X, Y, Z = dims
    return bound(2 * X * cw * Y * 4 + X * Y * Z * 7,
                 integrate_flops(X * Y * Z, 1, True))


def probe_write(dims, widths) -> Bound:
    """Rows 6 and 7: one output of each byte width in ``widths`` written."""
    return bound(dims[0] * dims[1] * dims[2] * sum(widths))


#: the granularity of a gather from device memory (bytes)
SECTOR = 32
#: trilinear samples of a hit's refinement (the bracket's two ends and 10
#: bisection steps)
REFINE_SAMPLES = 12


def raymarch(rays: int, origin_rows: int, samples: int, hits: int,
             sectors: int) -> Bound:
    """Row B for the counts one march's data needs (``ops/raycast.
    raycast_plain``'s ``stats``): the ``sectors`` distinct 32-byte sectors
    its gathers touch (occupancy bytes of the samples inside the box, tsdf
    words of the occupied ones and of each hit's refinement corners, the
    label and remission of each hit), each counted once however often the
    march reads it; the rays and the ``origin_rows`` origins (1 shared, or
    one a ray) read, 12 B each; the outputs (range, label, remission,
    endpoints, hit: 25 B a ray) written. A sample's float32 operations
    (its position, grid coordinate, test and step, 20) and a refinement's
    (12 samples of 40) count too; ``samples`` is every sample, the seed
    sample included."""
    nbytes = SECTOR * sectors + 12 * (rays + origin_rows) + 25 * rays
    return bound(nbytes, 20 * samples + 40 * REFINE_SAMPLES * hits)


def pack_occupancy(cells) -> Bound:
    """Row B's packing: the (cx, cy, cz) bool occupancy read (1 B a cell),
    its words of 4 x 4 x 2 cells written (4 B each)."""
    cx, cy, cz = cells
    words = -(-cx // 4) * -(-cy // 4) * -(-cz // 2)
    return bound(cx * cy * cz + 4 * words)


#: float32 operations of one ray/triangle test of
#: ``ops/triangles._mt_chunk``: the two cross products (6 products and 3 differences
#: each), the four dot products (3 products and 2 sums each), 1/det,
#: o - v0 (3), the three products by 1/det and u + v; the comparisons are
#: not counted
MT_FLOPS = 2 * 9 + 4 * 5 + 1 + 3 + 3 + 1


def mesh_raycast(rays: int, tris: int, origin_rows: int = 1) -> Bound:
    """Row C, the function, whatever the design: every one of the T
    triangles read once (36 B each; an unread triangle could be the
    nearest), the R rays and the ``origin_rows`` origins (1 shared, or one
    a ray; 12 B each) read, t and the triangle index written (8 B a ray).
    The bound row C's build and traversal together are held to."""
    return bound(36 * tris + 12 * (rays + origin_rows) + 8 * rays)


def mesh_raycast_dense(rays: int, tris: int, origin_rows: int = 1) -> Bound:
    """Row C's dense design (``mesh_raycast_dense``, the parent's): the
    bytes of :func:`mesh_raycast` and R x T tests of :data:`MT_FLOPS`
    operations (it tests every pair)."""
    return bound(mesh_raycast(rays, tris, origin_rows).bytes,
                 rays * tris * MT_FLOPS)


def bvh_keys(tris: int) -> Bound:
    """Row C's keys kernel: each triangle read (36 B), the scene's grid and
    the rays' reach (13 floats), its key (8 B) and padded box (24 B)
    written."""
    return bound(36 * tris + 4 * 13 + (8 + 24) * tris)


def bvh_sort(tris: int) -> Bound:
    """``torch.sort`` of the T int64 keys: read once, the sorted keys and
    their int64 indices written."""
    return bound(8 * tris + 16 * tris)


def bvh_hierarchy(tris: int) -> Bound:
    """Row C's hierarchy kernel: the T sorted keys read (8 B each); the two
    child ids (8 B) and the arrival counter (4 B) of each of the T - 1
    internal nodes and the parent of each of the 2T - 1 nodes (4 B)
    written."""
    return bound(8 * tris + 12 * (tris - 1) + 4 * (2 * tris - 1))


def bvh_refit(tris: int) -> Bound:
    """Row C's refit kernel: each leaf's triangle index (4 B) and padded
    box (24 B), each node's parent (4 B) and each internal node's child ids
    and counter (12 B) read; each internal node's two child boxes and
    heights (56 B) and counter (4 B), and the root's height, written."""
    m = tris - 1
    return bound(28 * tris + 4 * (2 * tris - 1) + 12 * m + 60 * m + 4)


def bvh_reorder(tris: int) -> Bound:
    """Row C's reorder kernel: each leaf's triangle index (4 B) and its
    triangle (36 B) read, its row of v0, e1, e2 and the index (48 B)
    written."""
    return bound((4 + 36 + 48) * tris)


def conv_flops(model, x) -> int:
    """Operations (a multiply and an add each) of every ``nn.Conv2d`` in
    one forward of ``model`` on ``x``, counted from each layer's weight
    and output shapes by forward hooks (the network's other work, the
    norms and activations, is elementwise and left out)."""
    import torch
    from torch import nn

    total = [0]

    def hook(m, _, out):
        total[0] += 2 * out.numel() * m.weight[0].numel()

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def train_step(forward_flops: int) -> Bound:
    """A train step of a convolution network whose forward takes
    ``forward_flops`` (:func:`conv_flops` of the batch): the forward and
    the two products of the backward (the gradients of the inputs and of
    the weights), 3x the forward, at the bf16 tensor-core rate."""
    flops = 3 * forward_flops
    return Bound(0, int(flops), flops_ms(flops, H100_BF16_TFLOPS),
                 "operations")
