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
    asin and row (18 operations, as :func:`integrate_flops` counts them)."""
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
