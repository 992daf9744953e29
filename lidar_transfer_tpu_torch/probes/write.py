"""Probes 6 and 7 on the card: output-write bandwidth and the aliasing
layouts.

Counterpart of ``scripts/probe_pallas_write.py`` (constant writes over
(BX, BY, Z) blocks or flat rows of BR, by dtype and output count, beside a
plain full write) and ``scripts/probe_alias.py`` (the same writes into
fresh outputs, into the caller's tensors, with a fourth unused tensor, and
after reading the old blocks). One CUDA kernel (``csrc/probe_write.cu``)
writes the constant i + 1 into output i; :func:`write_plain`
(``Tensor.fill_``) is its plain version, which a CPU tensor takes, and
``torch.full`` is the counterpart of the script's XLA baseline.

probe_alias's modes are arrangements of tensors on the host:

  noalias     a fresh ``torch.empty`` for each output on every call
  alias_any   the caller's three tensors, written in place
  alias_any4  as alias_any, the fourth tensor returned beside the three
              (the script appends it to the result: ``out + state[3:]``)
  alias_vmem  in place, each block read before it is written
              (``read_first``), as the script's VMEM-blocked inputs are
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_transfer_tpu_torch import _build

DIMS = (1024, 1024, 256)
#: dtype code of each output dtype the kernel writes
CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2,
         torch.int8: 3, torch.int16: 4}
ALIAS_MODES = ("noalias", "alias_any", "alias_any4", "alias_vmem")
#: probe_alias's outputs, its block
ALIAS_DTYPES = (torch.bfloat16, torch.int16, torch.bfloat16)
ALIAS_BLOCK = (2, 1024)
#: the kernel's tile (``csrc/probe_write.cu``): 256 threads x 4 16-byte
#: words, one CTA each
TILE_WORDS = 1024


class WritePlan(NamedTuple):
    """How kernel ``probe_write`` splits its outputs. The script's grid
    (``grid_x``, ``grid_y``) of blocks, each ``rows`` runs of ``span``
    elements ``stride`` apart; every run cut into ``tiles_per_run[i]``
    tiles of TILE_WORDS 16-byte words for output i; the ``tiles`` of all
    outputs one list, output by output and run by run; ``grid`` CTAs, CTA
    t on tile t."""

    grid_x: int
    grid_y: int
    rows: int
    stride: int
    span: int
    tiles_per_run: tuple
    tiles: int
    grid: int


def write_plan(shape, itemsizes, *, BX: int | None = None,
               BY: int | None = None, BR: int | None = None) -> WritePlan:
    """The partition the wrapper launches for outputs of ``shape`` and
    byte widths ``itemsizes`` (1 to 3): (BX, BY, Z) blocks or, with
    ``BR``, BR flat rows of Z."""
    X, Y, Z = shape
    if BR is not None:
        if BX is not None or BY is not None or BR < 1 or (X * Y) % BR:
            raise ValueError(f"probe_write: BR={BR} alone, dividing "
                             f"X*Y={X * Y}")
        gx, gy, rows, stride, span = X * Y // BR, 1, 1, BR * Z, BR * Z
    else:
        if (BX is None or BY is None or BX < 1 or BY < 1 or X % BX
                or Y % BY):
            raise ValueError(f"probe_write: (BX, BY)=({BX}, {BY}) must "
                             f"divide (X, Y)=({X}, {Y})")
        gx, gy, rows, stride, span = X // BX, Y // BY, BX, Y * Z, BY * Z
    if any(span * w % 16 for w in itemsizes):
        raise ValueError(f"probe_write: a block's run of {span} elements "
                         "is not a multiple of 16 bytes")
    per_run = tuple(-(-span * w // 16 // TILE_WORDS) for w in itemsizes)
    tiles = gx * gy * rows * sum(per_run)
    if tiles >= 1 << 31:
        raise ValueError(f"probe_write: {tiles} tiles, over 2^31")
    return WritePlan(gx, gy, rows, stride, span, per_run, tiles, tiles)


def plan_tiles(plan: WritePlan, itemsizes):
    """The tiles of ``plan`` as the kernel maps them: -> arrays (output,
    first byte, end byte), one entry a tile in the order of the list."""
    import numpy as np

    outs, starts, ends = [], [], []
    runs = plan.grid_x * plan.grid_y * plan.rows
    for i, (w, per) in enumerate(zip(itemsizes, plan.tiles_per_run)):
        tl = np.arange(runs * per, dtype=np.int64)
        q, k = tl // per, tl % per
        b, r = q // plan.rows, q % plan.rows
        first = ((b // plan.grid_y) * plan.rows + r) * plan.stride \
            + (b % plan.grid_y) * plan.span
        w0 = k * TILE_WORDS
        w1 = np.minimum(w0 + TILE_WORDS, plan.span * w // 16)
        outs.append(np.full(tl.shape, i))
        starts.append(first * w + w0 * 16)
        ends.append(first * w + w1 * 16)
    return tuple(np.concatenate(a) for a in (outs, starts, ends))


def write_plain(outs):
    """Fill output i with i + 1 (plain PyTorch); -> the outputs."""
    for i, o in enumerate(outs):
        o.fill_(i + 1)
    return tuple(outs)


def probe_write(outs, *, BX: int | None = None, BY: int | None = None,
                BR: int | None = None, read_first: bool = False):
    """Fill output i of ``outs`` (1 to 3 (X, Y, Z) tensors) with i + 1:
    kernel ``probe_write`` on the card, walking the script's (BX, BY, Z)
    blocks or, with ``BR``, its BR flat rows of Z in tiles
    (:func:`write_plan`); the plain version for CPU tensors.
    ``read_first`` loads each block before it is written."""
    if all(o.device.type == "cpu" for o in outs):
        return write_plain(outs)
    if not 1 <= len(outs) <= 3:
        raise ValueError(f"probe_write: 1 to 3 outputs, got {len(outs)}")
    dev = outs[0].device
    shape = tuple(outs[0].shape)
    if dev.type != "cuda" or len(shape) != 3:
        raise ValueError(f"probe_write: outputs must be (X, Y, Z) tensors "
                         f"on a CUDA device, got {shape} on {dev}")
    for o in outs:
        if (o.device != dev or tuple(o.shape) != shape or o.dtype not in CODES
                or not o.is_contiguous() or o.data_ptr() % 16):
            raise ValueError(f"probe_write: outputs must be contiguous, "
                             f"16-byte aligned {shape} tensors of "
                             f"{list(CODES)} on {dev}")
    plan = write_plan(shape, [o.element_size() for o in outs], BX=BX, BY=BY,
                      BR=BR)
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    codes = [CODES[o.dtype] for o in outs] + [0] * (3 - len(outs))
    tiles = list(plan.tiles_per_run) + [0] * (3 - len(outs))
    _build.launch("probe_write", "lt_probe_write", *ptrs, *codes, len(outs),
                  plan.grid_x, plan.grid_y, plan.rows, plan.stride,
                  plan.span, *tiles, plan.grid, int(read_first),
                  _build.stream_handle(dev))
    return tuple(outs)


def alias_call(mode: str, state, **block):
    """probe_alias's ``mode`` on ``state`` (three (X, Y, Z) tensors of
    ALIAS_DTYPES, plus a fourth for alias_any4); -> the outputs."""
    if mode == "noalias":
        return probe_write([torch.empty_like(t) for t in state[:3]], **block)
    if mode == "alias_any":
        return probe_write(state[:3], **block)
    if mode == "alias_any4":
        return probe_write(state[:3], **block) + tuple(state[3:4])
    if mode == "alias_vmem":
        return probe_write(state[:3], read_first=True, **block)
    raise ValueError(f"unknown mode {mode!r} (one of {ALIAS_MODES})")


def _gbs(nbytes, ms):
    return nbytes / (ms * 1e-3) / 1e9


def run_write(iters: int = 50, dims=DIMS, tag: str = ""):
    """probe_pallas_write's rows at ``dims``, each beside the plain fill of
    the same tensors. Prints one line a row; -> the rows as dicts."""
    from lidar_transfer_tpu_torch.probes.timing import cuda_ms, device_ms

    dev = torch.device("cuda")
    X, Y, Z = dims
    rows = []

    def row(name, ms, plain_ms, nbytes, err=None, d_ms=None, pd_ms=None):
        rows.append(dict(probe="write", row=name, ms=ms, plain_ms=plain_ms,
                         device_ms=d_ms, plain_device_ms=pd_ms,
                         gb_s=_gbs(nbytes, ms), max_abs_err=err))
        plain = ("" if plain_ms is None else
                 f", PyTorch fill {plain_ms:7.4f} ms "
                 f"({_gbs(nbytes, plain_ms):7.1f} GB/s)")
        on_dev = ("" if d_ms is None else f", device {d_ms:7.4f} ms"
                  + ("" if pd_ms is None else f" (fill {pd_ms:7.4f})"))
        print(f"write {name:28s}: {ms:7.4f} ms ({rows[-1]['gb_s']:7.1f} "
              f"GB/s){on_dev}{plain} {tag}", flush=True)

    for dt, n in ((torch.bfloat16, 1), (torch.bfloat16, 3),
                  (torch.float32, 1)):
        nbytes = X * Y * Z * dt.itemsize * n
        ms = cuda_ms(lambda: [torch.full(dims, i + 1, dtype=dt, device=dev)
                              for i in range(n)], iters)
        row(f"PyTorch full {str(dt)[6:]} x{n}", ms, None, nbytes)

    def kernel_row(name, dts, on_device=False, **block):
        """``on_device`` adds the device times (profiler traces) of the
        row and of the plain fill of the same tensors."""
        outs = [torch.empty(dims, dtype=dt, device=dev) for dt in dts]
        nbytes = sum(o.numel() * o.element_size() for o in outs)
        ms = cuda_ms(lambda: probe_write(outs, **block), iters)
        d_ms = pd_ms = None
        if on_device:
            d_ms = device_ms(lambda: probe_write(outs, **block), 3)[0]
            pd_ms = device_ms(lambda: write_plain(outs), 3)[0]
        ref = [torch.empty_like(o) for o in outs]
        p_ms = cuda_ms(lambda: write_plain(ref), iters)
        for o in outs:
            o.zero_()
        probe_write(outs, **block)
        if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
            raise AssertionError(f"write {name}: kernel != plain fill")
        row(name, ms, p_ms, nbytes, 0.0, d_ms, pd_ms)

    # the device time of one row of each of the script's two probes
    for bx, by in ((1, 1024), (2, 1024), (4, 1024), (8, 1024), (8, 512),
                   (16, 256), (1, 512), (4, 512)):
        kernel_row(f"BX{bx} BY{by} bf16 x1", [torch.bfloat16],
                   on_device=(bx, by) == (8, 1024), BX=bx, BY=by)
    for dt in (torch.float32, torch.int32, torch.int8):
        kernel_row(f"BX4 BY1024 {str(dt)[6:]} x1", [dt], BX=4, BY=1024)
    for bx in (4, 2):
        kernel_row(f"BX{bx} BY1024 bf16 x3", [torch.bfloat16] * 3, BX=bx,
                   BY=1024)
    print("write arbitrary semantics: no CUDA meaning (CTAs run in no "
          "order and carry nothing between them)", flush=True)
    for br in (1024, 4096, 8192):
        kernel_row(f"2D rows BR{br} bf16 x1", [torch.bfloat16],
                   on_device=br == 8192, BR=br)
    return rows


def run_alias(iters: int = 50, dims=DIMS, tag: str = ""):
    """probe_alias's modes at ``dims`` (three outputs bf16/int16/bf16,
    BX=2, BY=1024), each beside the plain fill of the same outputs. Prints
    one line a mode; -> the rows as dicts."""
    from lidar_transfer_tpu_torch.probes.timing import cuda_ms, device_ms

    dev = torch.device("cuda")
    bx, by = ALIAS_BLOCK
    state = [torch.zeros(dims, dtype=dt, device=dev)
             for dt in ALIAS_DTYPES + (torch.bfloat16,)]
    nbytes = sum(t.numel() * t.element_size() for t in state[:3])
    rows = []
    # the three fills of the outputs: the one PyTorch call a mode stands for
    p_dev = device_ms(lambda: write_plain(state[:3]), 3)[0]
    for mode in ALIAS_MODES:
        ms = cuda_ms(lambda: alias_call(mode, state, BX=bx, BY=by), iters)
        p_ms = cuda_ms(lambda: write_plain(state[:3]), iters)
        for t in state[:3]:
            t.zero_()
        out = alias_call(mode, state, BX=bx, BY=by)
        err = max(float((o.float() - (i + 1)).abs().max())
                  for i, o in enumerate(out[:3]))
        if err or len(out) != (4 if mode == "alias_any4" else 3):
            raise AssertionError(f"alias {mode}: outputs are not 1, 2, 3")
        d_ms = device_ms(lambda: alias_call(mode, state, BX=bx, BY=by),
                         3)[0]
        rows.append(dict(probe="alias", row=mode, ms=ms, plain_ms=p_ms,
                         device_ms=d_ms, plain_device_ms=p_dev,
                         gb_s=_gbs(nbytes, ms), max_abs_err=err))
        on_dev = "" if d_ms is None else f", device {d_ms:7.4f} ms"
        p_on_dev = "" if p_dev is None else f", device {p_dev:7.4f} ms"
        print(f"alias {mode:12s}: {ms:7.4f} ms ({_gbs(nbytes, ms):7.1f} "
              f"GB/s){on_dev}; PyTorch fill x3 {p_ms:7.4f} ms{p_on_dev} "
              f"{tag}", flush=True)
    return rows
