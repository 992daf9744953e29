"""Probe 4 on the card: the integrate body with parts taken out.

Counterpart of ``scripts/probe_kernel_parts.py``: the same inputs (random
columns from numpy seed 0, the script's ``params``), the same variants, as
one CUDA kernel (``csrc/probe_parts.cu``) whose variants are template
cases:

  writeonly  the constants 1, 2, 3 (the write floor)
  nogeom     no sqrt or pitch: depth = gz, row = min(int(gz), H - 1)
  nogather   every voxel reads its column's image row 0
  full       geometry, the row gather, the reset-mode rule, the writes

with 1 or 3 outputs (tsdf bf16, label int16, remission bf16); BX, the
script's x-planes a grid step, is the runs of 8 columns a warp walks
(:func:`parts_plan`, the layout of ``csrc/probe_runs.cuh``).
:func:`parts_plain` is the same function in PyTorch, which a CPU tensor
takes.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.probes.runs import RunPlan, align_of, run_plan

VARIANTS = ("writeonly", "nogeom", "nogather", "full")
OUT_DTYPES = (torch.bfloat16, torch.int16, torch.bfloat16)
#: image rows, column width (the script's H and CW)
H, CW = 64, 64
VOXEL, TRUNC = 0.05, 0.25
DIMS = (1024, 1024, 256)


def make_inputs(dims, device="cpu", seed: int = 0):
    """The script's inputs for an (X, Y, Z) volume: params (2, 8) f32
    (origin (-25.6, -25.6, -6.4), fov 0.05 / -0.44 rad) and random dcol,
    lrcol (X, CW, Y) f32 from numpy ``seed``."""
    X, Y = dims[0], dims[1]
    rng = np.random.default_rng(seed)
    dcol = rng.random((X, CW, Y)).astype(np.float32)
    lrcol = (rng.random((X, CW, Y)) * 16384).astype(np.float32)
    params = np.zeros((2, 8), np.float32)
    params[0, :5] = (-25.6, -25.6, -6.4, 0.05, -0.44)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (params, dcol, lrcol))


def parts_plain(variant: str, params, dcol, lrcol, *, Z: int, n_out: int = 3,
                H: int = H, voxel_size: float = VOXEL,
                trunc: float = TRUNC):
    """The variant's outputs (tsdf bf16[, label int16, remission bf16]),
    each (X, Y, Z), in plain PyTorch, in the script's arithmetic order."""
    _check_variant(variant, n_out)
    X, _, Y = dcol.shape
    dev = dcol.device
    if variant == "writeonly":
        return tuple(torch.full((X, Y, Z), i + 1, dtype=dt, device=dev)
                     for i, dt in enumerate(OUT_DTYPES[:n_out]))
    # 0-dim tensors: a division by a Python float becomes a multiply by its
    # reciprocal on the card, the kernel divides
    vox = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    tr = torch.tensor(trunc, dtype=torch.float32, device=dev)
    ox, oy, oz, fov_up, fov_down = (params[0, i] for i in range(5))
    fov = torch.abs(fov_up) + torch.abs(fov_down)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)  # noqa
    gx, gy = ar(X)[:, None, None], ar(Y)[None, :, None]
    gz = ar(Z)[None, None, :]
    px = ox + gx * vox
    py = oy + gy * vox
    rxy2 = px * px + py * py
    pz = oz + gz * vox
    if variant == "nogeom":
        depth = gz.expand(X, Y, Z)
        v = torch.clamp(gz.to(torch.int64), max=H - 1).expand(X, Y, Z)
        in_fov = (gz > 1.0).expand(X, Y, Z)
    else:
        depth = torch.sqrt(rxy2 + pz * pz)
        r = torch.sqrt(rxy2)
        t = pz / torch.clamp(r, min=1e-12)
        pitch = t * (1.0 - 0.33 * t * t)
        in_fov = (pitch <= fov_up) & (pitch >= fov_down)
        vf = (1.0 - (pitch + torch.abs(fov_down)) / fov) * H
        v = torch.clamp(torch.floor(vf), 0, H - 1).to(torch.int64)
    if variant == "nogather":
        depth_val = dcol[:, 0, :, None] + 0.0 * depth
        lr = lrcol[:, 0, :, None] + 0.0 * depth
    else:
        # row v of voxel (x, y, z) is dcol[x, v, y]
        depth_val = torch.gather(dcol.transpose(1, 2), 2, v)
        lr = torch.gather(lrcol.transpose(1, 2), 2, v)
    new_label = torch.floor(lr * (1.0 / 16384.0))
    new_rem = (lr - new_label * 16384.0) * (1.0 / 16383.0)
    diff = depth_val - depth
    dist = torch.clamp(diff / tr, max=1.0)
    active = in_fov & (depth_val > 0.0) & (diff >= -tr)
    upd = active & (dist < 0.0)
    vals = (torch.where(upd, dist, 1.0), torch.where(upd, new_label, 0.0),
            torch.where(upd, new_rem, 0.0))
    return tuple(val.to(dt) for val, dt in zip(vals[:n_out], OUT_DTYPES))


def parts_plan(X: int, Y: int, Z: int, BX: int = 2,
               out_align: int = 16) -> RunPlan:
    """The partition the wrapper launches (``probes/runs.py``): runs of 8
    columns, ``BX`` of them a warp, 8, 4 or 1 voxels a lane by the sizes
    and ``out_align``, the bytes the outputs' pointers are aligned to."""
    return run_plan(X, Y, Z, BX, 16, out_align, "probe_parts")


def probe_parts(variant: str, params, dcol, lrcol, *, Z: int,
                n_out: int = 3, BX: int = 2, H: int = H,
                voxel_size: float = VOXEL, trunc: float = TRUNC):
    """The variant's outputs: kernel ``probe_parts`` on the card, the plain
    version for CPU tensors; ``BX`` runs of 8 columns a warp
    (:func:`parts_plan`; the outputs do not depend on it)."""
    if dcol.device.type == "cpu":
        return parts_plain(variant, params, dcol, lrcol, Z=Z, n_out=n_out,
                           H=H, voxel_size=voxel_size, trunc=trunc)
    _check_variant(variant, n_out)
    X, cw, Y = dcol.shape
    _check_inputs("probe_parts", params, (dcol, lrcol))
    if not 0 < H <= cw:
        raise ValueError(f"probe_parts: H {H} must be in [1, CW={cw}]")
    dev = dcol.device
    outs = [torch.empty((X, Y, Z), dtype=dt, device=dev)
            for dt in OUT_DTYPES[:n_out]]
    plan = parts_plan(X, Y, Z, BX, min(align_of(o.data_ptr()) for o in outs))
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - n_out)
    _build.launch("probe_parts", "lt_probe_parts", *ptrs, params.data_ptr(),
                  dcol.data_ptr(), lrcol.data_ptr(), VARIANTS.index(variant),
                  n_out, X, Y, Z, H, cw, BX, plan.grid, plan.vec,
                  float(np.float32(voxel_size)), float(np.float32(trunc)),
                  _build.stream_handle(dev))
    return tuple(outs)


def _check_variant(variant, n_out):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")
    if n_out not in (1, 3):
        raise ValueError(f"n_out must be 1 or 3, got {n_out}")


def _check_inputs(name, params, cols):
    """Raise unless params is a (2, 8) and every column a contiguous
    float32 tensor on one CUDA device."""
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: inputs on {dev}")
    for t in (params, *cols):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name}: params and columns must be "
                             f"contiguous float32 tensors on {dev}")
    if tuple(params.shape) != (2, 8):
        raise ValueError(f"{name}: params must be (2, 8), got "
                         f"{tuple(params.shape)}")
    if any(c.shape != cols[0].shape for c in cols) or cols[0].dim() != 3:
        raise ValueError(f"{name}: columns must share one (X, CW, Y) shape")


def run(iters: int = 50, plain_iters: int = 3, dims=DIMS, tag: str = ""):
    """The script's rows at ``dims``: each variant with three outputs at
    BX 2, ``full`` with one output, ``full`` at BX 4 and 8. Prints one line
    a row; -> the rows as dicts (kernel and plain ms, Gvoxel/s, the largest
    difference to the plain version)."""
    from lidar_transfer_tpu_torch.probes.timing import (cuda_ms, device_ms,
                                                        max_diff)

    dev = torch.device("cuda")
    X, Y, Z = dims
    params, dcol, lrcol = make_inputs(dims, dev)
    nvox = X * Y * Z
    rows, plain = [], {}
    cases = [(v, 3, 2) for v in VARIANTS] + [("full", 1, 2), ("full", 3, 4),
                                            ("full", 3, 8)]
    for variant, n_out, bx in cases:
        kw = dict(Z=Z, n_out=n_out)
        call = lambda: probe_parts(variant, params, dcol, lrcol,  # noqa
                                   BX=bx, **kw)
        ms = cuda_ms(call, iters)
        if (variant, n_out) not in plain:
            plain[variant, n_out] = cuda_ms(
                lambda: parts_plain(variant, params, dcol, lrcol, **kw),
                plain_iters, warmup=1)
        name = f"{variant} BX{bx} out x{n_out}"
        err = max_diff(probe_parts(variant, params, dcol, lrcol, BX=bx, **kw),
                       parts_plain(variant, params, dcol, lrcol, **kw),
                       f"parts {name}")
        torch.cuda.empty_cache()
        rows.append(dict(probe="parts", row=name, ms=ms,
                         device_ms=device_ms(call, 3)[0],
                         plain_ms=plain[variant, n_out],
                         gvox_s=nvox / (ms * 1e-3) / 1e9, max_abs_err=err))
        print(f"parts {name:22s}: kernel {ms:8.3f} ms "
              f"({rows[-1]['gvox_s']:7.2f} Gvoxel/s), plain "
              f"{plain[variant, n_out]:8.2f} ms, max |diff| {err:g} {tag}",
              flush=True)
    return rows
