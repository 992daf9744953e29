"""Probe 8 on the card: the reset-mode integrate body on precomputed
columns, with its divisions ("precols") and without ("nodiv").

Counterpart of ``scripts/probe_integrate_ablate.py``:

  real     the port's own ``integrate_cuda`` (reset, compact state, the
           geometry table, no weight write) on random 64x2048 images
  cols     :func:`build_cols`, the probe's input preparation, in plain
           PyTorch: the port's integrate has no column table
  precols  kernel ``probe_ablate`` with the Pallas body's divisions
  nodiv    the same kernel with multiplications in their place

The kernel (``csrc/probe_ablate.cu``) reads the columns and the int8 row
table, applies the crop and writes the compact state; :func:`ablate_plain`
is the same function in PyTorch, which a CPU tensor takes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.ops.projection import deg2rad32
from lidar_transfer_tpu_torch.probes.parts import _check_inputs

DIMS = (1024, 1024, 256)
#: the script's images, column width, placement and fov
H, W, CW = 64, 2048, 64
ORIGIN = (-25.6, -25.6, -6.4)
VOXEL, TRUNC = 0.05, 0.25
FOV_UP, FOV_DOWN = 3.0, -25.0
OUT_DTYPES = (torch.bfloat16, torch.int16, torch.bfloat16)


def make_images(device="cpu", seed: int = 0, H: int = H, W: int = W):
    """The script's random (H, W) depth, label and remission images from
    numpy ``seed``."""
    rng = np.random.default_rng(seed)
    depth = (rng.random((H, W)) * 20 + 2).astype(np.float32)
    label = rng.integers(1, 20, (H, W)).astype(np.int32)
    rem = rng.random((H, W)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (depth, label, rem))


def ablate_params(origin, active_dims, device="cpu",
                  fov_up_deg: float = FOV_UP,
                  fov_down_deg: float = FOV_DOWN,
                  obs_weight: float = 1.0) -> torch.Tensor:
    """(2, 8) f32 as ``tsdf_pallas._params`` lays them out: origin, fov up
    and down (radians), obs weight, active y and z in row 0; active x at
    [1, 0]."""
    p = np.zeros((2, 8), np.float32)
    p[0] = (*origin, deg2rad32(fov_up_deg), deg2rad32(fov_down_deg),
            obs_weight, active_dims[1], active_dims[2])
    p[1, 0] = active_dims[0]
    return torch.from_numpy(p).to(device)


def build_cols(depth_im, label_im, rem_im, dims, origin,
               voxel_size: float = VOXEL, cw: int = CW):
    """(X, CW, Y) f32 columns of an (X, Y, ...) placement: each (x, y)'s
    image column u (yaw is constant along z), rows padded to ``cw``; depth
    and the packed label * 16384 + round(remission * 16383)."""
    X, Y = dims[0], dims[1]
    h, w = depth_im.shape
    dev = depth_im.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    o = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    vox = f32(voxel_size)
    gx = torch.arange(X, dtype=torch.float32, device=dev)[:, None]
    gy = torch.arange(Y, dtype=torch.float32, device=dev)[None, :]
    px = o[0] + gx * vox
    py = o[1] + gy * vox
    yaw = -torch.atan2(py, px)
    u = torch.clamp(torch.floor(0.5 * (yaw / f32(np.pi) + 1.0) * w), 0,
                    w - 1).to(torch.int64)

    def cols_of(img):
        img = F.pad(img.to(torch.float32), (0, 0, 0, max(cw - h, 0)))
        return img[:, u].permute(1, 0, 2).contiguous()

    packed = (label_im.to(torch.float32) * 16384.0
              + torch.round(torch.clamp(rem_im, 0.0, 1.0) * 16383.0))
    return cols_of(depth_im), cols_of(packed)


def ablate_plain(div: bool, params, dcol, lrcol, v_tab, *,
                 voxel_size: float = VOXEL, trunc: float = TRUNC):
    """The compact (tsdf bf16, label int16, remission bf16) reset state,
    each (X, Y, Z), in plain PyTorch: the Pallas body's divisions
    (``div``) or the probe's multiplications."""
    X, _, Y = dcol.shape
    Z = v_tab.shape[2]
    dev = dcol.device
    vox = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    tr = torch.tensor(trunc, dtype=torch.float32, device=dev)
    ox, oy, oz = params[0, 0], params[0, 1], params[0, 2]
    obs_w, ay, az, ax = params[0, 5], params[0, 6], params[0, 7], params[1, 0]
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)  # noqa
    gx, gy = ar(X)[:, None, None], ar(Y)[None, :, None]
    gz = ar(Z)[None, None, :]
    px = ox + gx * vox
    py = oy + gy * vox
    rxy2 = px * px + py * py
    in_crop_xy = (gx < ax) & (gy < ay)
    pz = oz + gz * vox
    depth = torch.sqrt(rxy2 + pz * pz)
    v_raw = v_tab.to(torch.int64)
    in_fov = v_raw >= 0
    v = torch.clamp(v_raw, min=0)
    depth_val = torch.gather(dcol.transpose(1, 2), 2, v)
    lr = torch.gather(lrcol.transpose(1, 2), 2, v)
    new_label = torch.floor(lr * (1.0 / 16384.0))
    new_rem = (lr - new_label * 16384.0) * (1.0 / 16383.0)
    diff = depth_val - depth
    active = (in_crop_xy & (gz < az) & in_fov & (depth_val > 0.0)
              & (diff >= -tr))
    # reset: the prior state is tsdf 1, weight 0, label 0, remission 0
    same = new_label == 0.0
    if div:
        dist = torch.clamp(diff / tr, max=1.0)
        w_new = 0.0 + obs_w
        tsdf_avg = (1.0 * 0.0 + dist) / w_new
        rem_avg = (0.0 * 0.0 + new_rem) / w_new
    else:
        dist = torch.clamp(diff * float(np.float32(1.0 / trunc)), max=1.0)
        tsdf_avg = dist * (1.0 / obs_w) * obs_w
        rem_avg = new_rem
    closer = dist < 0.0
    upd_same = active & same
    upd_diff = active & ~same & closer
    vals = (torch.where(upd_same, tsdf_avg, torch.where(upd_diff, dist, 1.0)),
            torch.where(upd_diff, new_label, 0.0),
            torch.where(upd_same, rem_avg,
                        torch.where(upd_diff, new_rem, 0.0)))
    return tuple(val.to(dt) for val, dt in zip(vals, OUT_DTYPES))


def probe_ablate(div: bool, params, dcol, lrcol, v_tab, *, BX: int = 2,
                 voxel_size: float = VOXEL, trunc: float = TRUNC):
    """The compact reset state: kernel ``probe_ablate`` on the card, the
    plain version for CPU tensors."""
    if dcol.device.type == "cpu":
        return ablate_plain(div, params, dcol, lrcol, v_tab,
                            voxel_size=voxel_size, trunc=trunc)
    X, cw, Y = dcol.shape
    _check_inputs("probe_ablate", params, (dcol, lrcol), X, BX)
    if (v_tab.device != dcol.device or v_tab.dtype != torch.int8
            or not v_tab.is_contiguous() or v_tab.dim() != 3
            or tuple(v_tab.shape[:2]) != (X, Y)):
        raise ValueError(f"probe_ablate: v_tab must be a contiguous int8 "
                         f"({X}, {Y}, Z) tensor on {dcol.device}")
    Z = v_tab.shape[2]
    dev = dcol.device
    outs = [torch.empty((X, Y, Z), dtype=dt, device=dev) for dt in OUT_DTYPES]
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    _build.launch("probe_ablate", "lt_probe_ablate",
                  *(o.data_ptr() for o in outs), params.data_ptr(),
                  dcol.data_ptr(), lrcol.data_ptr(), v_tab.data_ptr(),
                  int(div), X, Y, Z, cw, BX, f32(voxel_size), f32(trunc),
                  f32(1.0 / trunc), _build.stream_handle(dev))
    return tuple(outs)


def run(iters: int = 50, plain_iters: int = 3, dims=DIMS, tag: str = ""):
    """The script's rows at ``dims``: real, cols, precols, nodiv. Prints
    one line a row; -> the rows as dicts."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_cuda, precompute_geometry_cuda)
    from lidar_transfer_tpu_torch.probes.timing import (cuda_ms, device_ms,
                                                        max_diff)

    dev = torch.device("cuda")
    X, Y, Z = dims
    nvox = X * Y * Z
    spec = TS.VolumeSpec(ORIGIN, VOXEL, dims)
    imgs = make_images(dev)
    table = precompute_geometry_cuda(spec, FOV_UP, FOV_DOWN, H, device=dev)
    state = spec.init_state(dev, compact=True)
    fov = dict(fov_up_deg=FOV_UP, fov_down_deg=FOV_DOWN)
    rows = []

    def row(name, ms, plain_ms=None, err=None, d_ms=None):
        rows.append(dict(probe="ablate", row=name, ms=ms, device_ms=d_ms,
                         plain_ms=plain_ms,
                         gvox_s=nvox / (ms * 1e-3) / 1e9, max_abs_err=err))
        extra = "" if plain_ms is None else (
            f", plain {plain_ms:8.2f} ms, max |diff| {err:g}")
        print(f"ablate {name:40s}: {ms:8.3f} ms "
              f"({rows[-1]['gvox_s']:7.2f} Gvoxel/s){extra} {tag}",
              flush=True)

    row("real (integrate_cuda, compact, table)", cuda_ms(
        lambda: integrate_cuda(state, spec, *imgs, reset=True,
                               write_weight=False, v_tab=table, **fov),
        iters))
    del state
    row("cols (plain, the port's integrate has none)", cuda_ms(
        lambda: build_cols(*imgs, dims, ORIGIN), iters))
    dcol, lrcol = build_cols(*imgs, dims, ORIGIN)
    params = ablate_params(ORIGIN, dims, dev)
    args = (params, dcol, lrcol, table)
    for div, name in ((True, "precols"), (False, "nodiv")):
        ms = cuda_ms(lambda: probe_ablate(div, *args), iters)
        p_ms = cuda_ms(lambda: ablate_plain(div, *args), plain_iters,
                       warmup=1)
        err = max_diff(probe_ablate(div, *args), ablate_plain(div, *args),
                       f"ablate {name}")
        torch.cuda.empty_cache()
        row(name, ms, p_ms, err,
            device_ms(lambda: probe_ablate(div, *args), 3)[0])
    return rows
