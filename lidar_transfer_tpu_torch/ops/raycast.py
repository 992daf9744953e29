"""Virtual-scan synthesis by marching target rays through the TSDF volume
(PyTorch) and the raymarch kernel's plain version.

Counterpart of ``lidar_transfer_tpu/ops/raycast.py``. A coarse occupancy
grid (blocks of ``block``³ voxels that hold a surface voxel, dilated) lets
a ray take block-sized steps through free space; inside an occupied block
it takes fine steps, stops at the first +/- crossing of the TSDF sampled
at the floor voxel, and refines the hit by bisection on the trilinear
field. The JAX package marches all rays in lockstep in one
``lax.while_loop``; the port marches one ray per thread in a hand-written
kernel (``csrc/raymarch.cu``, through :func:`raymarch`), which reads the
occupancy packed into bits (:func:`pack_occupancy_plain` is the layout),
and :func:`raycast_plain` is the same march on tensors, a loop of at most
``max_steps`` steps that leaves as soon as every ray is done: what a CPU
tensor runs, and the kernel's oracle on the card. A ray may start at its
own origin: :func:`generate_rays_moving` gives a rolling-shutter sensor's.

Every float is float32, in the JAX function's order; the divisions by the
voxel size are true divisions on both devices (a 0-dim divisor: PyTorch
turns a division by a host scalar into a multiplication by its reciprocal
on the card), and the kernel repeats this arithmetic (-fmad=false).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from lidar_transfer_tpu_torch.ops.raycast_cuda import (MarchParams,
                                                       pack_occupancy_cuda,
                                                       raymarch_cuda,
                                                       words_shape)
from lidar_transfer_tpu_torch.ops.transforms import interpolate_pose
from lidar_transfer_tpu_torch.ops.tsdf import TSDFState, VolumeSpec

#: refinement: bisection steps on the trilinear field, and the bracket
#: widened by this many voxels each way
BISECT_STEPS, MARGIN_VOXELS = 10, 2.0
#: the farthest a ray marches (m)
T_FAR_MAX = 1e4
#: the granularity of a gather from device memory (bytes)
SECTOR = 32


def generate_rays(H: int, W: int, fov_up_deg: float, fov_down_deg: float,
                  beam_angles=None) -> np.ndarray:
    """(H*W, 3) f32 unit ray directions for a target sensor, row-major
    (H, W): yaw = linspace(0, 360, W) + 180 (wrapped to [0, 360]), pitch =
    linspace(fov_up, fov_down, H), or the beam angles (radians, sorted
    descending) where given."""
    initial = 180.0
    yaw = np.linspace(0.0, 360.0, W) + initial
    yaw[yaw > 360.0] -= 360.0
    yaw = np.deg2rad(yaw)
    if beam_angles is not None:
        pitch = np.sort(np.asarray(beam_angles, np.float64))[::-1]
        if pitch.shape[0] != H:
            raise ValueError(f"{pitch.shape[0]} beam angles != H={H}")
    else:
        pitch = np.deg2rad(np.linspace(fov_up_deg, fov_down_deg, H))
    colat = np.pi / 2.0 - pitch
    dirs = np.empty((H, W, 3), dtype=np.float64)
    dirs[:, :, 0] = np.sin(colat)[:, None] * np.cos(-yaw)[None, :]
    dirs[:, :, 1] = np.sin(colat)[:, None] * np.sin(-yaw)[None, :]
    dirs[:, :, 2] = np.cos(colat)[:, None]
    return dirs.reshape(-1, 3).astype(np.float32)


def generate_rays_moving(H: int, W: int, fov_up_deg: float,
                         fov_down_deg: float, pose_next: np.ndarray,
                         beam_angles=None, spin_fraction: float = 1.0
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Rolling-shutter rays: a spinning sensor fires image column w at the
    fraction w / W of the frame (times ``spin_fraction``) while it moves by
    ``pose_next``, the rigid transform from this scan's sensor frame to the
    next scan's (inv(pose[i]) @ pose[i+1]). Column w's rays are
    :func:`generate_rays`' rotated by the pose interpolated at its firing
    fraction (``transforms.interpolate_pose``), and its origin is that
    pose's translation. -> (rays (H*W, 3) f32 unit directions, origins
    (H*W, 3) f32), both for :func:`raycast_tsdf`."""
    base = generate_rays(H, W, fov_up_deg, fov_down_deg,
                         beam_angles=beam_angles).reshape(H, W, 3)
    t = np.linspace(0.0, spin_fraction, W, endpoint=False)
    poses = interpolate_pose(np.eye(4), np.asarray(pose_next, np.float64),
                             t)                                # (W,4,4)
    dirs = np.einsum("wij,hwj->hwi", poses[:, :3, :3], base)
    origins = np.broadcast_to(poses[:, :3, 3], (H, W, 3))
    return (np.ascontiguousarray(dirs.reshape(-1, 3), dtype=np.float32),
            np.ascontiguousarray(origins.reshape(-1, 3), dtype=np.float32))


class RaycastResult(NamedTuple):
    """Per-ray hit data, reshaped to the target image grid (H, W)."""

    range: torch.Tensor      # f32 distance along the unit ray; 0 = miss
    label: torch.Tensor      # i32 label of the hit; 0 = miss
    remission: torch.Tensor  # f32 remission at the hit; 0 = miss
    endpoints: torch.Tensor  # (H, W, 3) f32 hit points; 0 = miss
    hit: torch.Tensor        # bool


def _dilate(occ: torch.Tensor, rounds: int) -> torch.Tensor:
    """``rounds`` rounds of a +-1 dilation along each axis in turn, which
    is a (2 rounds + 1)³ box clipped at the faces (nothing wraps; the JAX
    function pads before it rolls). Along each axis the grid is padded
    with ``rounds`` empty cells on each side and ORed with itself shifted
    by 1, 2, 4, ... cells, so that cell j holds the OR of a window of
    2 rounds + 1 cells: about log2(2 rounds + 1) launches an axis, where a
    launch a round and axis is many more, and a max pool of that width
    more device time, on the card."""
    k = 2 * rounds + 1
    for axis in range(3):
        pad = [0] * 6
        pad[4 - 2 * axis] = pad[5 - 2 * axis] = rounds
        win, width = F.pad(occ, pad), 1
        while width < k:
            s = min(width, k - width)
            n = win.shape[axis] - s
            win = win.narrow(axis, 0, n) | win.narrow(axis, s, n)
            width += s
        occ = win
    return occ


def occupancy_grid(tsdf: torch.Tensor, block: int = 4) -> torch.Tensor:
    """Coarse bool grid: a block holds a touched voxel (tsdf < 1; free and
    unseen space stays at the init value 1), dilated by one block.

    The blockwise any() is a max pool of -tsdf in the storage dtype (a
    bf16 volume is never copied to float32); blocks the dims do not fill
    are pooled over the voxels they hold."""
    neg = torch.neg(tsdf)[None, None]
    coarse = F.max_pool3d(neg, block, block, ceil_mode=True)[0, 0]
    return _dilate(coarse > -1.0, 1)


def dilate_cells_for(spec: VolumeSpec, block: int = 4,
                     pixel_angle_rad: float = 0.0) -> int:
    """The default dilation of :func:`occupancy_from_points`: the
    truncation band plus a pixel cone's lateral spread over the volume
    diagonal, in cells, plus one cell."""
    cell = spec.voxel_size * block
    margin_m = spec.trunc_margin
    if pixel_angle_rad > 0.0:
        diag = float(np.linalg.norm(
            np.asarray(spec.dims, np.float64) * spec.voxel_size))
        margin_m += diag * float(np.tan(pixel_angle_rad))
    return int(np.ceil(margin_m / cell)) + 1


def occupancy_from_points(points: torch.Tensor, valid: torch.Tensor,
                          vol_origin, spec: VolumeSpec, block: int = 4,
                          dilate_cells: int | None = None,
                          pixel_angle_rad: float = 0.0) -> torch.Tensor:
    """Coarse occupancy from the surface points (O(points), not
    O(voxels)): the cell of every valid point, points up to
    ``dilate_cells`` cells outside the box marking their nearest boundary
    cell, dilated by ``dilate_cells`` (default :func:`dilate_cells_for`:
    the band and a pixel cone's spread, given the source's
    ``pixel_angle_rad``)."""
    X, Y, Z = spec.dims
    c = (-(-X // block), -(-Y // block), -(-Z // block))
    dev = points.device
    if dilate_cells is None:
        dilate_cells = dilate_cells_for(spec, block, pixel_angle_rad)
    cell = torch.tensor(spec.voxel_size * block, dtype=torch.float32,
                        device=dev)
    vo = torch.as_tensor(np.asarray(vol_origin, np.float32), device=dev)
    # clamped before the integer conversion: far points only fail `near`
    g = torch.clamp(torch.floor((points - vo) / cell), -2.0**30, 2.0**30)
    gi = g.to(torch.int64)
    d = dilate_cells
    near = valid.clone()
    for a in range(3):
        near &= (gi[:, a] >= -d) & (gi[:, a] < c[a] + d)
    gi = torch.minimum(torch.clamp(gi, min=0),
                       torch.tensor([c[0] - 1, c[1] - 1, c[2] - 1],
                                    device=dev))
    n_cells = c[0] * c[1] * c[2]
    flat = torch.where(near, (gi[:, 0] * c[1] + gi[:, 1]) * c[2] + gi[:, 2],
                       n_cells)
    occ = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)
    occ[flat] = True
    return _dilate(occ[:n_cells].reshape(c), dilate_cells)


def pack_occupancy_plain(occ: torch.Tensor) -> torch.Tensor:
    """The occupancy as the march kernel reads it: the (cx, cy, cz) bool
    grid in (wx, wy, wz) int32 words (``raycast_cuda.words_shape``), a
    word a brick of 4 x 4 x 2 cells; cell (x, y, z) is bit
    ((x % 4) * 4 + y % 4) * 2 + z % 2 of word (x // 4, y // 4, z // 2),
    and cells past the grid are 0."""
    cx, cy, cz = occ.shape
    wx, wy, wz = words_shape(occ.shape)
    pad = F.pad(occ, (0, 2 * wz - cz, 0, 4 * wy - cy, 0, 4 * wx - cx))
    bits = pad.reshape(wx, 4, wy, 4, wz, 2).permute(0, 2, 4, 1, 3, 5)
    weight = torch.pow(2, torch.arange(32, dtype=torch.int64,
                                       device=occ.device))
    w = (bits.reshape(wx, wy, wz, 32).to(torch.int64) * weight).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def occupancy_from_words(words: torch.Tensor, cells) -> torch.Tensor:
    """The (cx, cy, cz) bool grid that :func:`pack_occupancy_plain` packed
    into ``words``."""
    wx, wy, wz = words.shape
    shift = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shift) & 1
    grid = bits.reshape(wx, wy, wz, 4, 4, 2).permute(0, 3, 1, 4, 2, 5)
    cx, cy, cz = cells
    return grid.reshape(4 * wx, 4 * wy, 2 * wz)[:cx, :cy, :cz].bool()


def pack_occupancy(occ: torch.Tensor) -> torch.Tensor:
    """:func:`pack_occupancy_plain` for a CPU tensor, the packing kernel
    (``raycast_cuda.pack_occupancy_cuda``) for a CUDA tensor."""
    if occ.device.type == "cpu":
        return pack_occupancy_plain(occ)
    return pack_occupancy_cuda(occ)


def box_exit_t(origin: torch.Tensor, dirs: torch.Tensor, lo, hi):
    """Per-ray slab test of the volume's box: (t_entry, t_exit);
    ``lo``/``hi`` (3,) float32 tensors."""
    safe = torch.where(torch.abs(dirs) > 1e-12, dirs,
                       torch.where(dirs >= 0, 1e-12, -1e-12))
    inv = torch.reciprocal(safe)
    t0 = (lo - origin) * inv
    t1 = (hi - origin) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return t_near, t_far


def march_params(spec: VolumeSpec, vol_origin, block: int,
                 fine_step: float) -> MarchParams:
    f32 = np.float32
    lo = np.asarray(vol_origin, f32).reshape(3)
    vox = f32(spec.voxel_size)
    hi = lo + np.asarray(spec.dims, f32) * vox
    return MarchParams(tuple(float(v) for v in lo),
                       tuple(float(v) for v in hi), float(vox),
                       float(vox * f32(fine_step)), float(vox * f32(block)),
                       float(f32(MARGIN_VOXELS) * vox))


def default_max_steps(spec: VolumeSpec, fine_step: float) -> int:
    """Enough fine steps to cross the volume diagonal (the JAX default)."""
    diag = float(np.linalg.norm(spec.dims))
    return int(np.ceil(diag / max(fine_step, 1e-3))) + 64


def raycast_plain(state: TSDFState, occ: torch.Tensor, rays: torch.Tensor,
                  origin: torch.Tensor, prm: MarchParams, dims, block: int,
                  max_steps: int, stats: dict | None = None):
    """The march of ``_raycast_impl`` on tensors. ``origin`` (3,) or
    (R, 3); the state in its storage dtype (each gathered sample is
    converted, the volume never). -> (range, label i32, remission,
    endpoints (R, 3), hit), each per ray. ``stats``, where given, gets
    what the march's data needs: the samples (``steps``, the seed sample
    included), those inside the box (occupancy reads), inside an occupied
    block (tsdf reads), the hits, ``sectors``, the distinct
    :data:`SECTOR`-byte sectors of each array that these reads, a hit's
    refinement corners and its label and remission touch (each counted
    once, however often it is read), and each ray's samples
    (``ray_samples``, (R,) int64, summing to ``steps``; their
    ``samples_max`` and ``samples_p99``: the kernel, a thread a ray, lasts
    as long as its longest ray)."""
    X, Y, Z = dims
    R = rays.shape[0]
    dev = rays.device
    origin = torch.broadcast_to(origin.reshape(-1, 3), (R, 3))
    tsdf_f, label_f, rem_f = (t.reshape(-1) for t in
                              (state.tsdf, state.label, state.rem))
    occ_f = occ.reshape(-1)
    oy, oz = occ.shape[1], occ.shape[2]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    lo, hi, vox = f32(prm.lo), f32(prm.hi), f32(prm.vox)
    dmax = torch.tensor([X - 1, Y - 1, Z - 1], device=dev)
    dmax2 = dmax - 1
    counts = dict(steps=0, inside=0, occupied=0)
    per_ray = torch.zeros(R, dtype=torch.int64, device=dev)
    arrays = dict(occupancy=occ_f, tsdf=tsdf_f, label=label_f,
                  remission=rem_f)
    touched = {} if stats is None else {
        k: torch.zeros(-(-a.numel() * a.element_size() // SECTOR),
                       dtype=torch.bool, device=dev)
        for k, a in arrays.items()}

    def touch(name, flat, mask):
        if name in touched:
            touched[name][flat[mask] * arrays[name].element_size()
                          // SECTOR] = True

    def grid(t):
        pos = origin + rays * t[:, None]
        return (pos - lo) / vox

    def sample(t, live):
        g = grid(t)
        gi = torch.floor(g).to(torch.int64)
        inside = ((gi >= 0) & (gi <= dmax)).all(dim=1)
        gic = torch.minimum(torch.clamp(gi, min=0), dmax)
        flat = (gic[:, 0] * Y + gic[:, 1]) * Z + gic[:, 2]
        ci = torch.div(gic, block, rounding_mode="floor")
        cflat = (ci[:, 0] * oy + ci[:, 1]) * oz + ci[:, 2]
        occ_here = inside & occ_f[cflat]
        val = torch.where(occ_here, tsdf_f[flat].to(torch.float32), 1.0)
        if stats is not None:
            per_ray.add_(live)
            counts["steps"] += int(live.sum())
            counts["inside"] += int((inside & live).sum())
            counts["occupied"] += int((occ_here & live).sum())
            touch("occupancy", cflat, inside & live)
            touch("tsdf", flat, occ_here & live)
        return val, occ_here, flat

    def trilinear(t):
        g = grid(t)
        gi = torch.minimum(torch.clamp(torch.floor(g).to(torch.int64),
                                       min=0), dmax2)
        f = torch.clamp(g - gi.to(torch.float32), 0.0, 1.0)
        base = (gi[:, 0] * Y + gi[:, 1]) * Z + gi[:, 2]
        acc = torch.zeros(R, dtype=torch.float32, device=dev)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = ((f[:, 0] if dx else 1.0 - f[:, 0])
                         * (f[:, 1] if dy else 1.0 - f[:, 1])
                         * (f[:, 2] if dz else 1.0 - f[:, 2]))
                    idx = base + (dx * Y + dy) * Z + dz
                    corner = tsdf_f[idx]
                    touch("tsdf", idx, hit)
                    acc = acc + w * corner.to(torch.float32)
        return acc

    t_near, t_far = box_exit_t(origin, rays, lo, hi)
    t_far = torch.clamp(t_far, max=T_FAR_MAX)
    t = torch.clamp(t_near, min=0.0) + 1e-4
    done = t > t_far
    prev_t = t
    prev_val, _, _ = sample(t, torch.ones_like(done))
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    hit_t = torch.zeros(R, dtype=torch.float32, device=dev)
    hit_lo, hit_hi = hit_t.clone(), hit_t.clone()
    hit_flat = torch.zeros(R, dtype=torch.int64, device=dev)
    for _ in range(max_steps):
        if bool(done.all()):
            break
        val, occ_here, flat = sample(t, ~done)
        crossing = (prev_val > 0.0) & (val <= 0.0) & ~done
        denom = prev_val - val
        frac = torch.where(denom > 1e-12, prev_val / denom, 0.5)
        t_hit = prev_t + (t - prev_t) * frac
        hit = hit | crossing
        hit_t = torch.where(crossing, t_hit, hit_t)
        hit_lo = torch.where(crossing, prev_t, hit_lo)
        hit_hi = torch.where(crossing, t, hit_hi)
        hit_flat = torch.where(crossing, flat, hit_flat)
        done = done | crossing | (t > t_far)
        dt = torch.where(occ_here, prm.dt_fine, prm.dt_coarse)
        prev_t, prev_val = t, val
        t = torch.where(done, t, t + dt)

    lo_t = torch.clamp(hit_lo - prm.margin, min=0.0)
    hi_t = hit_hi + prm.margin
    f_lo = trilinear(lo_t)
    f_hi = trilinear(hi_t)
    bracket_ok = (f_lo > 0.0) & (f_hi <= 0.0)
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo_t + hi_t)
        f_mid = trilinear(mid)
        same_side = (f_mid > 0.0) == (f_lo > 0.0)
        lo_t = torch.where(same_side, mid, lo_t)
        f_lo = torch.where(same_side, f_mid, f_lo)
        hi_t = torch.where(same_side, hi_t, mid)
    refined = 0.5 * (lo_t + hi_t)
    hit_t = torch.where(hit & bracket_ok, refined, hit_t)

    rng = torch.where(hit, hit_t, 0.0)
    lbl = torch.where(hit, label_f[hit_flat].to(torch.int32), 0)
    rem = torch.where(hit, rem_f[hit_flat].to(torch.float32), 0.0)
    ends = torch.where(hit[:, None], origin + rays * rng[:, None], 0.0)
    if stats is not None:
        touch("label", hit_flat, hit)
        touch("remission", hit_flat, hit)
        stats.update(counts, hits=int(hit.sum()), sectors={
            k: int(v.sum()) for k, v in touched.items()},
            ray_samples=per_ray, samples_max=int(per_ray.max()),
            samples_p99=int(torch.quantile(per_ray.double(), 0.99,
                                           interpolation="higher")))
    return rng, lbl, rem, ends, hit


def raymarch(state: TSDFState, occ: torch.Tensor, rays: torch.Tensor,
             origin: torch.Tensor, prm: MarchParams, dims, block: int,
             max_steps: int):
    """The march: :func:`raycast_plain` for CPU tensors, the kernel
    (``ops/raycast_cuda.raymarch_cuda``) for CUDA tensors, which raises for
    any other device. -> (range, label i32, remission, endpoints (R, 3),
    hit)."""
    if rays.device.type == "cpu":
        return raycast_plain(state, occ, rays, origin, prm, dims, block,
                             max_steps)
    return raymarch_cuda(state, occ, rays, origin, prm, dims, block,
                         max_steps)


def raycast_tsdf(state: TSDFState, spec: VolumeSpec, rays: torch.Tensor,
                 origin, H: int, W: int, *, occ: torch.Tensor | None = None,
                 block: int = 4, fine_step: float = 0.5,
                 max_steps: int | None = None,
                 vol_origin=None) -> RaycastResult:
    """March target-sensor rays through the fused TSDF volume.

    rays (H*W, 3) f32 unit directions (:func:`generate_rays`); origin (3,)
    shared or (H*W, 3) per ray; occ the coarse occupancy (default
    :func:`occupancy_grid` of the state); block the coarse step in voxels;
    fine_step the fine step in voxels; max_steps by default enough fine
    steps to cross the volume diagonal; vol_origin the volume's placement
    (default ``spec.origin``)."""
    if max_steps is None:
        max_steps = default_max_steps(spec, fine_step)
    if occ is None:
        occ = occupancy_grid(state.tsdf, block=block)
    dev = rays.device
    origin = torch.as_tensor(origin, dtype=torch.float32,
                             device=dev).contiguous()
    prm = march_params(spec, spec.origin if vol_origin is None
                       else vol_origin, block, fine_step)
    rng, lbl, rem, ends, hit = raymarch(state, occ, rays, origin, prm,
                                        spec.dims, block, max_steps)
    return RaycastResult(range=rng.reshape(H, W), label=lbl.reshape(H, W),
                         remission=rem.reshape(H, W),
                         endpoints=ends.reshape(H, W, 3),
                         hit=hit.reshape(H, W))
