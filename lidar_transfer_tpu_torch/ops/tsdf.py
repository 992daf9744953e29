"""Class-aware TSDF fusion of range images into a voxel volume (PyTorch).

Counterpart of ``lidar_transfer_tpu/ops/tsdf.py``. :func:`integrate`,
:func:`integrate_chain` and :func:`precompute_geometry` are the plain
versions of the CUDA kernels (``ops/tsdf_cuda.py``). Every voxel projects
into the range image, reads one pixel and updates its own state: a
same-label observation averages in, a different label overwrites only where
``dist < weight`` (the reference kernel reads the weight as ``dist_old``, a
quirk both packages keep).

Where JAX donated the state buffers, the port updates the state tensors in
place and returns the same ``TSDFState``. A state is either float32
(f32/f32/i32/f32, 16 B/voxel) or compact (bf16/bf16/int16/bf16, 8 B/voxel);
either way the update computes in float32 and stores in the state's own
dtypes, rounding to nearest even.

Every scalar is a 0-dim tensor on the state's device, so each division is a
true IEEE division on the card too (PyTorch turns a division by a host
scalar into a multiplication by its reciprocal there); the kernel then
repeats this arithmetic exactly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from lidar_transfer_tpu_torch.ops.projection import fov_radians

#: storage dtypes of a float32 and of a compact state (tsdf, weight,
#: label, rem)
F32_DTYPES = (torch.float32, torch.float32, torch.int32, torch.float32)
COMPACT_DTYPES = (torch.bfloat16, torch.bfloat16, torch.int16,
                  torch.bfloat16)


class TSDFState(NamedTuple):
    """Volume state, four (X,Y,Z) tensors.

    tsdf (init 1), weight (init 0; doubles as dist_old in the class-aware
    rule), label (init 0), rem (init 0); dtypes ``F32_DTYPES`` or
    ``COMPACT_DTYPES``.
    """

    tsdf: torch.Tensor
    weight: torch.Tensor
    label: torch.Tensor
    rem: torch.Tensor


@dataclasses.dataclass(frozen=True)
class VolumeSpec:
    """Static geometry of a voxel volume."""

    origin: tuple[float, float, float]
    voxel_size: float
    dims: tuple[int, int, int]

    @classmethod
    def from_bounds(cls, bounds, voxel_size: float) -> "VolumeSpec":
        bounds = np.asarray(bounds, np.float64).reshape(3, 2)
        dims = np.ceil((bounds[:, 1] - bounds[:, 0]) / voxel_size
                       ).astype(int)
        return cls(origin=tuple(float(v) for v in bounds[:, 0]),
                   voxel_size=float(voxel_size),
                   dims=tuple(int(d) for d in dims))

    @property
    def trunc_margin(self) -> float:
        # 5 voxels, as the reference
        return self.voxel_size * 5.0

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.dims))

    def init_state(self, device="cpu", compact: bool = False) -> TSDFState:
        """A fresh state: float32 (16 B/voxel) or, with ``compact``,
        bf16/bf16/int16/bf16 (8 B/voxel)."""
        d = self.dims
        dt = COMPACT_DTYPES if compact else F32_DTYPES
        return TSDFState(
            tsdf=torch.ones(d, dtype=dt[0], device=device),
            weight=torch.zeros(d, dtype=dt[1], device=device),
            label=torch.zeros(d, dtype=dt[2], device=device),
            rem=torch.zeros(d, dtype=dt[3], device=device))

    def init_state_compact(self, device="cpu") -> TSDFState:
        return self.init_state(device, compact=True)


def state_dtypes(state: TSDFState) -> tuple[torch.dtype, ...]:
    """The state's dtypes; raises unless they are F32_DTYPES or
    COMPACT_DTYPES."""
    dts = tuple(t.dtype for t in state)
    if dts not in (F32_DTYPES, COMPACT_DTYPES):
        raise ValueError(f"TSDF state dtypes {dts} are neither float32 "
                         f"{F32_DTYPES} nor compact {COMPACT_DTYPES}")
    return dts


class IntegrateParams(NamedTuple):
    """Float32 scalars of one integrate, shared by the plain version and
    the kernel so both compute with the same values."""

    ox: float
    oy: float
    oz: float
    vox: float
    fov_up: float
    fov_down: float
    fov_down_abs: float
    fov: float
    pi: float
    trunc: float
    obs_weight: float
    active: tuple[int, int, int]


def integrate_params(spec: VolumeSpec, fov_up_deg, fov_down_deg,
                     obs_weight=1.0, origin=None,
                     active_dims=None) -> IntegrateParams:
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    origin = spec.origin if origin is None else origin
    ox, oy, oz = (f32(v) for v in np.asarray(origin, np.float32))
    active = spec.dims if active_dims is None else active_dims
    fov_up, fov_down, fov = fov_radians(fov_up_deg, fov_down_deg)
    return IntegrateParams(
        ox=ox, oy=oy, oz=oz, vox=f32(spec.voxel_size),
        fov_up=fov_up, fov_down=fov_down, fov_down_abs=abs(fov_down),
        fov=fov, pi=f32(np.pi), trunc=f32(spec.voxel_size * 5.0),
        obs_weight=f32(obs_weight),
        active=tuple(int(a) for a in np.asarray(active)))


def auto_x_chunk(dims: tuple[int, int, int],
                 slab_voxels: int = 1 << 26) -> int | None:
    """X-slab size bounding the plain version's temporaries (~64M voxels
    per slab). None = one slab (small volumes)."""
    X, Y, Z = dims
    if X * Y * Z <= slab_voxels:
        return None
    chunk = max(8, (slab_voxels // (Y * Z)) // 8 * 8)
    return int(min(chunk, X))


def _scalars(prm: IntegrateParams, dev) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(v, dtype=torch.float32, device=dev)
            for k, v in prm._asdict().items() if k != "active"}


def _voxel_positions(shape, gx0: int, c):
    """World positions of a slab's voxel corners, broadcastable
    (X,1,1)/(1,Y,1)/(1,1,Z), and the slab's global grid indices."""
    X, Y, Z = shape
    dev = c["ox"].device
    gx = torch.arange(gx0, gx0 + X, dtype=torch.float32, device=dev)
    gy = torch.arange(Y, dtype=torch.float32, device=dev)
    gz = torch.arange(Z, dtype=torch.float32, device=dev)
    px = (c["ox"] + gx * c["vox"])[:, None, None]
    py = (c["oy"] + gy * c["vox"])[None, :, None]
    pz = (c["oz"] + gz * c["vox"])[None, None, :]
    return px, py, pz, (gx, gy, gz)


def _voxel_rows(depth, pz, c, H: int):
    """-> (in_fov, image row) of every voxel from its pitch (the asin
    expression the kernels use)."""
    safe = torch.maximum(depth, torch.tensor(1e-12, device=depth.device))
    pitch = torch.asin(torch.clamp(pz / safe, -1.0, 1.0))
    in_fov = (pitch <= c["fov_up"]) & (pitch >= c["fov_down"])
    v = (1.0 - (pitch + c["fov_down_abs"]) / c["fov"]) * H
    return in_fov, torch.clamp(torch.floor(v), 0, H - 1).to(torch.int64)


def _integrate_block(block: TSDFState, images, prm: IntegrateParams,
                     gx0: int, reset: bool, write_weight: bool,
                     v_tab: torch.Tensor | None) -> None:
    """Fold the (depth, label, rem) images in order into one X-slab, in
    place; ``gx0`` is its first global x index. The f32 values are stored
    once, in the block's dtypes."""
    c = _scalars(prm, images[0][0].device)
    H, W = images[0][0].shape
    ax, ay, az = prm.active
    px, py, pz, (gx, gy, gz) = _voxel_positions(block.tsdf.shape, gx0, c)

    depth = torch.sqrt(px * px + py * py + pz * pz)
    yaw = -torch.atan2(py, px)                                  # (X,Y,1)
    u = 0.5 * (yaw / c["pi"] + 1.0) * W
    pix_x = torch.clamp(torch.floor(u), 0, W - 1).to(torch.int64)
    if v_tab is None:
        in_fov, pix_y = _voxel_rows(depth, pz, c, H)
    else:
        # the table's row (-1 = out of FOV) replaces the pitch math
        v_raw = v_tab.to(torch.int64)
        in_fov, pix_y = v_raw >= 0, torch.clamp(v_raw, min=0)
    flat = pix_y * W + pix_x
    in_crop = ((gx < ax)[:, None, None] & (gy < ay)[None, :, None]
               & (gz < az)[None, None, :])
    base = in_crop & in_fov

    if reset:
        # the prior state is the init constants: the buffers are only
        # written
        dev = depth.device
        tsdf_f = torch.tensor(1.0, device=dev)
        weight_f = torch.tensor(0.0, device=dev)
        rem_f = torch.tensor(0.0, device=dev)
        label_i = torch.tensor(0, dtype=torch.int32, device=dev)
    else:
        tsdf_f, weight_f, rem_f = (a.to(torch.float32) for a in
                                   (block.tsdf, block.weight, block.rem))
        label_i = block.label.to(torch.int32)

    for depth_im, label_im, rem_im in images:
        depth_val = depth_im.reshape(-1)[flat]
        new_label = label_im.reshape(-1)[flat]
        new_rem = rem_im.reshape(-1)[flat]

        depth_diff = depth_val - depth
        dist = torch.clamp(depth_diff / c["trunc"], max=1.0)
        active = base & (depth_val > 0) & (depth_diff >= -c["trunc"])

        same_class = label_i == new_label
        w_new = weight_f + c["obs_weight"]
        tsdf_avg = (tsdf_f * weight_f + dist) / w_new
        rem_avg = (rem_f * weight_f + new_rem) / w_new
        upd_same = active & same_class
        upd_diff = active & ~same_class & (dist < weight_f)

        tsdf_f = torch.where(upd_same, tsdf_avg,
                             torch.where(upd_diff, dist, tsdf_f))
        label_i = torch.where(upd_diff, new_label, label_i)
        rem_f = torch.where(upd_same, rem_avg,
                            torch.where(upd_diff, new_rem, rem_f))
        weight_f = torch.where(upd_same, w_new, weight_f)
    # copy_ converts to the storage dtype (bf16: round to nearest even)
    block.tsdf.copy_(tsdf_f)
    block.label.copy_(label_i)
    block.rem.copy_(rem_f)
    if write_weight:
        block.weight.copy_(weight_f)


def _check_images(images):
    H, W = images[0][0].shape
    for im in images:
        for t in im:
            if tuple(t.shape) != (H, W):
                raise ValueError(f"integrate: image shapes differ: "
                                 f"{tuple(t.shape)} != {(H, W)}")


def _run_slabs(state: TSDFState, spec: VolumeSpec, images, prm, *,
               x_chunk, reset, write_weight, x_offset, v_tab) -> TSDFState:
    state_dtypes(state)
    _check_images(images)
    if v_tab is not None and tuple(v_tab.shape) != tuple(spec.dims):
        raise ValueError(f"v_tab shape {tuple(v_tab.shape)} != spec dims "
                         f"{spec.dims}")
    X = spec.dims[0]
    if x_chunk == "auto":
        x_chunk = auto_x_chunk(spec.dims)
    step = X if x_chunk is None else x_chunk
    images = [(d, lb.to(torch.int32), r) for d, lb, r in images]
    for x0 in range(0, X, step):
        block = TSDFState(*(a[x0:x0 + step] for a in state))
        _integrate_block(block, images, prm, x_offset + x0, reset,
                         write_weight,
                         None if v_tab is None else v_tab[x0:x0 + step])
    return state


def integrate(state: TSDFState, spec: VolumeSpec, depth_im: torch.Tensor,
              label_im: torch.Tensor, rem_im: torch.Tensor, *,
              fov_up_deg, fov_down_deg, obs_weight: float = 1.0,
              origin=None, active_dims=None, x_chunk: int | None = "auto",
              reset: bool = False, write_weight: bool = True,
              x_offset: int = 0, v_tab: torch.Tensor | None = None
              ) -> TSDFState:
    """Fuse one range image into the volume, in place (plain version).

    Args:
      depth_im: (H,W) f32 range image, 0 = no data; label_im (H,W) i32;
        rem_im (H,W) f32.
      fov_up_deg / fov_down_deg: FOV of the image's sensor spec.
      origin: optional (3,) world origin (defaults to spec.origin).
      active_dims: optional (3,) crop; voxels at or above it are inert.
      reset: the prior state is the init constants (it is not read).
      write_weight: False leaves the weight tensor untouched (valid when
        no further integrate reads this state).
      x_offset: the state is the X-slab starting at this global x index of
        a volume whose ``origin`` is given; ``spec.dims`` is the slab's.
      v_tab: optional (X,Y,Z) int8 row table of this placement
        (:func:`precompute_geometry`; -1 = out of FOV), read instead of
        computing each voxel's pitch. The result is the same.
    """
    prm = integrate_params(spec, fov_up_deg, fov_down_deg, obs_weight,
                           origin, active_dims)
    return _run_slabs(state, spec, [(depth_im, label_im, rem_im)], prm,
                      x_chunk=x_chunk, reset=reset,
                      write_weight=write_weight, x_offset=x_offset,
                      v_tab=v_tab)


def integrate_chain(state: TSDFState, spec: VolumeSpec,
                    depth_ims: torch.Tensor, label_ims: torch.Tensor,
                    rem_ims: torch.Tensor, *, fov_up_deg, fov_down_deg,
                    obs_weight: float = 1.0, origin=None, active_dims=None,
                    x_chunk: int | None = "auto",
                    write_weight: bool = True, x_offset: int = 0,
                    v_tab: torch.Tensor | None = None) -> TSDFState:
    """Fuse S images, (S,H,W) stacks sharing one fov and origin, in order:
    the first onto the init constants (reset), each later one onto the
    running float32 values, and the state stored once in its own dtypes
    (plain version of the chain kernel; ``integrate_pallas_chain``).

    For a float32 state this equals S sequential :func:`integrate` calls,
    the first with ``reset``, bit for bit. For a compact state it is the
    float32 chain rounded once. The weight is carried through all S
    observations even when ``write_weight`` is False.
    """
    prm = integrate_params(spec, fov_up_deg, fov_down_deg, obs_weight,
                           origin, active_dims)
    images = list(zip(depth_ims, label_ims, rem_ims))
    if not images:
        raise ValueError("integrate_chain needs at least one image")
    return _run_slabs(state, spec, images, prm, x_chunk=x_chunk,
                      reset=True, write_weight=write_weight,
                      x_offset=x_offset, v_tab=v_tab)


def precompute_geometry(spec: VolumeSpec, fov_up_deg, fov_down_deg, H: int,
                        origin=None, device="cpu",
                        x_chunk: int | None = "auto") -> torch.Tensor:
    """(X,Y,Z) int8 image row of every voxel, -1 out of FOV, for a fixed
    placement of the volume (plain version of the geometry kernel;
    ``precompute_geometry`` of ``ops/tsdf_pallas.py``). It uses the asin
    expression of :func:`integrate`, so an integrate given this table
    equals one without it."""
    if H > 128:
        raise ValueError(f"the geometry table supports H <= 128, got {H}")
    c = _scalars(integrate_params(spec, fov_up_deg, fov_down_deg,
                                  origin=origin), device)
    out = torch.empty(spec.dims, dtype=torch.int8, device=device)
    X = spec.dims[0]
    if x_chunk == "auto":
        x_chunk = auto_x_chunk(spec.dims)
    step = X if x_chunk is None else x_chunk
    for x0 in range(0, X, step):
        blk = out[x0:x0 + step]
        px, py, pz, _ = _voxel_positions(blk.shape, x0, c)
        depth = torch.sqrt(px * px + py * py + pz * pz)
        in_fov, row = _voxel_rows(depth, pz, c, H)
        blk.copy_(torch.where(in_fov, row, -1))
    return out


# --- the decision rule of the fast geometry kernel (csrc/tsdf_geometry.cu)

#: pitches beyond this have no safe interval (tan grows without bound)
_EDGE_PITCH_CAP = 1.55
#: relative error of the kernel's estimate pz * rsqrtf(pxy) of tan(pitch),
#: pz the exact expression's own: rsqrtf 2 ulp, the product half an ulp,
#: the stored edge half an ulp, stated as 4 ulp
ESTIMATE_REL_ERR = 4 * 2.0 ** -23
#: absolute error of the estimate in units of the least distance of two
#: edges in tan space: away from the sensor a lane of the kernel takes its
#: 16 estimates as t0 + j * dt with dt at most that distance, 8 ulp of at
#: most 16 * dt
ESTIMATE_STEP_ERR = 16 * 8 * 2.0 ** -23
#: steps past the last interval a lane of the kernel can take
EDGE_PADDING = 16


def edge_min_gap(hi: np.ndarray) -> float:
    """The least distance of two edges between the caps, from the ``hi`` of
    :func:`geometry_edges`, as the kernel computes it; 0 with fewer than
    two edges."""
    gaps = np.diff(hi[1:-2].astype(np.float64))
    return float(gaps.min()) if gaps.size else 0.0


def estimate_walk_err(prm: IntegrateParams, Z: int, gap: float) -> float:
    """The absolute error in tan space of an estimate taken as t0 + j * dt
    in a column whose dt = vox / r_xy is at most ``gap``:
    ``ESTIMATE_STEP_ERR * gap`` for the sum itself, and for the roundings
    of the exact pz at the lane's first voxel and at this one (which the
    sum does not see) 2 ulp of the volume's largest |height| over r_xy,
    that is times ``gap / vox``."""
    oz, vox = np.float64(prm.oz), np.float64(prm.vox)
    top = max(abs(oz), abs(oz + Z * vox), Z * vox)
    return float((ESTIMATE_STEP_ERR
                  + 2.0 * np.spacing(np.float32(top)) / vox) * gap)


def geometry_edges(prm: IntegrateParams, H: int, Z: int):
    """The intervals of tan(pitch) on which the geometry table is constant,
    for the fast mode of the geometry kernel: -> (lo, hi, val), float32,
    float32 and int8 arrays of one entry an interval, in rising order.
    A voxel whose estimate t of tan(pitch) satisfies ``lo[i] < t < hi[i]``
    has the table value ``val[i]`` (its image row, -1 out of FOV) whatever
    the last bits of the exact expression do; between ``hi[i]`` and
    ``lo[i + 1]`` lies the guard band of an edge, where the exact
    expression decides.

    The edges are the H - 1 pitches where the row changes, the two FOV
    limits (tested on the pitch itself, so edges of their own) and the two
    caps at +-1.55 rad, beyond which nothing is safe; all from the float32
    scalars the exact expression uses, in float64. The band around an edge
    at pitch p, T = tan p: in pitch ``2.4e-7 * fov`` (the float32 roundings
    of the row expression) ``+ 4.8e-7`` (asin, 4 ulp) ``+ 2.4e-7 |T|`` (the
    exact ratio pz / depth) ``+ 4.8e-7 |T|`` (the estimate,
    ``ESTIMATE_REL_ERR``); in tan space that times ``1 + T * T``, plus
    :func:`estimate_walk_err` at the least distance of two edges (``Z``,
    the volume's height in voxels, enters there); the band is twice the
    sum; ``lo`` and ``hi`` are rounded away from their edges."""
    fov_up, fov_down, fda, fov = (float(v) for v in (
        prm.fov_up, prm.fov_down, prm.fov_down_abs, prm.fov))
    k = np.arange(1, H, dtype=np.float64)
    pitches = np.concatenate([fov * (1.0 - k / H) - fda, [fov_up, fov_down]])
    pitches = pitches[np.abs(pitches) < _EDGE_PITCH_CAP]
    pitches = np.unique(np.concatenate(
        [pitches, [-_EDGE_PITCH_CAP, _EDGE_PITCH_CAP]]))
    T = np.tan(pitches)
    delta = 2.4e-7 * fov + 4.8e-7 + (2.4e-7 + 4.8e-7) * np.abs(T)
    inner = np.diff(T[1:-1])
    step = estimate_walk_err(prm, Z,
                             1.1 * inner.min() if inner.size else 0.0)
    band = 2.0 * (delta * (1.0 + T * T) + step)
    up32 = lambda v: np.nextafter(  # noqa: E731
        v.astype(np.float32), np.float32(np.inf))
    down32 = lambda v: np.nextafter(  # noqa: E731
        v.astype(np.float32), np.float32(-np.inf))
    n = len(T) + 1
    lo = np.full(n, np.inf, np.float32)      # the outer two: never safe
    hi = np.full(n, np.inf, np.float32)
    lo[1:-1] = up32(T[:-1] + band[:-1])
    hi[:-1] = down32(T - band)
    mid = np.zeros(n)
    mid[1:-1] = 0.5 * (pitches[:-1] + pitches[1:])
    v = (1.0 - (mid + fda) / fov) * H
    row = np.clip(np.floor(v), 0, H - 1)
    val = np.where((mid <= fov_up) & (mid >= fov_down), row, -1)
    val[[0, -1]] = -1
    return lo, hi, val.astype(np.int8)


def geometry_by_rule(spec: VolumeSpec, fov_up_deg, fov_down_deg, H: int,
                     origin=None, perturb: torch.Tensor | None = None,
                     shift: torch.Tensor | None = None, walk: bool = False,
                     exact: torch.Tensor | None = None):
    """The fast geometry kernel's decision rule in plain PyTorch, for the
    tests: the estimate ``pz * rsqrt(pxy)`` against
    :func:`geometry_edges`, the exact expression
    (:func:`precompute_geometry`) wherever the estimate is not safely
    inside an interval. ``perturb``, an (X,Y,Z) float32 tensor of relative
    errors, is multiplied into the estimate as ``1 + perturb``; ``shift``,
    one of absolute errors, is added to it. ``walk`` takes the estimates
    as a lane of the kernel does where dt = vox / r_xy is at most the
    least distance of two edges: t0 + j * dt, one rounding, from the
    estimate t0 at the first of each 16 voxels along z. ``exact`` is
    :func:`precompute_geometry`'s table where the caller has it (two CPU
    runs of it may differ in the last bit of an asin, by how the threads
    split the volume).
    -> (the int8 table, the bool mask of voxels decided exactly)."""
    prm = integrate_params(spec, fov_up_deg, fov_down_deg, origin=origin)
    lo, hi, val = (torch.from_numpy(a)
                   for a in geometry_edges(prm, H, spec.dims[2]))
    c = _scalars(prm, "cpu")
    px, py, pz, _ = _voxel_positions(spec.dims, 0, c)
    rinv = torch.rsqrt(px * px + py * py)
    t = pz * rinv
    if walk:
        j = torch.arange(spec.dims[2]) % 16
        dt = c["vox"] * rinv
        t0 = pz[..., torch.arange(spec.dims[2]) - j] * rinv
        lane = (j.double() * dt.double() + t0.double()).float()
        t = torch.where(dt <= edge_min_gap(hi.numpy()), lane, t)
    if perturb is not None:
        t = t * (1.0 + perturb)
    if shift is not None:
        t = t + shift
    # the smallest i with t < hi[i]; a NaN estimate is safe nowhere
    i = torch.bucketize(torch.nan_to_num(t, nan=0.0), hi[:-1], right=True)
    safe = (t > lo[i]) & (t < hi[i])
    if exact is None:
        exact = precompute_geometry(spec, fov_up_deg, fov_down_deg, H,
                                    origin=origin)
    return torch.where(safe, val[i], exact), ~safe
