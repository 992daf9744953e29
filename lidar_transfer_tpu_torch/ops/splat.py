"""Virtual-scan synthesis by truncation-band splatting (PyTorch).

Counterpart of ``lidar_transfer_tpu/ops/splat.py``:

  1. every source pixel spawns one band candidate behind its surface, with
     the tsdf value, label and remission the fused volume holds there:
     - ``_band_samples_image`` (``attrs="image"``, one fused image, the
       mergemesh adaption): the first of K half-voxel steps inside the
       (cropped) volume, attributed from the pixel itself;
     - ``_band_samples_fold`` (``attrs="fold"``, S images on one grid, the
       mesh adaption): the class-aware rule folded over the S aligned
       observations at each step, the first step in the folded band;
     - ``_band_samples`` (``attrs="volume"``): the first step whose voxel
       of the materialised volume lies in the band (tsdf <= 0);
     none of them reads more than K*HW voxels, and the first two read none;
  2. the candidates are z-buffered into the TARGET image
     (``_target_assemble``, kernel A on the card) and the winner's stored
     tsdf moves its depth onto the zero crossing:
     ``t_surface = t_sample + tsdf * trunc_margin``.

The upsampling chords (``interp``) are not ported yet (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lidar_transfer_tpu_torch.ops import projection as P

#: half-voxel band steps a source ray probes behind its surface
SAMPLES_PER_RAY = 8


def _target_assemble(pos, tsdf_v, label_v, rem_v, valid, fov_up_deg,
                     fov_down_deg, beam_angles, H, W, beam_rows, trunc):
    """Candidate z-buffer + winner-attribute fetch + zero-crossing output.

    The winners are ``range_project``'s (same ``_pixel_keys`` and
    z-buffer); candidates tie on exactly equal depth towards the lowest
    candidate index.
    Returns (range, label, remission, endpoints (H,W,3), mask), all (H,W).
    """
    P._check_beam_rows(beam_rows, beam_angles, H)
    pix, key, depth, uf, *_ = P._pixel_keys(
        pos, valid, fov_up_deg, fov_down_deg, beam_angles,
        H, W, beam_rows, "depth")
    win = P.zbuffer_winners(pix, key, H * W)
    has_flat = win >= 0
    g = torch.where(has_flat, win, 0).to(torch.int64)
    has = has_flat.reshape(H, W)
    pos_w = pos[g].reshape(H, W, 3)
    depth_w = depth[g].reshape(H, W)
    uf_w = uf[g].reshape(H, W)
    tsdf_w = tsdf_v[g].reshape(H, W)
    rem_w = rem_v[g].reshape(H, W)
    lbl_w = label_v[g].reshape(H, W)

    # zero-crossing correction along the (co-centred) target ray
    rng = torch.where(has, torch.clamp(
        depth_w + tsdf_w * float(np.float32(trunc)), min=0.0), 0.0)
    if beam_angles is not None:
        # rows are exact hardware beams: endpoints lie ON the beam
        # directions, not on the winning sample's source ray
        pitch = (-torch.sort(-beam_angles).values)[:, None]      # (H, 1)
        yaw = (uf_w / W * 2.0 - 1.0) * math.pi
        cp, sp = torch.cos(pitch), torch.sin(pitch)
        dirs = torch.stack([cp * torch.cos(-yaw), cp * torch.sin(-yaw),
                            sp.expand_as(yaw)], dim=-1)
        endpoints = dirs * rng[..., None]
    else:
        scale = torch.where(has & (depth_w > 0),
                            rng / torch.clamp(depth_w, min=1e-6), 0.0)
        endpoints = pos_w * scale[..., None]
    return (rng, torch.where(has, lbl_w, 0),
            torch.where(has, torch.clamp(rem_w, min=0.0), 0.0),
            endpoints, has)


def _band_samples_image(label_flat, rem_flat, rng_flat, pts_flat,
                        valid_flat, vol_origin, active_dims, voxel_size,
                        samples_per_ray, trunc_margin):
    """One band candidate per source pixel, attributed from the image.

    The candidate is the pixel's first half-voxel step (k + 0.5) * vox/2
    behind its surface whose voxel lies inside the active volume; its tsdf
    is -(that step)/trunc. Valid only when a single image was fused.
    ``vol_origin`` (3,) f32 and ``active_dims`` (3,) f32 tensors.
    Returns (pos (N,3), t (N,), tsdf (N,), label i32 (N,), rem (N,),
    valid (N,)).
    """
    vox = np.float32(voxel_size)
    trunc = float(np.float32(trunc_margin))
    step = np.float32(vox * np.float32(0.5))

    safe_rng = torch.clamp(rng_flat, min=1e-6)
    dirs = pts_flat / safe_rng[:, None]

    found = torch.zeros_like(valid_flat)
    kmin = torch.zeros_like(rng_flat)
    for k in range(samples_per_ray):
        kd = float(np.float32(k + 0.5) * step)
        pos_k = dirs * (rng_flat + kd)[:, None]
        gi = torch.round((pos_k - vol_origin[None, :]) / float(vox))
        inside = ((gi >= 0) & (gi < active_dims[None, :])).all(dim=1)
        kmin = torch.where(inside & ~found, float(k), kmin)
        found = found | inside

    kd = (kmin + 0.5) * float(step)
    t = rng_flat + kd
    pos = dirs * t[:, None]
    tsdf_v = -kd / trunc
    return (pos, t, tsdf_v, label_flat.to(torch.int32), rem_flat,
            valid_flat & found)


def _first_k(ok):
    """-> (kmin, found): the first k along dim 0 where ``ok`` holds."""
    found = ok.any(dim=0)
    kmin = torch.argmax(ok.to(torch.uint8), dim=0)
    return kmin, found


def _pick(a, kmin):
    """``a[kmin[i], i]`` along dim 0 (the chosen sample of each ray)."""
    return torch.gather(a, 0, kmin[None]).squeeze(0)


def _band_samples_fold(rng_s, pts_s, valid_s, label_s, rem_s, vol_origin,
                       active_dims, voxel_size, samples_per_ray,
                       trunc_margin):
    """Band candidates for S images fused on one spherical grid, with the
    class-aware collision semantics and no volume.

    Every scan is projected into the same grid, so a voxel's pixel is the
    same in all S images: the rule is folded over the S observations at
    each sample's own source pixel, elementwise over (K, S, HW). A sample
    is usable when its spawning pixel is valid, it lies in the active
    volume and the fold left it in the band (tsdf <= 0); each ray keeps
    its first usable k. Args: (S, HW) stacks and (S, HW, 3) points.
    Returns flat (S*HW,) candidate arrays (pos, t, tsdf, label, rem,
    found).
    """
    dev = rng_s.device
    vox = torch.tensor(np.float32(voxel_size), device=dev)
    trunc = torch.tensor(np.float32(trunc_margin), device=dev)
    step = vox * 0.5
    S, HW = rng_s.shape
    one = torch.tensor(1.0, device=dev)

    dirs = pts_s / torch.clamp(rng_s, min=1e-6)[..., None]   # (S, HW, 3)
    k = (torch.arange(samples_per_ray, dtype=torch.float32, device=dev)
         + 0.5) * step
    t = rng_s[None] + k[:, None, None]                        # (K, S, HW)
    pos = dirs[None] * t[..., None]                           # (K,S,HW,3)
    gi = torch.round((pos - vol_origin) / vox)
    inside = ((gi >= 0) & (gi < active_dims)).all(dim=-1)

    tsdf_f = torch.ones_like(t)
    weight_f = torch.zeros_like(t)
    label_f = torch.zeros_like(t)
    rem_f = torch.zeros_like(t)
    for sp in range(S):
        depth_val = rng_s[sp]                                  # (HW,)
        new_label = label_s[sp].to(torch.float32)
        new_rem = rem_s[sp]
        obs_ok = valid_s[sp] & (depth_val > 0.0)
        diff = depth_val - t
        dist = torch.clamp(diff / trunc, max=1.0)
        active = obs_ok & (diff >= -trunc)

        same = label_f == new_label
        w_new = weight_f + one
        tsdf_avg = (tsdf_f * weight_f + dist) / w_new
        rem_avg = (rem_f * weight_f + new_rem) / w_new
        upd_same = active & same
        upd_diff = active & ~same & (dist < weight_f)
        tsdf_f = torch.where(upd_same, tsdf_avg,
                             torch.where(upd_diff, dist, tsdf_f))
        label_f = torch.where(upd_diff, new_label, label_f)
        rem_f = torch.where(upd_same, rem_avg,
                            torch.where(upd_diff, new_rem, rem_f))
        weight_f = torch.where(upd_same, w_new, weight_f)

    ok = valid_s[None] & inside & (tsdf_f <= 0.0)
    kmin, found = _first_k(ok)
    t_c = _pick(t, kmin)
    pos_c = dirs * t_c[..., None]
    return (pos_c.reshape(-1, 3), t_c.reshape(-1),
            _pick(tsdf_f, kmin).reshape(-1),
            _pick(label_f, kmin).to(torch.int32).reshape(-1),
            _pick(rem_f, kmin).reshape(-1), found.reshape(-1))


def _band_samples(tsdf, label, rem, rng_flat, pts_flat, valid_flat,
                  vol_origin, active_dims, voxel_size, samples_per_ray,
                  label_probe: bool = False):
    """Band candidates probed in the materialised volume, one per ray.

    Each ray's K half-voxel steps behind its surface read the nearest
    voxel corner (``round``); a step is usable when inside the active
    volume and in the written band (tsdf <= 0), with ``label_probe`` also
    when its voxel's label is > 0. Each ray keeps its first usable k; the
    label (without ``label_probe``) and the remission are read there
    alone. The volume may be float32 or compact. Returns (pos (HW,3),
    t, tsdf, label i32, rem, found).
    """
    dev = rng_flat.device
    X, Y, Z = tsdf.shape
    vox = torch.tensor(np.float32(voxel_size), device=dev)
    dirs = pts_flat / torch.clamp(rng_flat, min=1e-6)[:, None]
    k = (torch.arange(samples_per_ray, dtype=torch.float32, device=dev)
         + 0.5) * (vox * 0.5)
    t = rng_flat[None, :] + k[:, None]                        # (K, HW)
    pos = dirs[None] * t[..., None]                           # (K, HW, 3)

    gi = torch.round((pos - vol_origin) / vox).to(torch.int64)
    inside = ((gi >= 0) & (gi < active_dims)).all(dim=-1)
    hi = torch.tensor([X - 1, Y - 1, Z - 1], device=dev)
    gic = torch.minimum(torch.clamp(gi, min=0), hi)
    flat = (gic[..., 0] * Y + gic[..., 1]) * Z + gic[..., 2]  # (K, HW)

    tsdf_v = tsdf.reshape(-1)[flat].to(torch.float32)
    ok = valid_flat[None] & inside & (tsdf_v <= 0.0)
    if label_probe:
        label_v = label.reshape(-1)[flat].to(torch.int32)
        ok = ok & (label_v > 0)
    kmin, found = _first_k(ok)
    t_c = _pick(t, kmin)
    flat_c = _pick(flat, kmin)
    label_c = (_pick(label_v, kmin) if label_probe
               else label.reshape(-1)[flat_c].to(torch.int32))
    rem_c = rem.reshape(-1)[flat_c].to(torch.float32)
    return (dirs * t_c[:, None], t_c, _pick(tsdf_v, kmin), label_c, rem_c,
            found)


def assemble_candidate_parts(parts, *, fov_up_deg, fov_down_deg,
                             beam_angles, target_H, target_W,
                             trunc: float):
    """Concatenate per-source candidate tuples (pos, t, tsdf, label, rem,
    valid) and z-buffer them into the target grid."""
    cat = [torch.cat([p[i] for p in parts]) for i in range(6)]
    pos, _, tsdf_v, label_v, rem_v, valid = cat
    return _target_assemble(
        pos, tsdf_v, label_v.to(torch.int32), rem_v.to(torch.float32),
        valid, fov_up_deg, fov_down_deg, beam_angles, target_H, target_W,
        beam_rows=beam_angles is not None, trunc=trunc)


def splat_synthesize(state, spec, sources, *, target_H: int,
                     target_W: int, fov_up_deg: float, fov_down_deg: float,
                     vol_origin, active_dims=None, beam_angles=None,
                     samples_per_ray: int = SAMPLES_PER_RAY,
                     attrs: str = "auto", label_probe: bool = False,
                     interp=None):
    """Synthesize a target-spec virtual scan from the fused sources.

    ``state``: the fused volume (read by ``attrs="volume"`` alone; None
    elsewhere). ``sources``: one (range_flat (HW,), points_flat (HW,3),
    valid (HW,), label_flat (HW,), rem_flat (HW,)) tuple per fused image.
    ``vol_origin`` / ``active_dims``: the volume placement, (3,) each.
    ``attrs``: "image", "fold", "volume" (see the module docstring), or
    "auto": "image" for one source, else "volume". ``label_probe``: the
    volume path's band test also needs label > 0 (``_band_samples``).
    Returns (range, label, remission, endpoints (H,W,3), mask).
    """
    if attrs == "auto":
        attrs = "image" if len(sources) == 1 else "volume"
    if attrs not in ("image", "fold", "volume"):
        raise ValueError(f"unknown attrs {attrs!r} (expected 'auto', "
                         "'image', 'fold' or 'volume')")
    if interp is not None:
        raise NotImplementedError(
            "upsampling chords (interp) are not ported yet (ROADMAP.md, "
            "queue 1)")
    device = sources[0][0].device
    vol_origin = torch.as_tensor(np.asarray(vol_origin, np.float32),
                                 device=device)
    if active_dims is None:
        active_dims = spec.dims
    active_f = torch.as_tensor(np.asarray(active_dims, np.float32),
                               device=device)
    kw = dict(voxel_size=spec.voxel_size, samples_per_ray=samples_per_ray)
    if attrs == "image":
        parts = [_band_samples_image(lf, rf, r, p, v, vol_origin, active_f,
                                     trunc_margin=spec.trunc_margin, **kw)
                 for (r, p, v, lf, rf) in sources]
    elif attrs == "fold":
        parts = [_band_samples_fold(
            *(torch.stack([src[i] for src in sources]) for i in range(5)),
            vol_origin, active_f, trunc_margin=spec.trunc_margin, **kw)]
    else:
        parts = [_band_samples(state.tsdf, state.label, state.rem, r, p, v,
                               vol_origin, active_f,
                               label_probe=label_probe, **kw)
                 for (r, p, v, _, _) in sources]
    return assemble_candidate_parts(
        parts, fov_up_deg=fov_up_deg, fov_down_deg=fov_down_deg,
        beam_angles=beam_angles, target_H=target_H, target_W=target_W,
        trunc=float(spec.trunc_margin))
