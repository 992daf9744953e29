"""Virtual-scan synthesis by truncation-band splatting, image path (PyTorch).

Counterpart of ``lidar_transfer_tpu/ops/splat.py`` for one fused image
(the mergemesh adaption, ``attrs="image"``):

  1. every source pixel spawns one band candidate: the first of K
     half-voxel steps behind its surface that lies in the (cropped) volume,
     with the tsdf value that step would hold and the pixel's own label and
     remission (``_band_samples_image``; no volume reads);
  2. the candidates are z-buffered into the TARGET image
     (``_target_assemble``, kernel A on the card) and the winner's stored
     tsdf moves its depth onto the zero crossing:
     ``t_surface = t_sample + tsdf * trunc_margin``.

The multi-image band attributes (``attrs="fold"`` / ``"volume"``) and the
upsampling chords (``interp``) are not ported yet (ROADMAP.md, queue 1).
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


def splat_synthesize(spec, sources, *, target_H: int, target_W: int,
                     fov_up_deg: float, fov_down_deg: float,
                     vol_origin, active_dims=None, beam_angles=None,
                     attrs: str = "auto", interp=None):
    """Synthesize a target-spec virtual scan from one fused source image.

    ``sources``: one (range_flat (HW,), points_flat (HW,3), valid (HW,),
    label_flat (HW,), rem_flat (HW,)) tuple. ``vol_origin`` /
    ``active_dims``: the volume placement, (3,) each. The JAX function's
    volume argument is not taken: this path never reads the volume.
    Returns (range, label, remission, endpoints (H,W,3), mask).
    """
    if attrs == "auto":
        attrs = "image" if len(sources) == 1 else "volume"
    if attrs != "image" or len(sources) != 1:
        raise NotImplementedError(
            f"splat_synthesize attrs={attrs!r} with {len(sources)} sources "
            "is not ported yet (ROADMAP.md, queue 1: the materialized "
            "volume and the mesh adaption)")
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
    r, p, v, lf, rf = sources[0]
    parts = [_band_samples_image(lf, rf, r, p, v, vol_origin, active_f,
                                 voxel_size=spec.voxel_size,
                                 samples_per_ray=SAMPLES_PER_RAY,
                                 trunc_margin=spec.trunc_margin)]
    return assemble_candidate_parts(
        parts, fov_up_deg=fov_up_deg, fov_down_deg=fov_down_deg,
        beam_angles=beam_angles, target_H=target_H, target_W=target_W,
        trunc=float(spec.trunc_margin))
