#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lidar_transfer_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the eight CUDA kernels from ``lidar_transfer_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and holds each against its plain PyTorch
   version on the card: the z-buffer bit-exact (without a workspace, and
   with one workspace through a sequence of image sizes and back, N = 0,
   all points invalid, all points in one pixel with equal keys), the
   confusion counts exact, the TSDF integrate (float32 and compact state,
   with and without the geometry table) and its S-scan chain (S=3,
   256x256x208) with label and weight equal on >= 1 - 1e-6 of
   voxels, float32 tsdf/rem within 1e-5 and compact ones within one bf16
   ulp, and 34 more integrate cases at 128x128xZ and 127x125xZ to the same
   limits (Z = 208, 200 and 13, which the vector width does not divide;
   images of 128 rows; S = 1, 2, 3, 4 and 6; carried mode with and without
   changes; an x_offset slab with active dims smaller than the dims; state
   arrays off their alignment; a column count the warps do not divide);
   the geometry table's rows equal on >= 1 - 1e-6 of voxels; the three
   probe kernels at 64x256x256 in every variant, int16 labels exact and
   bf16 outputs within one bf16 ulp, the writes exact
   (``kernel_checks``).
2. Drives each path at the reference operating point (HDL64 64x2048
   source, voxel 0.05 m, bounds +-50/+-50/+-5 m, fixed bounds), with the
   launch counts set to 0 just before it and read just after:
   - mergemesh, one scan per window: the CLI as identity (IoU/Acc/MSE
     through the confusion kernel), as HDL64 -> HDL32 per frame and with
     --stream 4, then ``TransferEngine.fused_state()`` on the 2048x2048x208
     float32 volume;
   - mesh, three scans per window: the CLI as identity and as HDL64 ->
     HDL32, and with --ply on one frame, then ``fused_state()`` (the
     S-scan chain with the geometry table) with a float32 and a compact
     volume;
   - cp: the CLI as identity (exact: IoU and Acc 1, MSE 0) and as
     HDL64 -> HDL32;
   - catmesh: the CLI as HDL64 -> HDL32, then ``fused_state()``;
   - upsampling, HDL64 -> HDL64x2 (128 beams, the same fov): the CLI per
     frame and with --stream 4;
   - the probes at 1024x1024x256 through ``probes.run`` (the rows of
     ``python -m lidar_transfer_tpu_torch.probes all``).
   Every kernel of a path must have launched in its run.
3. Checks the outputs: files written, the stream equal to the per-frame run,
   the card's virtual scans against the port's CPU run of the same frame
   (mergemesh, mesh, cp, upsampling), 16-plane X-slabs of the fused volumes
   against the plain integrate and the plain chain, a non-empty PLY, a cp
   identity transfer equal to the source projection bit for bit, catmesh's
   files and scan equal to mergemesh's bit for bit.
4. Times each kernel four ways: the wrapper's time (CUDA events around
   back-to-back calls), the device time (the summed durations of the device
   operations of one call, from a ``torch.profiler`` trace), its plain
   version, and where one PyTorch call computes the same function that
   call (``scatter_reduce_`` amin, ``bincount``, ``torch.full``: timed
   here, called by nothing in the port), beside its bound from
   ``probes/bounds.py``; every case of the integrate, its chain and the
   z-buffer (``probes/cases.py``); an empty kernel launch; transfer_fast
   per frame of every adaption, the stream rates, fused_state() and
   export_mesh(), each with the GPU's name and power limit; and profiles
   the frame of every adaption for its device time, device launches and
   idle share. Nothing of the earlier paths was cut to make room: the
   frame timings average 10 passes where they took 20.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON (route, source, the TPU kernel replaced, launches
in all and per frame of each path, the largest difference to the plain
version, wrapper, device, plain, library and bound ms and what bounds it),
the one before that the GPU's name and power limit. Any failed check
raises, and the exit code is then nonzero. Without a CUDA device it exits
with 1 at once. It fails if ``jax`` or the JAX package was imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
#: the reference operating point's volume bounds and HDL32 target
BOUNDS = ((-50.0, 50.0), (-50.0, 50.0), (-5.0, 5.0))
HDL32_PATH = os.path.join(REPO, "configs", "hdl32.yaml")
sys.path.insert(0, REPO)

from lidar_transfer_tpu_torch.probes.timing import (  # noqa: E402
    bf16_ulp, cuda_ms, device_ms, gpu_line, whole_trace)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def _compare_states(torch, a, b, what: str) -> float:
    """Hold state ``a`` (kernel) against ``b`` (plain): label and weight
    equal on >= 1 - 1e-6 of voxels; where labels agree, float32 tsdf/rem
    within 1e-5, compact ones within one bf16 ulp. -> max |tsdf|, |rem|
    difference."""
    n = a.label.numel()
    bad_l = int((a.label != b.label).sum())
    bad_w = int((a.weight != b.weight).sum())
    same = a.label == b.label
    compact = a.tsdf.dtype == torch.bfloat16
    worst = 0.0
    for f in ("tsdf", "rem"):
        x = getattr(a, f)[same].float()
        y = getattr(b, f)[same].float()
        d = (x - y).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        ok = (bool((d <= bf16_ulp(y)).all()) if compact
              else worst <= 1e-5)
        check(ok, f"{what}: {f} beyond " +
              ("one bf16 ulp" if compact else "1e-5"))
    print(f"{what}: label mismatches {bad_l}, weight mismatches {bad_w} "
          f"of {n}, max |tsdf|/|rem| {worst:g}")
    check(bad_l <= n * 1e-6 and bad_w <= n * 1e-6,
          f"{what}: label/weight mismatch above 1e-6")
    return worst


def _check_fusion_kernels(torch, rng, kernels) -> None:
    """Phase 1 for the chain, the compact state and the geometry table at
    256x256x208, S=3, against their plain versions."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_chain_cuda, integrate_cuda, precompute_geometry_cuda)

    dev = torch.device("cuda")
    spec = TS.VolumeSpec((-6.4, -6.4, -5.0), 0.05, (256, 256, 208))
    fov = dict(fov_up_deg=3.0, fov_down_deg=-25.0)
    S, H, W = 3, 64, 2048
    depth = (rng.uniform(1.0, 12.0, (S, H, W))
             * (rng.random((S, H, W)) > 0.2)).astype(np.float32)
    stacks = [torch.from_numpy(a).to(dev) for a in (
        depth, rng.integers(0, 4, (S, H, W)).astype(np.int32),
        rng.random((S, H, W)).astype(np.float32))]

    table = precompute_geometry_cuda(spec, 3.0, -25.0, H, device=dev)
    plain = TS.precompute_geometry(spec, 3.0, -25.0, H, device=dev)
    torch.cuda.synchronize()
    bad = int((table != plain).sum())
    row_err = int((table.int() - plain.int()).abs().max())
    print(f"geometry table {spec.dims}: row mismatches {bad} of "
          f"{table.numel()}, max |row diff| {row_err}, in FOV "
          f"{float((plain >= 0).float().mean()):.4f}")
    check(bad <= table.numel() * 1e-6, "geometry table != plain table")
    kernels["tsdf_geometry"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/tsdf_geometry.cu",
        replaces="lidar_transfer_tpu/ops/tsdf_pallas.py:436",
        max_abs_err=row_err)

    worst = 0.0
    for compact in (False, True):
        for v_tab in (None, table):
            what = (f"chain S={S} {spec.dims} "
                    f"{'compact' if compact else 'f32'} table="
                    f"{v_tab is not None}")
            a = integrate_chain_cuda(spec.init_state(dev, compact), spec,
                                     *stacks, v_tab=v_tab, **fov)
            b = TS.integrate_chain(spec.init_state(dev, compact), spec,
                                   *stacks, v_tab=v_tab, **fov)
            torch.cuda.synchronize()
            worst = max(worst, _compare_states(torch, a, b, what))
            del a, b
        # the single integrate, compact, with the table, reset and carried
        prior = TS.integrate_chain(spec.init_state(dev, compact), spec,
                                   *stacks, **fov)
        for reset in (True, False):
            one = [t[0] for t in stacks]
            a = integrate_cuda(TS.TSDFState(*(t.clone() for t in prior)),
                               spec, *one, reset=reset, v_tab=table, **fov)
            b = TS.integrate(TS.TSDFState(*(t.clone() for t in prior)),
                             spec, *one, reset=reset, **fov)
            torch.cuda.synchronize()
            _compare_states(torch, a, b, f"integrate table=True "
                            f"{'compact' if compact else 'f32'} "
                            f"reset={reset} (plain without the table)")
            del a, b
        del prior
    kernels["tsdf_integrate_chain"] = dict(
        route="cuda",
        source="lidar_transfer_tpu_torch/csrc/tsdf_integrate.cu",
        replaces="lidar_transfer_tpu/ops/tsdf_pallas.py:667",
        max_abs_err=worst)


def _check_probe_kernels(torch, rng, kernels) -> None:
    """Phase 1 for the three probe kernels at 64x256x256, every variant
    against its plain version: int16 labels exact, bf16 outputs within one
    bf16 ulp, the writes exact."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import \
        precompute_geometry_cuda
    from lidar_transfer_tpu_torch.probes import ablate, parts, write
    from lidar_transfer_tpu_torch.probes.timing import max_diff

    dev = torch.device("cuda")
    dims = X, Y, Z = 64, 256, 256
    # parts: a placement whose voxels lie in FOV and in the band of the
    # random depths, labels 0..19 in the packed column (the script's own
    # placement leaves every voxel behind its 0-1 m depths)
    params = np.zeros((2, 8), np.float32)
    params[0, :5] = (3.0, -6.4, -1.6, 0.05, -0.44)
    cols = [(rng.random((X, parts.CW, Y)) * s).astype(np.float32)
            for s in (8.0, 16384.0 * 20)]
    args = [torch.from_numpy(a).to(dev) for a in (params, *cols)]
    worst = 0.0
    for variant in parts.VARIANTS:
        for n_out in (1, 3):
            ref = parts.parts_plain(variant, *args, Z=Z, n_out=n_out)
            for bx in (2, 4, 8):
                worst = max(worst, max_diff(
                    parts.probe_parts(variant, *args, Z=Z, n_out=n_out,
                                      BX=bx), ref,
                    f"probe_parts {variant} x{n_out} BX{bx}"))
    upd = ref[0] < 1                                 # full, three outputs
    print(f"probe_parts {dims}: 4 variants x 1/3 outputs x BX 2/4/8 equal "
          f"to plain, max |diff| {worst:g}; full updates "
          f"{float(upd.float().mean()):.4f} of voxels, "
          f"{int(torch.unique(ref[1][upd]).numel())} labels")
    check(0.001 < float(upd.float().mean()) < 0.9, "probe_parts updates "
          "no share of the voxels")
    kernels["probe_parts"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/probe_parts.cu",
        replaces="scripts/probe_kernel_parts.py:94", max_abs_err=worst)

    # ablate: depths 13-19 m around a volume 14 m out, labels 0..19 (0
    # takes the same-class branch), a crop short of the dims
    origin = (14.0, -6.4, -6.4)
    spec = TS.VolumeSpec(origin, 0.05, dims)
    imgs = [torch.from_numpy(a).to(dev) for a in (
        (rng.random((64, 2048)) * 6 + 13).astype(np.float32),
        rng.integers(0, 20, (64, 2048)).astype(np.int32),
        rng.random((64, 2048)).astype(np.float32))]
    table = precompute_geometry_cuda(spec, 3.0, -25.0, 64, device=dev)
    dcol, lrcol = ablate.build_cols(*imgs, dims, origin)
    args = (ablate.ablate_params(origin, (60, 250, 200), dev), dcol, lrcol,
            table)
    worst = 0.0
    for div in (True, False):
        ref = ablate.ablate_plain(div, *args)
        for bx in (1, 2, 4):
            worst = max(worst, max_diff(
                ablate.probe_ablate(div, *args, BX=bx), ref,
                f"probe_ablate div={div} BX{bx}"))
    upd = ref[0] < 1
    print(f"probe_ablate {dims}: precols and nodiv x BX 1/2/4 equal to "
          f"plain, max |diff| {worst:g}; updates "
          f"{float(upd.float().mean()):.4f} of voxels, same-class "
          f"{float((upd & (ref[1] == 0)).float().mean()):.4f}")
    check(0.001 < float(upd.float().mean()) < 0.9, "probe_ablate updates "
          "no share of the voxels")
    kernels["probe_ablate"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/probe_ablate.cu",
        replaces="scripts/probe_integrate_ablate.py:53", max_abs_err=worst)

    # write: blocks, dtypes, three outputs, flat rows, reading first, and
    # probe_alias's modes, over old contents of 7
    n = 0
    for dts, block in (
            ([torch.bfloat16], dict(BX=1, BY=256)),
            ([torch.bfloat16], dict(BX=2, BY=128)),
            ([torch.float32], dict(BX=4, BY=256)),
            ([torch.int32], dict(BX=4, BY=256)),
            ([torch.int8], dict(BX=4, BY=256)),
            ([torch.int16], dict(BX=8, BY=64)),
            ([torch.bfloat16] * 3, dict(BX=2, BY=256)),
            (write.ALIAS_DTYPES, dict(BX=2, BY=256, read_first=True)),
            ([torch.bfloat16], dict(BR=256)),
            ([torch.bfloat16], dict(BR=1024))):
        got = write.probe_write([torch.full(dims, 7, dtype=dt, device=dev)
                                 for dt in dts], **block)
        ref = write.write_plain([torch.empty(dims, dtype=dt, device=dev)
                                 for dt in dts])
        max_diff(got, ref, f"probe_write {dts} {block}")
        n += 1
    for mode in write.ALIAS_MODES:
        state = [torch.full(dims, 7, dtype=dt, device=dev)
                 for dt in write.ALIAS_DTYPES + (torch.bfloat16,)]
        out = write.alias_call(mode, state, BX=2, BY=256)
        max_diff(out[:3], write.write_plain(
            [torch.empty_like(t) for t in state[:3]]), f"alias {mode}")
        check(len(out) == (4 if mode == "alias_any4" else 3)
              and (mode == "noalias") != (out[0] is state[0]),
              f"alias {mode}: outputs not arranged as the mode says")
        n += 1
    print(f"probe_write {dims}: {n} block, dtype, row and alias cases "
          "equal to the plain fill")
    kernels["probe_write"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/probe_write.cu",
        replaces="scripts/probe_pallas_write.py:40", max_abs_err=0.0)


def _check_integrate_cases(torch, rng) -> float:
    """Phase 1 for the integrate's vector and scalar variants at 128x128xZ
    and 127x125xZ (a last warp with fewer columns; with Z = 13 a last run
    that ends inside a vector, which takes the scalar variant as the state
    arrays off their alignment do): a Z the vector width divides (208, 200)
    and one it does not (13), images of 64 and 128 rows, S = 1, 2 and 4 (compiled in) and 6 (read at
    run time), carried mode with and without changes, an x_offset slab
    with active dims smaller than the dims, state arrays off 16-byte
    alignment; float32 and compact, table and none. -> the largest tsdf/rem difference."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_chain_cuda, integrate_cuda, precompute_geometry_cuda)

    dev = torch.device("cuda")
    fov = dict(fov_up_deg=3.0, fov_down_deg=-25.0)
    W = 2048

    def images(S, H, empty=False):
        depth = (rng.uniform(0.8, 5.0, (S, H, W))
                 * (rng.random((S, H, W)) > (1.0 if empty else 0.2)))
        return [torch.from_numpy(a).to(dev) for a in (
            depth.astype(np.float32),
            rng.integers(0, 4, (S, H, W)).astype(np.int32),
            rng.random((S, H, W)).astype(np.float32))]

    def prior(dims, compact, misalign):
        gen = torch.Generator(device=dev).manual_seed(1)
        vals = (torch.rand(dims, device=dev, generator=gen) * 2 - 1,
                torch.randint(0, 3, dims, device=dev, generator=gen).float(),
                torch.randint(0, 4, dims, device=dev, generator=gen,
                              dtype=torch.int32),
                torch.rand(dims, device=dev, generator=gen))
        dts = TS.COMPACT_DTYPES if compact else TS.F32_DTYPES
        out = []
        for v, dt in zip(vals, dts):
            n = v.numel()
            flat = torch.empty(n + 1, dtype=dt, device=dev)
            t = flat[1:] if misalign else flat[:n]   # 2 or 4 bytes off
            t.copy_(v.reshape(-1).to(dt))
            out.append(t.view(dims))
        return TS.TSDFState(*out)

    # (Z, H, S, compact, table, mode, slab, misalign)
    cases = [(208, 64, 1, c, t, m, False, False)
             for c in (False, True) for t in (False, True)
             for m in ("reset", "carried")]
    cases += [
        (208, 64, 2, False, True, "chain", False, False),
        (208, 64, 4, True, True, "chain", False, False),
        (208, 128, 4, True, False, "chain", False, False),
        (208, 128, 6, False, True, "chain", False, False),
        (208, 128, 1, True, True, "reset", False, False),
        (200, 64, 1, True, True, "reset", False, False),
        (200, 64, 4, True, False, "chain", False, False),
        (200, 64, 1, False, True, "carried", False, False),
        (13, 64, 1, False, True, "reset", False, False),
        (13, 64, 2, True, True, "chain", False, False),
        (13, 128, 1, True, False, "carried", False, False),
        (208, 64, 1, True, True, "unchanged", False, False),
        (208, 64, 1, False, False, "unchanged", False, False),
        (208, 64, 1, True, True, "reset", True, False),
        (208, 64, 1, False, True, "carried", True, False),
        (208, 64, 2, True, False, "chain", True, False),
        (208, 64, 1, True, True, "carried", False, True),
        (208, 64, 2, False, True, "chain", False, True),
        (13, 64, 1, True, False, "reset", False, True),
        (208, 128, 6, True, True, "chain", False, True)]
    cases = [c + (False,) for c in cases] + [
        (208, 64, 1, True, True, "reset", False, False, True),
        (208, 64, 3, False, False, "chain", False, False, True),
        (208, 64, 1, False, True, "carried", False, False, True),
        (13, 64, 1, True, True, "reset", False, False, True),
        (13, 64, 1, False, False, "carried", False, False, True),
        (13, 64, 3, True, True, "chain", False, False, True)]
    worst, tables = 0.0, {}
    for Z, H, S, compact, table, mode, slab, misalign, odd in cases:
        X, Y = (127, 125) if odd else (128, 128)
        oz = -0.35 if Z == 13 else -5.0
        full = TS.VolumeSpec((-3.2, -3.2, oz), 0.05, (X, Y, Z))
        x0, xs = (40, 16) if slab else (0, X)
        spec = TS.VolumeSpec(full.origin, 0.05, (xs, Y, Z))
        active = (100, 120, max(Z - 8, 1)) if slab else None
        if (X, Z, H) not in tables:
            tables[X, Z, H] = precompute_geometry_cuda(full, 3.0, -25.0, H,
                                                       device=dev)
        v_tab = tables[X, Z, H][x0:x0 + xs] if table else None
        imgs = images(S, H, empty=mode == "unchanged")
        kw = dict(origin=full.origin, active_dims=active, x_offset=x0,
                  **fov)
        start = prior(spec.dims, compact, misalign)
        a = TS.TSDFState(*(t.clone() if not misalign else t for t in start))
        b = TS.TSDFState(*(t.clone() for t in start))
        if mode == "chain":
            a = integrate_chain_cuda(a, spec, *imgs, v_tab=v_tab, **kw)
            b = TS.integrate_chain(b, spec, *imgs, **kw)
        else:
            one = [t[0] for t in imgs]
            a = integrate_cuda(a, spec, *one, reset=mode == "reset",
                               v_tab=v_tab, **kw)
            b = TS.integrate(b, spec, *one, reset=mode == "reset", **kw)
        torch.cuda.synchronize()
        what = (f"integrate case Z={Z} H={H} S={S} "
                f"{'compact' if compact else 'f32'} table={table} {mode}"
                f"{' slab x=40..55, active (100,120,Z-8)' if slab else ''}"
                f"{' misaligned' if misalign else ''}"
                f"{' 127x125 columns' if odd else ''}")
        worst = max(worst, _compare_states(torch, a, b, what))
        ref0 = prior(spec.dims, compact, False)
        moved = float(((b.tsdf != ref0.tsdf) | (b.label != ref0.label))
                      .float().mean())
        if mode == "unchanged":
            check(moved == 0.0, f"{what}: empty images changed the state")
        else:
            check(moved > 1e-3, f"{what}: the images change no share of "
                  f"the voxels ({moved:g})")
    print(f"integrate cases: {len(cases)} equal to their plain versions, "
          f"max |tsdf|/|rem| difference {worst:g}")
    return worst


def _check_zbuffer_cases(torch, rng) -> None:
    """Phase 1 for the z-buffer's workspace, bit for bit against the plain
    version: one workspace through a sequence of image sizes and back,
    N = 0, all points invalid, all points in one pixel with equal keys; no scratch allocated beyond the sizes' growth."""
    from lidar_transfer_tpu_torch.ops import projection as TP

    dev = torch.device("cuda")

    def inputs(n, npix, kind):
        pix = rng.integers(0, npix, n).astype(np.int32)
        key = rng.uniform(1.0, 80.0, n).astype(np.float32)
        if kind == "random" and n:
            tie = rng.integers(0, n - 1, n // 5)
            pix[tie + 1], key[tie + 1] = pix[tie], key[tie]
            pix[rng.random(n) < 0.1] = npix
        elif kind == "invalid":
            pix[:] = npix
            pix[::3] = npix + 5
        elif kind == "one pixel":
            pix[:], key[:] = npix // 2, 7.5
        return torch.from_numpy(pix).to(dev), torch.from_numpy(key).to(dev)

    seq = [(64 * 2048, 139264, "random"), (32 * 2048, 70000, "random"),
           (128 * 2048, 300000, "random"), (64 * 2048, 0, "random"),
           (64 * 2048, 139264, "invalid"), (64 * 2048, 139264, "one pixel"),
           (32 * 2048, 70000, "random"), (64 * 2048, 139264, "random")]
    ws = TP.ZBufferWorkspace(dev)
    for npix, n, kind in seq:
        pix, key = inputs(n, npix, kind)
        got = TP.zbuffer_winners(pix, key, npix, workspace=ws)
        ref = TP.zbuffer_winners_plain(pix, key, npix)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"zbuffer workspace npix={npix} N={n} "
              f"{kind} != plain")
        if kind == "one pixel":
            check(int(got[npix // 2]) == 0 and int((got >= 0).sum()) == 1,
                  "zbuffer: equal keys must go to the lowest index")
    check(ws.allocations == 2, f"zbuffer workspace allocated "
          f"{ws.allocations} times for two growths")
    print(f"zbuffer workspace: {len(seq)} calls through 64/32/128/64x2048 "
          "pixels, N = 0, all invalid, one pixel with equal keys: equal to "
          f"plain, {ws.allocations} scratch allocations")


def _library_times(torch, pix_t, key_t, npix, pred_t, tgt_t, C):
    """One PyTorch call that computes the z-buffer's and the confusion's
    function on inputs prepared beforehand (the packed words; the cell
    indices): timed here as a yardstick, called by nothing in the port.
    -> (z-buffer ms, confusion ms), each checked against the kernel's
    result."""
    from lidar_transfer_tpu_torch.metrics import confusion as TF
    from lidar_transfer_tpu_torch.ops import projection as TP

    n = pix_t.shape[0]
    words = ((key_t.view(torch.int32).to(torch.int64) << 32)
             | torch.arange(n, device=pix_t.device))
    where = torch.where((pix_t < 0) | (pix_t >= npix), npix,
                        pix_t).to(torch.int64)         # npix: the overflow
    empty = torch.iinfo(torch.int64).max
    buf = torch.full((npix + 1,), empty, dtype=torch.int64,
                     device=pix_t.device)
    z_ms = cuda_ms(lambda: buf.scatter_reduce_(0, where, words, "amin"),
                   200)
    win = torch.where(buf[:npix] == empty, -1,
                      buf[:npix] & 0xFFFFFFFF).to(torch.int32)
    check(torch.equal(win, TP.zbuffer_winners(pix_t, key_t, npix)),
          "scatter_reduce_ amin != z-buffer kernel")
    ok = (pred_t >= 0) & (pred_t < C) & (tgt_t >= 0) & (tgt_t < C)
    ref = TF.confusion_matrix(pred_t, tgt_t, C)
    # the layout of the kernel's counts is found from its result
    for cells in ((tgt_t * C + pred_t)[ok].to(torch.int64),
                  (pred_t * C + tgt_t)[ok].to(torch.int64)):
        if torch.equal(torch.bincount(cells, minlength=C * C).reshape(C, C)
                       .to(ref.dtype), ref):
            break
    else:
        check(False, "bincount != confusion kernel")
    c_ms = cuda_ms(lambda: torch.bincount(cells, minlength=C * C), 200)
    return z_ms, c_ms


def kernel_checks(torch, kernels) -> tuple:
    """Phase 1: build the kernels and hold each against its plain version
    on the card, filling ``kernels`` with a row each. -> the z-buffer's and
    the confusion's inputs (pix, key, npix, pred, target, C), which phase 4
    times."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.metrics import confusion as TF
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    rng = np.random.default_rng(0)

    # ---------------------------------------------------- 1. kernel checks
    n, npix = 139264, 64 * 2048
    pix = rng.integers(0, npix, n).astype(np.int32)
    key = rng.uniform(1.0, 80.0, n).astype(np.float32)
    tie = rng.integers(0, n - 1, n // 5)
    pix[tie + 1], key[tie + 1] = pix[tie], key[tie]      # exact-key ties
    pix[rng.random(n) < 0.1] = npix                      # invalid points
    pix_t = torch.from_numpy(pix).to(dev)
    key_t = torch.from_numpy(key).to(dev)
    got = TP.zbuffer_winners(pix_t, key_t, npix)
    ref = TP.zbuffer_winners_plain(pix_t, key_t, npix)
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    print(f"zbuffer N={n} npix={npix}: mismatches "
          f"{int((got != ref).sum())}, winners {int((ref >= 0).sum())}")
    check(torch.equal(got, ref), "zbuffer kernel != plain (bit-exact)")
    kernels["zbuffer"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/zbuffer.cu",
        replaces="lidar_transfer_tpu/ops/projection.py:209",
        max_abs_err=err)
    _check_zbuffer_cases(torch, rng)

    m, C = 131072, 260
    pred = rng.choice([0, 10, 40, 48, 50, 70, 252], m).astype(np.int32)
    tgt = np.where(rng.random(m) < 0.8, pred,
                   rng.integers(-3, C + 3, m)).astype(np.int32)
    pred[rng.random(m) < 0.02] = -1
    pred_t = torch.from_numpy(pred).to(dev)
    tgt_t = torch.from_numpy(tgt).to(dev)
    got = TF.confusion_matrix(pred_t, tgt_t, C)
    ref = TF.confusion_scatter(pred_t, tgt_t, C)
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    print(f"confusion N={m} C={C}: total {int(got.sum())} "
          f"(plain {int(ref.sum())}), max |diff| {err}")
    check(torch.equal(got, ref), "confusion kernel != plain (exact)")
    kernels["confusion"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/confusion.cu",
        replaces="lidar_transfer_tpu/metrics/confusion.py:73",
        max_abs_err=err)

    spec = TS.VolumeSpec((-6.4, -6.4, -5.0), 0.05, (256, 256, 208))
    depth = (rng.uniform(1.0, 12.0, (64, 2048))
             * (rng.random((64, 2048)) > 0.2)).astype(np.float32)
    imgs = [torch.from_numpy(a).to(dev) for a in (
        depth, rng.integers(0, 30, (64, 2048)).astype(np.int32),
        rng.random((64, 2048)).astype(np.float32))]
    gen = torch.Generator(device=dev).manual_seed(0)
    prior = TS.TSDFState(
        tsdf=torch.rand(spec.dims, device=dev, generator=gen) * 2 - 1,
        weight=torch.randint(0, 3, spec.dims, device=dev,
                             generator=gen).float(),
        label=torch.randint(0, 30, spec.dims, device=dev, generator=gen,
                            dtype=torch.int32),
        rem=torch.rand(spec.dims, device=dev, generator=gen))
    worst = 0.0
    for reset in (True, False):
        for write_weight in (True, False):
            kw = dict(fov_up_deg=3.0, fov_down_deg=-25.0, reset=reset,
                      write_weight=write_weight)
            a = integrate_cuda(TS.TSDFState(*(t.clone() for t in prior)),
                               spec, *imgs, **kw)
            b = TS.integrate(TS.TSDFState(*(t.clone() for t in prior)),
                             spec, *imgs, **kw)
            torch.cuda.synchronize()
            worst = max(worst, _compare_states(
                torch, a, b, f"integrate {spec.dims} reset={reset} "
                f"write_weight={write_weight}"))
            del a, b
    del prior
    worst = max(worst, _check_integrate_cases(torch, rng))
    kernels["tsdf_integrate"] = dict(
        route="cuda",
        source="lidar_transfer_tpu_torch/csrc/tsdf_integrate.cu",
        replaces="lidar_transfer_tpu/ops/tsdf_pallas.py:372",
        max_abs_err=worst)
    _check_fusion_kernels(torch, rng, kernels)
    _check_probe_kernels(torch, rng, kernels)
    return pix_t, key_t, npix, pred_t, tgt_t, C


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from lidar_transfer_tpu_torch.metrics import confusion as TF
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.probes import bounds

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu)
    tag = f"[{gpu}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    kernels = {}
    pix_t, key_t, npix, pred_t, tgt_t, C = kernel_checks(torch, kernels)
    n, m = pix_t.shape[0], pred_t.shape[0]

    # ------------------------- 4a. the two small kernels, timed four ways
    ws = TP.ZBufferWorkspace(dev)
    zb = bounds.zbuffer(n, npix)
    z_lib, c_lib = _library_times(torch, pix_t, key_t, npix, pred_t, tgt_t,
                                  C)
    call = lambda: TP.zbuffer_winners(pix_t, key_t, npix,  # noqa: E731
                                      workspace=ws)
    z_dev, z_ops, z_names = device_ms(call, 50)
    kernels["zbuffer"].update(
        ms=cuda_ms(call, 200), device_ms=z_dev,
        plain_ms=cuda_ms(lambda: TP.zbuffer_winners_plain(
            pix_t, key_t, npix), 50),
        bound_ms=zb.ms, bound_by=zb.by, library_ms=z_lib)
    print(f"zbuffer with the engine's workspace: {z_ops:.1f} device "
          f"operations a call ({z_names}), {ws.allocations} scratch "
          f"allocation in {2 + 50 + 2 + 200} calls {tag}")
    check(z_ops <= 2 and ws.allocations == 1, "a z-buffer call with a "
          "workspace issues more than two device operations or allocates")
    cb = bounds.confusion(m, C)
    call = lambda: TF.confusion_matrix(pred_t, tgt_t, C)  # noqa: E731
    kernels["confusion"].update(
        ms=cuda_ms(call, 200), device_ms=device_ms(call, 50)[0],
        plain_ms=cuda_ms(lambda: TF.confusion_scatter(pred_t, tgt_t, C),
                         50),
        bound_ms=cb.ms, bound_by=cb.by, library_ms=c_lib)

    # ------------------------------------------------------ 2. the paths
    paths, per_frame = {}, {}
    with tempfile.TemporaryDirectory(prefix="lt_smoke_") as work:
        paths["mergemesh"] = _main_path(torch, work, kernels, tag, per_frame)
        torch.cuda.empty_cache()
        paths["mesh"] = _mesh_path(torch, work, kernels, tag, per_frame)
        torch.cuda.empty_cache()
        paths["cp"] = _cp_path(torch, work, tag, per_frame)
        paths["catmesh"] = _catmesh_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["upsample"] = _upsample_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
    paths["probes"] = per_frame["probes"] = _probe_path(torch, kernels, tag)
    _kernel_cases(torch, kernels, tag)
    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "lidar_transfer_tpu"
                  or m.startswith("lidar_transfer_tpu.")
                  for m in sys.modules), "the port imported the JAX package")
    rows = []
    for name, k in kernels.items():
        k.setdefault("library_ms", None)
        k["launches"] = sum(c[name] for c in paths.values())
        k["launches_per_frame"] = {
            path: c[name] for path, c in per_frame.items() if c.get(name)}
        check(k["device_ms"] is not None, f"kernel {name}: the profiler "
              "gave no whole trace of its device operations")
        print(f"kernel {name}: wrapper {k['ms']:.4f} ms, device "
              f"{k['device_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']} (share reached "
              f"{k['bound_ms'] / k['device_ms']:.3f}), plain "
              f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, "
              f"launches per frame {k['launches_per_frame']} {tag}")
        rows.append(dict(name=name, **k))
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _run_cli(work, base, name, *extra):
    """Run the port's CLI with ``base + extra`` and its output under
    ``work/name``; -> (output dir, per-frame metrics, printed text)."""
    from lidar_transfer_tpu_torch import cli

    out = os.path.join(work, name)
    mj = os.path.join(work, f"{name}.json")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(base + ["-p", out, "--metrics-json", mj, *extra])
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"cli {name} exit code {rc}")
    print(f"cli {name}: {time.perf_counter() - t:.2f} s wall")
    with open(mj) as f:
        return out, json.load(f), text


def _config(work, name, dataset="kitti", **kw):
    """A TransferConfig at the reference voxel and bounds, written to
    ``work/name.yaml``; -> (config, the CLI's base arguments on the
    dataset ``work/<dataset>`` with fixed bounds)."""
    from lidar_transfer_tpu_torch.config import TransferConfig

    cfg = TransferConfig(voxel_size=0.05, voxel_bounds=BOUNDS, **kw)
    path = os.path.join(work, f"{name}.yaml")
    cfg.to_yaml(path)
    return cfg, ["-d", os.path.join(work, dataset), "-c", path,
                 "--fixed-bounds", "-b", "-w"]


def _sequence(work, dataset="kitti"):
    """-> (the sequence ``work/<dataset>``, its scan capacity)."""
    from lidar_transfer_tpu_torch.datasets import kitti

    seq = kitti.KittiSequence.open(os.path.join(work, dataset))
    return seq, kitti.scan_capacity(max(os.path.getsize(f) // 16
                                        for f in seq.scan_files))


def _same_files(out_a, out_b, what: str) -> None:
    """The KITTI outputs under two CLI output dirs are equal byte for
    byte."""
    for sub in ("velodyne", "labels"):
        d_a = os.path.join(out_a, "sequences", "00", sub)
        d_b = os.path.join(out_b, "sequences", "00", sub)
        names = sorted(os.listdir(d_a))
        check(names == sorted(os.listdir(d_b)), f"{what}: {sub} files")
        for fn in names:
            with open(os.path.join(d_a, fn), "rb") as a, \
                    open(os.path.join(d_b, fn), "rb") as b:
                check(a.read() == b.read(), f"{what}: {sub}/{fn}")


def _equal_scans(torch, a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("range", "label", "remission", "points", "mask"))


def _card_vs_cpu(vs_card, vs_cpu, what: str) -> float:
    """Label/mask agreement of the card's scan with the CPU's on
    >= 99.9 % of pixels; -> the largest range difference where both
    agree."""
    lc, mc = vs_card.label.cpu(), vs_card.mask.cpu()
    agree = float(((lc == vs_cpu.label) & (mc == vs_cpu.mask)).float().mean())
    both = (lc == vs_cpu.label) & mc & vs_cpu.mask
    rerr = (vs_card.range.cpu() - vs_cpu.range)[both].abs()
    print(f"{what} card vs CPU: label/mask agreement {agree:.6f}, "
          f"range error > 1e-3 m on {int((rerr > 1e-3).sum())} of "
          f"{int(both.sum())} pixels, mask fill "
          f"{float(mc.float().mean()):.4f}")
    check(agree >= 0.999, f"{what}: card and CPU outputs disagree")
    return float(rerr.max()) if rerr.numel() else 0.0


def _launches_since(before: dict, per: float = 1.0) -> dict:
    """The kernels launched since the snapshot ``before`` of
    ``_build.launch_counts()``, over ``per`` frames."""
    from lidar_transfer_tpu_torch import _build

    return {k: (v - before[k]) / per
            for k, v in _build.launch_counts().items() if v > before[k]}


def _kernel_cases(torch, kernels, tag) -> None:
    """Every case of rows 1, 1b and A, and rows 2 and 3, at the reference
    point beside its bound (``probes/cases.py``, the table ``PERF.md``
    keeps); the integrate's, the chain's and the table's JSON rows take
    the case their path launches (float32 state with the table)."""
    from lidar_transfer_tpu_torch.probes import cases

    rows = {r["case"]: r for r in cases.measure()}
    torch.cuda.empty_cache()
    for name, r in rows.items():
        d = r["device_ms"]
        print(f"case {name}: wrapper {r['ms']:.4f} ms, device "
              + ("not measured" if d is None else
                 f"{d:.4f} ms ({r['device_ops']:.1f} operations), share of "
                 f"the bound {r['bound_ms'] / d if d else 0:.3f}")
              + f", bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['bytes']} bytes) {r['note']} {tag}")
    dims = "x".join(map(str, cases.DIMS))
    for kernel, case in (
            ("tsdf_integrate", f"single {dims} f32 reset no weight, table"),
            ("tsdf_integrate_chain", f"chain S=3 {dims} f32, table"),
            ("tsdf_geometry", f"geometry table {dims}")):
        r = rows[case]
        kernels[kernel].update(ms=r["ms"], device_ms=r["device_ms"],
                               bound_ms=r["bound_ms"],
                               bound_by=r["bound_by"])
    empty = rows["empty kernel launch"]["device_ms"]
    z = kernels["zbuffer"]["device_ms"]
    if empty and z:
        print(f"zbuffer device time {z:.5f} ms = {z / empty:.2f} x an empty "
              f"kernel launch's {empty:.5f} ms (aim: within 3 x) {tag}")


def _main_path(torch, work, kernels, tag, per_frame):
    """Phases 2-4 of the mergemesh path in the scratch directory ``work``
    (it writes the synthetic dataset ``work/kitti``); returns the launch
    counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.datasets import synthetic
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import (load_window,
                                                             merge_window,
                                                             stack_windows)

    dev = torch.device("cuda")
    synthetic.write_kitti_dataset(os.path.join(work, "kitti"),
                                  synthetic.Scene.default(), HDL64,
                                  n_scans=6)
    cfg, base = _config(work, "transfer")
    hdl32 = SensorSpec.from_yaml(HDL32_PATH)

    def run_cli(name, *extra):
        return _run_cli(work, base, name, *extra)

    _build.reset_launch_counts()
    _, m_id, text = run_cli("identity")
    per_frame["mergemesh"] = _launches_since(
        dict.fromkeys(_build.launch_counts(), 0), len(m_id))
    for key in ("IoU: ", "Acc: ", "MSE: ", "Took: "):
        check(text.count(key) == 6, f"identity run printed {key!r} lines")
    out_x, m_x, _ = run_cli("cross", "-t", HDL32_PATH)
    out_s, m_s, _ = run_cli("stream", "-t", HDL32_PATH, "--stream", "4")

    seq, cap = _sequence(work)
    eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev)
    w0 = load_window(seq, cfg, 0, cap, dev)
    vs_card = eng.transfer_fast(w0)
    t = time.perf_counter()
    before = _build.launch_counts()
    state = eng.fused_state()
    per_frame["mergemesh.fused_state"] = _launches_since(before)
    torch.cuda.synchronize()
    print(f"fused_state {tuple(state.tsdf.shape)} f32: "
          f"{time.perf_counter() - t:.2f} s first call (allocation "
          f"included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB {tag}")
    counts = _build.launch_counts()
    print(f"launches on the mergemesh path: {counts}")
    for k in ("zbuffer", "confusion", "tsdf_integrate"):
        check(counts[k] > 0, f"kernel {k} never launched on the "
              "mergemesh path")

    # ---------------------------------------------------- 3. output checks
    check(tuple(state.tsdf.shape) == (2048, 2048, 208),
          f"volume dims {tuple(state.tsdf.shape)}")
    written = int((state.tsdf < 1).sum())
    print(f"fused volume: {written} voxels with tsdf < 1")
    check(written > 0, "fused volume has no surface")
    for name, ms in (("identity", m_id), ("cross", m_x), ("stream", m_s)):
        check(len(ms) == 6, f"{name}: {len(ms)} frames")
        for fm in ms:
            lbl = os.path.join(work, name, "sequences", "00", "labels",
                               f"{fm['index']:06d}.label")
            check(os.path.getsize(lbl) == 4 * fm["points_written"],
                  f"{name}: label file of frame {fm['index']}")
    fill = [fm["points_written"] / (hdl32.H * hdl32.W) for fm in m_x]
    print(f"cross mask fill per frame: {[round(f, 4) for f in fill]}")
    check(min(fill) > 0, "cross transfer wrote an empty scan")
    for fm in m_id:
        check(np.isfinite([fm["iou"], fm["acc"], fm["mse"]]).all()
              and 0 < fm["iou"] <= 1, f"identity metrics {fm}")
    _same_files(out_x, out_s, "--stream 4 output differs from per-frame")
    print("--stream 4 output == per-frame output (all files)")

    _, m_cpu, _ = run_cli("cpu", "-t", HDL32_PATH, "--device", "cpu",
                          "--frames", "1")
    dn = abs(m_cpu[0]["points_written"] - m_x[0]["points_written"])
    print(f"cli --device cpu frame 0: {m_cpu[0]['points_written']} points, "
          f"card {m_x[0]['points_written']}")
    check(dn <= 1e-3 * hdl32.H * hdl32.W, "CPU and card point counts")
    cpu_eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                                device="cpu")
    rerr = _card_vs_cpu(vs_card, cpu_eng.transfer_fast(
        load_window(seq, cfg, 0, cap, "cpu")), "mergemesh (frame 0)")
    check(rerr <= 1e-3, "card and CPU ranges disagree")

    pts, rem, lbl, valid = merge_window(w0)
    ri = TP.range_project(pts, rem, lbl, valid, H=HDL64.H, W=HDL64.W,
                          fov_up_deg=hdl32.fov_up,
                          fov_down_deg=hdl32.fov_down)
    per_x = (state.tsdf < 1).sum(dim=(1, 2))
    fkw = dict(fov_up_deg=hdl32.fov_up, fov_down_deg=hdl32.fov_down,
               origin=eng.vol_spec.origin, active_dims=eng.vol_dims,
               reset=True, write_weight=False)
    for x0 in (int(per_x.argmax()) // 16 * 16, eng.vol_dims[0] // 2):
        slab = TS.VolumeSpec(eng.vol_spec.origin, eng.vol_spec.voxel_size,
                             (16,) + eng.vol_dims[1:])
        ref = TS.integrate(slab.init_state(dev), slab, ri.range, ri.label,
                           ri.remission, x_offset=x0, **fkw)
        _compare_states(torch, TS.TSDFState(*(a[x0:x0 + 16]
                                              for a in state)), ref,
                        f"fused slab x={x0}..{x0 + 15} vs plain integrate "
                        f"({int((ref.tsdf < 1).sum())} surface voxels)")
        del ref

    # ------------------------------------------------------------ 4. timing
    integ = lambda fn: lambda: fn(  # noqa: E731
        state, eng.vol_spec, ri.range, ri.label, ri.remission, **fkw)
    k_ms = cuda_ms(integ(integrate_cuda), 10)
    p_ms = cuda_ms(integ(TS.integrate), 2, warmup=1)
    geom = eng._ensure_geom(hdl32.fov_up, hdl32.fov_down, HDL64.H)
    kt_ms = cuda_ms(lambda: integrate_cuda(
        state, eng.vol_spec, ri.range, ri.label, ri.remission, v_tab=geom,
        **fkw), 10)
    kernels["tsdf_integrate"].update(ms=k_ms, plain_ms=p_ms)
    gvox = state.tsdf.numel() / (k_ms * 1e-3) / 1e9
    print(f"integrate {eng.vol_dims} reset, no weight write: kernel "
          f"{k_ms:.3f} ms ({gvox:.2f} Gvoxel/s), with the geometry table "
          f"{kt_ms:.3f} ms, plain {p_ms:.1f} ms {tag}")

    wins = [load_window(seq, cfg, i, cap, dev) for i in range(6)]
    frame_ms = cuda_ms(lambda: [eng.transfer_fast(w)
                                        for w in wins], 10) / len(wins)
    stacked = stack_windows(wins[:4])
    stream_ms = cuda_ms(lambda: eng.transfer_stream(stacked), 10)
    print(f"transfer_fast HDL64->HDL32: {frame_ms:.3f} ms/frame "
          f"({1e3 / frame_ms:.1f} scans/s) {tag}")
    print(f"transfer_stream 4 frames: {stream_ms:.3f} ms/batch "
          f"({4e3 / stream_ms:.1f} scans/s) {tag}")
    _profile_frames(torch, eng, wins, frame_ms, tag)
    return counts


def _mesh_path(torch, work, kernels, tag, per_frame):
    """Phases 2-4 of the mesh adaption, three scans per window, on the
    dataset ``work/kitti``; returns the launch counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_chain_cuda, precompute_geometry_cuda)
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import load_window

    dev = torch.device("cuda")
    cfg, base = _config(work, "mesh", adaption="mesh", number_of_scans=3)
    hdl32 = SensorSpec.from_yaml(HDL32_PATH)
    seq, cap = _sequence(work)
    n_frames = len(seq) - 2                     # primaries 1 .. len - 2
    ply = os.path.join(work, "ply")

    # ------------------------------------------- 2. main path (mesh)
    _build.reset_launch_counts()
    _, m_id, text = _run_cli(work, base, "mesh_identity")
    per_frame["mesh"] = _launches_since(
        dict.fromkeys(_build.launch_counts(), 0), len(m_id))
    for key in ("IoU: ", "Acc: ", "MSE: ", "Took: "):
        check(text.count(key) == n_frames,
              f"mesh identity run printed {key!r} lines")
    _, m_x, _ = _run_cli(work, base, "mesh_cross", "-t", HDL32_PATH)
    _, m_p, _ = _run_cli(work, base, "mesh_ply", "-t", HDL32_PATH,
                         "--frames", "1", "--ply", ply)
    w1 = load_window(seq, cfg, 1, cap, dev)
    fused = {}
    for compact in (False, True):
        eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                                device=dev, compact_volume=compact)
        eng.transfer_fast(w1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = _build.launch_counts()
        state = eng.fused_state()
        per_frame["mesh.fused_state"] = _launches_since(before)
        torch.cuda.synchronize()
        fused[compact] = time.perf_counter() - t
        print(f"mesh fused_state {tuple(state.tsdf.shape)} "
              f"{'compact' if compact else 'f32'}: {fused[compact]:.2f} s "
              f"first call (allocation and geometry table included), "
              f"{int((state.tsdf < 1).sum())} voxels with tsdf < 1 {tag}")
        # ------------------------------------- 3. the chain, slab by slab
        check(tuple(state.tsdf.shape) == (2048, 2048, 208),
              f"volume dims {tuple(state.tsdf.shape)}")
        _, ris = eng._project_window_scans(w1)
        stacks = [torch.stack([getattr(ri, f) for ri in ris])
                  for f in ("range", "label", "remission")]
        per_x = (state.tsdf < 1).sum(dim=(1, 2))
        check(int(per_x.sum()) > 0, "fused mesh volume has no surface")
        for x0 in (int(per_x.argmax()) // 16 * 16, eng.vol_dims[0] // 2):
            slab = TS.VolumeSpec(eng.vol_spec.origin,
                                 eng.vol_spec.voxel_size,
                                 (16,) + eng.vol_dims[1:])
            ref = TS.integrate_chain(
                slab.init_state(dev, compact), slab, *stacks,
                fov_up_deg=HDL64.fov_up, fov_down_deg=HDL64.fov_down,
                origin=eng.vol_spec.origin, active_dims=eng.vol_dims,
                x_offset=x0)
            _compare_states(torch, TS.TSDFState(*(a[x0:x0 + 16]
                                                  for a in state)), ref,
                            f"fused mesh slab x={x0}..{x0 + 15} "
                            f"{'compact' if compact else 'f32'} vs plain "
                            "chain")
            del ref
        del state, eng
        torch.cuda.empty_cache()
    counts = _build.launch_counts()
    print(f"launches on the mesh path: {counts}")
    for k in ("zbuffer", "confusion", "tsdf_integrate_chain",
              "tsdf_geometry"):
        check(counts[k] > 0, f"kernel {k} never launched on the mesh path")

    # ------------------------------------------- 3. outputs of the path
    for name, ms in (("identity", m_id), ("cross", m_x), ("ply", m_p)):
        check(len(ms) == (1 if name == "ply" else n_frames),
              f"mesh {name}: {len(ms)} frames")
        for fm in ms:
            lbl = os.path.join(work, f"mesh_{name}", "sequences", "00",
                               "labels", f"{fm['index']:06d}.label")
            check(os.path.getsize(lbl) == 4 * fm["points_written"] > 0,
                  f"mesh {name}: label file of frame {fm['index']}")
    for fm in m_id:
        check(np.isfinite([fm["iou"], fm["acc"], fm["mse"]]).all()
              and 0 < fm["iou"] <= 1, f"mesh identity metrics {fm}")
    ply_file = os.path.join(ply, f"{m_p[0]['index']:06d}.ply")
    print(f"PLY {ply_file}: {m_p[0]['triangles']} triangles, "
          f"{os.path.getsize(ply_file)} bytes")
    check(m_p[0]["triangles"] > 0 and os.path.getsize(ply_file) >
          94 * m_p[0]["triangles"], "the mesh PLY is empty")
    eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev)
    vs_card = eng.transfer_fast(w1)
    cpu_eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                                device="cpu")
    _card_vs_cpu(vs_card, cpu_eng.transfer_fast(
        load_window(seq, cfg, 1, cap, "cpu")), "mesh fold (frame 1)")
    check(float(vs_card.mask.float().mean()) > 0.3,
          "mesh virtual scan mostly empty")

    # ------------------------------------------------------ 4. timing
    wins = [load_window(seq, cfg, i, cap, dev) for i in range(1, 5)]
    fold_ms = cuda_ms(lambda: [eng.transfer_fast(w)
                                       for w in wins], 5) / len(wins)
    print(f"mesh transfer_fast (fold) HDL64->HDL32, 3 scans: "
          f"{fold_ms:.3f} ms/frame ({1e3 / fold_ms:.1f} scans/s) {tag}")
    _profile_frames(torch, eng, wins, fold_ms, tag)
    times = []
    for w in wins[:3]:
        eng.transfer_fast(w)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.fused_state()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    print(f"mesh fused_state() (projection + chain + table read, f32), "
          f"warm: {', '.join(f'{x:.3f}' for x in times)} ms {tag}")
    lut = np.zeros((300, 3), np.uint8)
    t = time.perf_counter()
    n_tri = eng.export_mesh(os.path.join(work, "export.ply"), colorize=lut)
    print(f"export_mesh (cells, {eng.vol_dims} f32): {n_tri} triangles in "
          f"{time.perf_counter() - t:.2f} s wall {tag}")

    spec = eng.vol_spec
    state = eng.fused_state()
    _, ris = eng._project_window_scans(wins[0])
    stacks = [torch.stack([getattr(ri, f) for ri in ris])
              for f in ("range", "label", "remission")]
    geom = eng._ensure_geom(HDL64.fov_up, HDL64.fov_down, HDL64.H)
    kw = dict(fov_up_deg=HDL64.fov_up, fov_down_deg=HDL64.fov_down)
    compact_state = spec.init_state(dev, compact=True)
    for st in (state, compact_state):
        for v_tab in (geom, None):
            k_ms = cuda_ms(lambda: integrate_chain_cuda(
                st, spec, *stacks, v_tab=v_tab, **kw), 10)
            p_ms = cuda_ms(lambda: TS.integrate_chain(
                st, spec, *stacks, v_tab=v_tab, **kw), 2, warmup=1)
            name = "compact" if st is compact_state else "f32"
            print(f"chain S=3 {spec.dims} {name} table={v_tab is not None}:"
                  f" kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms {tag}")
            if st is state and v_tab is not None:
                kernels["tsdf_integrate_chain"].update(ms=k_ms,
                                                       plain_ms=p_ms)
    del compact_state
    g_ms = cuda_ms(lambda: precompute_geometry_cuda(
        spec, HDL64.fov_up, HDL64.fov_down, HDL64.H, device=dev), 10)
    gp_ms = cuda_ms(lambda: TS.precompute_geometry(
        spec, HDL64.fov_up, HDL64.fov_down, HDL64.H, device=dev), 2,
        warmup=1)
    kernels["tsdf_geometry"].update(ms=g_ms, plain_ms=gp_ms)
    print(f"geometry table {spec.dims}: kernel {g_ms:.3f} ms, plain "
          f"{gp_ms:.1f} ms {tag}")
    del state, eng
    torch.cuda.empty_cache()
    vol = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev, mesh_attrs="volume",
                            compact_volume=True)
    vol_ms = cuda_ms(lambda: [vol.transfer_fast(w)
                                      for w in wins], 3) / len(wins)
    before = _build.launch_counts()
    vv = vol.transfer_fast(wins[0])
    per_frame["mesh.volume_frame"] = _launches_since(before)
    print(f"mesh transfer_fast (mesh_attrs=volume, compact, chain in the "
          f"frame): {vol_ms:.3f} ms/frame ({1e3 / vol_ms:.1f} scans/s), "
          f"mask fill {float(vv.mask.float().mean()):.4f} {tag}")
    return counts


def _cp_path(torch, work, tag, per_frame):
    """The cp adaption at the reference point on the dataset
    ``work/kitti``; returns the launch counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import load_window

    dev = torch.device("cuda")
    cfg, base = _config(work, "cp", adaption="cp")
    hdl32 = SensorSpec.from_yaml(HDL32_PATH)
    seq, cap = _sequence(work)

    _build.reset_launch_counts()
    _, m_id, _ = _run_cli(work, base, "cp_identity")
    per_frame["cp"] = _launches_since(
        dict.fromkeys(_build.launch_counts(), 0), len(m_id))
    _, m_x, _ = _run_cli(work, base, "cp_cross", "-t", HDL32_PATH)
    w0 = load_window(seq, cfg, 0, cap, dev)
    vs, _ = TD.TransferEngine(HDL64, HDL64, cfg, fixed_bounds=True,
                              device=dev).transfer(w0)
    src = TP.range_project(w0.points[0], w0.remissions[0], w0.labels[0],
                           w0.valid[0], H=HDL64.H, W=HDL64.W,
                           fov_up_deg=HDL64.fov_up,
                           fov_down_deg=HDL64.fov_down)
    eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True, device=dev)
    vs_card = eng.transfer(w0)[0]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"launches on the cp path: {counts}")
    for k in ("zbuffer", "confusion"):
        check(counts[k] > 0, f"kernel {k} never launched on the cp path")

    exact = all(torch.equal(a, b) for a, b in (
        (vs.range, src.range), (vs.label, src.label),
        (vs.remission, torch.clamp(src.remission, min=0.0)),
        (vs.mask, src.mask)))
    print(f"cp identity (frame 0): the source projection bit for bit: "
          f"{exact}, mask fill {float(vs.mask.float().mean()):.4f}")
    check(exact, "cp identity differs from the source projection")
    for fm in m_id:
        check((fm["iou"], fm["acc"], fm["mse"]) == (1.0, 1.0, 0.0),
              f"cp identity metrics {fm}")
    check(len(m_x) == 6 and min(fm["points_written"] for fm in m_x) > 0,
          "cp cross frames")
    try:
        eng.fused_state()
        check(False, "cp has no volume, but fused_state() returned one")
    except RuntimeError:
        pass
    _, m_cpu, _ = _run_cli(work, base, "cp_cpu", "-t", HDL32_PATH,
                           "--device", "cpu", "--frames", "1")
    print(f"cp cli --device cpu frame 0: {m_cpu[0]['points_written']} "
          f"points, card {m_x[0]['points_written']}")
    check(abs(m_cpu[0]["points_written"] - m_x[0]["points_written"])
          <= 1e-3 * hdl32.H * hdl32.W, "cp CPU and card point counts")
    cpu = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device="cpu")
    _card_vs_cpu(vs_card, cpu.transfer(load_window(seq, cfg, 0, cap,
                                                   "cpu"))[0], "cp (frame 0)")

    wins = [load_window(seq, cfg, i, cap, dev) for i in range(6)]
    ms = cuda_ms(lambda: [eng.transfer(w) for w in wins], 10) / len(wins)
    print(f"cp transfer HDL64->HDL32: {ms:.3f} ms/frame "
          f"({1e3 / ms:.1f} scans/s) {tag}")
    _profile_frames(torch, eng, wins, ms, tag)
    return counts


def _catmesh_path(torch, work, tag, per_frame):
    """The catmesh adaption (splat engine) at the reference point, held
    against the mergemesh run of ``_main_path``; returns the launch
    counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import load_window

    dev = torch.device("cuda")
    cfg, base = _config(work, "catmesh", adaption="catmesh")
    mm_cfg, _ = _config(work, "mergemesh")
    hdl32 = SensorSpec.from_yaml(HDL32_PATH)
    seq, cap = _sequence(work)

    _build.reset_launch_counts()
    out, m_x, _ = _run_cli(work, base, "catmesh_cross", "-t", HDL32_PATH)
    per_frame["catmesh"] = _launches_since(
        dict.fromkeys(_build.launch_counts(), 0), len(m_x))
    w0 = load_window(seq, cfg, 0, cap, dev)
    eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True, device=dev)
    vs = eng.transfer_fast(w0)
    before = _build.launch_counts()
    state = eng.fused_state()
    per_frame["catmesh.fused_state"] = _launches_since(before)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"launches on the catmesh path: {counts}")
    for k in ("zbuffer", "tsdf_integrate"):
        check(counts[k] > 0, f"kernel {k} never launched on the catmesh "
              "path")

    _same_files(out, os.path.join(work, "cross"),
                "catmesh CLI output differs from mergemesh's")
    mm_eng = TD.TransferEngine(HDL64, hdl32, mm_cfg, fixed_bounds=True,
                               device=dev)
    same = (vs.adaption == "catmesh"
            and _equal_scans(torch, vs, mm_eng.transfer_fast(w0)))
    print(f"catmesh HDL64->HDL32: CLI files == mergemesh's (6 frames); "
          f"frame 0 scan == mergemesh's bit for bit: {same}; fused volume "
          f"{int((state.tsdf < 1).sum())} voxels with tsdf < 1")
    check(same, "catmesh scan differs from mergemesh's")
    del state

    # the same body as mergemesh: both timed here, interleaved
    wins = [load_window(seq, cfg, i, cap, dev) for i in range(6)]
    ms = {"mergemesh": [], "catmesh": []}
    for name, e in (("mergemesh", mm_eng), ("catmesh", eng),
                    ("catmesh", eng), ("mergemesh", mm_eng)):
        ms[name].append(cuda_ms(lambda: [e.transfer_fast(w) for w in wins],
                                10) / len(wins))
    print("catmesh transfer_fast HDL64->HDL32: " + "; ".join(
        f"{k} {' / '.join(f'{v:.3f}' for v in vs)} ms/frame"
        for k, vs in ms.items()) + f" (timed mergemesh, catmesh, catmesh, "
        f"mergemesh) {tag}")
    _profile_frames(torch, eng, wins, min(ms["catmesh"]), tag)
    return counts


def _upsample_path(torch, work, tag, per_frame):
    """A target denser than the source, HDL64 -> HDL64x2 (128 beams over
    the same fov, as ``bench.py --upsample``), per frame and streamed, on
    the dataset ``work/kitti_up``, which it writes; returns the launch
    counts of the path."""
    import dataclasses

    import yaml

    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.datasets import synthetic
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import (load_window,
                                                             stack_windows)

    dev = torch.device("cuda")
    up = SensorSpec(name="HDL64x2", beams=128, fov_up=HDL64.fov_up,
                    fov_down=HDL64.fov_down,
                    angle_res_hor=HDL64.angle_res_hor)
    up_path = os.path.join(work, "hdl64x2.yaml")
    with open(up_path, "w") as f:
        yaml.safe_dump(up.to_dict(), f)
    # the source's beams lie 0.75 deg inside its fov, as a real sensor's
    # do: a beam on a row edge of the source or the target image (the fov
    # limits, and beams 7 and 56 with 0.5 deg) leaves whole rows to the
    # last ulp of an asin, which the card and the CPU round apart (ROADMAP.md
    # section 3); with 0.75 every beam lies >= 0.034 target rows from an
    # edge. config.yaml stays HDL64's
    ds = os.path.join(work, "kitti_up")
    synthetic.write_kitti_dataset(
        ds, synthetic.Scene.default(), dataclasses.replace(
            HDL64, fov_up=HDL64.fov_up - 0.75,
            fov_down=HDL64.fov_down + 0.75), n_scans=6)
    with open(os.path.join(ds, "config.yaml"), "w") as f:
        yaml.safe_dump(HDL64.to_dict(), f)
    cfg, base = _config(work, "upsample", dataset="kitti_up")
    seq, cap = _sequence(work, "kitti_up")

    _build.reset_launch_counts()
    out_f, m_f, _ = _run_cli(work, base, "up_frames", "-t", up_path)
    per_frame["upsample"] = _launches_since(
        dict.fromkeys(_build.launch_counts(), 0), len(m_f))
    out_s, _, _ = _run_cli(work, base, "up_stream", "-t", up_path,
                           "--stream", "4")
    w0 = load_window(seq, cfg, 0, cap, dev)
    eng = TD.TransferEngine(HDL64, up, cfg, fixed_bounds=True, device=dev)
    vs_card = eng.transfer_fast(w0)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"launches on the upsampling path: {counts}")
    check(counts["zbuffer"] > 0, "kernel zbuffer never launched on the "
          "upsampling path")

    _same_files(out_f, out_s, "--stream 4 upsampling output differs from "
                "per-frame")
    check(len(m_f) == 6, f"upsampling: {len(m_f)} frames")
    off = TD.TransferEngine(HDL64, up, cfg, fixed_bounds=True, device=dev,
                            upsample_interp=False).transfer_fast(w0)
    hit = float(vs_card.mask.float().mean())
    bare = float(off.mask.float().mean())
    rows = float(vs_card.mask.any(dim=1).float().mean())
    print(f"upsampling HDL64->HDL64x2 (frame 0): hit rate {hit:.4f} "
          f"({int(vs_card.mask.sum())} of {up.H * up.W} pixels), without "
          f"the chords {bare:.4f}; rows with a return {rows:.4f}; chords "
          f"m_v {eng._interp_mv}, m_u {eng._interp_mu}, v_span "
          f"{eng._interp_vspan}; --stream 4 == per-frame (all files)")
    check(eng._interp_active and hit > 1.5 * bare,
          "the chords add no coverage")
    cpu = TD.TransferEngine(HDL64, up, cfg, fixed_bounds=True, device="cpu")
    _card_vs_cpu(vs_card, cpu.transfer_fast(load_window(seq, cfg, 0, cap,
                                                        "cpu")),
                 "upsampling (frame 0)")

    wins = [load_window(seq, cfg, i, cap, dev) for i in range(6)]
    ms = cuda_ms(lambda: [eng.transfer_fast(w) for w in wins], 10) / len(wins)
    stacked = stack_windows(wins[:4])
    s_ms = cuda_ms(lambda: eng.transfer_stream(stacked), 10)
    print(f"upsampling transfer_fast HDL64->HDL64x2: {ms:.3f} ms/frame "
          f"({1e3 / ms:.1f} scans/s); transfer_stream 4 frames {s_ms:.3f} "
          f"ms ({4e3 / s_ms:.1f} scans/s) {tag}")
    _profile_frames(torch, eng, wins, ms, tag)
    return counts


def _probe_path(torch, kernels, tag):
    """The probes' rows at 1024x1024x256 (``probes.run``, what ``python
    -m lidar_transfer_tpu_torch.probes all`` prints); returns the launch
    counts of the path. Each probe kernel's JSON row takes the time of the
    row its kernel was written for: ``full`` at BX 2 with three outputs,
    ``precols``, and ``alias_any`` (three outputs in place)."""
    from lidar_transfer_tpu_torch import _build, probes
    from lidar_transfer_tpu_torch.probes import ablate, bounds, parts, write

    _build.reset_launch_counts()
    t = time.perf_counter()
    rows = probes.run(tag=tag)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"probe rows: {len(rows)} in {time.perf_counter() - t:.1f} s; "
          f"launches on the probe path: {counts}")
    picks = {"probe_parts": ("parts", "full BX2 out x3"),
             "probe_ablate": ("ablate", "precols"),
             "probe_write": ("alias", "alias_any")}
    for name, (probe, row) in picks.items():
        check(counts[name] > 0, f"kernel {name} never launched on the "
              "probe path")
        r = next(r for r in rows if (r["probe"], r["row"]) == (probe, row))
        k = kernels[name]
        k.update(ms=r["ms"], device_ms=r["device_ms"],
                 plain_ms=r["plain_ms"],
                 max_abs_err=max(k["max_abs_err"], r["max_abs_err"]))
    for name, b in (
            ("probe_parts", bounds.probe_parts(parts.DIMS, parts.CW, 3)),
            ("probe_ablate", bounds.probe_ablate(ablate.DIMS, ablate.CW)),
            ("probe_write", bounds.probe_write(
                write.DIMS, [dt.itemsize for dt in write.ALIAS_DTYPES]))):
        kernels[name].update(bound_ms=b.ms, bound_by=b.by)
    # the one PyTorch call that writes the alias probe's three outputs
    kernels["probe_write"]["library_ms"] = next(
        r["ms"] for r in rows if r["row"] == "PyTorch full bfloat16 x3")
    return counts


def _profile_frames(torch, eng, wins, frame_ms, tag):
    """Device time and device launches per frame of ``transfer_fast`` from
    a ``torch.profiler`` trace of the frames ``wins`` (after one pass of
    them inside the trace, see ``timing.whole_trace``); the idle share is
    1 - device time / the frame time measured with CUDA events (without
    the profiler, whose own host cost would inflate the frame)."""
    on_dev = whole_trace(lambda: [eng.transfer_fast(w) for w in wins], 1,
                         warmup=1)
    check(on_dev, "the profiler gave no whole trace of the frames (no two "
          "of its traces agreed)")
    dev_ms = sum(e.time_range.elapsed_us() for e in on_dev) / 1e3 / len(wins)
    top = {}
    for e in on_dev:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us()
    lead = sorted(top.items(), key=lambda kv: -kv[1])[:5]
    print(f"transfer_fast device time {dev_ms:.4f} ms/frame, "
          f"{len(on_dev) / len(wins):.1f} device launches/frame, idle share "
          f"{1 - dev_ms / frame_ms:.3f} of {frame_ms:.3f} ms {tag}")
    print("  leading device ops (us over the trace): " + "; ".join(
        f"{n[:60]} {us:.1f}" for n, us in lead))


if __name__ == "__main__":
    sys.exit(main())
