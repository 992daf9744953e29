#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lidar_transfer_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the sixteen CUDA kernels from ``lidar_transfer_tpu_torch/csrc`` (one
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
   the geometry table's fast mode equal to its exact mode byte for byte
   (HDL64 and HDL32 fovs, 128 rows, a shifted origin, a volume 9 m under
   the sensor, 2048x2048x208, and 2047x2047x206 at a pointer off its
   alignment) and both equal to the
   plain rows on >= 1 - 1e-6 of voxels; the confusion counts exact in 60
   more cases (C = 260, 20, 1, 37, 1500; N = 0, 1, 131072, 2^20; skewed and
   uniform labels; inputs off their alignment); the three
   probe kernels at 64x256x256 in every variant (the parts probe's int16
   labels exact and bf16 outputs within one bf16 ulp, also at sizes that
   take 8, 4 and 1 voxels a lane; the ablate probe bit for bit, also at
   Z = 206, at an X*Y no warp's column count divides and with a misaligned
   table; the writes byte for byte in every block, dtype, row, read-first
   and alias case); the packing of the raymarch's occupancy into bits
   word for word (12 grids up to 512x512x52 cells, counts the 4x4x2 brick
   does not divide); the raymarch kernel against ``raycast_plain`` in 24
   cases on a 256x256x96 volume and 65,536 rays, equal on every ray, bit
   for bit (float32 and compact, a shared origin, jittered per-ray origins
   and a rolling sensor's, fine steps of 0.5 and 2 voxels, max_steps cut
   at 90 and at K - 1, K and K + 1 past a ray's sixth batch of K samples,
   rays that start inside negative space; rays ending at t_far after a
   sample count K does not divide counted); row C, the mesh raycast (its
   BVH built by four kernels, then the traversal kernel), against
   ``raycast_mesh_plain``, the dense sweep, in 8 cases, bit for bit on
   every ray (soups of 1, 512 and 5,003 triangles and exact copies that
   tie, 65,613 rays, a shared and (R, 3) origins; one triangle alone; a
   heightfield with rays
   through its vertices and shared edges and along the six axes), the
   card's build equal to ``build_bvh_plain`` and the dense kernel of the
   parent design equal to ``raycast_mesh_plain`` in each; an empty mesh
   launches nothing (``kernel_checks``).
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
   - catmesh's oracle engine: ``TransferEngine(catmesh_engine="oracle")``
     HDL64 -> HDL32, three frames of scan 0 through ``transfer_fast``
     (the integrate, the seam-aware surface cells, host marching per
     category, ``dedupe_mesh``, row C's four build kernels and its
     traversal once a frame, the dense kernel never), each stage timed;
   - upsampling, HDL64 -> HDL64x2 (128 beams, the same fov): the CLI per
     frame and with --stream 4;
   - raymarch: ``TransferEngine(synthesis="raymarch")``, mergemesh, compact
     state, HDL64 -> HDL32, per frame and streamed (the volume integrated
     in every frame, the target's rays marched through it);
   - rolling shutter: frame 0 re-cast over the dataset's next pose by
     ``resynthesize_rolling_shutter``'s three engines (the splat engine's
     winners, the raymarch engine's band samples, the march with one
     origin a ray through its volume);
   - the probes at 1024x1024x256 through ``probes.run`` (the rows of
     ``python -m lidar_transfer_tpu_torch.probes all``);
   - segmentation (``lt-seg``'s path, ``experiments/segmentation.py``) on
     the same HDL64 dataset: ``train_segmentation`` of darknet53 at
     64x2048 (batch 2, bf16 compute, float32 parameters, 20 steps, a
     checkpoint), ``write_predictions`` with and without the kNN cleanup,
     ``evaluate_semantics`` of each (the z-buffer in every scan's
     projection, the confusion counts in the evaluation), and
     ``run_workflow("fake_on_real")`` with darknet21 through the CLI's
     mergemesh transfer;
   - parallel (``parallel/``, torch.distributed): two gloo ranks sharing
     cuda:0, spawned as ``python chip_smoke.py --parallel-child RANK
     WORLD WORK`` (NCCL refuses two ranks on one card; gloo reduces CUDA
     tensors through ``all_reduce``, which is all the path uses):
     ``integrate_sharded`` of scan 0's merged image into two
     1024x2048x208 float32 X-slabs (row 1 at x_offset 0 and 1024),
     ``splat_synthesize_sharded`` of that frame to HDL32 (the band probe
     on each slab, one MIN and one SUM ``all_reduce``, row A in the
     target assemble), ``sharded_confusion`` of its labels against the
     splat's (row 3 on each rank's rows, one SUM), and
     ``frame_parallel_transfer`` of frames 0-3, each rank loading and
     running its two (row A); then 3 DDP steps of float32 darknet53 (TF32
     off, one frame a rank); then the two entry points under the group:
     ``train_segmentation`` of float32 darknet53 (batch 2, a checkpoint
     at step 2, resumed to step 3) and ``grid_search(mesh=...)`` with one
     mergemesh cell of 3 frames at the reference voxel (padded to 4);
     then one NCCL rank's DDP step of bf16 darknet53 at batch 2. A child
     that fails fails the phase;
   - the front end: the CLI mergemesh HDL64 -> HDL32 on 4 frames without
     and with ``--png --html F --profile D`` (row A), ``lt-visualize-torch
     --html`` with predictions (the labels with every 7th point's changed)
     on the card and with ``--device cpu`` (rows A and 3), and
     ``experiments.multiscene`` at 2 scenes of 3 frames, 3 steps (rows A
     and 3, darknet21's training);
   - the runners ported from ``scripts/``: ``experiments.grids full`` at
     frames [1, 20] x voxel [0.25, 0.04], one frame a cell, on a 20-scan
     HDL64 64x2048 sequence (rows A and 3), ``grids multiscene`` at 2
     urban scenes x 1 cell, ``experiments.upsample`` at 20 steps and 4
     frames of 32 -> 64 beams at width 512 (row A in the transfer, the
     training and the predictions, row 3 in the evaluation), and
     ``probes.train_levers`` on darknet53 (batch 2, 64x2048) at 5 steps a
     variant (base, remat, mu_bf16, remat_mu_bf16), each printing its rows
     A and 3 launches a frame and the phase its wall time.
   Every kernel of a path must have launched in its run (the parallel
   path's in each child).
3. Checks the outputs: files written, the stream equal to the per-frame run,
   the card's virtual scans against the port's CPU run of the same frame
   (mergemesh, mesh, cp, upsampling; raymarch at +-12.8/+-12.8/+-3.2 m),
   16-plane X-slabs of the fused volumes against the plain integrate and
   the plain chain, a non-empty PLY, a cp identity transfer equal to the
   source projection bit for bit, catmesh's files and scan equal to
   mergemesh's bit for bit; the oracle's three frames equal, row C against
   the dense kernel on all 65,536 rays of the frame against its whole
   mesh and against ``raycast_mesh_plain`` and ``raycast_mesh_bvh_plain``
   on two full rows (bit for bit), the card's BVH of the frame equal to
   ``build_bvh_plain``'s, and row C against the port's native BVH on all
   rays (hit masks and labels within the JAX engine's seam budget of
   0.7 %, the attributes equal where both take one triangle), the frame
   beside the splat engine's; the march kernel against ``raycast_plain`` on
   the raymarch frame's 2048x2048x208 volume and 65,536 rays, and on the
   rolling raymarch engine's (R, 3)-origin march, equal on every ray, the
   raymarch frame beside the splat frame (both-hit share, range
   difference), the rolling splat frame with the identity pose against
   the static frame, each rolling engine's frame against the port's CPU
   run at +-12.8/+-12.8/+-3.2 m, and the miss decomposition of the splat
   and raymarch frames (summing to H * W); the darknet53 loss falling,
   the checkpoint loaded back with its logits bit for bit, every
   prediction file of the scan's length in the mapper's raw ids, finite
   scores, and one float32 darknet53 forward on the card (TF32 off)
   against the CPU (argmax agreement >= 99.9 %; bf16 against float32
   printed); on each parallel rank its slab against its planes of the
   whole volume fused by ``integrate_cuda`` in one process (label and
   weight exact, tsdf and rem bit for bit, else the count and largest
   difference held to 1e-6), the sharded scan equal to the whole volume's
   ``splat_synthesize(attrs="volume")`` bit for bit, the summed counts
   equal to ``confusion_matrix`` of the whole images, the four gathered
   frames equal to ``transfer_fast`` bit for bit; each kernel against
   its plain version on the path's own inputs: two 16-plane windows of
   the slab against the plain ``integrate`` at their global x_offset
   (as the mergemesh slabs), the rank's 32x2048 share of the counts
   against ``confusion_scatter`` and the summed counts against
   ``confusion_scatter`` of the whole images (exact), the sharded scan's
   z-buffer winners against ``zbuffer_winners_plain`` (exact); the DDP
   losses against the one-process step's within a relative 1e-5 and its
   parameters after 3 steps against the one-process step of batch 2
   (the bounds of ``tests/test_torch_experiments.py``: every one within
   2e-3, >= 99.9 % within 1e-4); the resumed ``train_segmentation``
   checkpoint (step 3, no ``module.`` prefix) against a one-process
   ``train_segmentation`` of 3 steps at batch 2 within the same bounds;
   the device-parallel grid cell's IoU, Acc and MSE equal to the
   sequential ``evaluate_transfer`` of the cell, and its
   ``grid_search.json`` written; and no jax in any child; the front end's
   scans with and without the flags equal byte for byte, one
   ``labels_png``/``velodyne_png`` file a frame, each decoded by
   ``png_decode`` (zlib alone) equal to the port's
   ``label_image_rgb``/``range_image_rgb`` of that frame's scan, the
   viewer page's frame records and ``check_js`` on its script, the
   profiler's Chrome trace with events (its kernel names printed, not
   required), the viewer's title metrics on the card against the CPU
   within 1e-6 (MSE 1e-5 relative) and its label and diff rows on
   >= 99.9 % of pixels, the multi-scene rows' JSONs with their means and
   stds numpy's over the scenes; the grid's JSON with the card's name and
   power limit, its cell (1 scan, 0.25 m) against ``evaluate_transfer`` on
   the port's CPU (iou and acc within 1e-3, mse within 1e-4 relative: the
   bounds of ``tests/test_torch_grids.py``), the multi-scene cell's
   ``_std``, ``_min`` and ``_max`` numpy's over its sequences, the
   upsampling rows finite over the 4 scans, and remat's final loss
   against base's (and remat_mu_bf16's against mu_bf16's) within
   ``REMAT_LOSS_RTOL`` relative.
4. Counts the z-buffer's device operations a call with the engine's
   workspace (at most two, one scratch allocation) and the confusion
   counts' (at most two); times, on the host clock, ``transfer_fast`` per
   frame of every adaption and rolling engine, the stream rates,
   ``fused_state()`` and ``export_mesh()`` with the GPU's name and power
   limit, the oracle frame's stages, and on each parallel rank the slab
   integrate, the probe-and-merge of one source with the bytes it
   reduces, and the DDP step beside the one-process step (gloo on one
   card, then the NCCL rank's bf16 step: the collectives' cost, not
   scaling); and profiles the frame of every adaption for its device
   time, device launches and idle share. A kernel's own time comes from
   ``python -m lidar_transfer_tpu_torch.probes.cases`` (beside its bound
   and its library yardstick), and the segmentation cells' from
   ``benchmark/``.

The front end's wall ms/frame with and without the flags is printed
beside the GPU's name and power limit.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON (route, source, the TPU kernel replaced, launches
in all and per frame of each path, the largest difference to the plain
version), the one before that the GPU's name and power limit. Any failed check
raises, and the exit code is then nonzero. Without a CUDA device it exits
with 1 at once. It fails if ``jax``, the JAX package, matplotlib or PIL
was imported (the card machine has neither of the last two).
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
    bf16_ulp, device_ms, gpu_line, whole_trace)


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


def _check_geometry_kernel(torch, kernels):
    """Phase 1 for the geometry table: the kernel's fast mode against its
    exact mode byte for byte (256x256x208 with the HDL64 and HDL32 fovs, 128
    rows, a shifted origin and one 9 m under the sensor, where pz passes 0
    at twice the rounding; the reference 2048x2048x208; 2047x2047x206
    at a pointer off its alignment), and both against the plain version at
    256x256x208. Prints the share of voxels the fast mode evaluated
    exactly. -> the HDL64 table at 256x256x208."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import \
        precompute_geometry_cuda

    dev = torch.device("cuda")
    hdl64, hdl32 = (3.0, -25.0), (10.67, -30.67)
    small, near = (256, 256, 208), (-6.4, -6.4, -5.0)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    first, row_err = None, 0
    # (dims, origin, fov, H, the table 3 bytes off its alignment)
    for dims, origin, fov, H, off in (
            (small, near, hdl64, 64, False),
            (small, near, hdl32, 32, False),
            (small, near, hdl64, 128, False),
            (small, (3.1, -7.77, -1.234), hdl64, 64, False),
            (small, (-6.4, -6.4, -9.0), hdl64, 64, False),
            ((2048, 2048, 208), (-50.0, -50.0, -5.0), hdl64, 64, False),
            ((2047, 2047, 206), (-50.0, -50.0, -5.0), hdl64, 64, True)):
        spec = TS.VolumeSpec(origin, 0.05, dims)
        n = spec.num_voxels
        out = None
        if off:
            out = torch.empty(n + 3, dtype=torch.int8, device=dev)[3:]
            out = out.view(dims)
            check(out.data_ptr() % 16 != 0, "the table is not misaligned")
        count.zero_()
        fast = precompute_geometry_cuda(spec, *fov, H, device=dev, out=out,
                                        exact_count=count)
        exact = precompute_geometry_cuda(spec, *fov, H, device=dev,
                                         exact=True)
        torch.cuda.synchronize()
        what = (f"geometry table {dims} origin {origin} fov {fov} H={H}"
                f"{' misaligned' if off else ''}")
        differ = int((fast != exact).sum())
        print(f"{what}: fast mode differs from exact mode at {differ} of "
              f"{n} voxels; evaluated exactly {int(count) / n:.2e} of them; "
              f"in FOV {float((exact >= 0).float().mean()):.4f}")
        check(differ == 0 and torch.equal(fast, exact),
              f"{what}: fast mode != exact mode (byte for byte)")
        check(int(count) < 0.01 * n, f"{what}: the exact path took 1 % of "
              "the voxels or more")
        if dims == small:
            plain = TS.precompute_geometry(spec, *fov, H, device=dev)
            bad_f, bad_e = (int((t != plain).sum()) for t in (fast, exact))
            row_err = max(row_err, int((fast.int() - plain.int()).abs()
                                       .max()))
            print(f"{what}: against the plain table, fast mode "
                  f"{bad_f} mismatches, exact mode {bad_e}")
            check(bad_f <= bad_e and bad_f <= n * 1e-6,
                  f"{what}: geometry table != plain table")
            del plain
        if first is None:
            first = fast
        del fast, exact, out
        torch.cuda.empty_cache()
    kernels["tsdf_geometry"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/tsdf_geometry.cu",
        replaces="lidar_transfer_tpu/ops/tsdf_pallas.py:436",
        max_abs_err=row_err)
    return first


def _check_confusion_cases(torch, rng) -> None:
    """Phase 1 for the confusion counts, exact against the plain version:
    C = 260, 20, 1 and 37, and 1500 (over the classes whose diagonal a
    block keeps), N = 0, 1, 131,072 and 2^20, skewed and uniform labels,
    and inputs off their alignment."""
    from lidar_transfer_tpu_torch.metrics import confusion as TF
    from lidar_transfer_tpu_torch.probes.cases import confusion_labels

    dev = torch.device("cuda")
    n_cases = 0
    for C in (260, 20, 1, 37, 1500):
        for m in (0, 1, 131072, 1 << 20):
            for skewed in (True, False):
                p, t = (torch.from_numpy(a).to(dev) for a in
                        confusion_labels(rng, m, C, skewed, stray=True))
                got = TF.confusion_matrix(p, t, C)
                ref = TF.confusion_scatter(p, t, C)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"confusion C={C} N={m} "
                      f"{'skewed' if skewed else 'uniform'} != plain")
                n_cases += 1
                if m > 1:
                    got = TF.confusion_matrix(p[1:], t[1:], C)
                    check(torch.equal(got, TF.confusion_scatter(
                        p[1:], t[1:], C)), f"confusion C={C} N={m - 1} off "
                        "its alignment != plain")
                    n_cases += 1
    print(f"confusion: {n_cases} cases (C = 260, 20, 1, 37, 1500; N = 0, 1, "
          "131072, 2^20 and one less off their alignment; skewed and "
          "uniform labels) equal to plain")


def _check_fusion_kernels(torch, rng, kernels) -> None:
    """Phase 1 for the geometry table (``_check_geometry_kernel``) and,
    with its table at 256x256x208, the chain and the compact state, S=3,
    against their plain versions."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_chain_cuda, integrate_cuda)

    dev = torch.device("cuda")
    spec = TS.VolumeSpec((-6.4, -6.4, -5.0), 0.05, (256, 256, 208))
    fov = dict(fov_up_deg=3.0, fov_down_deg=-25.0)
    S, H, W = 3, 64, 2048
    depth = (rng.uniform(1.0, 12.0, (S, H, W))
             * (rng.random((S, H, W)) > 0.2)).astype(np.float32)
    stacks = [torch.from_numpy(a).to(dev) for a in (
        depth, rng.integers(0, 4, (S, H, W)).astype(np.int32),
        rng.random((S, H, W)).astype(np.float32))]

    table = _check_geometry_kernel(torch, kernels)

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
    against its plain version: the parts probe's int16 labels exact and
    bf16 outputs within one bf16 ulp; the ablate probe bit for bit, also at
    Z = 206, at an X*Y that a warp's 8 columns do not divide and with a
    misaligned table; the writes byte for byte in every block, dtype,
    output count, flat-row, read-first and alias case, odd sizes too."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import \
        precompute_geometry_cuda
    from lidar_transfer_tpu_torch.probes import ablate, parts, runs, write
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
    share = float(upd.float().mean())
    labels = int(torch.unique(ref[1][upd]).numel())
    # sizes a run of 8 columns or an 8-voxel vector does not divide: an X*Y
    # that 8 does not divide with Z = 206 (one voxel a lane) and Z = 204
    # (four), and Z = 206 at an X*Y that 8 divides (eight)
    vecs = set()
    for odims in ((63, 255, 206), (63, 255, 204), (64, 256, 206)):
        oargs = [a[:odims[0], :, :odims[1]].contiguous() for a in args[1:]]
        vecs.add(parts.parts_plan(*odims).vec)
        for variant in parts.VARIANTS:
            for n_out in (1, 3):
                ref = parts.parts_plain(variant, args[0], *oargs, Z=odims[2],
                                        n_out=n_out)
                for bx in (2, 3):
                    worst = max(worst, max_diff(
                        parts.probe_parts(variant, args[0], *oargs,
                                          Z=odims[2], n_out=n_out, BX=bx),
                        ref, f"probe_parts {variant} x{n_out} BX{bx} "
                        f"{odims}"))
    print(f"probe_parts {dims}: 4 variants x 1/3 outputs x BX 2/4/8, and "
          f"at 63x255x206, 63x255x204, 64x256x206 x BX 2/3 ({sorted(vecs)} "
          f"voxels a lane), equal to plain (labels exact, bf16 within one "
          f"ulp), max |diff| {worst:g}; full updates {share:.4f} of voxels, "
          f"{labels} labels")
    check(vecs == {1, 4, 8}, "probe_parts: a vector width untested")
    check(0.001 < share < 0.9, "probe_parts updates no share of the "
          "voxels")
    kernels["probe_parts"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/probe_parts.cu",
        replaces="scripts/probe_kernel_parts.py:94", max_abs_err=worst)

    # ablate: depths 13-19 m around a volume 14 m out, labels 0..19 (0
    # takes the same-class branch), a crop short of the dims; bit for bit
    # equal to the plain version at the dims above (BX 1, 2, 4), at Z = 206
    # (8-voxel vectors: the runs hold 8 columns), at an X*Y that 8 does not
    # divide (Z = 256: a short last run of whole vectors; Z = 204: 4 voxels
    # a lane; Z = 206: one) and with the table 4 and 1 bytes off its
    # alignment (4 voxels a lane, one)
    origin = (14.0, -6.4, -6.4)
    imgs = [torch.from_numpy(a).to(dev) for a in (
        (rng.random((64, 2048)) * 6 + 13).astype(np.float32),
        rng.integers(0, 20, (64, 2048)).astype(np.int32),
        rng.random((64, 2048)).astype(np.float32))]
    n_cases, share = 0, None
    vecs = set()
    for adims, bxs, off in ((dims, (1, 2, 4), 0),
                            ((64, 256, 206), (2, 3), 0),
                            ((63, 255, 256), (2,), 0),
                            ((63, 255, 204), (1, 2), 0),
                            ((63, 255, 206), (1, 2), 0),
                            (dims, (2,), 4),
                            (dims, (2,), 1)):
        spec = TS.VolumeSpec(origin, 0.05, adims)
        table = precompute_geometry_cuda(spec, 3.0, -25.0, 64, device=dev)
        if off:
            buf = torch.empty(table.numel() + off, dtype=torch.int8,
                              device=dev)
            table = buf[off:].view(adims).copy_(table)
        dcol, lrcol = ablate.build_cols(*imgs, adims, origin)
        args = (ablate.ablate_params(origin, (adims[0] - 4, adims[1] - 6,
                                              adims[2] - 56), dev),
                dcol, lrcol, table)
        plan = ablate.ablate_plan(
            *adims, table_align=runs.align_of(table.data_ptr()))
        vecs.add(plan.vec)
        for div in (True, False):
            ref = ablate.ablate_plain(div, *args)
            for bx in bxs:
                got = ablate.probe_ablate(div, *args, BX=bx)
                what = (f"probe_ablate div={div} {adims} BX{bx} vec "
                        f"{plan.vec} table offset {off}")
                check(all(torch.equal(g, r) for g, r in zip(got, ref)),
                      f"{what}: != plain (bit for bit)")
                n_cases += 1
            if share is None:
                upd = ref[0] < 1
                share = (float(upd.float().mean()),
                         float((upd & (ref[1] == 0)).float().mean()))
        del table, dcol, lrcol, args, ref, got
    print(f"probe_ablate: {n_cases} cases (precols and nodiv; {dims} at BX "
          f"1/2/4, Z = 206 and 204, X*Y = 16065, the table 4 and 1 bytes off "
          f"its alignment; {sorted(vecs)} voxels a lane) equal to plain bit "
          f"for bit; updates {share[0]:.4f} of voxels, same-class "
          f"{share[1]:.4f}")
    check(vecs == {1, 4, 8}, "probe_ablate: a vector width untested")
    check(0.001 < share[0] < 0.9, "probe_ablate updates no share of the "
          "voxels")
    kernels["probe_ablate"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/probe_ablate.cu",
        replaces="scripts/probe_integrate_ablate.py:53", max_abs_err=0.0)

    # write: blocks, dtypes, three outputs, flat rows, reading first, odd
    # sizes whose runs end inside a tile, each output between guards of 16
    # elements of 7 that must stay 7; byte for byte equal to the plain fill
    def guarded(shape, dt):
        n = shape[0] * shape[1] * shape[2]
        buf = torch.full((n + 32,), 7, dtype=dt, device=dev)
        return buf, buf[16:16 + n].view(shape)

    all_dts = list(write.CODES)
    n = 0
    for wdims, dts, block in (
            [(dims, [torch.bfloat16], dict(BX=1, BY=256)),
             (dims, [torch.bfloat16], dict(BX=2, BY=128)),
             (dims, [torch.float32], dict(BX=4, BY=256)),
             (dims, [torch.int32], dict(BX=4, BY=256)),
             (dims, [torch.int8], dict(BX=4, BY=256)),
             (dims, [torch.int16], dict(BX=8, BY=64)),
             (dims, [torch.bfloat16] * 3, dict(BX=2, BY=256)),
             (dims, [torch.bfloat16], dict(BX=8, BY=256)),
             (dims, [torch.bfloat16], dict(BR=256)),
             (dims, [torch.bfloat16], dict(BR=1024)),
             ((63, 250, 208), [torch.bfloat16, torch.float32, torch.int8],
              dict(BX=7, BY=5)),
             ((63, 250, 208), [torch.int8, torch.int16, torch.int32],
              dict(BR=126))]
            + [(dims, [dt], dict(BX=4, BY=256, read_first=True))
               for dt in all_dts]
            + [((63, 250, 208), [torch.bfloat16, torch.float32, torch.int8],
                dict(BX=9, BY=25, read_first=True))]):
        bufs = [guarded(wdims, dt) for dt in dts]
        write.probe_write([o for _, o in bufs], **block)
        ref = write.write_plain([torch.empty(wdims, dtype=dt, device=dev)
                                 for dt in dts])
        for i, ((buf, o), r) in enumerate(zip(bufs, ref)):
            check(torch.equal(o, r), f"probe_write {wdims} {dts} {block}: "
                  f"output {i} != plain fill (byte for byte)")
            check(bool((buf[:16] == 7).all() and (buf[-16:] == 7).all()),
                  f"probe_write {wdims} {dts} {block}: wrote past output "
                  f"{i}")
        n += 1
    # probe_alias's modes, in each dtype, over old contents of 7
    for mode in write.ALIAS_MODES:
        for dt in all_dts:
            state = [torch.full(dims, 7, dtype=dt, device=dev)
                     for _ in range(4)]
            out = write.alias_call(mode, state, BX=2, BY=256)
            ref = write.write_plain([torch.empty_like(t)
                                     for t in state[:3]])
            check(all(torch.equal(o, r) for o, r in zip(out[:3], ref)),
                  f"alias {mode} {dt}: != plain fill (byte for byte)")
            check(len(out) == (4 if mode == "alias_any4" else 3)
                  and (mode == "noalias") != (out[0] is state[0])
                  and (mode != "alias_any4" or out[3] is state[3]),
                  f"alias {mode}: outputs not arranged as the mode says")
            n += 1
    print(f"probe_write: {n} block, dtype, row, read-first, odd-size and "
          "alias cases (every mode in every dtype) equal to the plain fill "
          "byte for byte, nothing written past an output")
    kernels["probe_write"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/probe_write.cu",
        replaces="scripts/probe_pallas_write.py:40", max_abs_err=0.0)
    # row 6, the alias probe, is the same kernel: its own JSON row, counted
    # by the kernel's launches
    kernels["probe_alias"] = dict(
        kernels["probe_write"], replaces="scripts/probe_alias.py:31",
        counter="probe_write")


def _march_volume(torch, dev, compact):
    """A TSDF as the integrate leaves one, 256x256x96 voxels of 0.1 m
    around the sensor: a ground plane, a wall and a box, tsdf = sdf / trunc
    in the 5-voxel band and 1 elsewhere, labels 40, 50, 10 and random
    remissions in the band. -> (state, spec)."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS

    spec = TS.VolumeSpec((-12.8, -12.8, -3.2), 0.1, (256, 256, 96))
    g = [spec.origin[i] + np.arange(spec.dims[i]) * spec.voxel_size
         for i in range(3)]
    x, y, z = np.meshgrid(*g, indexing="ij")
    box = np.maximum(np.maximum(np.abs(x + 4) - 1.5, np.abs(y - 5) - 2),
                     np.abs(z) - 1.5)
    sdfs = np.stack([z + 1.7, 11.0 - x, box])
    sdf = sdfs.min(0)
    trunc = spec.trunc_margin
    band = np.abs(sdf) < trunc
    arrays = (np.where(band, np.clip(sdf / trunc, -1, 1), 1.0),
              np.zeros(spec.dims),
              np.where(band, np.array([40, 50, 10])[sdfs.argmin(0)], 0),
              np.where(band, np.random.default_rng(5).random(spec.dims), 0))
    dts = TS.COMPACT_DTYPES if compact else TS.F32_DTYPES
    state = TS.TSDFState(*(torch.from_numpy(a).to(dev).to(dt)
                           for a, dt in zip(arrays, dts)))
    return state, spec


def _compare_marches(torch, got, ref, what: str) -> float:
    """Hold the kernel's march against the plain one on every ray: range,
    label, remission, endpoints and hit equal bit for bit (the kernel
    repeats the plain march's float32 arithmetic). -> the largest range
    difference (0)."""
    r = got[0].numel()
    bad_h = int((got[4] != ref[4]).sum())
    bad_l = int((got[1] != ref[1]).sum())
    d = (got[0] - ref[0]).abs()
    worst = float(d.max()) if d.numel() else 0.0
    print(f"{what}: hit mismatches {bad_h}, label mismatches {bad_l} of "
          f"{r} rays, {int((got[4] & ref[4]).sum())} both hit, max |range "
          f"diff| {worst:g} m")
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          f"{what}: the kernel's march differs from raycast_plain")
    return worst


def _check_pack_kernel(torch, kernels) -> None:
    """Phase 1 for the occupancy's packing into bits against
    ``pack_occupancy_plain``, word for word, on random grids whose cell
    counts the 4 x 4 x 2 brick does and does not divide (the reference
    frame's 512 x 512 x 52 among them); the words give back the grid."""
    from lidar_transfer_tpu_torch.ops import raycast as RC
    from lidar_transfer_tpu_torch.ops.raycast_cuda import pack_occupancy_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = ((512, 512, 52), (64, 64, 24), (63, 62, 33), (5, 7, 3),
              (1, 1, 1), (129, 3, 97))
    for cells in shapes:
        for p in (0.05, 0.5):
            occ = torch.rand(cells, device=dev, generator=gen) < p
            got = pack_occupancy_cuda(occ)
            ref = RC.pack_occupancy_plain(occ)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"pack {cells}: kernel != plain")
            check(torch.equal(RC.occupancy_from_words(got, cells), occ),
                  f"pack {cells}: the words do not give back the grid")
    print(f"raymarch_pack: {2 * len(shapes)} grids equal to "
          f"pack_occupancy_plain word for word, up to {shapes[0]} cells")
    kernels["raymarch_pack"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/raymarch.cu",
        replaces="lidar_transfer_tpu/ops/raycast.py:234", max_abs_err=0)


def _check_raymarch_kernel(torch, kernels) -> None:
    """Phase 1 for the raymarch kernel against ``raycast_plain`` on a
    synthetic 256x256x96 volume and 32x2048 HDL32 rays (full width),
    float32 and compact state, every ray equal: a shared origin, (R, 3)
    jittered origins and a rolling-shutter sensor's (R, 3) origins
    (``generate_rays_moving``, 1.5 m forward and 2 degrees of yaw over
    the frame), the default fine step of 0.5 voxels on the volume's
    occupancy grid and the engine's 2 voxels on the occupancy of points;
    max_steps at K - 1, K and K + 1 past the sixth batch boundary of a
    ray that keeps its step (K = ``raycast_cuda.AHEAD``, the samples
    walked ahead of their loads; a batch also ends where a sample's
    occupancy changes the step); rays that start inside negative space (the
    box's band). Rays that end at t_far after a count of samples K does not
    divide are counted and must occur."""
    from lidar_transfer_tpu_torch.ops import raycast as RC
    from lidar_transfer_tpu_torch.ops.raycast_cuda import AHEAD

    dev = torch.device("cuda")
    rays = torch.from_numpy(RC.generate_rays(32, 2048, 10.67,
                                             -30.67)).to(dev)
    r = rays.shape[0]
    per_ray = torch.from_numpy(np.random.default_rng(3).uniform(
        -0.3, 0.3, (r, 3)).astype(np.float32)).to(dev)
    yaw = np.deg2rad(2.0)
    pose = np.eye(4)
    pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    pose[:3, 3] = [1.5, 0.1, 0.0]
    m_rays, m_orig = (torch.from_numpy(a).to(dev) for a in
                      RC.generate_rays_moving(32, 2048, 10.67, -30.67, pose))
    # inside the box's negative band (sdf -0.2 m, tsdf -0.4): the seed
    # and the first samples are <= 0
    inside_box = torch.tensor([-4.0, 5.0, -1.3], device=dev)
    worst, n, mid_batch = 0.0, 0, 0
    for compact in (False, True):
        state, spec = _march_volume(torch, dev, compact)
        pts = (rays * 6.0).contiguous()
        grid_occ = RC.occupancy_grid(state.tsdf)
        pts_occ = RC.occupancy_from_points(
            pts, torch.ones(r, dtype=torch.bool, device=dev), spec.origin,
            spec, pixel_angle_rad=0.0076)
        cases = [(rays, o, fine, occ, steps)
                 for o in (torch.zeros(3, device=dev), per_ray)
                 for fine, occ, steps in ((0.5, grid_occ, None),
                                          (2.0, pts_occ, None),
                                          (0.5, grid_occ, 90))]
        cases += [(rays, torch.zeros(3, device=dev), 0.5, grid_occ,
                   6 * AHEAD + k) for k in (-1, 0, 1)]
        cases += [(rays, inside_box, 0.5, grid_occ, None),
                  (m_rays, m_orig, 2.0, pts_occ, None),
                  (m_rays, m_orig, 0.5, grid_occ, None)]
        for rs, origin, fine, occ, steps in cases:
            prm = RC.march_params(spec, spec.origin, 4, fine)
            steps = steps or RC.default_max_steps(spec, fine)
            args = (state, occ, rs, origin, prm, spec.dims, 4, steps)
            got = RC.raymarch(*args)
            stats = {}
            ref = RC.raycast_plain(*args, stats=stats)
            torch.cuda.synchronize()
            worst = max(worst, _compare_marches(
                torch, got, ref, f"raymarch {spec.dims} "
                f"{'compact' if compact else 'f32'} origin "
                f"{tuple(origin.shape)} fine {fine} max_steps {steps}"))
            # the loop's samples of a ray that neither hits nor reaches
            # max_steps end at t_far: inside a batch of a ray that keeps its
            # step unless K divides them
            loop = stats["ray_samples"] - 1
            mid_batch += int((~ref[4] & (loop < steps)
                              & (loop % AHEAD != 0)).sum())
            check(float(ref[4].float().mean()) > 0.1,
                  "raymarch: no share of the rays hits")
            n += 1
        del state
    check(mid_batch > 0, "raymarch: no ray ended at t_far inside a "
          "batch")
    print(f"raymarch: {n} cases equal to raycast_plain on every ray "
          f"({mid_batch} rays ended at t_far after a count of samples "
          f"{AHEAD} does not divide)")
    kernels["raymarch"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/raymarch.cu",
        replaces="lidar_transfer_tpu/ops/raycast.py:234", max_abs_err=worst)


#: the launch keys of row C on the path: its four build kernels and the
#: traversal, once each a call of ``raycast_mesh`` on the card
MESH_KEYS = ("mesh_bvh_keys", "mesh_bvh_hierarchy", "mesh_bvh_refit",
             "mesh_bvh_reorder", "mesh_raycast")


def _same_bvh(torch, got, ref) -> bool:
    """Two BVHs are equal: every node record, parent, leaf's triangle and
    row, key and the height."""
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def _mesh_cases(torch, dev, rng):
    """Row C's cases on the card: -> [(name, origins, dirs, triangles,
    index of the first copy or None)]. Random soups of 1, 512 (one tile
    of the dense kernel) and 5,003 triangles (a ragged last tile) followed
    by exact copies of every 7th triangle (a tie in t, which the lower
    index keeps), against 65,613 rays (a ragged last block), from a shared
    origin and from (R, 3) origins; one triangle alone (the root a leaf);
    a heightfield of 64 x 64 cells of two triangles with the rays aimed at
    its vertices and at the midpoints of its x edges and of its cells'
    diagonals (shared by two triangles), and the six axis directions, from
    a shared origin above a vertex."""
    R = 65536 + 77
    d = rng.normal(size=(R, 3)).astype(np.float32)
    dirs = torch.from_numpy(d / np.linalg.norm(d, axis=1,
                                               keepdims=True)).to(dev)
    origins = (torch.zeros(3, device=dev), torch.from_numpy(
        rng.uniform(-1, 1, (R, 3)).astype(np.float32)).to(dev))
    cases = []
    for T in (1, 512, 5003):
        c = rng.uniform(-8, 8, (T, 3)).astype(np.float32)
        tri = c[:, None, :] + rng.normal(0, 0.6, (T, 3, 3)).astype(
            np.float32)
        if T == 512:   # one triangle alone: the root is a leaf
            cases.append(("one triangle", origins[0], dirs,
                          torch.from_numpy(tri[:1]).to(dev), None))
        tri = torch.from_numpy(np.concatenate([tri, tri[::7]])).to(dev)
        for o in origins:
            cases.append((f"soup T={tri.shape[0]} R={R} origin "
                          f"{tuple(o.shape)}", o, dirs, tri, T))
    g = np.arange(65, dtype=np.float32) * np.float32(0.25) - np.float32(8)
    x, y = np.meshgrid(g, g, indexing="ij")
    z = (np.float32(-2) + np.float32(0.1) * np.sin(x) * np.cos(y)).astype(
        np.float32)
    v = np.stack([x, y, z], -1)
    quad = np.stack([v[:-1, :-1], v[1:, :-1], v[1:, 1:], v[:-1, 1:]], 2)
    hf = np.concatenate([quad[:, :, [0, 1, 2]], quad[:, :, [0, 2, 3]]],
                        0).reshape(-1, 3, 3)
    o = np.array([0.0, 0.0, 0.0], np.float32)
    targets = np.concatenate([v.reshape(-1, 3), (
        (v[1:, :] + v[:-1, :]) * np.float32(0.5)).reshape(-1, 3), (
        (quad[:, :, 0] + quad[:, :, 2]) * np.float32(0.5)).reshape(-1, 3)])
    hd = targets - o
    hd = hd / np.linalg.norm(hd, axis=1, keepdims=True)
    hd = np.concatenate([hd, np.eye(3, dtype=np.float32),
                         -np.eye(3, dtype=np.float32)]).astype(np.float32)
    cases.append((f"heightfield T={hf.shape[0]} R={hd.shape[0]}",
                  torch.from_numpy(o).to(dev), torch.from_numpy(hd).to(dev),
                  torch.from_numpy(np.ascontiguousarray(hf)).to(dev), None))
    return cases


def _check_mesh_raycast_kernel(torch, kernels) -> None:
    """Phase 1 for row C against its plain versions on the card, bit for
    bit (t, triangle index and hit on every ray) in each case of
    :func:`_mesh_cases`: ``raycast_mesh`` (the BVH built by the four build
    kernels, the traversal launched once) against ``raycast_mesh_plain``,
    the dense sweep; the card's build against ``build_bvh_plain`` on the
    same tensors, equal; the dense kernel against ``raycast_mesh_plain``.
    An empty mesh misses everywhere without a launch."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.ops import triangles as TT
    from lidar_transfer_tpu_torch.ops.triangles_cuda import (
        mesh_raycast_dense_cuda)

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    n, later, tied = 0, 0, 0
    for name, o, dirs, tri, copies in _mesh_cases(torch, dev, rng):
        before = _build.launch_counts()
        got = TT.raycast_mesh(o, dirs, tri)
        torch.cuda.synchronize()
        launched = _launches_since(before)
        want = {k: 1 for k in MESH_KEYS
                if k != "mesh_bvh_hierarchy" or tri.shape[0] > 1}
        check(launched == want, f"raycast_mesh {name}: launches "
              f"{launched}, not once each of {sorted(want)}")
        ref = TT.raycast_mesh_plain(o, dirs, tri)
        dense = mesh_raycast_dense_cuda(o.contiguous(), dirs, tri)
        reach = TT.ray_reach(o, dirs)
        same_build = _same_bvh(torch, TT.build_bvh(tri, reach),
                               TT.build_bvh_plain(tri, reach))
        torch.cuda.synchronize()
        hits = int(ref.hit.sum())
        print(f"mesh_raycast {name}: {hits} hits; BVH route against the "
              f"dense sweep: t mismatches {int((got.t != ref.t).sum())}, "
              f"tri mismatches {int((got.tri != ref.tri).sum())}; card "
              f"build equal to build_bvh_plain: {same_build}; dense kernel "
              f"t/tri mismatches {int((dense[0] != ref.t).sum())}/"
              f"{int((dense[1] != ref.tri).sum())}")
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"mesh_raycast {name}: BVH route != raycast_mesh_plain")
        check(same_build, f"mesh_raycast {name}: card build != "
              "build_bvh_plain")
        check(torch.equal(dense[0], ref.t) and torch.equal(dense[1],
                                                          ref.tri),
              f"mesh_raycast {name}: dense kernel != raycast_mesh_plain")
        check(tri.shape[0] < 4 or hits > dirs.shape[0] // 20,
              f"mesh_raycast {name}: too few hits")
        if copies is not None:
            # a hit on a triangle with a copy is a tie in t; the copy's
            # higher index must never win it
            later += int((ref.tri >= copies).sum())
            tied += int((ref.hit & (ref.tri % 7 == 0)).sum())
        n += 1
    check(later == 0 and tied > 0, f"mesh_raycast: {tied} ties, {later} "
          "won by a later copy")
    before = _build.launch_counts()
    empty = TT.raycast_mesh(torch.zeros(3, device=dev),
                            torch.ones((4, 3), device=dev),
                            torch.zeros((0, 3, 3), device=dev))
    check(not bool(empty.hit.any()) and bool((empty.tri == -1).all())
          and _build.launch_counts() == before,
          "mesh_raycast: an empty mesh hit or launched")
    print(f"mesh_raycast: {n} cases, the BVH route and the dense kernel "
          "equal to raycast_mesh_plain on every ray, bit for bit, and the "
          "card's build equal to build_bvh_plain")
    src = "lidar_transfer_tpu_torch/csrc/"
    for key, source in (("mesh_raycast", "mesh_raycast.cu"),
                        ("mesh_raycast_dense", "mesh_raycast.cu"),
                        ("mesh_bvh_keys", "mesh_bvh.cu"),
                        ("mesh_bvh_hierarchy", "mesh_bvh.cu"),
                        ("mesh_bvh_refit", "mesh_bvh.cu"),
                        ("mesh_bvh_reorder", "mesh_bvh.cu")):
        kernels[key] = dict(
            route="cuda", source=src + source,
            replaces="lidar_transfer_tpu/ops/triangles.py:57",
            max_abs_err=0.0)


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


def _check_group_norm(torch, kernels) -> None:
    """Kernel D against its plain version (ConvNorm's composition, under
    autocast for bf16 as RangeNet runs it) at darknet53's distinct norm
    shapes of a 1x64x2048 forward, in bf16 and float32, by
    ``probes/cases.check_norm``."""
    from lidar_transfer_tpu_torch.models.rangenet import (GN_EPS,
                                                          GROUP_SIZE,
                                                          RangeNetConfig)
    from lidar_transfer_tpu_torch.ops import group_norm as GN
    from lidar_transfer_tpu_torch.probes.cases import (check_norm,
                                                       norm_inputs,
                                                       norm_shapes)

    dev = torch.device("cuda")
    worst, least = 0.0, 1.0
    for C, H, W in dict.fromkeys(norm_shapes(RangeNetConfig.darknet53(),
                                             64, 2048)):
        G = C // GROUP_SIZE
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = norm_inputs(C, H, W, dev, dtype, seed=C + W)
            got = GN.group_norm_leaky_relu(x, G, w, b, GN_EPS)
            with torch.autocast("cuda", dtype=torch.bfloat16,
                                enabled=dtype != torch.float32):
                want = GN.group_norm_leaky_relu_plain(x, G, w, b, GN_EPS)
            torch.cuda.synchronize()
            what = f"group_norm (1, {C}, {H}, {W}) G={G} {dtype}"
            equal = check_norm(got, want, what)
            err = float((got.float() - want.float()).abs().max())
            print(f"{what}: {equal:.6f} of the elements equal, max |diff| "
                  f"{err:g}")
            worst, least = max(worst, err), min(least, equal)
    print(f"group_norm: least equal share {least:.6f}, max |diff| {worst:g}")
    kernels["group_norm"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/group_norm.cu",
        replaces="lidar_transfer_tpu/models/rangenet.py:80 (flax GroupNorm,"
                 " an XLA fusion)",
        max_abs_err=worst)


def _check_ptv3_kernels(torch, kernels) -> None:
    """Kernels E (the neighbour map) and F (the serialization codes)
    against their plain versions on the card, bit for bit: the codes at
    depths 1 to 16 with four clouds, the maps of kernels 3 and 5 over
    sparse and dense cells in two clouds."""
    from lidar_transfer_tpu_torch.ops import serialize as S
    from lidar_transfer_tpu_torch.ops import sparse_conv as SC

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(25)
    for bits in (1, 5, 12, 16):
        grid = torch.randint(0, 1 << bits, (200_003, 3), generator=g,
                             dtype=torch.int32)
        cloud = torch.randint(0, 4, (200_003,), generator=g)
        got = S.encode_cuda(grid.to(dev), cloud.to(dev), bits).cpu()
        check(torch.equal(got, S.encode_plain(grid, cloud, bits)),
              f"ptv3_serialize differs from its plain version at {bits} "
              "bits")
    print("ptv3_serialize: codes equal at 1, 5, 12 and 16 bits")
    kernels["ptv3_serialize"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/serialize.cu",
        replaces="none (no point model in the JAX package)",
        max_abs_err=0.0)
    for side, k in ((40, 3), (400, 3), (40, 5), (400, 5)):
        grid = torch.unique(torch.randint(0, side, (150_000, 3), generator=g,
                                          dtype=torch.int32), dim=0)
        cloud = torch.randint(0, 2, (grid.shape[0],), generator=g)
        got = SC.neighbor_map_cuda(grid.to(dev), cloud.to(dev), k).cpu()
        check(torch.equal(got, SC.neighbor_map_plain(grid, cloud, k)),
              f"ptv3_neighbor_map differs from its plain version (k {k}, "
              f"side {side})")
    print("ptv3_neighbor_map: maps equal at kernels 3 and 5, dense and "
          "sparse cells")
    kernels["ptv3_neighbor_map"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/neighbor_map.cu",
        replaces="none (no point model in the JAX package)",
        max_abs_err=0.0)


def kernel_checks(torch, kernels) -> tuple:
    """Phase 1: build the kernels and hold each against its plain version
    on the card, filling ``kernels`` with a row each. -> the z-buffer's and
    the confusion's inputs (pix, key, npix, pred, target, C), whose device
    operations ``main`` counts."""
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
    _check_confusion_cases(torch, rng)
    _check_group_norm(torch, kernels)
    _check_ptv3_kernels(torch, kernels)

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
    _check_pack_kernel(torch, kernels)
    _check_raymarch_kernel(torch, kernels)
    _check_mesh_raycast_kernel(torch, kernels)
    return pix_t, key_t, npix, pred_t, tgt_t, C


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from lidar_transfer_tpu_torch.metrics import confusion as TF
    from lidar_transfer_tpu_torch.ops import projection as TP

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu)
    tag = f"[{gpu}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    kernels = {}
    pix_t, key_t, npix, pred_t, tgt_t, C = kernel_checks(torch, kernels)

    # ------------- the two small kernels' device operations and scratch
    ws = TP.ZBufferWorkspace(dev)
    _, z_ops, z_names = device_ms(lambda: TP.zbuffer_winners(
        pix_t, key_t, npix, workspace=ws), 50)
    print(f"zbuffer with the engine's workspace: {z_ops:.1f} device "
          f"operations a call ({z_names}), {ws.allocations} scratch "
          f"allocation {tag}")
    check(z_ops <= 2 and ws.allocations == 1, "a z-buffer call with a "
          "workspace issues more than two device operations or allocates")
    _, c_ops, c_names = device_ms(
        lambda: TF.confusion_matrix(pred_t, tgt_t, C), 50)
    print(f"confusion N={pred_t.shape[0]} C={C}: {c_ops:.1f} device "
          f"operations a call ({c_names}) {tag}")
    check(c_ops <= 2, "a confusion call takes more than two device "
          "operations")

    # ------------------------------------------------------ 2. the paths
    paths, per_frame = {}, {}
    with tempfile.TemporaryDirectory(prefix="lt_smoke_") as work:
        paths["mergemesh"] = _main_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["mesh"] = _mesh_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["cp"] = _cp_path(torch, work, tag, per_frame)
        paths["catmesh"] = _catmesh_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["oracle"] = _oracle_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["upsample"] = _upsample_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["raymarch"] = _raymarch_path(torch, work, kernels, tag,
                                           per_frame)
        torch.cuda.empty_cache()
        paths["rolling"] = _rolling_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["segmentation"] = _segmentation_path(torch, work, per_frame)
        torch.cuda.empty_cache()
        paths["segmentation_ptv3"] = _ptv3_path(torch, work, per_frame)
        torch.cuda.empty_cache()
        paths["parallel"] = _parallel_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["front_end"] = _front_end_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
        paths["runners"] = _runners_path(torch, work, tag, per_frame)
        torch.cuda.empty_cache()
    paths["probes"] = per_frame["probes"] = _probe_path(torch, kernels, tag)
    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "lidar_transfer_tpu"
                  or m.startswith("lidar_transfer_tpu.")
                  for m in sys.modules), "the port imported the JAX package")
    check(not any(m.split(".")[0] in ("matplotlib", "PIL")
                  for m in sys.modules), "the port imported matplotlib or PIL")
    rows = []
    for name, k in kernels.items():
        counter = k.pop("counter", name)
        k["launches"] = sum(c[counter] for c in paths.values())
        k["launches_per_frame"] = {
            path: c[counter] for path, c in per_frame.items()
            if c.get(counter)}
        print(f"kernel {name}: max |diff| {k['max_abs_err']:g}, launches "
              f"{k['launches']}, per frame {k['launches_per_frame']}")
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


def _main_path(torch, work, tag, per_frame):
    """Phases 2-4 of the mergemesh path in the scratch directory ``work``
    (it writes the synthetic dataset ``work/kitti``); returns the launch
    counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.datasets import synthetic
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.ops import tsdf as TS
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
    _miss_decomposition(pts, valid, vs_card, hdl32, "mergemesh splat frame "
                        "0", tag, eng._zbuf)
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
    wins = [load_window(seq, cfg, i, cap, dev) for i in range(6)]
    frame_ms = _wall_ms(torch, lambda: [eng.transfer_fast(w)
                                          for w in wins], 10) / len(wins)
    stacked = stack_windows(wins[:4])
    stream_ms = _wall_ms(torch, lambda: eng.transfer_stream(stacked), 10)
    print(f"transfer_fast HDL64->HDL32: {frame_ms:.3f} ms/frame "
          f"({1e3 / frame_ms:.1f} scans/s) {tag}")
    print(f"transfer_stream 4 frames: {stream_ms:.3f} ms/batch "
          f"({4e3 / stream_ms:.1f} scans/s) {tag}")
    _profile_frames(torch, eng, wins, frame_ms, tag)
    return counts


def _mesh_path(torch, work, tag, per_frame):
    """Phases 2-4 of the mesh adaption, three scans per window, on the
    dataset ``work/kitti``; returns the launch counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.ops import tsdf as TS
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
    fold_ms = _wall_ms(torch, lambda: [eng.transfer_fast(w)
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
    del eng
    torch.cuda.empty_cache()
    vol = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev, mesh_attrs="volume",
                            compact_volume=True)
    vol_ms = _wall_ms(torch, lambda: [vol.transfer_fast(w)
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
    ms = _wall_ms(torch, lambda: [eng.transfer(w) for w in wins],
                  10) / len(wins)
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
        ms[name].append(_wall_ms(torch, lambda: [e.transfer_fast(w)
                                                 for w in wins], 10)
                        / len(wins))
    print("catmesh transfer_fast HDL64->HDL32: " + "; ".join(
        f"{k} {' / '.join(f'{v:.3f}' for v in vs)} ms/frame"
        for k, vs in ms.items()) + f" (timed mergemesh, catmesh, catmesh, "
        f"mergemesh) {tag}")
    _profile_frames(torch, eng, wins, min(ms["catmesh"]), tag)
    return counts


def _oracle_path(torch, work, tag, per_frame):
    """Catmesh's oracle engine at the reference point on the dataset
    ``work/kitti`` (HDL64 -> HDL32, fixed bounds, float32 state): three
    frames of scan 0 through ``transfer_fast``, each stage timed
    (``TransferEngine.spans``), row C's four build kernels and its
    traversal launched once a frame and the dense kernel never; on the
    frame's whole mesh, row C against the dense kernel on all 65,536 rays
    and against ``raycast_mesh_plain`` and ``raycast_mesh_bvh_plain`` on
    two full rows (bit for bit), the card's build against
    ``build_bvh_plain`` (equal), and against the port's native BVH on all
    rays; the frame against the splat engine's. Returns the launch counts
    of the path."""
    from lidar_transfer_tpu_torch import _build, native
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.ops import triangles as TT
    from lidar_transfer_tpu_torch.ops import triangles_cuda as TC
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import load_window

    dev = torch.device("cuda")
    cfg, _ = _config(work, "oracle", adaption="catmesh")
    hdl32 = SensorSpec.from_yaml(HDL32_PATH)
    seq, cap = _sequence(work)
    eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev, catmesh_engine="oracle")
    w0 = load_window(seq, cfg, 0, cap, dev)

    # ------------------------------------------- 2. the path, as a user
    _build.reset_launch_counts()
    frames, spans, walls = [], [], []
    for _ in range(3):
        eng.spans = {}
        t = time.perf_counter()
        frames.append(eng.transfer_fast(w0))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        spans.append(eng.spans)
    counts = _build.launch_counts()
    eng.spans = None
    per_frame["oracle"] = {k: v / 3 for k, v in counts.items() if v}
    print(f"launches on the oracle path (3 frames): {counts}")
    for k in ("zbuffer", "tsdf_integrate", "tsdf_geometry"):
        check(counts[k] > 0, f"kernel {k} never launched on the oracle "
              "path")
    for k in MESH_KEYS:
        check(counts[k] == 3, f"row C's {k} not launched once a frame")
    check(counts["mesh_raycast_dense"] == 0, "the dense kernel of row C "
          "launched on the oracle path")
    check(all(_equal_scans(torch, f, frames[0]) for f in frames[1:]),
          "oracle: three frames of one scan differ")
    vs, mesh = frames[0], eng._last_mesh
    check(vs.adaption == "catmesh" and mesh is not None, "oracle: no mesh")
    T, V = mesh.faces.shape[0], mesh.verts.shape[0]
    cats = sorted(k for k in spans[0] if k.startswith("march["))
    med = {k: float(np.median([s.get(k, 0.0) for s in spans]))
           for k in spans[0]}
    march = float(np.median([sum(s[k] for k in cats) for s in spans]))
    order = ["projection", "integrate", "cells", "dedupe", "upload",
             "raycast", "attributes"]
    print(f"oracle frame HDL64->HDL32 (catmesh, fixed bounds, f32): wall "
          f"{' / '.join(f'{w:.3f}' for w in walls)} s (median "
          f"{float(np.median(walls)):.3f}); T = {T} triangles, V = {V} "
          f"vertices, {len(cats)} categories, R = {eng.rays.shape[0]} rays "
          f"{tag}")
    print("oracle frame split, median of 3 (s): " + "; ".join(
        f"{k} {med[k]:.4f}" for k in order if k in med)
        + f"; host marching {march:.4f} ({', '.join(f'{k} {med[k]:.3f}' for k in cats)}) {tag}")
    hit = float(vs.mask.float().mean())
    splat = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                              device=dev).transfer_fast(w0)
    both = vs.mask & splat.mask
    diff = (vs.range - splat.range)[both].abs()
    print(f"oracle frame against the splat engine's: hit rate {hit:.4f} "
          f"(splat {float(splat.mask.float().mean()):.4f}), both hit "
          f"{float(both.float().mean()):.4f}, labels equal on "
          f"{float((vs.label == splat.label)[both].float().mean()):.4f} of "
          f"those, range difference median {float(diff.median()):.4f} m")
    check(hit > 0.3 and float(both.sum()) > 0.5 * float(splat.mask.sum()),
          "oracle frame mostly empty or apart from the splat frame")
    del splat

    # ------------- 3. row C on the frame's mesh: plain, dense, native BVH
    tris = torch.from_numpy(mesh.verts).to(dev)[
        torch.from_numpy(mesh.faces).to(dev).to(torch.int64)].contiguous()
    origin = torch.zeros(3, device=dev)
    rays = eng.rays
    R = rays.shape[0]
    rows = rays.reshape(hdl32.H, hdl32.W, 3)[15:17].reshape(-1, 3)
    rows = rows.contiguous()
    ref = TT.raycast_mesh_plain(origin, rows, tris, chunk=16384)
    sub = TT.raycast_mesh(origin, rows, tris)
    torch.cuda.synchronize()
    print(f"row C on rows 15-16 ({rows.shape[0]} rays) against the whole "
          f"mesh: {int(ref.hit.sum())} hits, t mismatches "
          f"{int((sub.t != ref.t).sum())}, tri mismatches "
          f"{int((sub.tri != ref.tri).sum())}")
    check(all(torch.equal(a, b) for a, b in zip(sub, ref)),
          "oracle: row C != raycast_mesh_plain on the frame's mesh")
    check(bool(ref.hit.any()), "oracle: rows 15-16 hit nothing")
    # the card's build against the plain build, stage by stage, and the
    # plain traversal of rows 15-16 through the frame's tree
    reach = TT.ray_reach(origin, rays)
    built = TT.build_bvh(tris, reach)
    keys, boxes = TT.bvh_keys_plain(tris, TT.scene_scale(tris), reach)
    keys, leaf = TT.leaf_order(keys)
    children, parents = TT.bvh_hierarchy_plain(keys)
    nodes, height = TT.bvh_refit_plain(children, boxes[leaf.to(torch.int64)])
    plain_bvh = TT.MeshBVH(nodes, parents, leaf,
                           TT.bvh_reorder_plain(tris, leaf), keys, height)
    same_build = _same_bvh(torch, built, plain_bvh)
    del keys, boxes, children, parents, nodes, plain_bvh
    stats = {}
    trav = TT.raycast_mesh_bvh_plain(origin, rows, built, stats)
    tests, visits = (stats[k].double().cpu().numpy()
                     for k in ("tests", "nodes"))
    per_ray = {name: dict(mean=float(x.mean()),
                          p99=float(np.percentile(x, 99)), max=int(x.max()))
               for name, x in (("tests", tests), ("nodes", visits))}
    print(f"row C's BVH of the frame: height {int(built.height)} (stack "
          f"{TC.STACK}); the card's build equal to build_bvh_plain: "
          f"{same_build}; rows 15-16 through it by raycast_mesh_bvh_plain: "
          f"triangles tested a ray {per_ray['tests']}, internal nodes "
          f"read a ray {per_ray['nodes']}")
    check(same_build, "oracle: the card's build != build_bvh_plain")
    check(all(torch.equal(a, b) for a, b in zip(trav, ref)),
          "oracle: raycast_mesh_bvh_plain != raycast_mesh_plain")
    del built
    full = TT.raycast_mesh(origin, rays, tris)
    dense = TC.mesh_raycast_dense_cuda(origin, rays, tris)
    torch.cuda.synchronize()
    print(f"row C against the dense kernel on all {R} rays: t mismatches "
          f"{int((full.t != dense[0]).sum())}, tri mismatches "
          f"{int((full.tri != dense[1]).sum())}, "
          f"{int(full.hit.sum())} hits")
    check(torch.equal(full.t, dense[0]) and torch.equal(full.tri, dense[1]),
          "oracle: row C != the dense kernel on the frame's rays")
    check(torch.equal(full.hit.reshape(vs.mask.shape), vs.mask)
          and torch.equal(torch.where(full.hit, full.t, 0.0).reshape(
              vs.range.shape), vs.range),
          "oracle: row C on the frame's mesh != the frame")
    t = time.perf_counter()
    nat = native.trace_mesh(rays.cpu().numpy(), np.zeros(3), mesh.verts,
                            mesh.faces, mesh.labels, mesh.rems)
    nat_s = time.perf_counter() - t
    k_hit, k_tri = full.hit.cpu().numpy(), full.tri.cpu().numpy()
    n_hit = nat.tri >= 0
    lbl = vs.label.reshape(-1).cpu().numpy()
    bh = k_hit & n_hit
    same = bh & (k_tri == nat.tri)
    seam = bh & (k_tri != nat.tri)
    mask_agree = float((k_hit == n_hit).mean())
    lbl_agree = float((lbl == nat.labels)[bh].mean())
    seam_agree = float((lbl == nat.labels)[seam].mean()) if seam.any() \
        else 1.0
    # relative: g++ contracts the native library's products into FMAs
    rng_err = float((np.abs(vs.range.reshape(-1).cpu().numpy() - nat.range)
                     / np.maximum(nat.range, 1e-6))[same].max())
    print(f"row C against the native BVH on all {R} rays ({nat_s:.1f} s "
          f"on the host, build included): hit masks agree on "
          f"{mask_agree:.6f}, both hit {int(bh.sum())}, same triangle "
          f"{int(same.sum())}; labels agree on {lbl_agree:.6f} of the "
          f"pixels both hit and on {seam_agree:.4f} of the "
          f"{int(seam.sum())} where the triangles differ (seams, shared "
          f"edges); range on the same triangle within {rng_err:.3g} "
          f"relative")
    check(mask_agree >= 0.993 and lbl_agree >= 0.993,
          "oracle: row C and the native BVH apart beyond the seam budget")
    check(rng_err <= 1e-4 and bool(
        (vs.remission.reshape(-1).cpu().numpy() == nat.remissions)[
            same].all()), "oracle: the frame's attributes != native's")
    del full, dense, trav, ref, sub, tris
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
    ms = _wall_ms(torch, lambda: [eng.transfer_fast(w) for w in wins],
                  10) / len(wins)
    stacked = stack_windows(wins[:4])
    s_ms = _wall_ms(torch, lambda: eng.transfer_stream(stacked), 10)
    print(f"upsampling transfer_fast HDL64->HDL64x2: {ms:.3f} ms/frame "
          f"({1e3 / ms:.1f} scans/s); transfer_stream 4 frames {s_ms:.3f} "
          f"ms ({4e3 / s_ms:.1f} scans/s) {tag}")
    _profile_frames(torch, eng, wins, ms, tag)
    return counts


def _probe_path(torch, kernels, tag):
    """The probes' rows at 1024x1024x256 (``probes.run``, what ``python
    -m lidar_transfer_tpu_torch.probes all`` prints); returns the launch
    counts of the path. Each probe kernel's JSON row takes the largest
    difference of the row its kernel was written for: ``full`` at BX 2
    with three outputs, ``precols``, and ``alias_any`` (three outputs in
    place)."""
    from lidar_transfer_tpu_torch import _build, probes

    _build.reset_launch_counts()
    t = time.perf_counter()
    rows = probes.run(tag=tag)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"probe rows: {len(rows)} in {time.perf_counter() - t:.1f} s; "
          f"launches on the probe path: {counts}")
    picks = {"probe_parts": ("parts", "full BX2 out x3"),
             "probe_ablate": ("ablate", "precols"),
             "probe_write": ("write", "BX8 BY1024 bf16 x1"),
             "probe_alias": ("alias", "alias_any")}
    for name, (probe, row) in picks.items():
        counter = kernels[name].get("counter", name)
        check(counts[counter] > 0, f"kernel {counter} never launched on "
              "the probe path")
        r = next(r for r in rows if (r["probe"], r["row"]) == (probe, row))
        k = kernels[name]
        k["max_abs_err"] = max(k["max_abs_err"], r["max_abs_err"])
    return counts


def _miss_decomposition(pts, valid, vs, target, what, tag, workspace=None):
    """The frame's miss decomposition (``metrics/diagnostics``) from the
    merged cloud it was transferred from, HDL64's fov as the source's and
    the reference bounds; the five counts must sum to H * W."""
    from lidar_transfer_tpu_torch.config import HDL64
    from lidar_transfer_tpu_torch.metrics.diagnostics import \
        miss_decomposition

    dec = miss_decomposition(
        pts, valid, vs.mask, target_H=target.H, target_W=target.W,
        t_fov_up=target.fov_up, t_fov_down=target.fov_down,
        s_fov_up=HDL64.fov_up, s_fov_down=HDL64.fov_down,
        vol_bounds=BOUNDS, workspace=workspace)
    d = dec.as_dict()
    check(sum(d.values()) == target.H * target.W and d["hit"] == int(
        vs.mask.sum()), f"{what}: the miss decomposition does not "
          "partition the image")
    print(f"{what} miss decomposition: {d}; rates "
          + json.dumps({k: round(v, 6) for k, v in dec.rates().items()})
          + f" {tag}")
    return d


def _raymarch_path(torch, work, kernels, tag, per_frame):
    """The raymarch synthesis at the reference point on the dataset
    ``work/kitti``: ``TransferEngine(synthesis="raymarch")``, mergemesh,
    one scan a window, HDL64 -> HDL32, compact state, fixed bounds, per
    frame and streamed; the march kernel against ``raycast_plain`` on the
    frame's full-size volume and rays; the card's frame against the port's
    CPU run at reduced bounds; the frame against the splat frame; its miss
    decomposition. Returns the launch counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.config import TransferConfig
    from lidar_transfer_tpu_torch.ops import raycast as RC
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import (load_window,
                                                             merge_window,
                                                             stack_windows)

    dev = torch.device("cuda")
    cfg, _ = _config(work, "raymarch")
    hdl32 = SensorSpec.from_yaml(HDL32_PATH)
    seq, cap = _sequence(work)
    kw = dict(fixed_bounds=True, synthesis="raymarch", compact_volume=True)
    eng = TD.TransferEngine(HDL64, hdl32, cfg, device=dev, **kw)
    wins = [load_window(seq, cfg, i, cap, dev) for i in range(6)]
    stacked = stack_windows(wins[:4])

    # ------------------------------------------- 2. the path, as a user
    _build.reset_launch_counts()
    t = time.perf_counter()
    per = [eng.transfer_fast(w) for w in wins]
    sv = eng.transfer_stream(stacked)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"raymarch path: 6 frames and a stream of 4 in "
          f"{time.perf_counter() - t:.2f} s (the geometry table and first "
          f"allocation included); launches {counts}")
    for k in ("zbuffer", "tsdf_integrate", "tsdf_geometry", "raymarch",
              "raymarch_pack"):
        check(counts[k] > 0, f"kernel {k} never launched on the raymarch "
              "path")
    before = _build.launch_counts()
    vs = eng.transfer_fast(wins[0])
    per_frame["raymarch"] = _launches_since(before)
    check(all(torch.equal(getattr(sv, f)[i], getattr(per[i], f))
              for i in range(4) for f in ("range", "label", "mask")),
          "raymarch: transfer_stream != per-frame transfer_fast")
    check(_equal_scans(torch, vs, per[0]), "raymarch: frame 0 twice "
          "differs")

    # ---------------- 3. the kernel against raycast_plain, full size
    state = eng.fused_state()
    check(state.tsdf.dtype == torch.bfloat16
          and tuple(state.tsdf.shape) == (2048, 2048, 208),
          f"raymarch volume {state.tsdf.dtype} {tuple(state.tsdf.shape)}")
    pts, _, _, valid = merge_window(wins[0])
    spec = eng.vol_spec
    occ = RC.occupancy_from_points(pts, valid, spec.origin, spec,
                                   pixel_angle_rad=eng._src_pixel_angle())
    prm = RC.march_params(spec, spec.origin, 4, 2.0)
    origin = torch.zeros(3, device=dev)
    args = (state, occ, eng.rays, origin, prm, spec.dims, 4,
            RC.default_max_steps(spec, 2.0))
    got = RC.raymarch(*args)
    check(torch.equal(got[0].reshape(vs.range.shape), vs.range)
          and torch.equal(got[4].reshape(vs.mask.shape), vs.mask),
          "raymarch: the kernel's march != the engine's frame")
    ref = RC.raycast_plain(*args)
    err = _compare_marches(torch, got, ref, f"raymarch kernel vs plain, "
                           f"the frame's {spec.dims} compact volume and "
                           f"{eng.rays.shape[0]} rays")
    k = kernels["raymarch"]
    k["max_abs_err"] = max(k["max_abs_err"], err)
    del ref, got

    # --------------------------------- 3. the frame's outputs, checked
    hit = float(vs.mask.float().mean())
    _miss_decomposition(pts, valid, vs, hdl32, "raymarch frame 0", tag,
                        eng._zbuf)
    splat = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                              device=dev).transfer_fast(wins[0])
    both = vs.mask & splat.mask
    diff = (vs.range - splat.range)[both].abs()
    q = torch.quantile(diff.float(), torch.tensor([0.5, 0.95], device=dev))
    print(f"raymarch frame 0 against the splat frame: hit rate {hit:.4f} "
          f"(splat {float(splat.mask.float().mean()):.4f}), both hit "
          f"{float(both.float().mean()):.4f} of the target pixels, "
          f"{float(both.sum()) / max(float(splat.mask.sum()), 1):.4f} of "
          f"the splat's hits; range difference there median "
          f"{float(q[0]):.4f} m, p95 {float(q[1]):.4f} m, max "
          f"{float(diff.max()):.4f} m; labels equal on "
          f"{float((vs.label == splat.label)[both].float().mean()):.4f}")
    check(hit > 0.3 and float(both.sum()) > 0.5 * float(splat.mask.sum()),
          "raymarch frame mostly empty or apart from the splat frame")
    del state

    # card against the port's CPU run at reduced bounds (the full volume
    # integrated and marched on the CPU does not fit the time limit)
    small = TransferConfig(voxel_size=0.05, voxel_bounds=(
        (-12.8, 12.8), (-12.8, 12.8), (-3.2, 3.2)))
    vs_small = TD.TransferEngine(HDL64, hdl32, small, device=dev,
                                 **kw).transfer_fast(
        load_window(seq, small, 0, cap, dev))
    t = time.perf_counter()
    vs_cpu = TD.TransferEngine(HDL64, hdl32, small, device="cpu",
                               **kw).transfer_fast(
        load_window(seq, small, 0, cap, "cpu"))
    print(f"raymarch +-12.8/+-12.8/+-3.2 m on the CPU: "
          f"{time.perf_counter() - t:.1f} s")
    _card_vs_cpu(vs_small, vs_cpu, "raymarch +-12.8 m (frame 0)")

    # ------------------------------------------------------ 4. timing
    frame_ms = _wall_ms(torch, lambda: [eng.transfer_fast(w) for w in wins],
                        3) / len(wins)
    stream_ms = _wall_ms(torch, lambda: eng.transfer_stream(stacked), 3)
    print(f"raymarch transfer_fast HDL64->HDL32 (compact, integrate in the "
          f"frame): {frame_ms:.3f} ms/frame ({1e3 / frame_ms:.1f} scans/s); "
          f"transfer_stream 4 frames {stream_ms:.3f} ms; hit rate "
          f"{hit:.4f} {tag}")
    _profile_frames(torch, eng, wins, frame_ms, tag)
    return counts


def _rolling_path(torch, work, tag, per_frame):
    """Rolling shutter at the reference point on the dataset ``work/kitti``
    (HDL64 -> HDL32, 2048x2048x208 compact, fixed bounds), frame 0 re-cast
    over the dataset's next pose by ``resynthesize_rolling_shutter``'s
    three engines: "auto" after the splat path's ``transfer_fast`` (the
    winners re-projected), "auto" on the raymarch engine's materialised
    volume (its band samples re-projected), "raymarch" (the moving rays
    marched with one origin a ray: row B). Checks the raymarch engine's
    march equal to ``raycast_plain`` on every ray, the splat engine with
    the identity pose against its static frame, and every engine's frame
    against the port's CPU run at +-12.8/+-12.8/+-3.2 m; times each
    engine. Returns the launch counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.config import TransferConfig
    from lidar_transfer_tpu_torch.ops import raycast as RC
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import load_window

    dev = torch.device("cuda")
    cfg, _ = _config(work, "rolling")
    hdl32 = SensorSpec.from_yaml(HDL32_PATH)
    seq, cap = _sequence(work)
    pose = np.linalg.inv(seq.poses[0]) @ seq.poses[1]
    kw = dict(fixed_bounds=True, compact_volume=True)
    w0 = load_window(seq, cfg, 0, cap, dev)

    def engines(c, device):
        return (TD.TransferEngine(HDL64, hdl32, c, device=device, **kw),
                TD.TransferEngine(HDL64, hdl32, c, device=device,
                                  synthesis="raymarch", **kw))

    def recast(splat, march, w, p):
        """-> {engine: rolling frame} of window ``w`` over pose ``p``."""
        splat.transfer_fast(w)
        march.transfer_fast(w)
        return {"splat": splat.resynthesize_rolling_shutter(p),
                "volume": march.resynthesize_rolling_shutter(p),
                "raymarch": march.resynthesize_rolling_shutter(
                    p, engine="raymarch")}

    # ------------------------------------------- 2. the path, as a user
    splat, march = engines(cfg, dev)
    _build.reset_launch_counts()
    t = time.perf_counter()
    frames = recast(splat, march, w0, pose)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"rolling path: frame 0 transferred and re-cast by the three "
          f"engines in {time.perf_counter() - t:.2f} s (first allocation "
          f"and geometry tables included); pose over the frame "
          f"{np.round(pose[:3, 3], 4).tolist()} m; launches {counts}")
    for k in ("zbuffer", "tsdf_integrate", "raymarch", "raymarch_pack"):
        check(counts[k] > 0, f"kernel {k} never launched on the rolling "
              "path")
    for name, vs in frames.items():
        check(vs.adaption == "mergemesh-rolling"
              and float(vs.mask.float().mean()) > 0.3,
              f"rolling {name}: not a rolling frame, or mostly empty")
    before = _build.launch_counts()
    march.resynthesize_rolling_shutter(pose, engine="raymarch")
    per_frame["rolling.raymarch"] = _launches_since(before)

    # ------------------------- 3. the engine's march against the plain
    t32 = hdl32
    rays, origins = (torch.from_numpy(a).to(dev) for a in
                     RC.generate_rays_moving(t32.H, t32.W, t32.fov_up,
                                             t32.fov_down, pose))
    spec = march.vol_spec
    vol_origin = march._last_origin
    args = (march.fused_state(), march._rolling_occupancy(vol_origin), rays,
            origins, RC.march_params(spec, vol_origin, 4, 2.0), spec.dims,
            4, RC.default_max_steps(spec, 2.0))
    got = RC.raymarch(*args)
    vs = frames["raymarch"]
    check(torch.equal(got[0].reshape(vs.range.shape), vs.range)
          and torch.equal(got[4].reshape(vs.mask.shape), vs.mask),
          "rolling: the kernel's march != the raymarch engine's frame")
    ref = RC.raycast_plain(*args)
    _compare_marches(torch, got, ref, f"rolling raymarch kernel vs plain, "
                     f"{spec.dims} compact, {rays.shape[0]} rays with (R, 3) "
                     f"origins")
    del ref, got, args

    # identity pose: the splat engine's rolling frame is its static frame
    static = splat.transfer_fast(w0)
    ident = splat.resynthesize_rolling_shutter(np.eye(4))
    same = float((ident.mask == static.mask).float().mean())
    both = ident.mask & static.mask
    d = (ident.range - static.range)[both].abs()
    print(f"rolling splat, identity pose, against the static frame: mask "
          f"equal on {same:.6f}, max |range diff| {float(d.max()):.2e} m, "
          f"labels equal on "
          f"{float((ident.label == static.label)[both].float().mean()):.6f}"
          f" of {int(both.sum())} pixels both hit")
    check(same >= 0.97 and float(d.max()) <= 1e-3
          and torch.equal(ident.label[both], static.label[both]),
          "rolling splat with the identity pose != the static frame")
    for name, vs in frames.items():
        ms_, ss = vs.mask, static.mask
        print(f"rolling {name}: hit rate {float(ms_.float().mean()):.4f} "
              f"(static {float(ss.float().mean()):.4f}); range against "
              f"the static frame median "
              f"{float((vs.range - static.range)[ms_ & ss].abs().median()):.4f}"
              " m")

    # card against the port's CPU run at reduced bounds
    small = TransferConfig(voxel_size=0.05, voxel_bounds=(
        (-12.8, 12.8), (-12.8, 12.8), (-3.2, 3.2)))
    card = recast(*engines(small, dev), load_window(seq, small, 0, cap, dev),
                  pose)
    t = time.perf_counter()
    cpu = recast(*engines(small, "cpu"),
                 load_window(seq, small, 0, cap, "cpu"), pose)
    print(f"rolling +-12.8/+-12.8/+-3.2 m on the CPU: "
          f"{time.perf_counter() - t:.1f} s")
    for name in frames:
        _card_vs_cpu(card[name], cpu[name], f"rolling {name} +-12.8 m "
                     "(frame 0)")

    # ------------------------------------------------------ 4. timing
    wins = [load_window(seq, cfg, i, cap, dev) for i in range(5)]
    poses = [np.linalg.inv(seq.poses[i]) @ seq.poses[i + 1]
             for i in range(5)]
    for name, eng, e in (("splat", splat, "auto"), ("volume", march, "auto"),
                         ("raymarch", march, "raymarch")):
        def frame(eng=eng, e=e):
            for w, p in zip(wins, poses):
                eng.transfer_fast(w)
                eng.resynthesize_rolling_shutter(p, engine=e)

        frame_ms = _wall_ms(torch, frame, 2) / len(wins)
        eng.transfer_fast(wins[0])
        recast_fn = lambda eng=eng, e=e: (  # noqa: E731
            eng.resynthesize_rolling_shutter(poses[0], engine=e))
        recast_ms = _wall_ms(torch, recast_fn, 5)
        d_ms, ops, _ = device_ms(recast_fn, 3)
        print(f"rolling {name}: transfer_fast + re-cast {frame_ms:.3f} "
              f"ms/frame ({1e3 / frame_ms:.1f} scans/s); the re-cast "
              f"{recast_ms:.3f} ms, device "
              + ("not measured" if d_ms is None else
                 f"{d_ms:.4f} ms in {ops} operations")
              + f", idle share "
              + ("-" if d_ms is None else f"{1 - d_ms / recast_ms:.3f}")
              + f" {tag}")
    del splat, march
    return counts


def png_decode(data: bytes) -> np.ndarray:
    """Decode an 8-bit RGB PNG whose rows all take filter 0, as the
    port's one PNG writer (``webviewer.png_bytes``) writes them, to an
    (H, W, 3) uint8 array with the standard library (zlib) alone; any
    other PNG fails the check."""
    import struct
    import zlib

    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        check(zlib.crc32(kind + body) & 0xFFFFFFFF == struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n])[0], "PNG chunk CRC")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color, _, _, interlace = head
    check((depth, color, interlace) == (8, 2, 0), f"PNG header {head}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def _html_frames(path):
    """The frame records of an exported viewer page, after ``check_js``
    has passed on its script."""
    import re

    from lidar_transfer_tpu_torch import webviewer

    with open(path) as f:
        doc = f.read()
    webviewer.check_js(webviewer.extract_script(doc))
    return json.loads(re.search(r"^const FRAMES = (.*);$", doc,
                                re.M).group(1))


def _uri_png(uri):
    import base64

    return png_decode(base64.b64decode(uri.split(",", 1)[1]))


def _front_end_path(torch, work, tag, per_frame):
    """The front end on the HDL64 dataset ``work/kitti``: the port's CLI
    mergemesh HDL64 -> HDL32 on 4 frames without and with ``--png --html
    --profile`` (row A in the transfer and in the viewer's source
    projections; the dims differ, so no metrics), ``lt-visualize-torch
    --html --predictions`` on the card against ``--device cpu`` (rows A
    and 3), and ``experiments.multiscene`` at 2 scenes, 3 steps, 3 frames
    (rows A and 3 and the RangeNet training). Returns the launch counts
    of the phase."""
    import shutil

    from lidar_transfer_tpu_torch import _build, visualize
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.experiments import multiscene
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import load_window
    from lidar_transfer_tpu_torch.utils.images import (label_image_rgb,
                                                       range_image_rgb)

    dev = torch.device("cuda")
    cfg, base = _config(work, "front")
    base += ["-t", HDL32_PATH, "--frames", "4"]
    hdl32 = SensorSpec.from_yaml(HDL32_PATH)
    html = os.path.join(work, "front.html")
    prof = os.path.join(work, "front_prof")

    _build.reset_launch_counts()
    t = time.perf_counter()
    out_a, m_a, _ = _run_cli(work, base, "front_plain")
    wall_a = (time.perf_counter() - t) * 1e3 / len(m_a)
    before = _build.launch_counts()
    t = time.perf_counter()
    out_b, m_b, text = _run_cli(work, base, "front_flags", "--png", "--html",
                                html, "--profile", prof)
    wall_b = (time.perf_counter() - t) * 1e3 / len(m_b)
    per_frame["front_end"] = _launches_since(before, len(m_b))
    check(len(m_a) == len(m_b) == 4, "front end: 4 frames a run")
    check(f"profiler trace in {prof}" in text, "front end: --profile line")
    med = [1e3 * float(np.median([fm["seconds"] for fm in ms[1:]]))
           for ms in (m_a, m_b)]
    print(f"front end CLI HDL64->HDL32, 4 frames: {wall_a:.1f} ms/frame "
          f"wall without the flags, {wall_b:.1f} with --png --html "
          f"--profile (engine set-up included); the median frame of "
          f"frames 1-3 {med[0]:.1f} and {med[1]:.1f} ms {tag}")
    _same_files(out_a, out_b, "--png --html --profile changed the scans")
    print("front end: the scans with and without the flags are equal byte "
          "for byte")

    # the PNGs, decoded here, against the port's renders of each frame
    seq, cap = _sequence(work)
    eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev)
    png_root = os.path.join(out_b, "sequences", "00")
    for sub in ("labels_png", "velodyne_png"):
        check(sorted(os.listdir(os.path.join(png_root, sub)))
              == [f"{fm['index']:06d}.png" for fm in m_b],
              f"front end: one {sub} file a frame")
    for fm in m_b:
        vs = eng.transfer_fast(load_window(seq, cfg, fm["index"], cap, dev))
        name = f"{fm['index']:06d}.png"
        for sub, want in (
                ("labels_png", label_image_rgb(vs.label.cpu().numpy(), cfg)),
                ("velodyne_png", range_image_rgb(vs.range.cpu().numpy()))):
            with open(os.path.join(png_root, sub, name), "rb") as f:
                got = png_decode(f.read())
            check(got.shape == (hdl32.H, hdl32.W, 3)
                  and np.array_equal(got, want), f"front end: {sub}/{name}")
    print(f"front end: {2 * len(m_b)} PNGs decode to the port's renders of "
          "their frames")
    del eng

    frames = _html_frames(html)
    check(len(frames) == 4 and all(f["virt"]["n"] > 0 and f["src"]["n"] > 0
                                   for f in frames),
          "front end: --html frame records")
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    check(len(events) > 0, "front end: empty profiler trace")
    names = sorted({e["name"] for e in events
                    if e.get("cat") == "kernel"})
    print(f"front end: {len(frames)} frames in the viewer page "
          f"({os.path.getsize(html) / 1e6:.1f} MB), check_js passed; "
          f"trace {len(events)} events, kernels "
          f"{[n[:48] for n in names]}")

    # lt-visualize-torch --html with predictions, card against CPU
    pred_dir = os.path.join(work, "front_pred", "sequences", "00",
                            "predictions")
    os.makedirs(pred_dir)
    for i in range(len(seq)):
        lbl = seq.read(i)[2].copy()
        lbl[::7] = 40
        kitti.write_label_file(os.path.join(pred_dir, f"{i:06d}.label"), lbl)
    viz = {}
    before = _build.launch_counts()
    for device in ("cuda", "cpu"):
        out = os.path.join(work, f"front_viz_{device}.html")
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = visualize.main(["-d", os.path.join(work, "kitti"), "-p",
                                 os.path.join(work, "front_pred"), "--html",
                                 out, "--frames", "2", "--device", device])
        check(rc == 0, f"lt-visualize-torch --device {device} exit {rc}")
        viz[device] = _html_frames(out)
        print(f"lt-visualize-torch --html --device {device}: 2 frames "
              f"{(time.perf_counter() - t) * 1e3 / 2:.1f} ms/frame wall "
              f"{tag}")
        if device == "cuda":
            per_frame["front_end.visualize"] = _launches_since(before, 2)
    for a, b in zip(viz["cuda"], viz["cpu"]):
        ma, mb = ([float(x) for x in r["title"].split()[1::2]]
                  for r in (a, b))
        print(f"visualize {a['name']}: card '{a['title']}', CPU "
              f"'{b['title']}'")
        check(abs(ma[0] - mb[0]) <= 1e-6 and abs(ma[1] - mb[1]) <= 1e-6
              and abs(ma[2] - mb[2]) <= 1e-5 * max(abs(mb[2]), 1e-30),
              "visualize: card and CPU title metrics")
        check(0 < ma[0] < 1, "visualize: the predictions' diff is empty")
        rows = {r["name"]: r for r in b["rows"]}
        for r in a["rows"]:
            if r["name"] in ("src labels", "virt labels", "diff"):
                x, y = _uri_png(r["png"]), _uri_png(rows[r["name"]]["png"])
                share = float((x == y).all(-1).mean())
                check(share >= 0.999, f"visualize {r['name']}: card and CPU "
                      f"agree on {share:.6f} of pixels")
    print("visualize --predictions: card and CPU title metrics and label "
          "and diff rows agree")

    # the multi-scene rows, cut to 2 scenes of 3 frames and 3 steps
    torch.cuda.empty_cache()
    ms_work = os.path.join(work, "multiscene")
    t = time.perf_counter()
    before = _build.launch_counts()
    check(multiscene.main(["--scenes", "2", "--steps", "3", "--frames", "3",
                           "--work", ms_work]) == 0, "multiscene exit code")
    ms_launches = _launches_since(before)
    rows_dir = os.path.join(ms_work, "rows")
    check(sorted(os.listdir(rows_dir)) == sorted(
        f"{r[0]}.json" for r in multiscene.ROWS), "multiscene: row files")
    for name, _, _ in multiscene.ROWS:
        with open(os.path.join(rows_dir, f"{name}.json")) as f:
            row = json.load(f)
        check(len(row["per_scene"]) == 2
              and row["backend"] == torch.cuda.get_device_name(0),
              f"multiscene {name}: scenes and backend")
        for key in ("miou", "miou_present", "acc"):
            vals = [r[key] for r in row["per_scene"]]
            check(np.isfinite(vals).all() and row[key] == float(np.mean(
                vals)) and row[key + "_std"] == float(np.std(vals)),
                f"multiscene {name}: {key} aggregate")
        print(f"multiscene {name} (2 scenes, 3 steps): miou_present "
              f"{row['miou_present']:.4f} ± {row['miou_present_std']:.4f}, "
              f"acc {row['acc']:.4f} ± {row['acc_std']:.4f}")
    print(f"multiscene at 2 scenes x 3 frames, 3 steps: "
          f"{time.perf_counter() - t:.1f} s wall, launches {ms_launches} "
          f"{tag}")
    shutil.rmtree(ms_work)
    counts = _build.launch_counts()
    print(f"launches on the front-end path: {counts}")
    # mergemesh defers its volume to fused_state(), which no front-end
    # entry point calls: rows A and 3 are the phase's kernels
    for k in ("zbuffer", "confusion"):
        check(counts[k] > 0, f"kernel {k} never launched on the front-end "
              "path")
    for key in ("front_end", "front_end.visualize"):
        check(per_frame[key].get("zbuffer", 0) > 0,
              f"{key}: no z-buffer launch")
    check(per_frame["front_end.visualize"].get("confusion", 0) > 0
          and ms_launches.get("confusion", 0) > 0,
          "front end: no confusion launch in the viewer or the rows")
    return counts


#: remat's loss against base's on the card after the same 7 steps from the
#: same weights, relative: cuDNN's backward may sum in another order when
#: the blocks are recomputed (equal bit for bit on an NVIDIA H100 80GB
#: HBM3 at 700.00 W)
REMAT_LOSS_RTOL = 1e-3
#: a grid cell's iou and acc, card against the port's CPU
#: (``tests/test_torch_grids.py``'s bound), and mse relative
GRID_ABS, GRID_MSE_REL = 1e-3, 1e-4


def _runners_path(torch, work, tag, per_frame):
    """The runners ported from ``scripts/``, on the card:
    ``experiments.grids full`` at cut axes (frames [1, 20] x voxel [0.25,
    0.04], one frame a cell, a 20-scan HDL64 64x2048
    ``Scene.default()`` sequence) with its cell at 1
    scan and 0.25 m held against ``evaluate_transfer`` on the port's CPU,
    ``grids multiscene`` at 2 urban scenes x 1 cell (the ``_std``,
    ``_min`` and ``_max`` columns numpy's over the sequences),
    ``experiments.upsample`` at 20 steps and 4 frames of 32 -> 64 beams at
    width 512, and ``probes.train_levers`` on darknet53 (batch 2,
    64x2048x5) at 5 timed steps a variant, remat's loss held to base's
    within ``REMAT_LOSS_RTOL``. Prints rows A and 3's launches per frame
    on each runner and the phase's wall time. Returns the launch counts of
    the phase."""
    import dataclasses
    import shutil

    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import TransferConfig
    from lidar_transfer_tpu_torch.experiments import grids, upsample
    from lidar_transfer_tpu_torch.experiments.grid_search import (
        evaluate_transfer)
    from lidar_transfer_tpu_torch.probes import train_levers

    t_phase = time.perf_counter()
    root = os.path.join(work, "runners")
    _build.reset_launch_counts()

    # grids full at cut axes; the dataset's 20 scans take the 20-scan
    # window's one frame
    gw = os.path.join(root, "full")
    before = _build.launch_counts()
    t = time.perf_counter()
    check(grids.main(["full", "--frames-list", "1", "20", "--voxel-sizes",
                      "0.25", "0.04", "--frames-per-cell", "1",
                      "--n-scans", "20", "--work", gw]) == 0,
          "grids full exit code")
    per_frame["runners.grids_full"] = _launches_since(before, 4)
    with open(os.path.join(gw, "grid", "grid_search.json")) as f:
        full = json.load(f)
    check(full["device"] == gpu_line() and len(full["cells"]) == 4
          and all(np.isfinite([c[k] for k in ("iou", "acc", "mse")]).all()
                  and c["sequences"]["00"]["frames"] == 1
                  for c in full["cells"]), "grids full: cells and device")
    print(f"grids full, frames [1, 20] x voxel [0.25, 0.04], 1 frame a "
          f"cell: {time.perf_counter() - t:.1f} s wall (the 20-scan "
          f"dataset's generation included) {tag}")
    cell = full["cells"][0]
    cfg = dataclasses.replace(TransferConfig(), number_of_scans=1,
                              voxel_size=0.25)
    t = time.perf_counter()
    cpu = evaluate_transfer(os.path.join(gw, "grid_ds64"), cfg, frames=1,
                            device="cpu")
    print(f"the cell on the port's CPU: {time.perf_counter() - t:.1f} s")
    d = {k: abs(cell[k] - cpu[k]) for k in ("iou", "acc", "mse")}
    print(f"grids full cell (1, 0.25): card iou {cell['iou']:.6f} acc "
          f"{cell['acc']:.6f} mse {cell['mse']:.4f}; CPU iou "
          f"{cpu['iou']:.6f} acc {cpu['acc']:.6f} mse {cpu['mse']:.4f}; "
          f"|diff| {d}")
    check(d["iou"] <= GRID_ABS and d["acc"] <= GRID_ABS
          and d["mse"] <= GRID_MSE_REL * abs(cpu["mse"]),
          "grids full: the card's cell against the CPU's")

    # grids multiscene at 2 urban scenes x 1 cell
    before = _build.launch_counts()
    t = time.perf_counter()
    mw = os.path.join(root, "multiscene")
    check(grids.main(["multiscene", "--scenes", "2", "--frames-list", "1",
                      "--voxel-sizes", "0.05", "--n-scans", "1", "--work",
                      mw]) == 0, "grids multiscene exit code")
    per_frame["runners.grids_multiscene"] = _launches_since(before, 2)
    with open(os.path.join(mw, "grid", "grid_search.json")) as f:
        (ms,) = json.load(f)["cells"]
    for k in ("iou", "acc", "mse"):
        vals = [ms["sequences"][q][k] for q in ("00", "01")]
        check(np.isfinite(vals).all() and ms[k + "_std"] == float(np.std(
            vals)) and ms[k + "_min"] == min(vals)
              and ms[k + "_max"] == max(vals),
              f"grids multiscene: {k} columns")
    print(f"grids multiscene, 2 urban scenes x (1, 0.05): iou "
          f"{ms['iou']:.4f} ± {ms['iou_std']:.4f}, acc {ms['acc']:.4f} ± "
          f"{ms['acc_std']:.4f}, {time.perf_counter() - t:.1f} s wall {tag}")

    # the upsampling workflow, 32 -> 64 beams at width 512
    before = _build.launch_counts()
    t = time.perf_counter()
    uw = os.path.join(root, "upsample")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = upsample.main(["--steps", "20", "--frames", "4", "--work", uw])
    check(rc == 0, "upsample exit code")
    # 4 scans transferred, 3 x 20 steps of batch 2 trained, 3 x 4 scans
    # predicted and scored: counted over the 4 frames of the dataset
    per_frame["runners.upsample"] = _launches_since(before, 4)
    for name in ("fake64_on_real64", "real32_on_real64",
                 "real64_on_fake64"):
        with open(os.path.join(uw, "rows", f"{name}.json")) as f:
            row = json.load(f)
        check(row["scans"] == 4 and np.isfinite(row["miou_present"])
              and 0 < row["acc"] <= 1, f"upsample {name}: {row}")
        print(f"upsample {name} (20 steps, 4 frames): miou_present "
              f"{row['miou_present']:.4f}, acc {row['acc']:.4f}")
    print(f"upsample 32 -> 64 beams at width 512: "
          f"{time.perf_counter() - t:.1f} s wall {tag}")
    shutil.rmtree(root)

    # the train-step levers on darknet53 (the device time, which takes
    # traced steps, is the probe's own: python -m
    # lidar_transfer_tpu_torch.probes.train_levers)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rows = {}
    for variant in train_levers.VARIANTS:
        r = train_levers.run_variant("darknet53", variant, iters=5,
                                     device="cuda", device_time=False)
        rows[variant] = r
        check(np.isfinite(r["final_loss"]) and r["mfu"] > 0,
              f"train_levers {variant}: {r}")
        print(f"train_levers darknet53 {variant}: {r['step_ms']:.3f} "
              f"ms/step (min {r['step_ms_min']:.3f}, max "
              f"{r['step_ms_max']:.3f}), peak {r['peak_gib']:.2f} GiB, "
              f"mfu {r['mfu']:.4f}, loss {r['final_loss']:.6f} {tag}")
        torch.cuda.empty_cache()
    print(f"train_levers, 4 variants: {time.perf_counter() - t:.1f} s "
          "wall")
    for a, b in (("remat", "base"), ("remat_mu_bf16", "mu_bf16")):
        rel = (abs(rows[a]["final_loss"] - rows[b]["final_loss"])
               / abs(rows[b]["final_loss"]))
        print(f"train_levers: {a}'s loss against {b}'s, relative "
              f"{rel:.3e} (bound {REMAT_LOSS_RTOL})")
        check(rel <= REMAT_LOSS_RTOL, f"train_levers: {a}'s loss is not "
              f"{b}'s")

    counts = _build.launch_counts()
    for key in ("runners.grids_full", "runners.grids_multiscene",
                "runners.upsample"):
        pf = per_frame[key]
        print(f"{key}: zbuffer {pf.get('zbuffer', 0):.2f}, confusion "
              f"{pf.get('confusion', 0):.2f} launches a frame")
        check(pf.get("zbuffer", 0) > 0 and pf.get("confusion", 0) > 0,
              f"{key}: rows A and 3 not both launched")
    print(f"launches on the runners' path: {counts}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s wall {tag}")
    return counts

def _segmentation_path(torch, work, per_frame):
    """``lt-seg``'s path on the dataset ``work/kitti`` (HDL64, 64x2048):
    ``train_segmentation`` of darknet53 at full width (batch 2, bf16
    compute, float32 parameters, 20 steps, a checkpoint), the checkpoint
    loaded back (logits bit for bit), ``write_predictions`` with and
    without the kNN cleanup and ``evaluate_semantics`` of each (the
    z-buffer in every scan's projection, the confusion counts in the
    evaluation), one float32 forward of the trained weights on the card
    (TF32 off) against the CPU, and ``run_workflow("fake_on_real")`` with
    darknet21 through the CLI's mergemesh transfer. Returns the launch
    counts of the path."""
    import dataclasses

    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.experiments import segmentation as SG
    from lidar_transfer_tpu_torch.experiments.workflows import run_workflow
    from lidar_transfer_tpu_torch.models import RangeNet, RangeNetConfig

    dev = torch.device("cuda")
    ds = os.path.join(work, "kitti")
    ckpt = os.path.join(work, "seg.pt")
    mapper = SG.LabelMapper.from_labels(dict(
        _config(work, "seg")[0].labels))
    cfg53 = RangeNetConfig.darknet53(num_classes=mapper.num_classes)
    steps = 20

    _build.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model, mapper, spec = SG.train_segmentation(
            ds, steps=steps, batch_size=2, model_cfg=cfg53, seed=0,
            checkpoint_path=ckpt, device=dev)
        torch.cuda.synchronize()
    print(buf.getvalue(), end="")
    per_frame["segmentation.train"] = _launches_since(
        dict.fromkeys(_build.launch_counts(), 0), steps)
    losses = [float(line.rsplit(" ", 1)[1])
              for line in buf.getvalue().splitlines()
              if line.startswith("step ")]
    print(f"train_segmentation darknet53 {spec.H}x{spec.W}, batch 2, "
          f"{steps} steps: losses {losses}")
    check(len(losses) == 3 and all(np.isfinite(losses)),
          "train_segmentation printed no finite losses")
    check(losses[-1] < 0.8 * losses[0], "the darknet53 loss did not fall")

    # the checkpoint round trip
    loaded, mapper2, spec2 = SG.load_checkpoint(ckpt, dev)
    check(loaded.cfg == cfg53 and mapper2.raw_ids == mapper.raw_ids
          and spec2 == spec, "checkpoint config, mapper or spec")
    seq, cap = _sequence(work)
    before = _build.launch_counts()
    batch = [SG._frame_tensors(seq, i, spec, cap, mapper, dev)
             for i in (0, 1)]
    per_frame["segmentation.frame"] = _launches_since(before, 2)
    feats = torch.stack([b[0] for b in batch])
    with torch.no_grad():
        same = torch.equal(model(feats), loaded(feats))
    print(f"checkpoint round trip ({os.path.getsize(ckpt) / 2**20:.1f} "
          f"MiB): logits bit-equal {same}")
    check(same, "the loaded checkpoint's logits differ")
    del loaded

    # predictions and their evaluation
    res = {}
    for knn in (False, True):
        root = os.path.join(work, f"seg_pred_{knn}")
        before = _build.launch_counts()
        n = SG.write_predictions(ds, root, model, mapper, spec, knn=knn,
                                 verbose=False)
        per_frame[f"segmentation.infer{'_knn' if knn else ''}"] = \
            _launches_since(before, n)
        check(n == len(seq), f"write_predictions wrote {n} scans")
        for i in range(n):
            f = os.path.join(root, "sequences", "00", "predictions",
                             f"{i:06d}.label")
            raw = np.fromfile(f, np.uint32)
            check(raw.size == seq.read(i)[0].shape[0]
                  and set(np.unique(raw)) <= set(mapper.raw_ids),
                  f"prediction file {f}")
        before = _build.launch_counts()
        res[knn] = SG.evaluate_semantics(ds, root, device=dev)
        per_frame["segmentation.eval"] = _launches_since(before, n)
        r = res[knn]
        print(f"write_predictions knn={knn}: {n} scans; evaluate_semantics "
              f"mIoU {r['miou']:.4f}, present {r['miou_present']:.4f}, acc "
              f"{r['acc']:.4f}")
        check(r["scans"] == n and 0 < r["acc"] <= 1
              and np.isfinite(r["miou"]), f"evaluation knn={knn}: {r}")
    counts = _build.launch_counts()

    # the card against the CPU: one float32 forward, TF32 off
    m32 = RangeNet(dataclasses.replace(cfg53, compute_dtype=torch.float32))
    m32.load_state_dict(model.state_dict())
    x = feats[:1]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            card = m32.to(dev)(x)
            bf16 = model(x)
            cpu = m32.cpu()(x.cpu())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    agree = float((card.argmax(-1).cpu() == cpu.argmax(-1)).float().mean())
    agree16 = float((bf16.argmax(-1) == card.argmax(-1)).float().mean())
    print(f"darknet53 float32 forward, card (TF32 off) vs CPU: argmax "
          f"agreement {agree:.6f}, max |logit diff| "
          f"{float((card.cpu() - cpu).abs().max()):.3e}; bf16 compute vs "
          f"float32 on the card: {agree16:.6f}")
    check(agree >= 0.999, "card and CPU argmax disagree")
    del m32, card, cpu, bf16, model, feats, batch

    # fake_on_real: darknet21 on the mergemesh transfer, scored on real
    _build.reset_launch_counts()
    cfg, _ = _config(work, "seg_workflow")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        wf = run_workflow(
            "fake_on_real", ds, os.path.join(work, "wf"), cfg, steps=5,
            frames=3, model_cfg=RangeNetConfig.darknet21(
                num_classes=mapper.num_classes), verbose=False, device=dev)
    wf_counts = _build.launch_counts()
    per_frame["segmentation.fake_on_real"] = wf_counts
    print(f"run_workflow fake_on_real (darknet21, 5 steps on 3 "
          f"transferred scans): mIoU {wf['miou']:.4f}, acc "
          f"{wf['acc']:.4f} on {wf['scans']} real scans")
    check(wf["scans"] == len(seq) and np.isfinite(wf["miou"]),
          f"fake_on_real result {wf}")
    counts = {k: v + wf_counts[k] for k, v in counts.items()}
    print(f"launches on the segmentation path: {counts}")
    for k in ("zbuffer", "confusion", "group_norm"):
        check(counts[k] > 0, f"kernel {k} never launched on the "
              "segmentation path")
    return counts


def _ptv3_path(torch, work, per_frame):
    """``lt-seg-torch --arch ptv3``'s path on ``work/kitti``: PT-v3m1 base
    at its published widths trained by ``train_segmentation`` (batch 2,
    bf16 products, 12 steps, a checkpoint), loaded back,
    ``write_predictions`` (each point its cell's class) and
    ``evaluate_semantics``. Returns the launch counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.experiments import segmentation as SG
    from lidar_transfer_tpu_torch.models import ptv3

    dev = torch.device("cuda")
    ds = os.path.join(work, "kitti")
    ckpt = os.path.join(work, "ptv3.pt")
    steps = 12
    _build.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        SG.train_segmentation(ds, steps=steps, batch_size=2,
                              model_cfg=ptv3.PTv3Config.base(), seed=0,
                              checkpoint_path=ckpt, device=dev)
        torch.cuda.synchronize()
    train_counts = _build.launch_counts()
    per_frame["segmentation_ptv3.train"] = _launches_since(
        dict.fromkeys(train_counts, 0), steps)
    losses = [float(line.rsplit(" ", 1)[1])
              for line in buf.getvalue().splitlines()
              if line.startswith("step ")]
    print(f"train_segmentation ptv3 (PT-v3m1 base), batch 2, {steps} steps: "
          f"losses {losses}")
    check(len(losses) == 3 and all(np.isfinite(losses)),
          "the ptv3 train printed no finite losses")
    model, mapper, spec = SG.load_checkpoint(ckpt, dev)
    check(isinstance(model, ptv3.PTv3), "the ptv3 checkpoint loaded "
          "another network")
    pred = os.path.join(work, "pred_ptv3")
    n = SG.write_predictions(ds, pred, model, mapper, spec, verbose=False)
    res = SG.evaluate_semantics(ds, pred, device=dev)
    print(f"ptv3 predictions by cell: {n} scans, mIoU {res['miou']:.4f}, "
          f"acc {res['acc']:.4f}")
    check(n == res["scans"] and np.isfinite(res["acc"]),
          f"ptv3 evaluation {res}")
    counts = _build.launch_counts()
    print(f"launches on the ptv3 path: {counts}")
    for k in ("ptv3_serialize", "ptv3_neighbor_map", "confusion"):
        check(counts[k] > 0, f"kernel {k} never launched on the ptv3 path")
    return counts


def _profile_frames(torch, eng, wins, frame_ms, tag):
    """Device time and device launches per frame of ``transfer_fast`` from
    a ``torch.profiler`` trace of the frames ``wins`` (after one pass of
    them inside the trace, see ``timing.whole_trace``); the idle share is
    1 - device time / ``frame_ms``, the frame time measured without the
    profiler, whose own host cost would inflate the frame."""
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


# ------------------------------------------------------- parallel phase
#: the rank count of the parallel phase's gloo children (sharing cuda:0)
PAR_WORLD = 2


def _parallel_ddp_setup(torch, work, dev, compute_dtype):
    """-> (darknet53 computing in ``compute_dtype`` at the seed's
    parameters, its Adam, the batch of frames 0 and 1 of ``work/kitti``
    (64x2048))."""
    import dataclasses

    from lidar_transfer_tpu_torch.config import SensorSpec
    from lidar_transfer_tpu_torch.experiments import segmentation as SG
    from lidar_transfer_tpu_torch.models import (RangeNet, RangeNetConfig,
                                                 make_train_state)

    mapper = SG.LabelMapper.from_labels(dict(
        _config(work, "par_seg")[0].labels))
    cfg = dataclasses.replace(
        RangeNetConfig.darknet53(num_classes=mapper.num_classes),
        compute_dtype=compute_dtype)
    model = RangeNet(cfg).to(dev)
    opt = make_train_state(model, torch.Generator().manual_seed(0))
    seq, cap = _sequence(work)
    spec = SensorSpec.from_yaml(os.path.join(work, "kitti", "config.yaml"))
    frames = [SG._frame_tensors(seq, i, spec, cap, mapper, dev)
              for i in (0, 1)]
    batch = {k: torch.stack([f[i] for f in frames])
             for i, k in enumerate(("features", "labels", "weights"))}
    return model, opt, batch


def _wall_ms(torch, step, n):
    """Median ms of ``n`` calls of ``step``, each ended by a device
    synchronise, on the host clock (a frame's host work and a gloo step's
    wait on the host are in it)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def _parallel_path(torch, work, tag, per_frame):
    """``parallel/`` at the reference point: two gloo ranks sharing cuda:0,
    spawned as ``python chip_smoke.py --parallel-child`` (X-slab fusion
    of scan 0 into two 1024x2048x208 float32 slabs and its synthesis, each
    held to the whole volume; the summed confusion counts; the
    frame-parallel transfer of 4 frames against ``transfer_fast``; 3 DDP
    steps of float32 darknet53, one frame a rank, against the one-process
    step of batch 2 computed here first), then one NCCL rank's DDP step of
    bf16 darknet53 at batch 2 beside the one-process step. The children
    also run ``train_segmentation`` and a device-parallel ``grid_search``
    cell, held to the one-process runs made here. A child that fails
    fails the phase. Returns the children's launch counts, summed."""
    import dataclasses
    import subprocess

    import torch.distributed as dist

    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.experiments import segmentation as SG
    from lidar_transfer_tpu_torch.experiments.grid_search import (
        evaluate_transfer)
    from lidar_transfer_tpu_torch.models.rangenet import train_step
    from lidar_transfer_tpu_torch.parallel import (make_mesh,
                                                   sharded_train_step)
    from lidar_transfer_tpu_torch.parallel.multihost import initialize

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model, opt, batch = _parallel_ddp_setup(torch, work, dev,
                                                torch.float32)
        ref_losses = [float(train_step(model, opt, batch))
                      for _ in range(3)]
        torch.save(model.state_dict(), os.path.join(work, "par_ref.pt"))
        one_ms = _wall_ms(torch, lambda: train_step(model, opt, batch), 5)
        # the entry points' one-process runs: train_segmentation of 3
        # steps at batch 2, and the grid cell run frame after frame
        seg_model, _, _ = SG.train_segmentation(
            os.path.join(work, "kitti"), steps=3, batch_size=2,
            model_cfg=model.cfg, seed=0, device=dev, verbose=False)
        torch.save(seg_model.state_dict(),
                   os.path.join(work, "par_seg_ref.pt"))
        del seg_model
        cell_cfg = dataclasses.replace(
            _config(work, "par_transfer")[0], adaption="mergemesh",
            number_of_scans=1)
        seq_cell = evaluate_transfer(os.path.join(work, "kitti"), cell_cfg,
                                     frames=3, fixed_bounds=True, device=dev)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    del model, opt, batch
    torch.cuda.empty_cache()

    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-child",
         str(r), str(PAR_WORLD), work], cwd=REPO)
        for r in range(PAR_WORLD)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0] * PAR_WORLD, f"parallel children exit codes {rcs}")
    res = []
    for r in range(PAR_WORLD):
        with open(os.path.join(work, f"par{r}.json")) as f:
            res.append(json.load(f))
    counts = {k: sum(c["launches"][k] for c in res)
              for k in _build.launch_counts()}
    grid_file = os.path.join(work, "par_grid", "grid_search.json")
    check(os.path.exists(grid_file), "the device-parallel grid_search "
          "wrote no grid_search.json")
    print(f"parallel: {PAR_WORLD} ranks, backend "
          f"{[c['backend'] for c in res]}, sharing cuda:0; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for c in res:
        check(not c["foreign"], f"parallel rank {c['rank']} imported "
              f"{c['foreign'][:3]}")
        for k in ("tsdf_integrate", "zbuffer", "confusion"):
            check(c["launches"][k] > 0, f"kernel {k} never launched on "
                  f"parallel rank {c['rank']}")
        check(np.allclose(c["ddp_losses"], ref_losses, rtol=1e-5, atol=0),
              f"parallel rank {c['rank']}: DDP losses {c['ddp_losses']} "
              f"beside the one-process {ref_losses} (rtol 1e-5)")
        cell = c["grid"]
        check(cell["frames"] == seq_cell["frames"] == 3
              and all(cell[k] == seq_cell[k] for k in ("iou", "acc", "mse")),
              f"parallel rank {c['rank']}: device-parallel grid cell {cell} "
              f"!= the sequential cell {seq_cell}")
        print(f"parallel rank {c['rank']}: slab against the whole volume "
              f"(mismatches, max |diff|) {c['slab_vs_whole']}; synthesis "
              f"equal {c['synth_equal']} (hit {c['hit']:.4f}); confusion "
              f"equal {c['confusion_equal']} ({c['confusion_total']} "
              f"pixels); frames equal {c['frames_equal']}; DDP losses "
              f"{c['ddp_losses']} (one process {ref_losses}), max |param "
              f"diff| {c['ddp_max_err']:.3e}, within 1e-4 "
              f"{c['ddp_share_1e-4']:.6f}, beyond 2e-3 "
              f"{c['ddp_over_2e-3']}; train_segmentation resumed at step 2 "
              f"against one process: max |param diff| "
              f"{c['seg_max_err']:.3e}, within 1e-4 "
              f"{c['seg_share_1e-4']:.6f}; grid cell (IoU, Acc, MSE) "
              f"{tuple(cell[k] for k in ('iou', 'acc', 'mse'))} equal to "
              f"the sequential cell's")
        print(f"parallel rank {c['rank']} (two gloo ranks share one card: "
              f"the collectives' cost, not scaling): slab integrate "
              f"1024x2048x208 {c['integrate_ms']:.4f} ms; probe and merge "
              f"{c['probe_merge_ms']:.3f} ms, {c['bytes_reduced']} bytes "
              f"reduced a call; DDP step float32, one frame a rank "
              f"{c['ddp_step_ms']:.3f} ms beside the one-process step of "
              f"batch 2 {one_ms:.3f} ms {tag}")

    # one NCCL rank: the DDP step of bf16 darknet53 at batch 2
    backend = initialize(f"file://{os.path.join(work, 'nccl_pg')}", 1, 0,
                         backend="nccl", device=dev)
    try:
        mesh = make_mesh(model=1)
        model, opt, batch = _parallel_ddp_setup(torch, work, dev,
                                                torch.bfloat16)
        step = sharded_train_step(model, opt, mesh)
        losses = [float(step(batch)) for _ in range(2)]
        check(all(np.isfinite(losses)), f"NCCL DDP losses {losses}")
        ddp_ms = _wall_ms(torch, lambda: step(batch), 10)
        plain_ms = _wall_ms(torch, lambda: train_step(model, opt, batch), 10)
    finally:
        dist.destroy_process_group()
    print(f"parallel: one {backend} rank, DDP step of bf16 darknet53, batch "
          f"2 at 64x2048: {ddp_ms:.3f} ms (median of 10) beside the "
          f"one-process step {plain_ms:.3f} ms; phase "
          f"{time.perf_counter() - t_phase:.1f} s wall {tag}")
    del model, opt, batch, step
    # launches a rank (the ranks do the same work); the path's total sums
    # them
    per_frame["parallel"] = {k: v / PAR_WORLD for k, v in counts.items()}
    return counts


def _parallel_child(argv) -> int:
    """One gloo rank of the parallel phase on cuda:0 (``python chip_smoke.py
    --parallel-child RANK WORLD WORK``); writes ``WORK/par<RANK>.json``.
    Every failed check raises, and the exit code is then nonzero."""
    import torch
    import torch.distributed as dist

    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64, SensorSpec
    from lidar_transfer_tpu_torch.experiments import segmentation as SG
    from lidar_transfer_tpu_torch.experiments.grid_search import grid_search
    from lidar_transfer_tpu_torch.metrics.confusion import (
        confusion_matrix, confusion_scatter)
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.splat import splat_synthesize
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda
    from lidar_transfer_tpu_torch.parallel import (
        frame_parallel_transfer, integrate_sharded, make_mesh,
        shard_volume, sharded_band_probe, sharded_confusion,
        sharded_train_step, splat_synthesize_sharded)
    from lidar_transfer_tpu_torch.parallel.multihost import (
        initialize, load_global_windows)
    from lidar_transfer_tpu_torch.parallel.sharding import slab_range
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import load_window

    rank, world, work = int(argv[0]), int(argv[1]), argv[2]
    dev = torch.device("cuda", 0)
    backend = initialize(f"file://{os.path.join(work, 'par_pg')}", world,
                         rank, backend="gloo", device=dev)
    res = {"rank": rank, "backend": backend}
    try:
        _build.library()
        mesh = make_mesh(model=1)
        cfg, _ = _config(work, "par_transfer")
        hdl32 = SensorSpec.from_yaml(HDL32_PATH)
        eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                                device=dev)
        spec, t = eng.vol_spec, eng.target
        seq, cap = _sequence(work)
        window = load_window(seq, cfg, 0, cap, dev)
        ri, origin, active, _, _ = eng._merged_image(window)
        back = TP.reverse_project(ri, fov_up_deg=t.fov_up,
                                  fov_down_deg=t.fov_down,
                                  preserve_float=True)
        src = (ri.range.reshape(-1), back, ri.mask.reshape(-1))
        tgt = dict(target_H=t.H, target_W=t.W, fov_up_deg=t.fov_up,
                   fov_down_deg=t.fov_down, beam_angles=eng.t_beam_angles)
        img = (ri.range, ri.label, ri.remission)
        fov = dict(fov_up_deg=t.fov_up, fov_down_deg=t.fov_down)
        frames = [0, 1, 2, 3]
        wins = load_global_windows(seq, cfg, frames, cap, mesh, dev)
        torch.cuda.synchronize()
        dist.barrier()

        # the path: X-slab fusion and synthesis, the summed counts, the
        # frame-parallel transfer; launches counted from here
        _build.reset_launch_counts()
        slab = integrate_sharded(shard_volume(spec, mesh, device=dev), spec,
                                 mesh, *img, **fov)
        scan = splat_synthesize_sharded(slab, spec, mesh, [src], **tgt)
        fp = frame_parallel_transfer(eng, wins, mesh)
        # the volume probe's labels against the splat's, each rank its
        # share of the rows
        rows = slice(rank * t.H // world, (rank + 1) * t.H // world)
        conf = sharded_confusion(mesh, 260)(scan[1][rows].contiguous(),
                                            fp[1][0][rows].contiguous())
        torch.cuda.synchronize()
        res["launches"] = _build.launch_counts()

        # the checks. Each kernel against its plain version on this path's
        # inputs: two 16-plane windows of the slab at their global x_offset
        x0, planes = slab_range(spec, mesh)
        per_x = (slab.tsdf < 1).sum(dim=(1, 2))
        for w in (int(per_x.argmax()) // 16 * 16, planes // 2):
            win = TS.VolumeSpec(spec.origin, spec.voxel_size,
                                (16,) + tuple(spec.dims[1:]))
            ref = TS.integrate(win.init_state(dev), win, *img,
                               origin=spec.origin, active_dims=spec.dims,
                               x_offset=x0 + w, **fov)
            _compare_states(torch, TS.TSDFState(*(a[w:w + 16]
                                                  for a in slab)), ref,
                            f"parallel rank {rank}: slab x={x0 + w}.."
                            f"{x0 + w + 15} vs plain integrate "
                            f"({int((ref.tsdf < 1).sum())} surface voxels)")
            del ref
        # the rank's share of the counts, and the sharded scan's winners
        # (the probe is collective: every rank calls it)
        pred_s = scan[1][rows].reshape(-1).contiguous()
        tgt_s = fp[1][0][rows].reshape(-1).contiguous()
        check(torch.equal(confusion_matrix(pred_s, tgt_s, 260),
                          confusion_scatter(pred_s, tgt_s, 260)),
              f"rank {rank}: confusion of its {pred_s.numel()} pixels != "
              "confusion_scatter (exact)")
        pos, *_, valid = sharded_band_probe(slab, spec, mesh, *src)
        beams = eng.t_beam_angles
        pix, key, *_ = TP._pixel_keys(pos, valid, t.fov_up, t.fov_down,
                                      beams, t.H, t.W, beams is not None,
                                      "depth")
        got = TP.zbuffer_winners(pix, key, t.H * t.W)
        check(torch.equal(got, TP.zbuffer_winners_plain(pix, key,
                                                        t.H * t.W)),
              f"rank {rank}: the sharded scan's z-buffer winners != "
              "zbuffer_winners_plain (exact)")
        res["zbuffer_winners"] = int((got >= 0).sum())
        del pos, valid, pix, key, got

        # each rank in turn fuses the whole volume itself
        for turn in range(world):
            if turn == rank:
                whole = integrate_cuda(spec.init_state(dev), spec, *img,
                                       origin=origin, active_dims=active,
                                       **fov)
                diffs = {}
                for f in ("tsdf", "weight", "label", "rem"):
                    a = getattr(slab, f)
                    b = getattr(whole, f)[x0:x0 + planes]
                    bad = a != b
                    d = (a.float() - b.float()).abs()
                    diffs[f] = (int(bad.sum()),
                                float(d.max()) if d.numel() else 0.0)
                res["slab_vs_whole"] = diffs
                check(diffs["label"][0] == 0 and diffs["weight"][0] == 0,
                      f"rank {rank}: slab label/weight differ from the "
                      f"whole volume: {diffs}")
                check(diffs["tsdf"][1] <= 1e-6 and diffs["rem"][1] <= 1e-6,
                      f"rank {rank}: slab tsdf/rem beyond 1e-6: {diffs}")
                srcs5 = [src + (ri.label.reshape(-1),
                                torch.clamp(ri.remission, min=0.0)
                                .reshape(-1))]
                ref = splat_synthesize(
                    whole, spec, srcs5, vol_origin=origin,
                    active_dims=active, attrs="volume", **tgt)
                res["synth_equal"] = all(torch.equal(a, b)
                                         for a, b in zip(scan, ref))
                res["hit"] = float(ref[4].float().mean())
                check(res["synth_equal"], f"rank {rank}: sharded synthesis "
                      "!= the whole volume's (bit for bit)")
                del whole, ref
                torch.cuda.empty_cache()
            dist.barrier()
        full = confusion_scatter(scan[1].reshape(-1).contiguous(),
                                 fp[1][0].reshape(-1).contiguous(), 260)
        res["confusion_total"] = int(full.sum())
        res["confusion_equal"] = bool(torch.equal(conf, full))
        check(res["confusion_equal"], "sharded confusion != "
              "confusion_scatter of the whole images (exact)")
        same = []
        for k, idx in enumerate(frames):
            vs = eng.transfer_fast(load_window(seq, cfg, idx, cap, dev))
            same.append(all(torch.equal(a[k], b)
                            for a, b in zip(fp, vs[:5])))
        res["frames_equal"] = same
        check(all(same), f"frame_parallel_transfer != transfer_fast: {same}")

        # times, on the host clock: the slab integrate and the
        # probe-and-merge (gloo reduces on the host)
        res["integrate_ms"] = _wall_ms(
            torch, lambda: integrate_sharded(slab, spec, mesh, *img, **fov), 5)
        res["probe_merge_ms"] = _wall_ms(
            torch, lambda: sharded_band_probe(slab, spec, mesh, *src), 5)
        res["bytes_reduced"] = 16 * src[0].numel()
        del slab, scan
        torch.cuda.empty_cache()

        # DDP: darknet53, one frame a rank, 3 steps, float32, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model, opt, batch = _parallel_ddp_setup(torch, work, dev,
                                                torch.float32)
        mine = {k: v[rank:rank + 1] for k, v in batch.items()}
        step = sharded_train_step(model, opt, mesh)
        res["ddp_losses"] = [float(step(mine)) for _ in range(3)]
        want = torch.load(os.path.join(work, "par_ref.pt"),
                          map_location=dev)
        diff = torch.cat([(p.detach() - want[k]).abs().reshape(-1)
                          for k, p in model.state_dict().items()])
        res["ddp_max_err"] = float(diff.max())
        res["ddp_share_1e-4"] = float((diff <= 1e-4).float().mean())
        res["ddp_over_2e-3"] = int((diff > 2e-3).sum())
        # the bounds of tests/test_torch_experiments.py
        check(res["ddp_max_err"] <= 2e-3 and res["ddp_share_1e-4"] >= 0.999,
              f"DDP darknet53 beyond its bounds: max "
              f"{res['ddp_max_err']}, share within 1e-4 "
              f"{res['ddp_share_1e-4']}")
        res["ddp_step_ms"] = _wall_ms(torch, lambda: step(mine), 5)
        seg_cfg = model.cfg
        del model, opt, batch, mine, step, want, diff
        torch.cuda.empty_cache()

        # the entry points under the group: train_segmentation (batch 2,
        # one frame a rank; a checkpoint at step 2, resumed to step 3) ...
        ds = os.path.join(work, "kitti")
        ckpt = os.path.join(work, "par_seg.pt")
        kw = dict(batch_size=2, model_cfg=seg_cfg, seed=0, device=dev,
                  checkpoint_path=ckpt, verbose=False)
        SG.train_segmentation(ds, steps=2, **kw)
        SG.train_segmentation(ds, steps=3, resume=True, **kw)
        blob = torch.load(ckpt, map_location=dev, weights_only=False)
        want = torch.load(os.path.join(work, "par_seg_ref.pt"),
                          map_location=dev)
        check(blob["step"] == 3 and set(blob["model_state"]) == set(want),
              f"rank {rank}: the resumed checkpoint holds step "
              f"{blob['step']} and keys {sorted(blob['model_state'])[:3]}")
        diff = torch.cat([(v - want[k]).abs().reshape(-1)
                          for k, v in blob["model_state"].items()])
        res["seg_max_err"] = float(diff.max())
        res["seg_share_1e-4"] = float((diff <= 1e-4).float().mean())
        check(res["seg_max_err"] <= 2e-3 and res["seg_share_1e-4"] >= 0.999,
              f"rank {rank}: train_segmentation under the group beyond "
              f"the bounds: max {res['seg_max_err']}, share within 1e-4 "
              f"{res['seg_share_1e-4']}")
        del blob, want, diff
        # ... and a device-parallel grid cell of 3 frames (padded to 4)
        out = grid_search(ds, frames_list=[1], voxel_sizes=[cfg.voxel_size],
                          adaption="mergemesh", base_cfg=cfg,
                          frames_per_cell=3, verbose=False, mesh=mesh,
                          device=dev, out_dir=os.path.join(work, "par_grid"))
        cell = out["cells"][0]["sequences"]["00"]
        check(out["grid"]["device_parallel"], "grid_search ran sequential")
        res["grid"] = {k: cell[k] for k in ("frames", "iou", "acc", "mse")}
    finally:
        dist.destroy_process_group()
    res["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "lidar_transfer_tpu"))
    with open(os.path.join(work, f"par{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(_parallel_child(sys.argv[2:]))
    sys.exit(main())
