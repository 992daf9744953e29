"""Every case of the TSDF integrate, its chain, the geometry table, the
confusion counts, the z-buffer, the fused GroupNorm and PT-v3m1's two
kernels, timed on the card beside its bound.

    python -m lidar_transfer_tpu_torch.probes.cases [volume|small|frame|march|mesh|norm|ptv3 ...]
                                                    [--only TEXT]
                                                    [--out FILE.json]

Times, at the reference operating point (2048x2048x208 voxels of 0.05 m,
64x2048 images of three synthetic HDL64 scans, the z-buffer on one scan's
padded points):

  volume  the single integrate, reset, weight not written: float32 and
          compact state, with and without the geometry table; carried mode
          with the table, float32 and compact; compact with the table at
          1024x1024x256; the S=3 chain, weight written: float32 and
          compact, table and none; the single integrate and the chain with
          the table at 2048x2048x206, a Z the vector width does not divide,
          and at 2047x2047x206, where the last run ends inside a vector
          and the kernel takes its one-voxel-a-lane variant; the geometry
          table in its fast and its exact mode at each of those four sizes
          (a tree whose kernel has one mode gives that one);
  small   the confusion counts at C = 260 and 20, skewed and uniform
          labels, N = 131,072 and 2^20; the z-buffer without a workspace
          and with one; each of the two as PyTorch's library calls compute
          it (the yardstick; a result that differs from the kernel's
          raises); an empty kernel launch;
  frame   three mergemesh frames (HDL64 to HDL32, ``transfer_fast``): the
          device operations they issue;
  march   row B, the raymarch kernel, on the reference march (the first
          synthetic HDL64 scan in the 2048x2048x208 compact volume of
          ``TransferEngine(synthesis="raymarch")``, 65,536 HDL32 rays from
          the sensor, fine step 2 voxels) and from a rolling-shutter
          sensor's per-ray origins over the scene's next pose, and on
          every other column of the reference rays: the device time of
          each operation (the march, and the packing of the
          occupancy into bits), the samples a ray (mean, p99, max) and
          the cycles a sample at the card's highest SM clock;
  mesh    row C on the first scan's oracle catmesh frame
          (``TransferEngine(catmesh_engine="oracle")``, HDL64 -> HDL32,
          float32 state): its 65,536 HDL32 rays from the sensor against
          the frame's per-category meshes; each stage of the BVH's build
          (the keys, ``torch.sort``, the hierarchy, the refit with the
          fill of its counters, the reorder), the traversal, the whole
          route (``raycast_mesh``) and the dense kernel of the parent
          design;
  probes  rows 4 to 7 at the probe scripts' 1024x1024x256: the parts
          kernel in the script's rows (each variant with three outputs at
          BX 2, full with one output, full at BX 4 and 8); the ablate
          kernel, precols and nodiv at BX 1, 2 and 4, beside the real
          compact integrate with the table on the same images and table;
          the write kernel, bf16 x1 at BX8 BY1024 and in flat rows of
          BR8192, the three alias outputs in place (alias_any) and read
          first (alias_vmem), three bf16 outputs, float32 and int8, each
          beside ``Tensor.fill_`` of the same tensors (three fills for three
          outputs) and ``torch.full``, alias_vmem also beside an in-place
          ``Tensor.add_`` of each output (the same bytes read and written).
  norm    row D, GroupNorm with its affine and leaky ReLU
          (``ops/group_norm``), at each distinct (C, H, W) of darknet53's
          57 norms in a forward of 1x64x2048 in bf16, beside ATen's
          ``F.group_norm`` + ``F.leaky_relu`` + cast under bf16 autocast
          (the yardstick; outputs that differ beyond the card test's
          tolerance raise), and each summed over the 57 layers.
  ptv3    rows F and E, PT-v3m1's serialization codes (``ops/serialize``)
          and neighbour maps of kernels 3 and 5 (``ops/sparse_conv``) of
          the 0.05 m cells of four synthetic HDL-64E scans, each beside its
          plain version on the card.

Each case gives the wrapper's time (CUDA events around back-to-back calls),
the device time (the summed durations of the device operations of a call,
``torch.profiler``), the device operations a call, and the bound from
``bounds.py`` with the share of it reached (bound / device time). Two
versions of the kernels are compared by running the same command in a
checkout of each, in turns on one card, and reading the ``--out`` files
side by side.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

GROUPS = ("volume", "small", "frame", "probes", "march", "mesh", "norm",
          "ptv3")
DIMS = (2048, 2048, 208)
ODD_DIMS = (2048, 2048, 206)
SCALAR_DIMS = (2047, 2047, 206)
SMALL_DIMS = (1024, 1024, 256)
ORIGIN = (-50.0, -50.0, -5.0)
SMALL_ORIGIN = (-25.6, -25.6, -6.4)
VOXEL = 0.05


def confusion_labels(rng, n: int, n_classes: int, skewed: bool,
                     ids=None, stray: bool = False):
    """(pred, target) int32 arrays of ``n`` samples for the confusion
    counts. Skewed: pred from 7 ids (``ids``, else drawn), 80 % of the
    targets equal to it, the rest uniform; else both uniform. ``stray``
    lets skewed targets fall up to 3 outside [0, n_classes) and sets 2 %
    of the preds to -1."""
    import numpy as np

    if not skewed:
        return (rng.integers(0, n_classes, n).astype(np.int32),
                rng.integers(0, n_classes, n).astype(np.int32))
    ids = rng.integers(0, n_classes, 7) if ids is None else ids
    pred = rng.choice(ids, n).astype(np.int32)
    other = (rng.integers(-3, n_classes + 3, n) if stray
             else rng.integers(0, n_classes, n))
    tgt = np.where(rng.random(n) < 0.8, pred, other).astype(np.int32)
    if stray:
        pred[rng.random(n) < 0.02] = -1
    return pred, tgt


def measure(groups=GROUPS, only: str = "") -> list[dict]:
    """Run the cases of ``groups`` whose name contains ``only`` on the
    card; -> one dict a case."""
    import numpy as np
    import torch

    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64
    from lidar_transfer_tpu_torch.datasets import kitti, synthetic
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.probes import timing

    dev = torch.device("cuda")
    gpu = timing.gpu_line()
    _build.library()
    rows = []

    def add(row):
        rows.append(dict(row, gpu=gpu))
        print(json.dumps(rows[-1]), flush=True)
        return rows[-1]

    def case(name, fn, bound, iters, dev_iters, note="", **extra):
        if only not in name:
            return None
        ms = timing.cuda_ms(fn, iters)
        d_ms, ops, names = timing.device_ms(fn, dev_iters)
        return add(dict(case=name, ms=ms, device_ms=d_ms, device_ops=ops,
                        ops=names, bytes=bound.bytes, bound_ms=bound.ms,
                        bound_by=bound.by, note=note, **extra))

    # three scans of the synthetic scene, each in its own sensor frame
    scene = synthetic.Scene.default()
    poses = synthetic.straight_line_poses(3)
    fov = dict(fov_up_deg=HDL64.fov_up, fov_down_deg=HDL64.fov_down)
    ris, scans = [], []
    for i in range(3):
        pts, rem, lbl = synthetic.simulate_scan(scene, HDL64, poses[i])
        cap = kitti.scan_capacity(len(pts))
        pad = lambda a: np.concatenate(  # noqa: E731
            [a, np.zeros((cap - len(a),) + a.shape[1:], a.dtype)])
        valid = np.arange(cap) < len(pts)
        args = [torch.from_numpy(a).to(dev) for a in (
            pad(pts), pad(rem.astype(np.float32)),
            pad(lbl.astype(np.int32)), valid)]
        scans.append(args)
        ris.append(TP.range_project(*args, H=HDL64.H, W=HDL64.W, **fov))
    if "volume" in groups:
        _volume_cases(case, ris, fov, dev)
    if "small" in groups:
        _small_cases(case, scans[0], dev)
    if "frame" in groups:
        _frame_case(case, scans, dev)
    if "probes" in groups:
        _probe_cases(case, dev)
    if "march" in groups:
        _march_cases(case, scans[0], dev, np.linalg.inv(poses[0]) @ poses[1])
    if "mesh" in groups:
        _mesh_cases(case, scans[0], dev)
    if "norm" in groups:
        _norm_cases(case, add, dev)
    if "ptv3" in groups:
        _ptv3_cases(case, dev)
    return rows


def _volume_cases(case, ris, fov, dev) -> None:
    """Rows 1, 1b and 2 of the kernel table."""
    import inspect

    import torch

    from lidar_transfer_tpu_torch.config import HDL64
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_chain_cuda, integrate_cuda, precompute_geometry_cuda)
    from lidar_transfer_tpu_torch.probes import bounds

    one = (ris[0].range, ris[0].label, ris[0].remission)
    stacks = [torch.stack([getattr(ri, f) for ri in ris])
              for f in ("range", "label", "remission")]
    hw = (HDL64.H, HDL64.W)
    for dims, origin in ((DIMS, ORIGIN), (ODD_DIMS, ORIGIN),
                         (SCALAR_DIMS, ORIGIN), (SMALL_DIMS, SMALL_ORIGIN)):
        big = dims == DIMS
        spec = TS.VolumeSpec(origin, VOXEL, dims)
        tag = "x".join(map(str, dims))
        table = precompute_geometry_cuda(spec, HDL64.fov_up, HDL64.fov_down,
                                         HDL64.H, device=dev)
        # the table's modes; a tree from before the fast mode has one
        modes = ({"fast": {}, "exact": {"exact": True}}
                 if "exact" in inspect.signature(
                     precompute_geometry_cuda).parameters
                 else {"exact": {}})
        for mode, kw in modes.items():
            case(f"geometry table {tag} {mode}",
                 lambda: precompute_geometry_cuda(
                     spec, HDL64.fov_up, HDL64.fov_down, HDL64.H,
                     device=dev, **kw),
                 bounds.geometry(dims), 10, 3)
        for compact in (False, True):
            if dims == SMALL_DIMS and not compact:
                continue
            kind = "compact" if compact else "f32"
            state = spec.init_state(dev, compact)
            for v_tab in (None, table):
                if not big and v_tab is None:
                    continue
                tab = "table" if v_tab is not None else "no table"
                case(f"single {tag} {kind} reset no weight, {tab}",
                     lambda: integrate_cuda(
                         state, spec, *one, reset=True, write_weight=False,
                         v_tab=v_tab, **fov),
                     bounds.integrate(dims, compact=compact,
                                      write_weight=False,
                                      table=v_tab is not None, image_hw=hw),
                     10, 3)
                if dims != SMALL_DIMS:
                    case(f"chain S=3 {tag} {kind}, {tab}",
                         lambda: integrate_chain_cuda(
                             state, spec, *stacks, v_tab=v_tab, **fov),
                         bounds.integrate(dims, compact=compact, S=3,
                                          table=v_tab is not None,
                                          image_hw=hw), 10, 3)
            if big:
                # carried: scan 0 fused, then scan 1 onto it; the bound
                # counts the voxels this data reads and changes
                integrate_cuda(state, spec, *one, reset=True, v_tab=table,
                               **fov)
                before = TS.TSDFState(*(t.clone() for t in state))
                nxt = (ris[1].range, ris[1].label, ris[1].remission)
                integrate_cuda(state, spec, *nxt, v_tab=table, **fov)
                changed = torch.zeros(dims, dtype=torch.bool, device=dev)
                for a, b in zip(before, state):
                    changed |= a != b
                n_chg, n_act = int(changed.sum()), int((table >= 0).sum())
                del before, changed
                case(f"single {tag} {kind} carried, table",
                     lambda: integrate_cuda(state, spec, *nxt, v_tab=table,
                                            **fov),
                     bounds.integrate(dims, compact=compact, reset=False,
                                      table=True, image_hw=hw,
                                      active_voxels=n_act,
                                      changed_voxels=n_chg), 10, 3,
                     note=f"read {n_act / spec.num_voxels:.4f}, changed "
                          f"{n_chg / spec.num_voxels:.4f} of voxels")
            del state
            torch.cuda.empty_cache()
        del table
        torch.cuda.empty_cache()


def _small_cases(case, scan, dev) -> None:
    """Rows 3 and A of the kernel table, and an empty kernel launch."""
    import numpy as np
    import torch

    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import HDL64
    from lidar_transfer_tpu_torch.metrics import confusion as TF
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.probes import bounds

    rng = np.random.default_rng(0)
    for C, ids in ((260, [0, 10, 40, 48, 50, 70, 252]),
                   (20, [0, 1, 2, 3, 5, 7, 11])):
        for m in (131072, 1 << 20):
            for labels in ("skewed", "uniform"):
                pred_t, tgt_t = (
                    torch.from_numpy(a).to(dev) for a in confusion_labels(
                        rng, m, C, labels == "skewed", ids))
                case(f"confusion N={m} C={C} {labels}",
                     lambda: TF.confusion_matrix(pred_t, tgt_t, C),
                     bounds.confusion(m, C), 200, 50)

    # the confusion counts in library calls: the cell indices (pred * C +
    # target, C * C for a stray id) and ``bincount``
    m, C = 131072, 260
    pred_t, tgt_t = (torch.from_numpy(a).to(dev) for a in confusion_labels(
        rng, m, C, True, [0, 10, 40, 48, 50, 70, 252], stray=True))

    def confusion_library():
        ok = (pred_t >= 0) & (pred_t < C) & (tgt_t >= 0) & (tgt_t < C)
        cells = torch.where(ok, pred_t * C + tgt_t, C * C).to(torch.int64)
        return torch.bincount(cells, minlength=C * C + 1)[:C * C].reshape(
            C, C)

    ref = TF.confusion_matrix(pred_t, tgt_t, C)
    if not torch.equal(confusion_library().to(ref.dtype), ref):
        raise AssertionError("the confusion's library calls (bincount) != "
                             "its kernel")
    case("confusion library", confusion_library, bounds.confusion(m, C),
         200, 50, note=f"N={m} C={C} skewed, stray ids")

    pts, _, _, valid = scan
    npix = HDL64.H * HDL64.W
    pix, key, *_ = TP._pixel_keys(pts, valid, HDL64.fov_up, HDL64.fov_down,
                                  None, HDL64.H, HDL64.W, False, "depth")
    pix, key = pix.contiguous(), key.contiguous()
    zb = bounds.zbuffer(pix.shape[0], npix)
    what = f"z-buffer N={pix.shape[0]} npix={npix}"
    case(f"{what}, no workspace",
         lambda: TP.zbuffer_winners(pix, key, npix), zb, 200, 50)
    ws = TP.ZBufferWorkspace()
    case(f"{what}, workspace",
         lambda: TP.zbuffer_winners(pix, key, npix, workspace=ws), zb, 200,
         50)

    # the z-buffer in library calls: the packing of (key bits << 32) |
    # index, the reset of the buffer (``fill_``), ``scatter_reduce_`` amin
    # and the decode to winners
    n, empty = pix.shape[0], torch.iinfo(torch.int64).max
    buf = torch.empty(npix + 1, dtype=torch.int64, device=dev)

    def zbuffer_library():
        words = ((key.view(torch.int32).to(torch.int64) << 32)
                 | torch.arange(n, device=dev))
        where = torch.where((pix < 0) | (pix >= npix), npix,
                            pix).to(torch.int64)     # npix: the overflow
        buf.fill_(empty)
        buf.scatter_reduce_(0, where, words, "amin")
        won = buf[:npix]
        return torch.where(won == empty, -1,
                           won & 0xFFFFFFFF).to(torch.int32)

    if not torch.equal(zbuffer_library(), TP.zbuffer_winners(pix, key, npix)):
        raise AssertionError("the z-buffer's library calls != its kernel")
    case("zbuffer library", zbuffer_library, zb, 200, 50, note=what)
    lib, stream = _build.library(), _build.stream_handle(dev)
    case("empty kernel launch", lambda: lib.lt_empty_launch(stream),
         bounds.bound(0), 200, 50)


def _frame_case(case, scans, dev) -> None:
    """The mergemesh frame: its device operations a frame."""
    import torch

    from lidar_transfer_tpu_torch.config import HDL32, HDL64, TransferConfig
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import ScanWindow
    from lidar_transfer_tpu_torch.probes import bounds

    cfg = TransferConfig(voxel_size=VOXEL, voxel_bounds=tuple(
        (o, o + d * VOXEL) for o, d in zip(ORIGIN, (2000, 2000, 200))))
    eng = TD.TransferEngine(HDL64, HDL32, cfg, fixed_bounds=True, device=dev)
    wins = [ScanWindow(points=p[None], remissions=r[None], labels=lb[None],
                       valid=v[None],
                       rel_pose=torch.eye(4, device=dev)[None])
            for p, r, lb, v in scans]
    case("mergemesh frame HDL64->HDL32 (transfer_fast, 3 frames a call)",
         lambda: [eng.transfer_fast(w) for w in wins], bounds.bound(0), 20,
         3)


def _probe_cases(case, dev) -> None:
    """Rows 4 to 7 of the kernel table, rows 4, 6 and 7 each beside what it
    is held to: the real integrate (row 4) and PyTorch's fill (rows 6 and
    7)."""
    import torch

    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_cuda, precompute_geometry_cuda)
    from lidar_transfer_tpu_torch.probes import ablate, bounds, parts, write

    dims = parts.DIMS
    tag = "x".join(map(str, dims))
    cols = parts.make_inputs(dims, dev)
    for variant, n_out, bx in ([(v, 3, 2) for v in parts.VARIANTS]
                               + [("full", 1, 2), ("full", 3, 4),
                                  ("full", 3, 8)]):
        case(f"parts {variant} BX{bx} x{n_out} {tag}",
             lambda: parts.probe_parts(variant, *cols, Z=dims[2],
                                       n_out=n_out, BX=bx),
             bounds.probe_parts(dims, parts.CW, n_out), 20, 3)
    del cols
    torch.cuda.empty_cache()

    dims = ablate.DIMS
    tag = "x".join(map(str, dims))
    spec = TS.VolumeSpec(ablate.ORIGIN, ablate.VOXEL, dims)
    imgs = ablate.make_images(dev)
    fov = dict(fov_up_deg=ablate.FOV_UP, fov_down_deg=ablate.FOV_DOWN)
    table = precompute_geometry_cuda(spec, ablate.FOV_UP, ablate.FOV_DOWN,
                                     ablate.H, device=dev)
    state = spec.init_state(dev, compact=True)
    case(f"ablate real {tag} (integrate compact reset no weight, table)",
         lambda: integrate_cuda(state, spec, *imgs, reset=True,
                                write_weight=False, v_tab=table, **fov),
         bounds.integrate(dims, compact=True, write_weight=False, table=True,
                          image_hw=(ablate.H, ablate.W)), 20, 3)
    del state
    args = (ablate.ablate_params(ablate.ORIGIN, dims, dev),
            *ablate.build_cols(*imgs, dims, ablate.ORIGIN), table)
    for div, name in ((True, "precols"), (False, "nodiv")):
        for bx in (2, 1, 4):
            case(f"ablate {name} {tag} BX{bx}",
                 lambda: ablate.probe_ablate(div, *args, BX=bx),
                 bounds.probe_ablate(dims, ablate.CW), 20, 3)
    del args, table
    torch.cuda.empty_cache()

    dims = write.DIMS
    alias = dict(zip(("BX", "BY"), write.ALIAS_BLOCK))
    for name, dts, block in (
            ("bf16 x1 BX8 BY1024", [torch.bfloat16], dict(BX=8, BY=1024)),
            ("bf16 x1 BR8192", [torch.bfloat16], dict(BR=8192)),
            ("alias_any", write.ALIAS_DTYPES, alias),
            ("alias_vmem", write.ALIAS_DTYPES, dict(alias, read_first=True)),
            ("bf16 x3 BX4 BY1024", [torch.bfloat16] * 3,
             dict(BX=4, BY=1024)),
            ("float32 x1 BX4 BY1024", [torch.float32], dict(BX=4, BY=1024)),
            ("int8 x1 BX4 BY1024", [torch.int8], dict(BX=4, BY=1024))):
        outs = [torch.zeros(dims, dtype=dt, device=dev) for dt in dts]
        # read first: each output's bytes read and written
        b = bounds.probe_write(dims, [dt.itemsize * (
            2 if block.get("read_first") else 1) for dt in dts])
        case(f"write {name} {tag}",
             lambda: write.probe_write(outs, **block), b, 20, 3)
        case(f"write {name} {tag}: Tensor.fill_ x{len(outs)}",
             lambda: write.write_plain(outs), b, 20, 3)
        case(f"write {name} {tag}: torch.full x{len(outs)}",
             lambda: [torch.full(dims, i + 1, dtype=dt, device=dev)
                      for i, dt in enumerate(dts)], b, 20, 3)
        if block.get("read_first"):
            # PyTorch's read and write of the same bytes, one call an output
            case(f"write {name} {tag}: Tensor.add_ x{len(outs)}",
                 lambda: [o.add_(1) for o in outs], b, 20, 3)
        del outs
        torch.cuda.empty_cache()


def march_inputs(scan, dev):
    """Row B's reference march: the first scan of the synthetic HDL64
    scene (``scan``, padded on the card) integrated by
    ``TransferEngine(synthesis="raymarch")`` (mergemesh, compact state,
    fixed bounds +-50/+-50/+-5 m, voxel 0.05 m: 2048x2048x208) and the
    engine's occupancy of its points; -> (engine, the arguments of
    ``ops/raycast.raymarch`` for the HDL32 rays from the sensor)."""
    import torch

    from lidar_transfer_tpu_torch.config import HDL32, HDL64, TransferConfig
    from lidar_transfer_tpu_torch.ops import raycast as RC
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import ScanWindow

    cfg = TransferConfig(voxel_size=VOXEL, voxel_bounds=(
        (-50.0, 50.0), (-50.0, 50.0), (-5.0, 5.0)))
    eng = TD.TransferEngine(HDL64, HDL32, cfg, fixed_bounds=True,
                            device=dev, synthesis="raymarch",
                            compact_volume=True)
    pts, rem, lbl, valid = scan
    eng.transfer_fast(ScanWindow(
        points=pts[None], remissions=rem[None], labels=lbl[None],
        valid=valid[None], rel_pose=torch.eye(4, device=dev)[None]))
    spec = eng.vol_spec
    occ = RC.occupancy_from_points(pts, valid, spec.origin, spec,
                                   pixel_angle_rad=eng._src_pixel_angle())
    prm = RC.march_params(spec, spec.origin, 4, 2.0)
    return eng, (eng.fused_state(), occ, eng.rays,
                 torch.zeros(3, device=dev), prm, spec.dims, 4,
                 RC.default_max_steps(spec, 2.0))


def _march_cases(case, scan, dev, pose_next) -> None:
    """Row B on the reference march, from the sensor and (where the tree
    has ``generate_rays_moving``) from a rolling-shutter sensor's (R, 3)
    origins over ``pose_next``; each with the device time of each of its
    operations (``split``: the march kernel, and the occupancy's packing
    where the kernel reads bits) and the samples a ray of the plain
    march."""
    import torch

    from lidar_transfer_tpu_torch.config import HDL32
    from lidar_transfer_tpu_torch.ops import raycast as RC
    from lidar_transfer_tpu_torch.probes import bounds, timing

    eng, args = march_inputs(scan, dev)
    # every other column: half the warps, rays of the same lengths (a
    # kernel set by its longest rays keeps its time, one set by its total
    # work halves it)
    half = args[2].reshape(HDL32.H, HDL32.W, 3)[:, ::2].reshape(-1, 3)
    runs = [("reference march 65536 HDL32 rays, 2048x2048x208 compact, "
             "shared origin", args),
            ("reference march, every other column: 32768 rays",
             (*args[:2], half.contiguous(), *args[3:]))]
    if hasattr(RC, "generate_rays_moving"):
        rays, origins = RC.generate_rays_moving(
            HDL32.H, HDL32.W, HDL32.fov_up, HDL32.fov_down, pose_next)
        runs.append((
            "rolling march 65536 HDL32 rays, 2048x2048x208 compact, (R, 3) "
            "origins", (args[0], args[1], torch.from_numpy(rays).to(dev),
                        torch.from_numpy(origins).to(dev), *args[4:])))
    clock = timing.max_sm_clock_mhz()
    for name, a in runs:
        stats = {}
        RC.raycast_plain(*a, stats=stats)
        R = a[2].shape[0]
        rb = bounds.raymarch(R, a[3].reshape(-1, 3).shape[0],
                             stats["steps"], stats["hits"],
                             sum(stats["sectors"].values()))
        samples = dict(mean=stats["steps"] / R, hits=stats["hits"],
                       occupied=stats["occupied"],
                       max=stats.get("samples_max"),
                       p99=stats.get("samples_p99"))
        split = timing.device_split(lambda: RC.raymarch(*a), 3)
        march_ms = sum(v for k, v in split.items() if "raymarch" in k)
        case(name, lambda: RC.raymarch(*a), rb, 20, 3,
             note=f"samples a ray {samples}", split=split, samples=samples,
             max_sm_clock_mhz=clock,
             cycles_a_sample=(march_ms * 1e-3 * clock * 1e6
                              / samples["max"] if samples["max"] else None))
    del eng
    torch.cuda.empty_cache()


def _mesh_cases(case, scan, dev) -> None:
    """Row C on the first scan's oracle catmesh frame at the reference
    point: the frame's meshes as (T, 3, 3) triangles on the card, the
    HDL32 rays from the sensor; each build stage, the traversal, the
    route and the dense kernel."""
    import torch

    from lidar_transfer_tpu_torch.config import (HDL32, HDL64,
                                                 TransferConfig)
    from lidar_transfer_tpu_torch.ops import triangles as TT
    from lidar_transfer_tpu_torch.ops import triangles_cuda as TC
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import ScanWindow
    from lidar_transfer_tpu_torch.probes import bounds

    cfg = TransferConfig(adaption="catmesh", voxel_size=VOXEL,
                         voxel_bounds=((-50.0, 50.0), (-50.0, 50.0),
                                       (-5.0, 5.0)))
    eng = TD.TransferEngine(HDL64, HDL32, cfg, fixed_bounds=True,
                            device=dev, catmesh_engine="oracle")
    pts, rem, lbl, valid = scan
    eng.transfer_fast(ScanWindow(
        points=pts[None], remissions=rem[None], labels=lbl[None],
        valid=valid[None], rel_pose=torch.eye(4, device=dev)[None]))
    mesh, rays = eng._last_mesh, eng.rays
    tris = torch.from_numpy(mesh.verts).to(dev)[torch.from_numpy(
        mesh.faces).to(dev).to(torch.int64)].contiguous()
    del eng
    torch.cuda.empty_cache()
    origin = torch.zeros(3, device=dev)
    T, R = tris.shape[0], rays.shape[0]
    scene, reach = TT.scene_scale(tris), TT.ray_reach(origin, rays)
    keys, boxes = TC.bvh_keys_cuda(tris, scene, reach)
    skeys, leaf = TT.leaf_order(keys)
    nodes, parents, counters = TC.bvh_hierarchy_cuda(skeys)
    height = TC.bvh_refit_cuda(nodes, parents, counters, leaf, boxes)
    bvh = TT.MeshBVH(nodes, parents, leaf, TC.bvh_reorder_cuda(tris, leaf),
                     skeys, height)
    name = f"oracle frame T={T}"
    case(f"mesh bvh keys, {name}",
         lambda: TC.bvh_keys_cuda(tris, scene, reach), bounds.bvh_keys(T),
         3, 3, triangles=T)
    case(f"mesh bvh sort (torch.sort), {name}", lambda: TT.leaf_order(keys),
         bounds.bvh_sort(T), 3, 3, triangles=T)
    case(f"mesh bvh hierarchy, {name}",
         lambda: TC.bvh_hierarchy_cuda(skeys), bounds.bvh_hierarchy(T), 3,
         3, triangles=T)
    case(f"mesh bvh refit, {name}", lambda: TC.bvh_refit_cuda(
        nodes, parents, counters.zero_(), leaf, boxes), bounds.bvh_refit(T),
        3, 3, note="with the fill of its counters", triangles=T)
    case(f"mesh bvh reorder, {name}",
         lambda: TC.bvh_reorder_cuda(tris, leaf), bounds.bvh_reorder(T), 3,
         3, triangles=T)
    case(f"mesh traversal, 65536 HDL32 rays, {name}",
         lambda: TC.mesh_raycast_cuda(origin, rays, bvh),
         bounds.mesh_raycast(R, T, 1), 3, 3,
         note="beside row C's whole bound", triangles=T)
    case(f"mesh raycast (build and traversal), 65536 HDL32 rays, {name}",
         lambda: TT.raycast_mesh(origin, rays, tris),
         bounds.mesh_raycast(R, T, 1), 3, 3, triangles=T)
    case(f"mesh raycast dense (the parent design), 65536 HDL32 rays, "
         f"{name}", lambda: TC.mesh_raycast_dense_cuda(origin, rays, tris),
         bounds.mesh_raycast_dense(R, T, 1), 1, 1, triangles=T)
    del tris, bvh, keys, boxes, skeys
    torch.cuda.empty_cache()


def norm_shapes(cfg, H: int, W: int) -> list[tuple[int, int, int]]:
    """(C, H, W) of each GroupNorm of a ``models.RangeNet`` forward of
    ``cfg`` on an H x W input, in the forward's order: the stem, each
    stage's halving convolution and its blocks' two, the decoder's."""
    W += (-W) % 2 ** len(cfg.stage_blocks)
    shapes = [(cfg.stem_features, H, W)]
    for n, f in zip(cfg.stage_blocks, cfg.stage_features):
        W //= 2
        shapes += [(f, H, W)] + [(f // 2, H, W), (f, H, W)] * n
    for skip in reversed((cfg.stem_features,) + cfg.stage_features[:-1]):
        W *= 2
        shapes.append((max(skip, 32), H, W))
    return shapes


def norm_inputs(C: int, H: int, W: int, dev, dtype, seed: int = 0):
    """A (1, C, H, W) input like a convolution's output (normal, a mean of
    its own a channel) and GroupNorm parameters near their start (weight
    about 1, bias about 0)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((1, C, H, W), generator=g, device=dev)
         + torch.randn((1, C, 1, 1), generator=g, device=dev)).to(dtype)
    w = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
    b = 0.1 * torch.randn(C, generator=g, device=dev)
    return x, w, b


def check_norm(got, want, what: str) -> float:
    """Hold kernel D's output to the plain float32 composition's (both
    sum in float32, in other orders): bf16 equal on >= 99.9 % of elements
    and elsewhere within one bf16 ulp of the plain value or 1e-5, whichever
    is larger (near 0 a bf16 ulp is finer than the statistics' float32
    error, and the two may differ in sign there); float32 within 1e-5,
    relative and absolute. Raises AssertionError otherwise; -> the share
    of equal elements."""
    import torch

    from lidar_transfer_tpu_torch.probes.timing import bf16_ulp

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}, "
                             f"plain {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    equal = float((got == want).float().mean())
    if got.dtype == torch.bfloat16:
        tol = torch.clamp(bf16_ulp(w), min=1e-5)
    else:
        tol = 1e-5 + 1e-5 * w.abs()
    bad = (g - w).abs() > tol
    if (got.dtype == torch.bfloat16 and equal < 0.999) or bool(bad.any()):
        raise AssertionError(
            f"{what}: {equal:.6f} of the elements equal, {int(bad.sum())} "
            f"beyond the tolerance (first: {g[bad][:4].tolist()} against "
            f"{w[bad][:4].tolist()})")
    return equal


def _norm_cases(case, add, dev) -> None:
    """Row D at darknet53's norms of a forward at 1x64x2048, bf16."""
    import collections

    import torch
    import torch.nn.functional as F

    from lidar_transfer_tpu_torch.models.rangenet import (GN_EPS,
                                                          GROUP_SIZE,
                                                          RangeNetConfig)
    from lidar_transfer_tpu_torch.ops import group_norm as GN
    from lidar_transfer_tpu_torch.probes import bounds

    shapes = collections.Counter(norm_shapes(RangeNetConfig.darknet53(),
                                             64, 2048))
    totals = {}
    for (C, H, W), count in shapes.items():
        x, w, b = norm_inputs(C, H, W, dev, torch.bfloat16)
        G = C // GROUP_SIZE

        def kernel():
            return GN.group_norm_leaky_relu(x, G, w, b, GN_EPS)

        def library():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return F.leaky_relu(F.group_norm(x, G, w, b, GN_EPS),
                                    0.1).to(torch.bfloat16)

        equal = check_norm(kernel(), library(), f"group_norm C={C} {H}x{W}")
        bound = bounds.group_norm(x.numel())
        what = f"C={C} G={G} {H}x{W}, {count} of the 57"
        for name, fn in (("group_norm", kernel),
                         ("group_norm library", library)):
            row = case(f"{name} {what}", fn, bound, 200, 50,
                       equal_share=equal)
            if row is None:
                continue
            t = totals.setdefault(name, dict(
                ms=0.0, device_ms=0.0, device_ops=0, bytes=0, bound_ms=0.0,
                layers=0))
            for k in ("ms", "device_ms", "device_ops"):
                t[k] = (None if row[k] is None or t[k] is None
                        else t[k] + count * row[k])
            t["bytes"] += count * bound.bytes
            t["bound_ms"] += count * bound.ms
            t["layers"] += count
    for name, t in totals.items():
        add(dict(case=f"{name}, {t.pop('layers')} layers summed", ops={},
                 bound_by="bytes", note="1x64x2048 bf16", **t))


def ptv3_cells(dev, scans: int = 4):
    """The 0.05 m cells of ``scans`` HDL-64E scans of the synthetic
    scene, as PT-v3m1's step samples them -> (cells (N, 3) int32, scan ids
    (N,))."""
    import numpy as np
    import torch

    from lidar_transfer_tpu_torch.config import HDL64
    from lidar_transfer_tpu_torch.datasets import synthetic
    from lidar_transfer_tpu_torch.models.ptv3 import grid_sample

    scene = synthetic.Scene.default()
    pts = [synthetic.simulate_scan(scene, HDL64, pose)[0]
           for pose in synthetic.straight_line_poses(scans)]
    points = torch.from_numpy(np.concatenate(pts)).to(dev)
    _, grid, cloud, _, _ = grid_sample(points, [len(p) for p in pts], 0.05)
    return grid, cloud


def _ptv3_cases(case, dev) -> None:
    """Rows E and F at scale 0 of a PT-v3m1 step of four HDL-64E scans,
    each beside its plain version on the same card (the yardstick; a
    kernel that differs from it raises)."""
    from lidar_transfer_tpu_torch.ops import serialize as S
    from lidar_transfer_tpu_torch.ops import sparse_conv as SC
    from lidar_transfer_tpu_torch.probes import bounds

    grid, cloud = ptv3_cells(dev)
    n, bits = grid.shape[0], S.depth(grid)
    if not (S.encode_cuda(grid, cloud, bits)
            == S.encode_plain(grid, cloud, bits)).all():
        raise AssertionError("ptv3_serialize differs from its plain version")
    what = f"N={n}, {bits} bits, 4 scans"
    for name, fn in (("ptv3_serialize", S.encode_cuda),
                     ("ptv3_serialize plain", S.encode_plain)):
        case(f"{name} {what}", lambda: fn(grid, cloud, bits),
             bounds.ptv3_serialize(n), 50, 10)
    for k in (3, 5):
        if not (SC.neighbor_map_cuda(grid, cloud, k)
                == SC.neighbor_map_plain(grid, cloud, k)).all():
            raise AssertionError(f"ptv3_neighbor_map k={k} differs from its "
                                 "plain version")
        for name, fn in (("ptv3_neighbor_map", SC.neighbor_map_cuda),
                         ("ptv3_neighbor_map plain", SC.neighbor_map_plain)):
            case(f"{name} k={k} N={n}, 4 scans",
                 lambda fn=fn: fn(grid, cloud, k),
                 bounds.ptv3_neighbor_map(n, k), 20, 5)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("groups", nargs="*", metavar="GROUP",
                    help=f"the groups of cases to run, of {', '.join(GROUPS)}"
                         " (default: all)")
    ap.add_argument("--only", default="", metavar="TEXT",
                    help="run only the cases whose name contains TEXT")
    ap.add_argument("--out", help="write every row as JSON here")
    args = ap.parse_args(argv)
    if set(args.groups) - set(GROUPS):
        ap.error(f"unknown group in {args.groups}; choose from {GROUPS}")
    if not torch.cuda.is_available():
        print("the cases run on a CUDA device; none is available",
              file=sys.stderr)
        return 1
    rows = measure(tuple(args.groups) or GROUPS, args.only)
    if not rows:
        ap.error(f"no case of these groups contains {args.only!r}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(f"# {rows[0]['gpu']}")
    print("# case | bound ms (by) | wrapper ms / device ms / device ops a "
          "call | share of bound (bound / device ms)")
    for r in rows:
        d = r["device_ms"]
        print(f"{r['case']} | {r['bound_ms']:.4f} ({r['bound_by']}) | "
              f"{r['ms']:.4f} / "
              + ("not measured" if d is None else f"{d:.4f}")
              + f" / {r['device_ops']:.1f} | "
              + (f"{r['bound_ms'] / d:.3f}" if d else "-"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
