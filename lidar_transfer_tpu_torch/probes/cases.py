"""Every case of the TSDF integrate, its chain and the z-buffer, timed on
the card beside its bound.

    python -m lidar_transfer_tpu_torch.probes.cases [volume|small|frame ...]
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
          table;
  small   the confusion counts; the z-buffer without a workspace and with
          one; an empty kernel launch;
  frame   three mergemesh frames (HDL64 to HDL32, ``transfer_fast``): the
          device operations they issue.

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

GROUPS = ("volume", "small", "frame")
DIMS = (2048, 2048, 208)
ODD_DIMS = (2048, 2048, 206)
SCALAR_DIMS = (2047, 2047, 206)
SMALL_DIMS = (1024, 1024, 256)
ORIGIN = (-50.0, -50.0, -5.0)
SMALL_ORIGIN = (-25.6, -25.6, -6.4)
VOXEL = 0.05


def measure(groups=GROUPS) -> list[dict]:
    """Run the cases of ``groups`` on the card; -> one dict a case."""
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

    def case(name, fn, bound, iters, dev_iters, note=""):
        ms = timing.cuda_ms(fn, iters)
        d_ms, ops, names = timing.device_ms(fn, dev_iters)
        rows.append(dict(case=name, ms=ms, device_ms=d_ms, device_ops=ops,
                         ops=names, bytes=bound.bytes, bound_ms=bound.ms,
                         bound_by=bound.by, note=note, gpu=gpu))
        print(json.dumps(rows[-1]), flush=True)

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
    return rows


def _volume_cases(case, ris, fov, dev) -> None:
    """Rows 1, 1b and 2 of the kernel table."""
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
        if big:
            case(f"geometry table {tag}", lambda: precompute_geometry_cuda(
                spec, HDL64.fov_up, HDL64.fov_down, HDL64.H, device=dev),
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
    m, C = 131072, 260
    pred = rng.choice([0, 10, 40, 48, 50, 70, 252], m).astype(np.int32)
    tgt = np.where(rng.random(m) < 0.8, pred,
                   rng.integers(0, C, m)).astype(np.int32)
    pred_t, tgt_t = (torch.from_numpy(a).to(dev) for a in (pred, tgt))
    case(f"confusion N={m} C={C}",
         lambda: TF.confusion_matrix(pred_t, tgt_t, C),
         bounds.confusion(m, C), 200, 50)

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


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("groups", nargs="*", metavar="GROUP",
                    help=f"the groups of cases to run, of {', '.join(GROUPS)}"
                         " (default: all)")
    ap.add_argument("--out", help="write every row as JSON here")
    args = ap.parse_args(argv)
    if set(args.groups) - set(GROUPS):
        ap.error(f"unknown group in {args.groups}; choose from {GROUPS}")
    if not torch.cuda.is_available():
        print("the cases run on a CUDA device; none is available",
              file=sys.stderr)
        return 1
    rows = measure(tuple(args.groups) or GROUPS)
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
