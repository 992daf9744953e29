"""Command-line entry point for batch scan transfer (PyTorch port).

Counterpart of ``lt-transfer`` (``lidar_transfer_tpu/cli.py``) for the
mergemesh and mesh adaptions (``adaption`` and ``number_of_scans`` of the
config) with splat synthesis:

  python -m lidar_transfer_tpu_torch.cli -d DATASET [-c CFG.yaml] [-s SEQ]
      [-t TARGET.yaml] [-o OFFSET] [-p OUT] [-b] [-w] [--one_scan]
      [--frames N] [--fixed-bounds] [--metrics-json F] [--stream N]
      [--ply DIR] [--device cuda|cpu]

It prints the same "IoU:", "Acc:", "MSE: " and "Took: ...s" lines (the
metric lines when source and target image dims agree) and writes the
per-frame metrics to --metrics-json. ``--ply DIR`` writes each frame's
fused volume as a PLY mesh coloured by label (``DIR/<index>.ply``) and
records its triangle count; it needs the per-frame path, so it turns
``--stream`` off. It runs on the card unless
``--device cpu`` is given; without a CUDA device it refuses to start.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from shutil import copy2

import numpy as np
import torch

from lidar_transfer_tpu.utils.prefetch import Prefetcher
from lidar_transfer_tpu.utils.runtime import StageTimer
from lidar_transfer_tpu_torch.config import (SensorSpec, TransferConfig,
                                             make_color_lut)
from lidar_transfer_tpu_torch.datasets import kitti
from lidar_transfer_tpu_torch.metrics.compare import compare_scans
from lidar_transfer_tpu_torch.ops import projection as P
from lidar_transfer_tpu_torch.pipeline.deform import TransferEngine
from lidar_transfer_tpu_torch.pipeline.multiscan import (load_window,
                                                         max_end_index,
                                                         min_start_index,
                                                         stack_windows)
from lidar_transfer_tpu_torch.pipeline.writer import write_virtual_scan


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("lt-transfer (torch)")
    p.add_argument("--dataset", "-d", type=str, required=True,
                   help="Dataset root to adapt (KITTI layout).")
    p.add_argument("--config", "-c", type=str, default=None,
                   help="Tool config yaml (defaults to the built-in "
                        "SemanticKITTI mergemesh config).")
    p.add_argument("--sequence", "-s", type=str, default="00")
    p.add_argument("--target", "-t", type=str, default="",
                   help="Target sensor yaml. Defaults to the dataset's "
                        "config.yaml (identity transfer).")
    p.add_argument("--offset", "-o", type=int, default=0)
    p.add_argument("--output", "-p", type=str, default="output/")
    p.add_argument("--batch", "-b", action="store_true",
                   help="Batch mode (frames advance by batch_interval).")
    p.add_argument("--write", "-w", action="store_true",
                   help="Write the transferred dataset.")
    p.add_argument("--one_scan", action="store_true", help="Run only once.")
    p.add_argument("--frames", type=int, default=None,
                   help="Max frames to process.")
    p.add_argument("--fixed-bounds", action="store_true",
                   help="Use the full config-bounds volume (no per-frame "
                        "cloud clipping).")
    p.add_argument("--metrics-json", type=str, default=None,
                   help="Write per-frame metrics to this JSON file.")
    p.add_argument("--stream", type=int, default=0, metavar="N",
                   help="Transfer N frames per TransferEngine."
                        "transfer_stream call. 0 = per-frame (default).")
    p.add_argument("--ply", type=str, default=None, metavar="DIR",
                   help="Write each frame's fused volume as a PLY mesh "
                        "coloured by label into DIR (turns --stream off).")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device (default cuda; cpu only when asked "
                        "for).")
    return p


def _source_metrics(window, vs, source, eng) -> dict:
    """Compare the window's primary scan, projected at the source spec,
    with the virtual scan (one frame, unbatched)."""
    src = P.range_project(
        window.points[0], window.remissions[0], window.labels[0],
        window.valid[0], H=source.H, W=source.W, fov_up_deg=source.fov_up,
        fov_down_deg=source.fov_down, beam_angles=eng.s_beam_angles)
    res = compare_scans(src.label, src.mask, src.range,
                        torch.clamp(src.remission, min=0.0),
                        vs.label, vs.range, vs.remission)
    scalars = torch.stack([res.mean_iou, res.mean_acc, res.mse]).cpu()
    return dict(iou_per_class=res.iou_per_class.cpu().numpy(),
                present=res.present.cpu().numpy(),
                iou=float(scalars[0]), acc=float(scalars[1]),
                mse=float(scalars[2]))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: lt-transfer (torch) runs on the card "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    if args.stream < 0:
        raise SystemExit(f"--stream must be >= 0, got {args.stream}")
    if args.stream and args.ply:
        print("--stream disabled: --ply needs the per-frame path")
        args.stream = 0

    cfg = (TransferConfig.from_yaml(args.config) if args.config
           else TransferConfig())
    source_cfg_path = os.path.join(args.dataset, "config.yaml")
    source = SensorSpec.from_yaml(source_cfg_path)
    target_path = args.target or source_cfg_path
    target = SensorSpec.from_yaml(target_path)

    print("*" * 60)
    print(f"Source {source.name}: {source.H} x {source.W} "
          f"fov [{source.fov_up}, {source.fov_down}]")
    print(f"Target {target.name}: {target.H} x {target.W} "
          f"fov [{target.fov_up}, {target.fov_down}]")
    print(f"Adaption {cfg.adaption}, nscans {cfg.number_of_scans}, "
          f"voxel {cfg.voxel_size}, device {device}")
    print("*" * 60)

    seq = kitti.KittiSequence.open(args.dataset, args.sequence)
    if len(seq) == 0:
        print("Empty sequence! Exiting...")
        return 1
    probe = max(os.path.getsize(f) // 16 for f in seq.scan_files)
    capacity = kitti.scan_capacity(probe)

    out_path = None
    if args.write:
        out_path = kitti.make_output_dirs(args.output, args.sequence)
        copy2(target_path, out_path)
        if args.config:
            copy2(args.config, out_path)
        cfg.to_yaml(os.path.join(out_path, "lidar_transfer.yaml"))

    eng = TransferEngine(source, target, cfg,
                         fixed_bounds=args.fixed_bounds, device=device)
    same_dims = (source.H, source.W) == (target.H, target.W)
    idx = max(args.offset, min_start_index(cfg.number_of_scans))
    if idx != args.offset:
        print(f"Automatic offset {idx}")
    end = max_end_index(cfg.number_of_scans, len(seq))
    increment = cfg.batch_interval if args.batch else 1

    plan = []
    j = idx
    while j < end:
        if args.frames is not None and len(plan) >= args.frames:
            break
        plan.append(j)
        if args.one_scan:
            break
        j += increment
    windows_ahead = Prefetcher(
        lambda i: load_window(seq, cfg, i, capacity, device), plan, depth=2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def frame_results():
        """Yield (idx, window, VirtualScan, timer, t0) per frame."""
        if not args.stream:
            for i, window in windows_ahead:
                timer = StageTimer()
                t0 = time.time()
                with timer.span("transfer", 1):
                    vs = eng.transfer_fast(window)
                    sync()
                yield i, window, vs, timer, t0
            return
        buf = []

        def flush():
            if not buf:
                return
            timers = [StageTimer() for _ in buf]
            t0 = time.time()
            stacked = stack_windows([w for _, w in buf])
            with timers[0].span("transfer_stream", len(buf)):
                sv = eng.transfer_stream(stacked)
                sync()
            for k, (i, w) in enumerate(buf):
                vs = type(sv)(*(f[k] for f in sv[:5]), sv.adaption)
                yield i, w, vs, timers[k], t0
                t0 = time.time()
            buf.clear()

        for i, window in windows_ahead:
            buf.append((i, window))
            if len(buf) == args.stream:
                yield from flush()
        yield from flush()

    lut = (None if not args.ply else
           (make_color_lut(cfg.color_map_bgr)[:, ::-1] * 255).astype(
               np.uint8))
    all_metrics = []
    try:
        for n_done, (i, window, vs, timer, t0) in enumerate(
                frame_results(), start=1):
            frame_metrics = {"index": i}
            if same_dims:
                m = _source_metrics(window, vs, source, eng)
                iou, present = m["iou_per_class"], m["present"]
                print("IoU class: ", (iou[present] * 100).astype(int))
                print("IoU: ", m["iou"])
                print("Acc: ", m["acc"])
                print("MSE: ", m["mse"])
                frame_metrics.update(iou=m["iou"], acc=m["acc"],
                                     mse=m["mse"])
            if args.write:
                with timer.span("write", 1):
                    frame_metrics["points_written"] = write_virtual_scan(
                        out_path, i, vs)
            if args.ply:
                os.makedirs(args.ply, exist_ok=True)
                frame_metrics["triangles"] = eng.export_mesh(
                    os.path.join(args.ply, f"{i:06d}.ply"), colorize=lut)
            s = time.time() - t0
            print("Took: %.2fs" % s)
            frame_metrics["seconds"] = s
            frame_metrics["stages"] = timer.report()
            all_metrics.append(frame_metrics)
            if n_done < len(plan):
                print("#" * 30, args.sequence, "-", i + increment, "/",
                      len(seq), "#" * 30)
    finally:
        windows_ahead.close()

    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(all_metrics, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
