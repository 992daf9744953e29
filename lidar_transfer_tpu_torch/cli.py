"""Command-line entry point for batch scan transfer (PyTorch port).

Counterpart of ``lt-transfer`` (``lidar_transfer_tpu/cli.py``) for the
cp, mergemesh, mesh and catmesh adaptions (``adaption`` and
``number_of_scans`` of the config) with splat synthesis, to any target,
denser than the source or not:

  python -m lidar_transfer_tpu_torch.cli -d DATASET [-c CFG.yaml] [-s SEQ]
      [-t TARGET.yaml] [-o OFFSET] [-p OUT] [-b] [-w] [--one_scan]
      [--frames N] [--fixed-bounds] [--metrics-json F] [--stream N]
      [--ply DIR] [--rolling-shutter] [--png] [--html OUT.html]
      [--html-frames N] [--html-max-points N] [--profile DIR]
      [--device cuda|cpu]

It prints the same "IoU:", "Acc:", "MSE: " and "Took: ...s" lines (the
metric lines when source and target image dims agree) and writes the
per-frame metrics to --metrics-json. ``--ply DIR`` writes each frame's
fused volume as a PLY mesh coloured by label (``DIR/<index>.ply``, mesh
and mergemesh only) and records its triangle count; it needs the
per-frame path, so it turns ``--stream`` off. ``--rolling-shutter``
re-casts each mesh or mergemesh frame with the rays of a sensor that moves
while it spins, by the next scan's pose
(``TransferEngine.resynthesize_rolling_shutter``; the last scan of the
sequence, which has no next pose, stays static); it needs the per-frame
path too. ``--png`` writes label and range renders of each virtual scan
(``<out>/sequences/<seq>/labels_png`` and ``velodyne_png``, through
``utils/images``), with or without ``-w``. ``--html OUT.html`` writes the
standalone WebGL viewer (``webviewer.export_html``) of the first
``--html-frames`` frames, source beside virtual scan with the
``interactive.frame_payload`` title metrics; it turns ``--stream`` off.
``--profile DIR`` records the frame loop and its loader with
``torch.profiler`` (CPU and, on the card, CUDA activities) and writes a
Chrome trace, ``DIR/trace.json``, also when the loop raises; the port's
own spans (``utils/runtime``: the loader thread's ``prefetch.load``,
``loader.read``, ``loader.pad``, ``stage.*`` of the frame loop) are added
to it, one row a thread, placed by two ``lt.clock`` anchors at the
profile's start and end. Per frame it runs
``TransferEngine.transfer_fast``, which for cp is ``transfer``, cp's
exact-identity path. It runs on the card unless
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

from lidar_transfer_tpu_torch.config import (SensorSpec, TransferConfig,
                                             make_color_lut)
from lidar_transfer_tpu_torch.datasets import kitti
from lidar_transfer_tpu_torch.interactive import frame_payload
from lidar_transfer_tpu_torch.metrics.compare import compare_scans
from lidar_transfer_tpu_torch.ops import projection as P
from lidar_transfer_tpu_torch.pipeline.deform import TransferEngine
from lidar_transfer_tpu_torch.pipeline.multiscan import (load_window,
                                                         max_end_index,
                                                         min_start_index,
                                                         stack_windows)
from lidar_transfer_tpu_torch.pipeline.writer import write_virtual_scan
from lidar_transfer_tpu_torch.utils.images import save_virtual_scan_pngs
from lidar_transfer_tpu_torch.utils.prefetch import Prefetcher
from lidar_transfer_tpu_torch.utils.runtime import (StageTimer,
                                                    add_to_chrome_trace,
                                                    profiler_anchor)
from lidar_transfer_tpu_torch.webviewer import export_html


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
    p.add_argument("--rolling-shutter", action="store_true",
                   help="Model ego motion within each frame: target rays "
                        "originate at the per-column interpolated sensor "
                        "pose (uses the next scan's pose; turns --stream "
                        "off).")
    p.add_argument("--png", action="store_true",
                   help="Export label/range PNGs of each virtual scan.")
    p.add_argument("--html", type=str, default=None, metavar="OUT.html",
                   help="Write a standalone interactive WebGL viewer of "
                        "the first --html-frames transfers (linked "
                        "source|virtual 3D views, image rows, label "
                        "diff, IoU/Acc/MSE title; n/b/q/1/2/3 keys; "
                        "turns --stream off).")
    p.add_argument("--html-frames", type=int, default=4,
                   help="Frames embedded in --html (default 4).")
    p.add_argument("--html-max-points", type=int, default=300_000,
                   help="Per-cloud point cap embedded in --html.")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Record the frame loop with torch.profiler and "
                        "write a Chrome trace into DIR, the port's spans "
                        "added.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device (default cuda; cpu only when asked "
                        "for).")
    return p


def _source_image(window, source, eng):
    """The window's primary scan projected at the source spec."""
    return P.range_project(
        window.points[0], window.remissions[0], window.labels[0],
        window.valid[0], H=source.H, W=source.W, fov_up_deg=source.fov_up,
        fov_down_deg=source.fov_down, beam_angles=eng.s_beam_angles)


def _source_metrics(src, vs) -> dict:
    """Compare the source image ``src`` with the virtual scan (one frame,
    unbatched)."""
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
    if args.stream and (args.ply or args.rolling_shutter or args.html):
        print("--stream disabled: --rolling-shutter/--ply/--html need the "
              "per-frame path")
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
    if args.write or args.png:
        out_path = kitti.make_output_dirs(args.output, args.sequence,
                                          write_png=args.png)
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
    prof = None
    if args.profile:   # from before the loader's first window
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        profiler_anchor()
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
                    if (args.rolling_shutter and i + 1 < len(seq)
                            and cfg.adaption in ("mesh", "mergemesh")):
                        vs = eng.resynthesize_rolling_shutter(
                            np.linalg.inv(seq.poses[i]) @ seq.poses[i + 1])
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
    html_frames = []
    # an exception mid-run still stops the profiler and writes the trace
    try:
        for n_done, (i, window, vs, timer, t0) in enumerate(
                frame_results(), start=1):
            frame_metrics = {"index": i, "adaption": vs.adaption}
            src = None
            if same_dims:
                src = _source_image(window, source, eng)
                m = _source_metrics(src, vs)
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
            if args.png:
                save_virtual_scan_pngs(out_path, i, vs._replace(
                    label=vs.label.cpu().numpy(),
                    range=vs.range.cpu().numpy()), cfg)
            if args.html and len(html_frames) < args.html_frames:
                # the metrics branch's source projection where it ran
                src_ri = (src if src is not None
                          else _source_image(window, source, eng))
                val = window.valid[0]
                html_frames.append((f"{args.sequence}_{i:06d}", frame_payload(
                    src_ri, cfg, virtual=vs,
                    source_points=window.points[0][val],
                    source_labels=window.labels[0][val])))
            if args.ply and cfg.adaption in ("mesh", "mergemesh"):
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
        if prof is not None:
            profiler_anchor()
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            trace = os.path.join(args.profile, "trace.json")
            prof.export_chrome_trace(trace)
            print(f"profiler trace in {args.profile}, with "
                  f"{add_to_chrome_trace(trace)} port spans")

    if args.html and html_frames:
        out = export_html(
            html_frames, args.html,
            title=f"{source.name} → {target.name} ({cfg.adaption})",
            max_points=args.html_max_points)
        print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, "
              f"{len(html_frames)} frames)")

    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(all_metrics, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
