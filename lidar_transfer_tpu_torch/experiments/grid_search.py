"""Grid search: number_of_scans x voxel_size (x sequences), in-process.

Counterpart of ``lidar_transfer_tpu/experiments/grid_search.py`` (the
``lt-grid-search`` command, here ``lt-grid-search-torch``), the rebuild of
the reference's ``experiments/grid_search_nframes_voxelsize.py``: each cell
calls the port's ``TransferEngine`` and its metrics come back as values;
the results are written as JSON and rendered as SVG heat maps like the
reference's plots. A cell's frames run one after another on one device,
or with ``mesh=`` (``--device-parallel``, under ``torchrun``) spread over
the ranks of a process group by ``parallel.frame_parallel_transfer``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def _compare_one(seq, eng, cfg, capacity, idx, vs):
    """IoU/Acc/MSE of one virtual scan against its source scan."""
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.metrics.compare import compare_scans
    from lidar_transfer_tpu_torch.ops import projection as P

    p, r, l, m = (torch.from_numpy(a).to(eng.device) for a in
                  kitti.pad_points(*seq.read(idx), capacity))
    m = P.mask_classes(l, m, cfg.ignore_classes)
    src = P.range_project(
        p, r, l, m, H=eng.source.H, W=eng.source.W,
        fov_up_deg=eng.source.fov_up, fov_down_deg=eng.source.fov_down,
        beam_angles=eng.s_beam_angles)
    res = compare_scans(src.label, src.mask, src.range,
                        torch.clamp(src.remission, min=0.0),
                        vs.label, vs.range, vs.remission)
    return tuple(float(v) for v in torch.stack(
        [res.mean_iou, res.mean_acc, res.mse]).cpu())


def evaluate_transfer(dataset: str, cfg, sequence: str = "00",
                      offset: int = 0, frames: int = 1,
                      target_yaml: str | None = None,
                      fixed_bounds: bool = False,
                      mesh=None, mesh_attrs: str = "fold",
                      device="cuda") -> dict:
    """Run the transfer on ``frames`` scans and return the mean
    IoU/Acc/MSE: one in-process reference grid-search cell.

    ``mesh``: a ``parallel.make_mesh`` mesh (every rank of the process
    group calls this with it). The cell's frames, padded to a multiple of
    its "data" axis, then run spread over the ranks
    (``parallel.frame_parallel_transfer``, which implies fixed bounds; each
    rank reads only its own frames) and come back to every rank, which
    scores them all; mergemesh only, as the JAX package.
    """
    from lidar_transfer_tpu_torch.config import SensorSpec
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.experiments.segmentation import _device
    from lidar_transfer_tpu_torch.pipeline.deform import (TransferEngine,
                                                          VirtualScan)
    from lidar_transfer_tpu_torch.pipeline.multiscan import (
        load_window, max_end_index, min_start_index)

    device = _device(device)
    source = SensorSpec.from_yaml(os.path.join(dataset, "config.yaml"))
    target = SensorSpec.from_yaml(target_yaml) if target_yaml else source
    seq = kitti.KittiSequence.open(dataset, sequence)
    capacity = kitti.scan_capacity(
        max(os.path.getsize(f) // 16 for f in seq.scan_files))
    eng = TransferEngine(source, target, cfg,
                         fixed_bounds=fixed_bounds or mesh is not None,
                         mesh_attrs=mesh_attrs, device=device)

    idx0 = max(offset, min_start_index(cfg.number_of_scans))
    end = max_end_index(cfg.number_of_scans, len(seq))
    indices = [idx0 + k for k in range(frames) if idx0 + k < end]
    same_dims = (source.H, source.W) == (target.H, target.W)
    scores = []
    t0 = time.time()
    if mesh is not None and indices:
        if cfg.adaption != "mergemesh":
            raise ValueError("device-parallel cells support mergemesh only")
        from lidar_transfer_tpu_torch.parallel.multihost import (
            load_global_windows)
        from lidar_transfer_tpu_torch.parallel.sharding import (
            axis_sizes, frame_parallel_transfer)

        # pad the batch to a multiple of the data axis; the padded frames
        # are dropped
        pad = (-len(indices)) % axis_sizes(mesh)["data"]
        batch = load_global_windows(seq, cfg, indices + [indices[-1]] * pad,
                                    capacity, mesh, device)
        outs = frame_parallel_transfer(eng, batch, mesh=mesh)
        for k, idx in enumerate(indices):
            vs = VirtualScan(*(o[k] for o in outs), adaption=cfg.adaption)
            if same_dims:
                scores.append(_compare_one(seq, eng, cfg, capacity, idx,
                                           vs))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    else:
        for idx in indices:
            window = load_window(seq, cfg, idx, capacity, device)
            # cp takes its exact per-frame path, as the CLI; the others
            # the production path (transfer_fast)
            vs = (eng.transfer(window)[0] if cfg.adaption == "cp"
                  else eng.transfer_fast(window))
            if same_dims:
                scores.append(_compare_one(seq, eng, cfg, capacity, idx,
                                           vs))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    dt = time.time() - t0
    # grid cells are quality measurements: scans_per_sec includes the
    # per-frame metric reads and is informational only
    out = {"frames": len(indices), "seconds": dt,
           "scans_per_sec": len(indices) / max(dt, 1e-9)}
    if scores:
        iou, acc, mse = np.mean(np.asarray(scores), axis=0)
        out.update(iou=float(iou), acc=float(acc), mse=float(mse))
    return out


def grid_search(dataset: str, *, frames_list=(1, 2, 3),
                voxel_sizes=(0.25, 0.1, 0.05), sequences=("00",),
                offset: int = 0, frames_per_cell: int = 1,
                adaption: str = "mergemesh", base_cfg=None,
                target_yaml: str | None = None,
                out_dir: str | None = None, verbose: bool = True,
                mesh=None, mesh_attrs: str = "fold",
                device="cuda") -> dict:
    """Sweep number_of_scans x voxel_size over sequences.

    Returns {"cells": [...], "grid": {...}} and, with ``out_dir``, writes
    ``grid_search.json`` + ``heatmap_{iou,acc,mse}.svg`` (rank 0 alone in
    a process group). ``mesh``: each cell's frames run spread over its
    ranks (see ``evaluate_transfer``).
    """
    import torch.distributed as dist

    from lidar_transfer_tpu_torch.config import TransferConfig

    rank = (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)
    base = base_cfg or TransferConfig()
    cuda = torch.device(device).type == "cuda"
    cells = []
    for nscans in frames_list:
        for voxel in voxel_sizes:
            cfg = dataclasses.replace(base, adaption=adaption,
                                      number_of_scans=int(nscans),
                                      voxel_size=float(voxel))
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            per_seq = [evaluate_transfer(dataset, cfg, sequence=seq,
                                         offset=offset,
                                         frames=frames_per_cell,
                                         target_yaml=target_yaml,
                                         mesh=mesh, mesh_attrs=mesh_attrs,
                                         device=device)
                       for seq in sequences]
            wall = time.perf_counter() - t0
            cell = {"number_of_scans": int(nscans),
                    "voxel_size": float(voxel),
                    "sequences": dict(zip(sequences, per_seq))}
            for key in ("iou", "acc", "mse", "scans_per_sec"):
                vals = [r[key] for r in per_seq if key in r]
                if vals:
                    cell[key] = float(np.mean(vals))
                    if len(vals) > 1:
                        # the spread across sequences: quality claims
                        # carry a spread, not a point
                        cell[key + "_std"] = float(np.std(vals))
                        cell[key + "_min"] = float(np.min(vals))
                        cell[key + "_max"] = float(np.max(vals))
            cells.append(cell)
            if verbose and rank == 0:
                msg = ", ".join(f"{k}={cell[k]:.4f}"
                                for k in ("iou", "acc", "mse") if k in cell)
                # the cell's wall time and, on the card, its peak memory
                peak = ""
                if cuda:
                    gib = torch.cuda.max_memory_allocated(device) / 2**30
                    peak = f", peak {gib:.2f} GiB"
                print(f"nscans={nscans} voxel={voxel}: {msg} "
                      f"({wall:.2f} s{peak})")

    result = {"grid": {"frames_list": list(frames_list),
                       "voxel_sizes": list(voxel_sizes),
                       "sequences": list(sequences),
                       "adaption": adaption,
                       "device_parallel": mesh is not None,
                       "fixed_bounds": mesh is not None,
                       # cp cells run the exact per-frame transfer();
                       # everything else runs transfer_fast
                       "transfer_path": ("exact" if adaption == "cp"
                                         else "fast"),
                       "mesh_attrs": mesh_attrs},
              "cells": cells}
    if out_dir and rank == 0:
        write_grid(result, out_dir)
    return result


def write_grid(result: dict, out_dir: str) -> None:
    """Write ``result`` as ``out_dir/grid_search.json`` and its heat maps
    ``heatmap_{iou,acc,mse}.svg``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "grid_search.json"), "w") as f:
        json.dump(result, f, indent=2)
    for metric in ("iou", "acc", "mse"):
        if any(metric in c for c in result["cells"]):
            _heatmap(result, metric,
                     os.path.join(out_dir, f"heatmap_{metric}.svg"))


def _heatmap(result: dict, metric: str, out_file: str) -> None:
    """Render a frames x voxel heat map (as the reference's ``plot``)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"matplotlib unavailable - skipping plot {out_file}")
        return

    frames = result["grid"]["frames_list"]
    voxels = result["grid"]["voxel_sizes"]
    data = np.full((len(frames), len(voxels)), np.nan)
    for c in result["cells"]:
        if metric in c:
            data[frames.index(c["number_of_scans"]),
                 voxels.index(c["voxel_size"])] = c[metric]
    fig, ax = plt.subplots(figsize=(1.2 * len(voxels) + 2,
                                    0.8 * len(frames) + 2))
    im = ax.imshow(data, cmap="viridis", aspect="auto")
    ax.set_xticks(range(len(voxels)), [str(v) for v in voxels])
    ax.set_yticks(range(len(frames)), [str(f) for f in frames])
    ax.set_xlabel("voxel size [m]")
    ax.set_ylabel("number of scans")
    ax.set_title(metric)
    for i in range(len(frames)):
        for j in range(len(voxels)):
            if np.isfinite(data[i, j]):
                ax.text(j, i, f"{data[i, j]:.3f}", ha="center",
                        va="center", color="white", fontsize=8)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_file)
    plt.close(fig)


def main(argv=None) -> int:
    import argparse

    from lidar_transfer_tpu_torch.config import TransferConfig

    p = argparse.ArgumentParser("lt-grid-search-torch")
    p.add_argument("--dataset", "-d", required=True)
    p.add_argument("--sequences", "-s", nargs="+", default=["00"])
    p.add_argument("--frames-list", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--voxel-sizes", type=float, nargs="+",
                   default=[0.25, 0.1, 0.05])
    p.add_argument("--frames-per-cell", type=int, default=1)
    p.add_argument("--offset", "-o", type=int, default=0)
    p.add_argument("--adaption", default="mergemesh")
    p.add_argument("--mesh-attrs", default="fold",
                   choices=["fold", "volume"],
                   help="mesh-adaption band attributes: pixel-wise fold "
                        "(volume-free) or the materialised volume probe")
    p.add_argument("--target", "-t", default=None)
    p.add_argument("--out", default="grid_out/")
    p.add_argument("--config", "-c", default=None)
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; cpu only when asked "
                        "for).")
    p.add_argument("--device-parallel", action="store_true",
                   help="run each cell's frames spread over the ranks of "
                        "the torchrun job, one rank a card (mergemesh "
                        "only)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("no CUDA device: lt-grid-search-torch runs on the card (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2

    base = TransferConfig.from_yaml(args.config) if args.config else None
    mesh, device, joined, rank = None, args.device, None, 0
    if args.device_parallel:
        import torch.distributed as dist

        from lidar_transfer_tpu_torch.parallel.multihost import (
            initialize_from_env)
        from lidar_transfer_tpu_torch.parallel.sharding import make_mesh

        joined = initialize_from_env(args.device)
        if joined is None:
            print("--device-parallel runs under torchrun with more than one "
                  "rank (torchrun --nproc-per-node N -m "
                  "lidar_transfer_tpu_torch.experiments.grid_search ...)",
                  file=sys.stderr)
            return 2
        device, rank = joined[1], dist.get_rank()
        mesh = make_mesh(model=1)       # every rank on the frame axis
    try:
        grid_search(args.dataset, frames_list=args.frames_list,
                    voxel_sizes=args.voxel_sizes, sequences=args.sequences,
                    offset=args.offset, frames_per_cell=args.frames_per_cell,
                    adaption=args.adaption, base_cfg=base,
                    target_yaml=args.target, out_dir=args.out, mesh=mesh,
                    mesh_attrs=args.mesh_attrs, device=device)
    finally:
        if joined is not None:
            dist.destroy_process_group()
    if rank == 0:
        print(f"results in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
