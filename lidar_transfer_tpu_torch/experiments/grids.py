"""The quality grids at the reference axes: ``full`` and ``multiscene``.

The port's counterpart of ``scripts/run_grid_full.py`` and
``scripts/run_grid_multiscene.py``:

  python -m lidar_transfer_tpu_torch.experiments.grids full
      [--frames-list 1 2 3 4 5 10 20] [--voxel-sizes 0.25 0.1 0.075 0.05
      0.04] [--frames-per-cell 2] [--n-scans 24] [--work DIR]
      [--dataset DIR] [--out DIR] [--device cuda|cpu]
  python -m lidar_transfer_tpu_torch.experiments.grids multiscene
      [--scenes 3] [--frames-per-cell 1] (and the same flags)

Both sweep the reference's axes, frames [1,2,3,4,5,10,20] x voxel
[0.25,0.1,0.075,0.05,0.04] (experiments/grid_search_nframes_voxelsize.py
:48-49), with the identity mergemesh transfer from offset 0 through
``grid_search``. ``full`` runs one HDL64 64x2048 sequence of
``synthetic.Scene.default()``, two frames a cell; ``multiscene`` runs N
sequences of one tree, sequence ``0i`` from ``synthetic.Scene.urban(i)``,
one frame a cell, and each cell carries the ``_std``, ``_min`` and
``_max`` columns across the sequences. A dataset is written with
``datasets/synthetic.write_kitti_dataset`` only where it is missing
(``--dataset``, default ``<work>/grid_ds64`` or
``<work>/grid_ds64_multiscene``). ``<out>/grid_search.json`` (``--out``
defaults to ``<work>/grid``) holds the JAX grid's keys and ``"device"``:
the card's name and power limit as ``nvidia-smi`` prints them, or
``"cpu"``; the heat maps beside it. Each cell's wall time and peak device
memory are printed. It runs on the card unless ``--device cpu`` is given;
without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

#: the reference's axes
FRAMES = [1, 2, 3, 4, 5, 10, 20]
VOXELS = [0.25, 0.1, 0.075, 0.05, 0.04]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("grids (torch)")
    sub = ap.add_subparsers(dest="grid", required=True)
    for name, per_cell in (("full", 2), ("multiscene", 1)):
        p = sub.add_parser(name)
        p.add_argument("--out", default=None,
                       help="directory of grid_search.json (default "
                            "WORK/grid)")
        p.add_argument("--dataset", default=None,
                       help="KITTI tree, written where missing (default "
                            "under WORK)")
        p.add_argument("--work", default=os.path.join(
            tempfile.gettempdir(), f"grid_{name}"))
        p.add_argument("--device", default="cuda",
                       help="Torch device (default cuda; cpu only when "
                            "asked for).")
        if name == "multiscene":
            p.add_argument("--scenes", type=int, default=3)
        p.add_argument("--frames-list", type=int, nargs="+",
                       default=list(FRAMES))
        p.add_argument("--voxel-sizes", type=float, nargs="+",
                       default=list(VOXELS))
        p.add_argument("--frames-per-cell", type=int, default=per_cell)
        p.add_argument("--n-scans", type=int, default=24)
    return ap


def write_datasets(grid: str, dataset: str, n_scans: int,
                   scenes: int = 1) -> tuple[str, ...]:
    """The HDL64 tree of ``grid`` at ``dataset``, each sequence written
    only where it is missing; -> the sequence names."""
    from lidar_transfer_tpu_torch.config import HDL64
    from lidar_transfer_tpu_torch.datasets import synthetic

    if grid == "full":
        if not os.path.exists(os.path.join(dataset, "config.yaml")):
            print(f"generating {n_scans}-scan 64x2048 dataset at "
                  f"{dataset}", flush=True)
            synthetic.write_kitti_dataset(
                dataset, synthetic.Scene.default(), HDL64, n_scans=n_scans)
        return ("00",)
    sequences = tuple(f"{i:02d}" for i in range(scenes))
    for i, seq in enumerate(sequences):
        marker = os.path.join(dataset, "sequences", seq, "poses.txt")
        if not os.path.exists(marker):
            print(f"generating urban(seed={i}) 64x2048 sequence {seq}",
                  flush=True)
            synthetic.write_kitti_dataset(
                dataset, synthetic.Scene.urban(i), HDL64, n_scans=n_scans,
                sequence=seq)
    return sequences


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: grids (torch) runs on the card (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2

    from lidar_transfer_tpu_torch.experiments.grid_search import (
        grid_search, write_grid)
    from lidar_transfer_tpu_torch.probes.timing import device_line

    dataset = args.dataset or os.path.join(
        args.work, "grid_ds64" if args.grid == "full"
        else "grid_ds64_multiscene")
    out = args.out or os.path.join(args.work, "grid")
    sequences = write_datasets(args.grid, dataset, args.n_scans,
                               getattr(args, "scenes", 1))
    t0 = time.time()
    res = grid_search(dataset, frames_list=args.frames_list,
                      voxel_sizes=args.voxel_sizes,
                      frames_per_cell=args.frames_per_cell,
                      sequences=sequences, offset=0, adaption="mergemesh",
                      verbose=True, device=device)
    res["device"] = device_line(device)
    write_grid(res, out)
    print(f"wrote {out}/grid_search.json ({len(res['cells'])} cells x "
          f"{len(sequences)} sequences in {time.time() - t0:.0f} s, "
          f"{res['device']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
