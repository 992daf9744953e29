"""python -m lidar_transfer_tpu_torch.probes [parts|ablate|alias|write|all]

Runs the probes on the card at 1024x1024x256 and prints one line a row:
the kernel's milliseconds (CUDA events, the mean over --iters launches),
Gvoxel/s or GB/s, its plain version's time, and the card's name and power
limit. Without a CUDA device it exits with 1.
"""

from __future__ import annotations

import argparse
import sys

import torch

from lidar_transfer_tpu_torch.probes import PROBES, run
from lidar_transfer_tpu_torch.probes.timing import gpu_line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("python -m lidar_transfer_tpu_torch.probes")
    ap.add_argument("which", nargs="?", default="all",
                    choices=(*PROBES, "all"))
    ap.add_argument("--iters", type=int, default=50,
                    help="launches a kernel time is the mean of")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the probes run on a CUDA device; none is available",
              file=sys.stderr)
        return 1
    gpu = gpu_line()
    print(gpu, flush=True)
    run(PROBES if args.which == "all" else (args.which,), iters=args.iters,
        tag=f"[{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
