"""Multi-scene workflow rows: mean ± spread over seeded urban scenes.

The port's counterpart of ``scripts/run_workflow_multiscene.py``:

  python -m lidar_transfer_tpu_torch.experiments.multiscene [--scenes 3]
      [--steps 300] [--rows fake_on_real,...] [--work DIR] [--out DIR]
      [--device cuda|cpu]

It runs the three cross-geometry workflow rows (the reference paper's
train-on-fake/deploy-on-real claim) once per seeded
``synthetic.Scene.urban(i)`` scene and reports each metric as mean ± std
over the scenes. Each scene is its own sequence ``0i`` of one 64-beam
dataset tree, with its own transfer, training and evaluation through
``experiments/workflows.run_workflow`` (nothing is pooled across scenes).
It writes ``<out>/<row>.json`` (``--out`` defaults to ``<work>/rows``)
with the per-scene rows and the aggregate, the keys of the original's
JSONs; ``"backend"`` is the name of the device that ran it. It runs on the
card unless ``--device cpu`` is given; without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROWS = (
    ("fake_on_real", "fake_on_real", "hdl32"),
    ("real_on_fake_identity", "real_on_fake", None),
    ("real_on_fake", "real_on_fake", "hdl32"),
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("multiscene (torch)")
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--bounds", type=float, default=80.0,
                    help="scene-covering volume bounds (+-m in x and y)")
    ap.add_argument("--rows", default=None,
                    help="comma list of row names to run (default all)")
    ap.add_argument("--work",
                    default=os.path.join(tempfile.gettempdir(),
                                         "wf_multiscene"))
    ap.add_argument("--out", default=None,
                    help="directory of the row JSONs (default WORK/rows)")
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default cuda; cpu only when asked "
                         "for).")
    return ap


def aggregate(per_scene: list[dict]) -> dict:
    """Mean, std, min and max of miou, miou_present and acc over the
    scenes."""
    agg = {}
    for key in ("miou", "miou_present", "acc"):
        vals = [r[key] for r in per_scene if key in r]
        if vals:
            agg[key] = float(np.mean(vals))
            agg[key + "_std"] = float(np.std(vals))
            agg[key + "_min"] = float(np.min(vals))
            agg[key + "_max"] = float(np.max(vals))
    return agg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch
    import yaml

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: multiscene (torch) runs on the card (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2

    from lidar_transfer_tpu_torch.config import (HDL32, SensorSpec,
                                                 TransferConfig)
    from lidar_transfer_tpu_torch.datasets import synthetic
    from lidar_transfer_tpu_torch.experiments.workflows import run_workflow

    backend = (torch.cuda.get_device_name(device) if device.type == "cuda"
               else "cpu")
    out_dir = args.out or os.path.join(args.work, "rows")
    spec64 = SensorSpec(name="syn64", beams=64, fov_up=5.0,
                        fov_down=-24.0,
                        angle_res_hor=360.0 / args.width)
    os.makedirs(args.work, exist_ok=True)
    ds64 = os.path.join(args.work, "real64")
    sequences = [f"{i:02d}" for i in range(args.scenes)]
    for i, seq in enumerate(sequences):
        marker = os.path.join(ds64, "sequences", seq, "poses.txt")
        if not os.path.exists(marker):
            print(f"generating urban(seed={i}) sequence {seq}", flush=True)
            synthetic.write_kitti_dataset(
                ds64, synthetic.Scene.urban(i), spec64,
                n_scans=args.frames, step=1.5, sequence=seq)

    b = args.bounds
    cfg = TransferConfig(
        adaption="mergemesh", number_of_scans=1,
        voxel_bounds=((-b, b), (-b, b), (-5.0, 5.0)))
    # the target sensor of the cross-geometry rows (configs/hdl32.yaml)
    hdl32 = os.path.join(args.work, "hdl32.yaml")
    with open(hdl32, "w") as f:
        yaml.safe_dump(HDL32.to_dict(), f)

    only = set(args.rows.split(",")) if args.rows else None
    os.makedirs(out_dir, exist_ok=True)
    for name, kind, target in ROWS:
        if only and name not in only:
            continue
        target_yaml = hdl32 if target == "hdl32" else None
        per_scene = []
        for i, seq in enumerate(sequences):
            print(f"=== {name} scene {i} (seq {seq}) ===", flush=True)
            res = run_workflow(
                kind, ds64, os.path.join(args.work, f"{name}_s{i}"),
                cfg, sequence=seq, target_yaml=target_yaml,
                steps=args.steps, batch_size=args.batch_size,
                device=device)
            res.update(scene_seed=i, sequence=seq)
            per_scene.append(res)
        agg = {"row": name, "kind": kind,
               "target": os.path.basename(target_yaml) if target_yaml
               else None,
               "scenes": args.scenes, "steps": args.steps,
               "backend": backend,
               "bounds": b, "width": args.width,
               "world": "synthetic.Scene.urban (>=12 classes, movers)",
               "per_scene": per_scene}
        agg.update(aggregate(per_scene))
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(agg, f, indent=2)
        print(f"{name}: miou_present {agg['miou_present']:.4f} "
              f"± {agg['miou_present_std']:.4f}  acc {agg['acc']:.4f} "
              f"± {agg['acc_std']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
