"""The upsampling workflow: train on upsampled fake scans, evaluate on true.

The port's counterpart of ``scripts/run_upsample_workflow.py``:

  python -m lidar_transfer_tpu_torch.experiments.upsample [--steps 300]
      [--batch-size 2] [--frames 12] [--width 512] [--src-beams 32]
      [--tgt-beams 64] [--bounds 80] [--urban-scenes 0] [--work DIR]
      [--out DIR] [--device cuda|cpu]

The paper's use case in the upsampling direction: a user has labelled
32-beam scans and wants a 64-beam segmentation model without labelling
64-beam scans. On one world it writes

  A  a "real" ``--src-beams`` x W synthetic dataset (labelled),
  B  the true ``--tgt-beams`` x W dataset of the same world and poses,
  F  the fake ``--tgt-beams`` dataset: A transferred to B's sensor by
     ``workflows.generate_fake_dataset`` (mergemesh, voxel 0.1 m,
     +-``--bounds`` m; the rows between A's beams filled by the splat's
     chords),

and trains darknet21 (``train_segmentation``), predicts
(``write_predictions``) and scores (``evaluate_semantics``) three rows,
in this order: ``fake64_on_real64`` (train on F, evaluate on B: the
experiment), ``real32_on_real64`` (train on A, evaluate on B: no
transfer) and ``real64_on_fake64`` (train on B, evaluate on F: whether
the chords look like real beams), named by the beam counts. ``--src-beams
16 --tgt-beams 64`` is the 4x shape. ``--urban-scenes N`` runs the
workflow once per seeded ``synthetic.Scene.urban(i)`` world and writes
each row as mean, std, min and max over the worlds
(``multiscene.aggregate``), with ``"backend"`` the card's name; 0 runs
``Scene.default()`` once. It writes ``<out>/<row>.json`` (``--out``
defaults to ``<work>/rows``) with the keys of the original's JSONs, and
runs on the card unless ``--device cpu`` is given; without a CUDA device
it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("upsample (torch)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--src-beams", type=int, default=32)
    ap.add_argument("--tgt-beams", type=int, default=64,
                    help="target beam count (64 for the 2x rows, or "
                         "--src-beams 16 --tgt-beams 64 for the 4x shape)")
    ap.add_argument("--bounds", type=float, default=80.0,
                    help="voxel half-extent (m); must cover the scene: "
                         "the fake scans hold only in-volume returns")
    ap.add_argument("--urban-scenes", type=int, default=0,
                    help="N > 0: run once per synthetic.Scene.urban(i), "
                         "i < N, and aggregate each row over the worlds; "
                         "0: one Scene.default() run")
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                   "wf_upsample"))
    ap.add_argument("--out", default=None,
                    help="directory of the row JSONs (default WORK/rows)")
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default cuda; cpu only when asked "
                         "for).")
    return ap


def sensors(args):
    """-> (the source spec, the target spec) of the workflow."""
    from lidar_transfer_tpu_torch.config import SensorSpec

    res_hor = 360.0 / args.width
    return tuple(SensorSpec(name=f"syn{b}", beams=b, fov_up=5.0,
                            fov_down=-24.0, angle_res_hor=res_hor)
                 for b in (args.src_beams, args.tgt_beams))


def transfer_config(bounds: float):
    """The workflow's transfer: mergemesh, one scan, voxel 0.1 m."""
    from lidar_transfer_tpu_torch.config import TransferConfig

    return TransferConfig(
        adaption="mergemesh", number_of_scans=1, voxel_size=0.1,
        voxel_bounds=((-bounds, bounds), (-bounds, bounds), (-4.0, 4.0)))


def one_scene(args, scene, work: str, device) -> dict:
    """All three rows (training and evaluation) on one world; -> {row
    name: evaluate_semantics' dict with the bookkeeping}."""
    import yaml

    from lidar_transfer_tpu_torch.datasets import synthetic
    from lidar_transfer_tpu_torch.experiments.segmentation import (
        evaluate_semantics, train_segmentation, write_predictions)
    from lidar_transfer_tpu_torch.experiments.workflows import (
        generate_fake_dataset)

    spec_s, spec_t = sensors(args)
    s, t = args.src_beams, args.tgt_beams
    cfg = transfer_config(args.bounds)
    os.makedirs(work, exist_ok=True)
    ds_s = os.path.join(work, f"real{s}")
    ds_t = os.path.join(work, f"real{t}")
    synthetic.write_kitti_dataset(ds_s, scene, spec_s, n_scans=args.frames,
                                  step=1.0)
    synthetic.write_kitti_dataset(ds_t, scene, spec_t, n_scans=args.frames,
                                  step=1.0)
    tgt_yaml = os.path.join(work, f"target{t}.yaml")
    with open(tgt_yaml, "w") as f:
        yaml.safe_dump(spec_t.to_dict(), f)
    fake = generate_fake_dataset(ds_s, os.path.join(work, f"fake{t}"), cfg,
                                 target_yaml=tgt_yaml, device=device)
    rows = {}
    for name, train_ds, eval_ds in ((f"fake{t}_on_real{t}", fake, ds_t),
                                    (f"real{s}_on_real{t}", ds_s, ds_t),
                                    (f"real{t}_on_fake{t}", ds_t, fake)):
        model, mapper, spec = train_segmentation(
            train_ds, steps=args.steps, batch_size=args.batch_size,
            cfg=cfg, device=device)
        pred = os.path.join(work, f"pred_{name}")
        write_predictions(eval_ds, pred, model, mapper, spec)
        r = evaluate_semantics(eval_ds, pred, cfg=cfg, device=device)
        r.update(kind=name, train_dataset=train_ds, eval_dataset=eval_ds,
                 steps=args.steps, bounds=args.bounds)
        rows[name] = r
        print(f"{name}: miou_present {r['miou_present']:.4f} "
              f"acc {r['acc']:.4f}", flush=True)
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: upsample (torch) runs on the card (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2

    from lidar_transfer_tpu_torch.datasets import synthetic
    from lidar_transfer_tpu_torch.experiments.multiscene import aggregate

    out_dir = args.out or os.path.join(args.work, "rows")
    os.makedirs(out_dir, exist_ok=True)
    if not args.urban_scenes:
        rows = one_scene(args, synthetic.Scene.default(), args.work, device)
        for name, r in rows.items():
            with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                json.dump(r, f, indent=2)
        return 0

    backend = (torch.cuda.get_device_name(device) if device.type == "cuda"
               else "cpu")
    per_scene = []
    for i in range(args.urban_scenes):
        print(f"=== urban scene seed {i} ===", flush=True)
        rows = one_scene(args, synthetic.Scene.urban(i),
                         os.path.join(args.work, f"s{i}"), device)
        for r in rows.values():
            r.update(scene_seed=i)
        per_scene.append(rows)
    for name in per_scene[0]:
        agg = {"row": name, "scenes": args.urban_scenes,
               "steps": args.steps, "backend": backend,
               "bounds": args.bounds, "width": args.width,
               "src_beams": args.src_beams, "tgt_beams": args.tgt_beams,
               "world": "synthetic.Scene.urban (>=12 classes, movers)",
               "per_scene": [sc[name] for sc in per_scene]}
        agg.update(aggregate(agg["per_scene"]))
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(agg, f, indent=2)
        print(f"{name}: miou_present {agg['miou_present']:.4f} "
              f"± {agg['miou_present_std']:.4f}  acc {agg['acc']:.4f} "
              f"± {agg['acc_std']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
