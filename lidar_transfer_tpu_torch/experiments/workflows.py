"""End-to-end experiment workflows: fake_on_fake / fake_on_real / real_on_fake.

Counterpart of ``lidar_transfer_tpu/experiments/workflows.py`` (the
``lt-workflow`` command, here ``lt-workflow-torch``), the in-process form of
the reference's shell pipelines (``experiments/run_fake_on_fake.sh``,
``run_fake_on_real.sh``, ``run_real_on_fake.sh``, ``train.sh``): make a
transferred ("fake") dataset with the port's CLI, train RangeNet on one
dataset, infer and evaluate on the other. The first word names the
training data, the second the evaluation data ("fake_on_real" = train on
fake, evaluate on real).
"""

from __future__ import annotations

import os
import shutil
import sys


def generate_fake_dataset(dataset: str, out_root: str, cfg, *,
                          sequence: str = "00",
                          target_yaml: str | None = None,
                          frames: int | None = None,
                          verbose: bool = True, device="cuda") -> str:
    """Run the transfer over a sequence through the port's ``cli.main``
    (``-b -w``) and write a KITTI-format dataset; -> its root, ready for
    training."""
    from lidar_transfer_tpu_torch import cli

    args = ["-d", dataset, "-s", sequence, "-b", "-w", "-p", out_root,
            "--device", str(device)]
    if target_yaml:
        args += ["-t", target_yaml]
    if frames is not None:
        args += ["--frames", str(frames)]
    # start from a clean sequence dir: a reused work dir would mix this
    # run's frames with a previous run's leftovers
    seq_old = os.path.join(out_root, "sequences", sequence)
    if os.path.isdir(seq_old):
        if verbose:
            print(f"clearing previous fake sequence at {seq_old}")
        shutil.rmtree(seq_old)
    cfg_path = os.path.join(out_root, "_tool_config.yaml")
    os.makedirs(out_root, exist_ok=True)
    cfg.to_yaml(cfg_path)
    args += ["-c", cfg_path]
    rc = cli.main(args)
    if rc != 0:
        raise RuntimeError(f"transfer failed with rc={rc}")
    # the fake dataset root needs a config.yaml (the target spec) and the
    # sequence's poses and calibration
    src_cfg = target_yaml or os.path.join(dataset, "config.yaml")
    shutil.copy2(src_cfg, os.path.join(out_root, "config.yaml"))
    seq_dir = os.path.join(out_root, "sequences", sequence)
    for fname in ("calib.txt", "poses.txt"):
        src = os.path.join(dataset, "sequences", sequence, fname)
        if os.path.exists(src):
            shutil.copy2(src, seq_dir)
    if verbose:
        print(f"fake dataset at {out_root}")
    return out_root


def run_workflow(kind: str, real_dataset: str, work_dir: str, cfg, *,
                 sequence: str = "00", target_yaml: str | None = None,
                 frames: int | None = None, steps: int = 50,
                 batch_size: int = 1, model_cfg=None,
                 verbose: bool = True, knn: bool = False,
                 device="cuda") -> dict:
    """Run one of the reference's experiment pipelines end to end.

    kind: 'fake_on_fake' | 'fake_on_real' | 'real_on_fake' | 'real_on_real'
    Returns evaluate_semantics' dict plus bookkeeping.
    """
    from lidar_transfer_tpu_torch.experiments.segmentation import (
        evaluate_semantics, train_segmentation, write_predictions)

    train_kind, eval_kind = kind.split("_on_")
    fake_root = None
    if "fake" in (train_kind, eval_kind):
        fake_root = generate_fake_dataset(
            real_dataset, os.path.join(work_dir, "fake"), cfg,
            sequence=sequence, target_yaml=target_yaml, frames=frames,
            verbose=verbose, device=device)
    train_ds = fake_root if train_kind == "fake" else real_dataset
    eval_ds = fake_root if eval_kind == "fake" else real_dataset

    model, mapper, spec = train_segmentation(
        train_ds, sequences=(sequence,), steps=steps,
        batch_size=batch_size, model_cfg=model_cfg, cfg=cfg,
        verbose=verbose, device=device)
    pred_root = os.path.join(work_dir, f"pred_{kind}")
    write_predictions(eval_ds, pred_root, model, mapper, spec,
                      sequences=(sequence,), verbose=verbose, knn=knn)
    res = evaluate_semantics(eval_ds, pred_root, sequences=(sequence,),
                             cfg=cfg, device=device)
    res.update(kind=kind, train_dataset=train_ds, eval_dataset=eval_ds,
               predictions=pred_root, knn=knn)
    if verbose:
        print(f"{kind}: mIoU {res['miou']:.4f} acc {res['acc']:.4f}")
    return res


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from lidar_transfer_tpu_torch.config import TransferConfig
    from lidar_transfer_tpu_torch.models import RangeNetConfig

    p = argparse.ArgumentParser("lt-workflow-torch")
    p.add_argument("kind", choices=["fake_on_fake", "fake_on_real",
                                    "real_on_fake", "real_on_real"])
    p.add_argument("--dataset", "-d", required=True,
                   help="Real dataset root.")
    p.add_argument("--work-dir", "-w", default="workflow_out/")
    p.add_argument("--sequence", "-s", default="00")
    p.add_argument("--target", "-t", default=None)
    p.add_argument("--config", "-c", default=None)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--knn", action="store_true",
                   help="RangeNet++ kNN per-point cleanup at inference.")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; cpu only when asked "
                        "for).")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("no CUDA device: lt-workflow-torch runs on the card (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2

    cfg = (TransferConfig.from_yaml(args.config) if args.config
           else TransferConfig())
    model_cfg = None
    if args.tiny:
        from lidar_transfer_tpu_torch.experiments.segmentation import (
            LabelMapper)
        mapper = LabelMapper.from_labels(dict(cfg.labels))
        model_cfg = RangeNetConfig.tiny(num_classes=mapper.num_classes)
    res = run_workflow(args.kind, args.dataset, args.work_dir, cfg,
                       sequence=args.sequence, target_yaml=args.target,
                       frames=args.frames, steps=args.steps,
                       batch_size=args.batch_size, model_cfg=model_cfg,
                       knn=args.knn, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
