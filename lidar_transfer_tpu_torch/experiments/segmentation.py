"""Segmentation harness: train / infer / eval on KITTI datasets, with
RangeNet on range images or Point Transformer V3 on the points.

Counterpart of ``lidar_transfer_tpu/experiments/segmentation.py`` (the
``lt-seg`` command, here ``lt-seg-torch``), in place of the reference's
external chain: its ``experiments/train.sh`` shells out to lidar-bonnetal's
train.py/infer.py and ``run_fake_on_fake.sh`` to semantic-kitti-api's
evaluate_semantics.py.

  train_segmentation  range-project scans (the z-buffer kernel) -> 5-channel
                      features -> RangeNet (bf16 convolutions) with masked
                      CE and Adam, on one card, or data-parallel over the
                      ranks of a process group (``torchrun``).
  write_predictions   per-scan argmax -> raw ids per point (optionally the
                      kNN cleanup) -> .label files in semantic-kitti's
                      predictions layout.
  evaluate_semantics  point-wise confusion (the confusion kernel) over
                      (prediction, ground truth) label files -> mIoU / acc.

With ``model_cfg`` a ``models.ptv3.PTv3Config`` (``lt-seg-torch --arch
ptv3``) the same entry points take the point branch: each scan's points
``[x, y, z, remission]`` and labels go to the card whole
(``_point_tensors``), the step grid-samples them there, and each point is
predicted its 0.05 m cell's class; there is no range image and no kNN.

Raw SemanticKITTI ids map to dense train indices through ``LabelMapper``
(built from the config's ``labels`` block). Moving classes fold onto their
static counterparts (252 -> 10 and so on, as bonnetal's learning_map), and
ignore classes get weight 0 in the loss and leave the IoU mean.

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU; without a CUDA device it raises. The loader's spans
(``utils/runtime``): ``loader.upload`` a copy to the device,
``loader.project`` and ``loader.labels``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from lidar_transfer_tpu_torch.utils.runtime import span, upload

# moving -> static folds (SemanticKITTI convention)
MOVING_TO_STATIC = {252: 10, 253: 31, 254: 30, 255: 32, 256: 16, 257: 13,
                    258: 18, 259: 20}


@dataclasses.dataclass(frozen=True)
class LabelMapper:
    """Bijective-ish map raw label ids <-> dense train indices."""

    raw_ids: tuple[int, ...]          # index -> raw id (train classes)
    raw_to_index: np.ndarray          # (max_raw+1,) raw id -> index
    ignore_indices: tuple[int, ...]   # train indices excluded from loss/IoU

    @classmethod
    def from_labels(cls, labels: dict[int, str],
                    ignore_classes=(0, 1)) -> "LabelMapper":
        static_ids = sorted(k for k in labels
                            if k not in MOVING_TO_STATIC)
        max_raw = max(labels) + 1
        raw_to_index = np.zeros((max_raw,), np.int32)
        for idx, raw in enumerate(static_ids):
            raw_to_index[raw] = idx
        for moving, static in MOVING_TO_STATIC.items():
            if moving < max_raw and static in static_ids:
                raw_to_index[moving] = static_ids.index(static)
        ignore_idx = tuple(static_ids.index(c) for c in ignore_classes
                           if c in static_ids)
        return cls(raw_ids=tuple(static_ids), raw_to_index=raw_to_index,
                   ignore_indices=ignore_idx)

    @property
    def num_classes(self) -> int:
        return len(self.raw_ids)

    def to_index(self, raw: np.ndarray) -> np.ndarray:
        raw = np.clip(raw, 0, self.raw_to_index.shape[0] - 1)
        return self.raw_to_index[raw]

    def to_raw(self, index: np.ndarray) -> np.ndarray:
        lut = np.asarray(self.raw_ids, np.int32)
        return lut[np.clip(index, 0, self.num_classes - 1)]


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the segmentation harness runs "
                           "on the card (pass device='cpu' / --device cpu "
                           "to run on the CPU)")
    return device


def _project(points, remissions, labels, spec, capacity, device):
    """One scan, padded to ``capacity`` and projected on ``device`` ->
    (RangeImage, the 5-channel features (H, W, 5))."""
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.models.rangenet import range_image_features
    from lidar_transfer_tpu_torch.ops import projection as P

    p, r, l, m = (upload(a, device) for a in
                  kitti.pad_points(points, remissions, labels, capacity))
    with span("loader.project"):
        ri = P.range_project(p, r, l, m, H=spec.H, W=spec.W,
                             fov_up_deg=spec.fov_up,
                             fov_down_deg=spec.fov_down)
        xyz = torch.where(ri.mask[..., None],
                          p[torch.clamp(ri.index, min=0).long()], 0.0)
        return ri, range_image_features(ri.range, xyz, ri.remission, ri.mask)


def _frame_tensors(seq, idx, spec, capacity, mapper, device):
    """One scan -> (features (H,W,5), labels (H,W) index, weights (H,W)),
    all three on ``device``: the uploads are the padded points and the
    label table."""
    ri, feats = _project(*seq.read(idx), spec, capacity, device)
    lut = upload(mapper.raw_to_index, device)  # <= 260 entries
    with span("loader.labels"):
        lbl_idx = lut[torch.clamp(ri.label, 0, lut.shape[0] - 1).long()]
        weights = ri.mask.to(torch.float32)
        for ig in mapper.ignore_indices:
            weights = torch.where(lbl_idx == ig, 0.0, weights)
    return feats, lbl_idx, weights


def _point_tensors(seq, idx, mapper, device):
    """One scan's points for the point branch -> (points (n, 4) float32
    ``[x, y, z, remission]``, labels (n,) int64 class indices with -1 for
    the ignored classes), both on ``device``: two uploads and the label
    table."""
    pts, rem, lab = seq.read(idx)
    p = upload(np.concatenate([pts, rem[:, None]], 1).astype(np.float32),
               device)
    raw = upload(lab.astype(np.int32), device)
    lut = mapper.raw_to_index.astype(np.int64)
    lut[np.isin(lut, mapper.ignore_indices)] = -1
    lut = upload(lut, device)
    with span("loader.labels"):
        return p, lut[torch.clamp(raw, 0, lut.shape[0] - 1).long()]


def save_checkpoint(path: str, model, mapper, spec, *, optimizer=None,
                    step: int | None = None,
                    sampling: dict | None = None) -> None:
    """Write a model bundle (``torch.save`` of the state dicts, the mapper,
    the sensor spec and the model config), readable by ``load_checkpoint``
    and ``lt-seg-torch infer``. ``optimizer``/``step``, when given, make it
    resumable (``train_segmentation(resume=True)``)."""
    blob = {"model_state": {k: v.detach().cpu()
                            for k, v in model.state_dict().items()},
            "mapper": mapper, "spec": spec, "model_cfg": model.cfg}
    if optimizer is not None:
        blob["optimizer"] = optimizer.state_dict()
        blob["step"] = step
        if sampling is not None:
            blob["sampling"] = sampling
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def _read_checkpoint(path: str, device) -> dict:
    # weights_only=False: the bundle holds this package's dataclasses (the
    # config, mapper and spec), which the safe loader refuses; the file is
    # one that save_checkpoint wrote
    return torch.load(path, map_location=device, weights_only=False)


def load_checkpoint(path: str, device="cuda"):
    """-> (model on ``device``, mapper, spec)."""
    from lidar_transfer_tpu_torch.models import RangeNet
    from lidar_transfer_tpu_torch.models.ptv3 import PTv3, PTv3Config

    device = _device(device)
    blob = _read_checkpoint(path, device)
    net = PTv3 if isinstance(blob["model_cfg"], PTv3Config) else RangeNet
    model = net(blob["model_cfg"]).to(device)
    model.load_state_dict(blob["model_state"])
    return model, blob["mapper"], blob["spec"]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step`` of a run seeded ``seed``: the
    point branch's cell picks, order shuffles and drop path."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (1 << 63))


def train_segmentation(dataset: str, *, sequences=("00",), steps: int = 100,
                       batch_size: int = 1, learning_rate: float = 1e-3,
                       model_cfg=None, cfg=None, seed: int = 0,
                       width: int | None = None, verbose: bool = True,
                       use_mesh: bool = True, checkpoint_path=None,
                       checkpoint_every: int = 0, resume: bool = False,
                       device="cuda"):
    """Train RangeNet (or PT-v3m1) on a KITTI-format dataset. Returns
    (model, mapper, spec). ``checkpoint_every`` > 0 writes
    ``checkpoint_path`` every N steps; ``resume=True`` continues a killed
    run from that checkpoint (parameters, optimizer state, step, and the
    same sampling stream replayed).

    ``use_mesh`` under a process group of more than one rank whose count
    divides ``batch_size``: every rank draws the same sampling stream,
    takes its slice of each global batch and steps through
    ``parallel.sharded_train_step`` (DDP over a model-1 mesh); rank 0 alone
    prints and writes the checkpoint (the model's own state, no
    ``module.`` prefix), and every rank waits for it. Otherwise each
    process trains the whole batch on its own device.

    ``model_cfg`` a ``PTv3Config``: Point Transformer V3 on the points
    (``_point_tensors``, ``models.ptv3.train_step`` with AdamW at the
    configuration's rates, ``learning_rate`` and ``width`` unused); step
    ``k`` draws its cell picks, order shuffles and drop path from
    ``step_generator(seed, k)``. It takes no mesh: under a process group
    of more than one rank with ``use_mesh`` it raises.
    """
    import torch.distributed as dist

    from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.models import (RangeNet, RangeNetConfig,
                                                 make_train_state,
                                                 train_step)
    from lidar_transfer_tpu_torch.models import ptv3
    from lidar_transfer_tpu_torch.utils.prefetch import Prefetcher

    device = _device(device)
    points = isinstance(model_cfg, ptv3.PTv3Config)
    grouped = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped and use_mesh else 1
    if points and world > 1:
        raise ValueError("PT-v3m1 trains in one process; data-parallel "
                         "training is RangeNet's")
    verbose = verbose and rank == 0
    cfg = cfg or TransferConfig()
    spec = SensorSpec.from_yaml(os.path.join(dataset, "config.yaml"))
    if width is not None:
        # fov_hor/width can float-round DOWN through SensorSpec.W's int();
        # aiming the ratio at width+0.5 makes the truncation give `width`
        spec = dataclasses.replace(
            spec, angle_res_hor=spec.fov_hor / (width + 0.5))
    mapper = LabelMapper.from_labels(dict(cfg.labels),
                                     ignore_classes=cfg.ignore_classes)
    if points:
        model_cfg = dataclasses.replace(model_cfg,
                                        num_classes=mapper.num_classes)
        model = ptv3.PTv3(model_cfg)
        model.init_parameters(torch.Generator().manual_seed(seed))
        model.to(device)
        optimizer = ptv3.make_optimizer(model)
    else:
        model_cfg = model_cfg or RangeNetConfig.darknet21(
            num_classes=mapper.num_classes)
        model = RangeNet(model_cfg).to(device)
        optimizer = make_train_state(
            model, torch.Generator().manual_seed(seed), learning_rate)

    seqs = [kitti.KittiSequence.open(dataset, s) for s in sequences]
    capacity = kitti.scan_capacity(max(
        os.path.getsize(f) // 16 for sq in seqs for f in sq.scan_files))
    sampling = {"seed": seed, "batch_size": batch_size,
                "sequences": tuple(sequences), "dataset": dataset}

    start_step = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        blob = _read_checkpoint(checkpoint_path, device)
        if "optimizer" not in blob:
            raise ValueError(
                f"{checkpoint_path} has no optimizer state (opt_state): it "
                "is not resumable (re-save with checkpoint_every>0)")
        if blob["model_cfg"] != model_cfg:
            raise ValueError(
                f"{checkpoint_path} was trained with a different model "
                f"config ({blob['model_cfg']} != {model_cfg})")
        # the replay is exact only when the rng stream is consumed the
        # same way: seed, batch size and the frame list must all match
        have = blob.get("sampling")
        if have is not None and have != sampling:
            raise ValueError(
                f"{checkpoint_path} was trained with different sampling "
                f"parameters ({have} != {sampling}): resuming would replay "
                "a divergent batch stream")
        model.load_state_dict(blob["model_state"])
        optimizer.load_state_dict(blob["optimizer"])
        start_step = int(blob["step"])
        if verbose:
            print(f"resuming from {checkpoint_path} at step {start_step}")

    mesh = None
    if world > 1 and batch_size % world == 0:
        from lidar_transfer_tpu_torch.parallel import (make_mesh,
                                                       sharded_train_step)

        # model=1: the batch alone is split (no shard_params_tp here)
        mesh = make_mesh(model=1)
        sharded = sharded_train_step(model, optimizer, mesh)
        lo, hi = rank * batch_size // world, (rank + 1) * batch_size // world

        def step_fn(step, batch):
            return sharded(batch)
    elif points:
        def step_fn(step, batch):
            return ptv3.train_step(model, optimizer, batch,
                                   step_generator(seed, step, device))
        lo, hi = 0, batch_size
    else:
        def step_fn(step, batch):
            return train_step(model, optimizer, batch)
        lo, hi = 0, batch_size

    def save(step):
        if rank == 0:
            save_checkpoint(checkpoint_path, model, mapper, spec,
                            optimizer=optimizer, step=step,
                            sampling=sampling)
        if mesh is not None:
            dist.barrier(group=mesh.get_group("data"))

    rng = np.random.default_rng(seed)
    all_frames = [(si, fi) for si, sq in enumerate(seqs)
                  for fi in range(len(sq))]
    # replay the sampling stream up to start_step, so a resumed run draws
    # the batches the uninterrupted run would have; then draw every
    # remaining pick up front, so the batches can be prefetched
    for _ in range(start_step):
        rng.choice(len(all_frames), size=batch_size, replace=True)
    step_picks = [rng.choice(len(all_frames), size=batch_size,
                             replace=True)
                  for _ in range(start_step, steps)]

    def load_batch(step):
        picked = [all_frames[k] for k in step_picks[step - start_step][lo:hi]]
        if points:
            p, l = zip(*(_point_tensors(seqs[si], fi, mapper, device)
                         for si, fi in picked))
            return dict(points=torch.cat(p), labels=torch.cat(l),
                        counts=[t.shape[0] for t in p])
        f, l, w = zip(*(_frame_tensors(seqs[si], fi, spec, capacity, mapper,
                                       device) for si, fi in picked))
        return dict(features=torch.stack(f), labels=torch.stack(l),
                    weights=torch.stack(w))

    with Prefetcher(load_batch, range(start_step, steps)) as batches:
        for step, batch in batches:
            # the loss stays on the device; reading it waits for the step
            loss = step_fn(step, batch)
            if verbose and (step % 10 == 0 or step == steps - 1):
                print(f"step {step}: loss {float(loss):.4f}")
            if (checkpoint_path and checkpoint_every
                    and (step + 1) % checkpoint_every == 0):
                save(step + 1)
    if checkpoint_path:
        # the final state, resumable (a finished run can be extended with
        # a larger ``steps`` and ``resume=True``)
        save(max(steps, start_step))
    return model, mapper, spec


def write_predictions(dataset: str, out_root: str, model, mapper, spec, *,
                      sequences=("00",), verbose: bool = True,
                      batch: int = 8, knn: bool = False, knn_k: int = 5,
                      knn_ksize: int = 5, knn_cutoff: float = 1.0) -> int:
    """Run inference over sequences on the model's device; write the
    semantic-kitti predictions tree (``<out_root>/sequences/<s>/
    predictions/<i>.label``, uint32 raw ids, one per point).

    Each point gets the class of its range-image pixel; with ``knn=True``
    RangeNet++'s kNN cleanup refines it (``models/postproc.py``). A
    PT-v3m1 ``model`` gives each point its 0.05 m cell's class
    (``models.ptv3.predict``; ``knn`` is refused). Scan
    reads are prefetched, and the results come to the host as one stacked
    array per ``batch`` frames. Returns the number of scans written.
    """
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.models.postproc import knn_cleanup
    from lidar_transfer_tpu_torch.models import ptv3
    from lidar_transfer_tpu_torch.models.rangenet import infer
    from lidar_transfer_tpu_torch.utils.prefetch import Prefetcher

    points = isinstance(model, ptv3.PTv3)
    if points and knn:
        raise ValueError("the kNN cleanup needs a range image; PT-v3m1 "
                         "predicts each point by its cell")
    device = next(model.parameters()).device
    raw_lut = torch.tensor(mapper.raw_ids, dtype=torch.int32, device=device)
    n = 0
    for s in sequences:
        seq = kitti.KittiSequence.open(dataset, s, require_labels=False)
        capacity = kitti.scan_capacity(max(
            os.path.getsize(f) // 16 for f in seq.scan_files))
        pred_dir = os.path.join(out_root, "sequences", s, "predictions")
        os.makedirs(pred_dir, exist_ok=True)

        def dispatch(idx):
            """-> ((capacity,) raw-id predictions on the device, the
            scan's point count)."""
            pts, rem = kitti.read_scan_file(seq.scan_files[idx])
            if points:
                p = upload(np.concatenate([pts, rem[:, None]], 1)
                           .astype(np.float32), device)
                pred = ptv3.predict(model, p, [pts.shape[0]])
                raw = torch.zeros(capacity, dtype=torch.int32, device=device)
                raw[:pts.shape[0]] = raw_lut[pred]
                return raw, pts.shape[0]
            ri, feats = _project(pts, rem, np.zeros(pts.shape[0], np.int32),
                                 spec, capacity, device)
            pred_img = infer(model, feats[None])[0]
            if knn:
                pred_pts = knn_cleanup(
                    ri.range, pred_img, ri.mask, ri.point_depth,
                    ri.point_u, ri.point_v, ri.point_valid,
                    num_classes=mapper.num_classes, k=knn_k,
                    ksize=knn_ksize, cutoff=knn_cutoff)
            else:
                # each point through its pixel (padded entries take pixel
                # 0 and are cut off at write time)
                flat = (torch.clamp(ri.point_v, 0, spec.H - 1) * spec.W
                        + torch.clamp(ri.point_u, 0, spec.W - 1))
                pred_pts = pred_img.reshape(-1)[flat.long()]
            raw = raw_lut[torch.clamp(pred_pts, 0,
                                      mapper.num_classes - 1).long()]
            return raw, pts.shape[0]

        def flush(pending):
            raws = torch.stack([r for r, _, _ in pending]).cpu().numpy()
            for (_, npts, idx), row in zip(pending, raws):
                row[:npts].astype(np.uint32).tofile(
                    os.path.join(pred_dir, f"{idx:06d}.label"))

        pending = []
        with Prefetcher(dispatch, range(len(seq))) as frames:
            for idx, (raw, npts) in frames:
                pending.append((raw, npts, idx))
                n += 1
                if len(pending) >= batch:
                    flush(pending)
                    pending = []
        if pending:
            flush(pending)
        if verbose:
            print(f"sequence {s}: {len(seq)} predictions written")
    return n


def evaluate_semantics(dataset: str, predictions: str, *,
                       sequences=("00",), cfg=None, device="cuda") -> dict:
    """Point-wise mIoU/acc of predictions against the ground-truth labels,
    as semantic-kitti-api's evaluate_semantics.py computes them: one
    confusion over all points of all scans (the port's ``IoUEval``, whose
    counts run on ``device``), ignore classes out of the mean."""
    from lidar_transfer_tpu_torch.config import TransferConfig
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.metrics.ioueval import IoUEval

    device = _device(device)
    cfg = cfg or TransferConfig()
    mapper = LabelMapper.from_labels(dict(cfg.labels),
                                     ignore_classes=cfg.ignore_classes)
    ev = IoUEval(mapper.num_classes, ignore=list(mapper.ignore_indices))
    n_scans = 0
    for s in sequences:
        seq = kitti.KittiSequence.open(dataset, s)
        pred_dir = os.path.join(predictions, "sequences", s, "predictions")
        for idx in range(len(seq)):
            _, _, gt = seq.read(idx)
            pred = kitti.read_label_file(
                os.path.join(pred_dir, f"{idx:06d}.label"), gt.shape[0])
            ev.add_batch(torch.from_numpy(mapper.to_index(pred)).to(device),
                         torch.from_numpy(mapper.to_index(gt)).to(device))
            n_scans += 1
    miou, per_class = ev.get_iou()
    acc = ev.get_acc()
    per = {mapper.raw_ids[i]: float(per_class[i])
           for i in range(mapper.num_classes)
           if i not in mapper.ignore_indices}
    # classes with no ground-truth point drag ``miou`` toward 0 on data
    # that exercises a subset of the label space (as semantic-kitti-api's
    # mean does); ``miou_present`` averages the classes that occur
    gt_counts = ev.conf.sum(axis=0)
    present = [i for i in range(mapper.num_classes)
               if i not in mapper.ignore_indices and gt_counts[i] > 0]
    miou_present = (float(np.mean([float(per_class[i]) for i in present]))
                    if present else 0.0)
    return {"miou": float(miou), "miou_present": miou_present,
            "acc": float(acc), "scans": n_scans, "iou_per_class": per}


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser("lt-seg-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train")
    pt.add_argument("--dataset", "-d", required=True)
    pt.add_argument("--sequences", "-s", nargs="+", default=["00"])
    pt.add_argument("--steps", type=int, default=100)
    pt.add_argument("--batch-size", type=int, default=1)
    pt.add_argument("--lr", type=float, default=1e-3,
                    help="Adam's learning rate (RangeNet; ptv3 takes "
                         "PT-v3m1's AdamW rates, 0.002 and 0.0002 for the "
                         "blocks).")
    pt.add_argument("--arch", default="darknet21",
                    choices=["darknet53", "darknet21", "tiny", "ptv3"],
                    help="Network: a RangeNet on range images (darknet53 "
                         "= bonnetal's published shape; darknet21 default; "
                         "tiny = smoke), or ptv3, Point Transformer V3 "
                         "(Pointcept's PT-v3m1 SemanticKITTI base) on each "
                         "scan's points [x, y, z, remission], grid-sampled "
                         "at 0.05 m on the card, each point predicted its "
                         "cell's class (no range image, no kNN; one "
                         "process).")
    pt.add_argument("--tiny", action="store_true",
                    help="Alias for --arch tiny (tests/smoke); with "
                         "--arch ptv3, PT-v3m1's two-scale smoke shape.")
    pt.add_argument("--remat", action="store_true",
                    help="Recompute the encoder's blocks in the backward "
                         "(less activation memory, more compute; "
                         "checkpoint-compatible either way).")
    pt.add_argument("--out", default="seg_model.pt")
    pt.add_argument("--save-every", type=int, default=0,
                    help="Checkpoint --out every N steps (resumable).")
    pt.add_argument("--resume", action="store_true",
                    help="Continue a killed run from --out's checkpoint.")

    pi = sub.add_parser("infer")
    pi.add_argument("--dataset", "-d", required=True)
    pi.add_argument("--sequences", "-s", nargs="+", default=["00"])
    pi.add_argument("--model", "-m", required=True)
    pi.add_argument("--out", "-p", required=True)
    pi.add_argument("--knn", action="store_true",
                    help="RangeNet++ kNN label cleanup per point.")
    pi.add_argument("--knn-k", type=int, default=5)
    pi.add_argument("--knn-ksize", type=int, default=5)
    pi.add_argument("--knn-cutoff", type=float, default=1.0)

    pe = sub.add_parser("eval")
    pe.add_argument("--dataset", "-d", required=True)
    pe.add_argument("--sequences", "-s", nargs="+", default=["00"])
    pe.add_argument("--predictions", "-p", required=True)
    pe.add_argument("--json", default=None)
    for q in (pt, pi, pe):
        q.add_argument("--device", default="cuda",
                       help="Torch device (default cuda; cpu only when "
                            "asked for).")

    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("no CUDA device: lt-seg-torch runs on the card (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2

    if args.cmd == "train":
        import torch.distributed as dist

        from lidar_transfer_tpu_torch.config import TransferConfig
        from lidar_transfer_tpu_torch.models import RangeNetConfig
        from lidar_transfer_tpu_torch.parallel.multihost import (
            initialize_from_env)

        from lidar_transfer_tpu_torch.models.ptv3 import PTv3Config

        mapper = LabelMapper.from_labels(dict(TransferConfig().labels))
        if args.arch == "ptv3":
            model_cfg = (PTv3Config.tiny if args.tiny else PTv3Config.base)(
                num_classes=mapper.num_classes)
        else:
            model_cfg = getattr(RangeNetConfig,
                                "tiny" if args.tiny else args.arch)(
                num_classes=mapper.num_classes)
        if args.remat and args.arch == "ptv3":
            p.error("--remat recomputes RangeNet's encoder; ptv3 has none")
        if args.remat:
            model_cfg = dataclasses.replace(model_cfg, remat=True)
        # under torchrun: one rank a process, data-parallel steps
        joined = initialize_from_env(args.device)
        device = args.device if joined is None else joined[1]
        rank = 0 if joined is None else dist.get_rank()
        if joined is not None and rank == 0:
            print(f"{dist.get_world_size()} ranks, backend {joined[0]}")
        try:
            train_segmentation(
                args.dataset, sequences=tuple(args.sequences),
                steps=args.steps, batch_size=args.batch_size,
                learning_rate=args.lr, model_cfg=model_cfg,
                checkpoint_path=args.out, checkpoint_every=args.save_every,
                resume=args.resume, device=device)
        finally:
            if joined is not None:
                dist.destroy_process_group()
        if rank == 0:
            print(f"model written to {args.out}")
    elif args.cmd == "infer":
        model, mapper, spec = load_checkpoint(args.model, args.device)
        n = write_predictions(args.dataset, args.out, model, mapper, spec,
                              sequences=tuple(args.sequences),
                              knn=args.knn, knn_k=args.knn_k,
                              knn_ksize=args.knn_ksize,
                              knn_cutoff=args.knn_cutoff)
        print(f"{n} scans inferred")
    else:
        res = evaluate_semantics(args.dataset, args.predictions,
                                 sequences=tuple(args.sequences),
                                 device=args.device)
        print(f"mIoU: {res['miou']:.4f}  Acc: {res['acc']:.4f} "
              f"({res['scans']} scans)")
        if args.json:
            with open(args.json, "w") as f:
                json.dump(res, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
