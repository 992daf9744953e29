"""The segmentation loops: RangeNet training and inference with the kNN
cleanup, on the scans of the cell's sequence.

Training, as ``train_segmentation`` runs it: each step draws ``batch``
scans with replacement, a ``Prefetcher`` of depth 2 reads, projects and
labels them (``experiments/segmentation._frame_tensors``) and the step is
``models.rangenet.train_step`` with Adam. Inference, as
``write_predictions(knn=True)`` dispatches a scan: read and project in the
``Prefetcher``, then ``infer``, ``knn_cleanup`` and the raw ids, brought
to the host in stacks of ``host_stack``; no file is written.

The weights are drawn on the card from the seed in one call and handed to
the port and to the reference alike. Configuration keys: ``sensor``, the
network's shape (``reference/rangenet.leaves``), ``num_classes``,
``labels``, ``moving_to_static``, ``ignore``, ``learning_rate``, ``knn``;
traffic keys: ``loop``, ``scans``, ``pose_step_m``, ``prefetch_depth``,
``trace_periods`` and ``batch``/``checked_steps`` (training) or
``host_stack``/``warmup_scans``/``sample_gap``/``samples`` (inference).
"""

from __future__ import annotations

import itertools
import os
import random
import statistics
import sys
import time

import numpy as np
import torch

from harness import counts, scenes
from harness.common import Spans
from reference import kitti as RK
from reference import rangenet as R


def make_weights(config: dict, seed: int, device) -> torch.Tensor:
    """The network's weights as one flat float32 vector, drawn on
    ``device`` from ``seed``: every convolution kernel from a normal
    truncated at two standard deviations, scaled to variance 1/fan_in
    (flax's ``lecun_normal``), the norms' scales 1, every bias 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = R.leaves(config)
    sizes = torch.tensor([int(np.prod(s)) for _, s, _ in leaves],
                         device=device)
    std = torch.tensor([(1.0 / f) ** 0.5 / .87962566103423978 if f else 0.0
                        for _, _, f in leaves], device=device)
    ones = torch.tensor([float(n.endswith("norm.weight"))
                         for n, _, _ in leaves], device=device)
    flat = torch.empty(int(sizes.sum()), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (flat * torch.repeat_interleave(std, sizes)
            + torch.repeat_interleave(ones, sizes))


def label_lut(config: dict) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """-> (raw id -> class index, class index -> raw id, the ignored
    class indices): the static classes in raw-id order, each moving class
    on its static counterpart."""
    moving = {int(k): v for k, v in config["moving_to_static"].items()}
    static = sorted(k for k in config["labels"] if k not in moving)
    to_index = np.zeros(max(config["labels"]) + 1, np.int32)
    for i, raw in enumerate(static):
        to_index[raw] = i
    for m, s in moving.items():
        if s in static:
            to_index[m] = static.index(s)
    ignore = [static.index(c) for c in config["ignore"] if c in static]
    return to_index, np.asarray(static, np.int32), ignore


class _SegWork:
    """Scans, the port's model with the benchmark's weights, the mapper."""

    period = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 data_dir: str, spans: Spans):
        from lidar_transfer_tpu_torch.config import SensorSpec
        from lidar_transfer_tpu_torch.datasets import kitti
        from lidar_transfer_tpu_torch.experiments.segmentation import (
            LabelMapper)
        from lidar_transfer_tpu_torch.models.rangenet import (RangeNet,
                                                              RangeNetConfig)

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.data_dir, self.spans = device, data_dir, spans
        scenes.write_sequence(data_dir, scenes.Scene.urban(seed),
                              config["sensor"], traffic["scans"],
                              traffic["pose_step_m"], device)
        self.seq = kitti.KittiSequence.open(data_dir)
        self.capacity = kitti.scan_capacity(max(
            os.path.getsize(f) // 16 for f in self.seq.scan_files))
        self.spec = SensorSpec.from_yaml(os.path.join(data_dir,
                                                      "config.yaml"))
        self.mapper = LabelMapper.from_labels(
            {int(k): str(k) for k in config["labels"]},
            ignore_classes=tuple(config["ignore"]))
        if self.mapper.num_classes != config["num_classes"]:
            raise ValueError(f"the labels give {self.mapper.num_classes} "
                             f"classes, the configuration "
                             f"{config['num_classes']}")
        mcfg = RangeNetConfig(
            num_classes=config["num_classes"],
            stage_blocks=tuple(config["stage_blocks"]),
            stage_features=tuple(config["stage_features"]),
            stem_features=config["stem_features"],
            input_channels=config["input_channels"],
            compute_dtype=getattr(torch, config["compute_dtype"]))
        with torch.device("meta"):
            model = RangeNet(mcfg)
        self.model = model.to_empty(device=device)
        self.flat0 = make_weights(config, seed, device)
        named = list(self.model.named_parameters())
        layout = R.leaves(config)
        if [(n, tuple(p.shape)) for n, p in named] != \
                [(n, s) for n, s, _ in layout]:
            raise ValueError("the port's RangeNet parameters differ from "
                             "the configuration's layout")
        with torch.no_grad():
            torch._foreach_copy_(
                list(self.model.parameters()),
                list(R.unflatten(self.flat0, config).values()))
        self.forward_flops = counts.darknet_forward_flops(
            config, self.spec.H, self.spec.W)

    def _prefetch(self, load, start: int, count):
        from lidar_transfer_tpu_torch.utils.prefetch import Prefetcher

        idx = (itertools.count(start) if count is None
               else range(start, start + count))
        return Prefetcher(self.spans.wrap("load", load), idx,
                          depth=self.traffic["prefetch_depth"])

    def _ref_scan(self, i: int, with_labels: bool):
        """Scan ``i`` read, padded and prepared by the reference:
        (features, class indices, weights, range image)."""
        root = self.data_dir
        pts, rem = RK.read_scan(RK.scan_files(root, "velodyne", ".bin")[i])
        lab = (RK.read_labels(RK.scan_files(root, "labels", ".label")[i])
               if with_labels else np.zeros(pts.shape[0], np.int32))
        p, e, lab, m = (torch.from_numpy(a).to(self.device) for a in
                        RK.pad(pts, rem, lab, RK.capacity(root)))
        to_index, _, ignore = label_lut(self.config)
        return R.features(p, e, lab, m, self.config["sensor"],
                          torch.from_numpy(to_index).to(self.device),
                          ignore)

    def release(self) -> None:
        self.model = None


class TrainWork(_SegWork):
    """Closed-loop train steps; the first ``checked_steps`` run in set-up
    through the window's own iterator, on scans that all differ, and are
    what the check follows."""

    span_names = {"loader_wait", "step", "load"}
    #: what ``check`` can put in the program's place
    stand_ins = ("control", "half_batch")

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        from lidar_transfer_tpu_torch.experiments.segmentation import (
            _frame_tensors)

        tr, B = self.traffic, self.traffic["batch"]
        self.opt = torch.optim.Adam(
            self.model.parameters(), lr=self.config["learning_rate"],
            betas=(0.9, 0.999), eps=1e-8)
        self._rng = np.random.default_rng(self.seed)
        n, checked = len(self.seq), tr["checked_steps"]
        self._picks = list(self._rng.permutation(n)[:checked * B]
                           .reshape(checked, B))

        def load(step):
            while len(self._picks) <= step:
                self._picks.append(self._rng.choice(n, size=B,
                                                    replace=True))
            f, l, w = zip(*(_frame_tensors(self.seq, int(i), self.spec,
                                           self.capacity, self.mapper,
                                           self.device)
                            for i in self._picks[step]))
            return dict(features=torch.stack(f), labels=torch.stack(l),
                        weights=torch.stack(w))

        self._load = load
        self._step = 0
        self._it = self._prefetch(load, 0, None)
        names = [n for n, _ in self.model.named_parameters()]
        self.losses = []
        for k in range(checked):
            self.losses.append(float(self._one(self._it)))
            if k == 0:      # no moment: the optimizer never stepped
                self.m1 = {n: self.opt.state[p].get(
                    "exp_avg", torch.zeros_like(p)).clone()
                    for n, p in zip(names, self.model.parameters())}
        self.p3 = {n: p.detach().clone()
                   for n, p in self.model.named_parameters()}
        self.counts = {"step_flops": counts.train_step_flops(
            self.forward_flops * B), "batch": B}
        self.period = B     # a traced period is one step of B scans

    def _one(self, it):
        from lidar_transfer_tpu_torch.models.rangenet import train_step

        with self.spans("loader_wait"):
            step, batch = next(it)
        with self.spans("step"):
            loss = train_step(self.model, self.opt, batch)
        self._step = step + 1
        return loss

    def periods(self, n: int) -> None:
        """``n`` steps through a Prefetcher of their own."""
        with self._prefetch(self._load, self._step, n) as it:
            for _ in range(n):
                self._one(it)

    def window(self, seconds: float) -> tuple[int, float]:
        """Steps until ``seconds`` have passed, on the iterator of the
        checked steps. -> (scans of finished steps, seconds)."""
        steps = 0
        with self._it as it:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                self._one(it)
                steps += 1
                self.spans.mark(self.traffic["batch"])
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            return steps * self.traffic["batch"], time.perf_counter() - t0

    def release(self) -> None:
        super().release()
        self.opt = None

    def check(self, stand_in: str | None = None) -> dict:
        """The first steps against the plain reference's (float32, TF32
        off): each step's loss, the first gradient by leaf (the program's
        from Adam's first moment after one step) and the change of the
        parameters after the last step by leaf. ``stand_in``: "control",
        the reference with float8 convolutions in the program's place;
        "half_batch", the reference on the first half of each batch, the
        mean taken over it (a planted fault)."""
        checked = self.traffic["checked_steps"]
        batches = []
        for step in range(checked):
            f, l, w, _ = zip(*(self._ref_scan(int(i), True)
                               for i in self._picks[step]))
            batches.append((torch.stack(f), torch.stack(l),
                            torch.stack(w)))
        lr = self.config["learning_rate"]
        with R.no_tf32():
            losses_r, g_r, p_r = R.train_steps(self.flat0, batches,
                                               self.config, lr)
            if stand_in == "control":
                losses_p, g_p, p_p = R.train_steps(
                    self.flat0, batches, self.config, lr, fp8=True)
            elif stand_in == "half_batch":
                half = [tuple(t[:t.shape[0] // 2] for t in b)
                        for b in batches]
                losses_p, g_p, p_p = R.train_steps(self.flat0, half,
                                                   self.config, lr)
            elif stand_in is None:
                losses_p = self.losses
                g_p = {k: v / 0.1 for k, v in self.m1.items()}
                p_p = self.p3
            else:
                raise ValueError(f"no stand-in {stand_in!r} for training")
        p0 = R.unflatten(self.flat0, self.config)
        return train_readings(losses_p, g_p, p_p, losses_r, g_r, p_r, p0)


def train_readings(losses_p, g_p, p_p, losses_r, g_r, p_r, p0) -> dict:
    """loss_rel: the largest relative gap of a step's loss; grad_rel and
    change_rel: the worst leaf's gap between the program's and the
    reference's norm of the first gradient and of the parameters' change,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the change."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    gn_r = {k: float(v.norm()) for k, v in g_r.items()}
    med_g = statistics.median(gn_r.values())
    grad_rel = max(abs(float(g_p[k].norm()) - gn_r[k]) / max(gn_r[k], med_g)
                   for k in gn_r)
    moved = [k for k in gn_r if gn_r[k] >= 1e-3 * med_g]
    dn_r = {k: float((p_r[k] - p0[k]).norm()) for k in moved}
    med_d = statistics.median(dn_r.values())
    change_rel = max(abs(float((p_p[k] - p0[k]).norm()) - dn_r[k])
                     / max(dn_r[k], med_d) for k in moved)
    return {"loss_rel": loss_rel, "grad_rel": grad_rel,
            "change_rel": change_rel,
            "leaves_left_out": float(len(gn_r) - len(moved))}


class InferWork(_SegWork):
    """Closed-loop inference over the sequence, one scan a forward."""

    span_names = {"loader_wait", "infer", "knn", "lut", "host", "load"}

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        from lidar_transfer_tpu_torch.datasets import kitti
        from lidar_transfer_tpu_torch.experiments.segmentation import _project

        self.period = self.traffic["host_stack"]
        self.raw_lut = torch.tensor(self.mapper.raw_ids, dtype=torch.int32,
                                    device=self.device)

        def load(k):
            idx = k % len(self.seq)
            pts, rem = kitti.read_scan_file(self.seq.scan_files[idx])
            ri, feats = _project(pts, rem, np.zeros(pts.shape[0], np.int32),
                                 self.spec, self.capacity, self.device)
            return idx, ri, feats, pts.shape[0]

        self._load = load
        self._next = 0
        # the scans to check: numbers of window scans drawn from the seed
        rnd = random.Random(self.seed)
        self._sampled = set(itertools.accumulate(
            (rnd.randint(1, 2 * self.traffic["sample_gap"] - 1)
             for _ in range(self.traffic["samples"])),
            initial=self.traffic["warmup_scans"]))
        self.kept = []      # (scan index, pixel classes, host raw ids)
        self.counts = {"scan_flops": self.forward_flops}
        self.periods(self.traffic["warmup_scans"] // self.period)

    def _scans(self, it, n: int) -> int:
        """``n`` scans (a multiple of the host stack) -> scans on the
        host."""
        from lidar_transfer_tpu_torch.models.postproc import knn_cleanup
        from lidar_transfer_tpu_torch.models.rangenet import infer

        sp, knn = self.spans, self.config["knn"]
        C = self.mapper.num_classes
        pending = []
        for _ in range(n):
            with sp("loader_wait"):
                k, (idx, ri, feats, npts) = next(it)
            with sp("infer"):
                pred_img = infer(self.model, feats[None])[0]
            with sp("knn"):
                pred = knn_cleanup(
                    ri.range, pred_img, ri.mask, ri.point_depth, ri.point_u,
                    ri.point_v, ri.point_valid, num_classes=C, k=knn["k"],
                    ksize=knn["ksize"], sigma=knn["sigma"],
                    cutoff=knn["cutoff"])
            with sp("lut"):
                raw = self.raw_lut[torch.clamp(pred, 0, C - 1).long()]
            pending.append((k, idx, pred_img, raw, npts))
            if len(pending) == self.period:
                with sp("host"):
                    rows = torch.stack([p[3] for p in pending]).cpu().numpy()
                for (k, idx, img, _, npts), row in zip(pending, rows):
                    if k + 1 in self._sampled:
                        self.kept.append((idx, img, row[:npts]))
                pending = []
        self._next += n
        return n

    def periods(self, n: int) -> None:
        """``n`` host stacks through a Prefetcher of their own."""
        m = n * self.period
        with self._prefetch(self._load, self._next, m) as it:
            self._scans(it, m)

    def window(self, seconds: float) -> tuple[int, float]:
        """Host stacks until ``seconds`` have passed. -> (scans labelled
        on the host, seconds)."""
        done = 0
        with self._prefetch(self._load, self._next, None) as it:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                done += self._scans(it, self.period)
                self.spans.mark(self.period)
            return done, time.perf_counter() - t0

    def check(self, stand_in: str | None = None) -> dict:
        """The kept scans against the plain reference (float32, TF32 off):
        logit_gap, the widest gap by which the reference's logit of a
        pixel's class lies below its best; knn_differ, the share of points
        whose raw id differs from the reference's kNN vote over the same
        pixel classes. ``stand_in="control"``: the reference one precision
        down stands in for the program, its convolutions in float8 and its
        kNN on ranges rounded to bfloat16."""
        if stand_in not in (None, "control"):
            raise ValueError(f"no stand-in {stand_in!r} for inference")
        cfg, knn = self.config, self.config["knn"]
        C = cfg["num_classes"]
        _, raw_ids, _ = label_lut(cfg)
        raw_ids = torch.from_numpy(raw_ids).to(self.device)
        params = R.unflatten(self.flat0, cfg)
        gap, differ, points = 0.0, 0, 0

        def vote(ri, img, rng, depth):
            v = R.knn_cleanup(
                rng, img, ri["mask"], depth, ri["point_u"], ri["point_v"],
                ri["point_valid"], num_classes=C, k=knn["k"],
                ksize=knn["ksize"], sigma=knn["sigma"], cutoff=knn["cutoff"])
            return raw_ids[torch.clamp(v, 0, C - 1).long()].cpu().numpy()

        with R.no_tf32(), torch.no_grad():
            for idx, img, row in self.kept:
                feats, _, _, ri = self._ref_scan(idx, False)
                logits = R.forward(params, feats[None], cfg)[0]
                if stand_in == "control":
                    img = torch.argmax(R.forward(params, feats[None], cfg,
                                                 fp8=True)[0], dim=-1)
                    bf = lambda t: t.bfloat16().float()  # noqa: E731
                    row = vote(ri, img, bf(ri["range"]),
                               bf(ri["point_depth"]))[:row.shape[0]]
                want = vote(ri, img, ri["range"],
                            ri["point_depth"])[:row.shape[0]]
                best = logits.max(dim=-1).values
                got = torch.gather(logits, -1, img.long()[..., None])[..., 0]
                gap = max(gap, float((best - got)[ri["mask"]].max()))
                differ += int((row != want).sum())
                points += row.shape[0]
        # no scan checked reads as the widest gap there is
        return {"logit_gap": gap if points else sys.float_info.max,
                "knn_differ": differ / points if points else 1.0}
