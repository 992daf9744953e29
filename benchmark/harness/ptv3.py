"""The Point Transformer V3 training loop: PT-v3m1 train steps on the
points of the cell's scans, as ``lt-seg-torch train --arch ptv3`` runs
them.

Each step draws ``batch`` scans with replacement; a ``Prefetcher`` of depth
``prefetch_depth`` reads and uploads each scan's points and labels
(``experiments/segmentation._point_tensors``), and the step is
``models.ptv3.train_step`` with AdamW: grid sampling, serialization,
neighbour maps, forward, backward and the optimizer on the card. Step
``k`` draws its cell picks, order shuffles and drop path from
``experiments.segmentation.step_generator(seed, k)``, as ``lt-seg-torch``
does, and the reference is handed the same generators.

The weights are drawn on the card from the seed in one call and handed to
the port and to the reference alike. Configuration keys: ``sensor``, the
network's shape (``reference/ptv3.leaves``), ``labels``,
``moving_to_static``, ``ignore``, ``num_classes``, the AdamW rates;
traffic keys: ``loop``, ``scans``, ``pose_step_m``, ``prefetch_depth``,
``batch``, ``checked_steps``, ``trace_periods``.

It imports the port's ``models.ptv3`` at once, so a program without it
fails here, before any scan is made.
"""

from __future__ import annotations

import itertools
import statistics
import time

import numpy as np
import torch

from harness import scenes
from harness.common import Spans
from harness.segment import label_lut, train_readings
from reference import kitti as RK
from reference import ptv3 as R

from lidar_transfer_tpu_torch.models import ptv3 as P  # noqa: E402


def make_weights(config: dict, seed: int, device) -> dict:
    """The network's weights by leaf, drawn on ``device`` from ``seed`` in
    one call: each Linear's weight from a normal of std 0.02, each
    convolution's of std 1/sqrt(fan-in), both truncated at two standard
    deviations (Pointcept's init); norm scales 1, biases 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    layout = R.leaves(config)
    sizes = [int(np.prod(s)) for _, s, _ in layout]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for (name, shape, kind), n in zip(layout, sizes):
        v = flat[at:at + n].view(shape)
        at += n
        if kind == "linear":
            v = v * 0.02
        elif kind == "conv":
            v = v * (shape[0] * shape[1]) ** -0.5
        else:
            v = torch.full_like(v, float(kind == "one"))
        out[name] = v
    return out


class TrainWork:
    """Closed-loop PT-v3m1 train steps; the first ``checked_steps`` run in
    set-up through the window's own iterator, on scans that all differ,
    and are what the check follows."""

    period = 1
    span_names = {"loader_wait", "step", "load"}
    #: what ``check`` can put in the program's place
    stand_ins = ("control", "half_batch")

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 data_dir: str, spans: Spans):
        from lidar_transfer_tpu_torch.datasets import kitti
        from lidar_transfer_tpu_torch.experiments.segmentation import (
            LabelMapper, _point_tensors)

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.data_dir, self.spans = device, data_dir, spans
        scenes.write_sequence(data_dir, scenes.Scene.urban(seed),
                              config["sensor"], traffic["scans"],
                              traffic["pose_step_m"], device)
        seq = kitti.KittiSequence.open(data_dir)
        mapper = LabelMapper.from_labels(
            {int(k): str(k) for k in config["labels"]},
            ignore_classes=tuple(config["ignore"]))
        if mapper.num_classes != config["num_classes"]:
            raise ValueError(f"the labels give {mapper.num_classes} "
                             f"classes, the configuration "
                             f"{config['num_classes']}")
        self.model = P.PTv3(P.PTv3Config.from_dict(config)).to(device)
        self.w0 = make_weights(config, seed, device)
        named = list(self.model.named_parameters())
        if [(n, tuple(p.shape)) for n, p in named] != \
                [(n, s) for n, s, _ in R.leaves(config)]:
            raise ValueError("the port's PT-v3m1 parameters differ from the "
                             "configuration's layout")
        with torch.no_grad():
            for n, p in named:
                p.copy_(self.w0[n])
        self.opt = P.make_optimizer(self.model)

        B, n, checked = traffic["batch"], len(seq), traffic["checked_steps"]
        rng = np.random.default_rng(seed)
        first = np.concatenate([rng.permutation(n) for _ in
                                range(-(-checked * B // n))])
        self._picks = list(first[:checked * B].reshape(checked, B))

        def load(step):
            while len(self._picks) <= step:
                self._picks.append(rng.choice(n, size=B, replace=True))
            p, lab = zip(*(_point_tensors(seq, int(i), mapper, device)
                           for i in self._picks[step]))
            return dict(points=torch.cat(p), labels=torch.cat(lab),
                        counts=[t.shape[0] for t in p])

        self._load = load
        self._step = 0
        self._traced = None
        self._it = self._prefetch(0, None)
        names = [n for n, _ in named]
        self.losses = []
        for k in range(checked):
            self.losses.append(float(self._one(self._it)))
            if k == 0:      # AdamW's first moment after one step: 0.1 g
                self.m1 = {nm: self.opt.state[p].get(
                    "exp_avg", torch.zeros_like(p)).clone()
                           for nm, p in zip(names, self.model.parameters())}
        self.p3 = {nm: p.detach().clone()
                   for nm, p in self.model.named_parameters()}
        self.counts = {"batch": B}
        self.period = B     # a traced period is one step of B scans

    def _prefetch(self, start: int, count, repeat: bool = False):
        from lidar_transfer_tpu_torch.utils.prefetch import Prefetcher

        idx = (itertools.count(start) if count is None
               else [start] * count if repeat
               else range(start, start + count))
        return Prefetcher(self.spans.wrap("load", self._load), idx,
                          depth=self.traffic["prefetch_depth"])

    def _gen(self, step: int) -> torch.Generator:
        from lidar_transfer_tpu_torch.experiments.segmentation import (
            step_generator)

        return step_generator(self.seed, step, self.device)

    def _one(self, it):
        with self.spans("loader_wait"):
            step, batch = next(it)
        with self.spans("step"):
            loss = P.train_step(self.model, self.opt, batch, self._gen(step))
        self._step = step + 1
        return loss

    def _counted(self, key: str, steps: int) -> None:
        self.counts[key] = dict(P.stage_counts(), steps=steps)

    def periods(self, n: int) -> None:
        """``n`` steps through a Prefetcher of their own, each on the same
        scans with the same draws: the first step after the window, again.
        Steps on other scans launch other numbers of device operations,
        and the traced stretch needs each operation a whole number of
        times a period. Their counters are ``counts["stretch"]`` (the
        traced stretch's, the last call)."""
        if self._traced is None:
            self._traced = self._step
        P.reset_stage_counts()
        with self._prefetch(self._traced, n, repeat=True) as it:
            for _ in range(n):
                self._one(it)
        self._counted("stretch", n)

    def window(self, seconds: float) -> tuple[int, float]:
        """Steps until ``seconds`` have passed, on the iterator of the
        checked steps; their counters are ``counts["window"]``. -> (scans
        of finished steps, seconds)."""
        steps = 0
        P.reset_stage_counts()
        with self._it as it:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                self._one(it)
                steps += 1
                self.spans.mark(self.traffic["batch"])
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            done = time.perf_counter() - t0
        self._counted("window", steps)
        return steps * self.traffic["batch"], done

    def release(self) -> None:
        self.model = None
        self.opt = None

    def _ref_batch(self, step: int):
        to_index, _, ignore = label_lut(self.config)
        pts, labs, counts = [], [], []
        root = self.data_dir
        for i in self._picks[step]:
            p, rem = RK.read_scan(RK.scan_files(root, "velodyne", ".bin")[i])
            lab = RK.read_labels(RK.scan_files(root, "labels", ".label")[i])
            idx = to_index[np.clip(lab, 0, to_index.shape[0] - 1)]
            pts.append(np.concatenate([p, rem[:, None]], 1))
            labs.append(np.where(np.isin(idx, ignore), -1, idx))
            counts.append(p.shape[0])
        return (torch.from_numpy(np.concatenate(pts)).to(self.device),
                torch.from_numpy(np.concatenate(labs)).long().to(
                    self.device), counts)

    def check(self, stand_in: str | None = None) -> dict:
        """The first steps against the plain reference's (float32, TF32
        off, the same generator draws): each step's loss, the first
        gradient by leaf (the program's from AdamW's first moment after one
        step) and the change of the parameters after the last step by leaf
        (``harness.segment.train_readings``), and the first gradients'
        own gap by leaf (:func:`grad_diff`). ``stand_in``: "control", the
        reference with float8 products in the program's place;
        "half_batch", the reference on the first half of each batch's
        scans (a planted fault)."""
        checked = self.traffic["checked_steps"]
        batches = [self._ref_batch(k) for k in range(checked)]

        def gens():
            return [self._gen(k) for k in range(checked)]

        with R.no_tf32():
            losses_r, g_r, p_r = R.train_steps(self.w0, batches, self.config,
                                               gens())
            if stand_in == "control":
                losses_p, g_p, p_p = R.train_steps(
                    self.w0, batches, self.config, gens(), "float8")
            elif stand_in == "half_batch":
                half = []
                for pts, lab, counts in batches:
                    k = len(counts) // 2
                    m = sum(counts[:k])
                    half.append((pts[:m], lab[:m], counts[:k]))
                losses_p, g_p, p_p = R.train_steps(self.w0, half,
                                                   self.config, gens())
            elif stand_in is None:
                losses_p = self.losses
                g_p = {k: v / 0.1 for k, v in self.m1.items()}
                p_p = self.p3
            else:
                raise ValueError(f"no stand-in {stand_in!r} for training")
        readings = train_readings(losses_p, g_p, p_p, losses_r, g_r, p_r,
                                  self.w0)
        return dict(readings, grad_diff=grad_diff(g_p, g_r))


def grad_diff(g_p: dict, g_r: dict) -> float:
    """The worst leaf's norm of the gap between the program's and the
    reference's first gradient, over the larger of that leaf's and the
    median leaf's reference norm. ``grad_rel`` compares norms alone, which
    a gradient drawn with other random masks (drop path by point) keeps;
    this compares the gradients themselves."""
    norms = {k: float(v.norm()) for k, v in g_r.items()}
    med = statistics.median(norms.values())
    return max(float((g_p[k] - g_r[k]).norm()) / max(norms[k], med)
               for k in g_r)

