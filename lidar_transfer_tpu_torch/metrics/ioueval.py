"""Confusion-matrix IoU/accuracy metrics (PyTorch).

Counterpart of ``lidar_transfer_tpu/metrics/ioueval.py``: ignore classes
are masked out of rows and columns, the union carries the reference's
1e-15 epsilon, and the mean runs over the included classes.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_transfer_tpu_torch.metrics.confusion import confusion_matrix

__all__ = ["confusion_matrix", "iou_from_confusion", "acc_from_confusion",
           "IoUEval"]


def _masked_stats(conf: torch.Tensor, ignore_mask: torch.Tensor):
    keep = ~ignore_mask
    conf = conf.to(torch.int64) * keep[:, None] * keep[None, :]
    tp = torch.diagonal(conf)
    fp = conf.sum(dim=1) - tp
    fn = conf.sum(dim=0) - tp
    return tp, fp, fn


def iou_from_confusion(conf: torch.Tensor, ignore_mask: torch.Tensor):
    """-> (mean IoU over included classes, per-class IoU), float64."""
    tp, fp, fn = _masked_stats(conf, ignore_mask)
    iou = tp.to(torch.float64) / ((tp + fp + fn).to(torch.float64) + 1e-15)
    include = ~ignore_mask
    n_inc = max(int(include.sum()), 1)
    return torch.where(include, iou, 0.0).sum() / n_inc, iou


def acc_from_confusion(conf: torch.Tensor,
                       ignore_mask: torch.Tensor) -> torch.Tensor:
    """Overall accuracy over the included classes, float64."""
    tp, fp, _ = _masked_stats(conf, ignore_mask)
    include = ~ignore_mask
    total = (torch.where(include, tp, 0).sum()
             + torch.where(include, fp, 0).sum()).to(torch.float64) + 1e-15
    return tp.sum().to(torch.float64) / total


class IoUEval:
    """Stateful accumulator with the reference's iouEval API. Batches are
    counted on their own device; the accumulator is host int64."""

    def __init__(self, n_classes: int, ignore=None):
        self.n_classes = n_classes
        mask = np.zeros((n_classes,), dtype=bool)
        ignore = np.asarray([] if ignore is None else ignore, np.int64)
        if ignore.size:
            mask[ignore] = True
        self.ignore_mask = mask
        self.reset()

    def reset(self) -> None:
        self.conf = np.zeros((self.n_classes, self.n_classes), np.int64)

    def add_batch(self, pred: torch.Tensor, target: torch.Tensor) -> None:
        conf = confusion_matrix(pred.reshape(-1).to(torch.int32),
                                target.reshape(-1).to(torch.int32),
                                self.n_classes)
        self.conf = self.conf + conf.cpu().numpy().astype(np.int64)

    addBatch = add_batch

    def _host_stats(self):
        conf = self.conf.copy()
        conf[self.ignore_mask, :] = 0
        conf[:, self.ignore_mask] = 0
        tp = np.diag(conf).astype(np.float64)
        fp = (conf.sum(axis=1) - np.diag(conf)).astype(np.float64)
        fn = (conf.sum(axis=0) - np.diag(conf)).astype(np.float64)
        return tp, fp, fn, ~self.ignore_mask

    def get_iou(self) -> tuple[float, np.ndarray]:
        tp, fp, fn, include = self._host_stats()
        iou = tp / (tp + fp + fn + 1e-15)
        return float(iou[include].sum() / max(include.sum(), 1)), iou

    getIoU = get_iou

    def get_acc(self) -> float:
        tp, fp, _, include = self._host_stats()
        return float(tp.sum() / (tp[include].sum() + fp[include].sum()
                                 + 1e-15))

    getacc = get_acc
