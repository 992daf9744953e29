"""Confusion matrix: CUDA histogram kernel and its plain version (PyTorch).

Counterpart of ``lidar_transfer_tpu/metrics/confusion.py``. On the card
:func:`confusion_matrix` launches kernel B (``csrc/confusion.cu``, which
replaces the Pallas ``confusion_pallas``); a CPU tensor takes
:func:`confusion_scatter`. Rows are pred, columns target; ids outside
[0, n_classes), negatives included, are dropped. Counts are exact int32.
"""

from __future__ import annotations

import torch

from lidar_transfer_tpu_torch import _build


def confusion_scatter(pred: torch.Tensor, target: torch.Tensor,
                      n_classes: int) -> torch.Tensor:
    """Plain version: a histogram of ``pred * C + target`` over the
    in-range pairs."""
    p = pred.reshape(-1).to(torch.int64)
    t = target.reshape(-1).to(torch.int64)
    ok = (p >= 0) & (p < n_classes) & (t >= 0) & (t < n_classes)
    counts = torch.bincount((p * n_classes + t)[ok],
                            minlength=n_classes * n_classes)
    return counts.reshape(n_classes, n_classes).to(torch.int32)


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """(n_classes, n_classes) int32 counts (kernel B on a CUDA tensor)."""
    if pred.device.type == "cpu" and target.device.type == "cpu":
        return confusion_scatter(pred, target, n_classes)
    if pred.device.type != "cuda" or target.device != pred.device:
        raise ValueError(f"confusion_matrix: pred on {pred.device}, target "
                         f"on {target.device}; both must be on one CUDA "
                         "device")
    if pred.dtype != torch.int32 or target.dtype != torch.int32:
        raise TypeError(f"confusion_matrix: need int32 ids, got "
                        f"{pred.dtype} and {target.dtype}")
    if pred.shape != target.shape:
        raise ValueError(f"confusion_matrix: shapes {tuple(pred.shape)} and "
                         f"{tuple(target.shape)} differ")
    if not (pred.is_contiguous() and target.is_contiguous()):
        raise ValueError("confusion_matrix: inputs must be contiguous")
    if not 0 < n_classes <= 46340:            # C * C must fit in int32
        raise ValueError(f"confusion_matrix: n_classes {n_classes}")
    out = torch.empty((n_classes, n_classes), dtype=torch.int32,
                      device=pred.device)
    _build.launch("confusion", "lt_confusion", pred.data_ptr(),
                  target.data_ptr(), pred.numel(), n_classes,
                  out.data_ptr(), _build.stream_handle(pred.device))
    return out
