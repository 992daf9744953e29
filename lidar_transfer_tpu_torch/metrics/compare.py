"""Source-vs-virtual scan comparison (PyTorch).

Counterpart of ``lidar_transfer_tpu/metrics/compare.py``: black (no data
or label 0) source pixels are zeroed in both scans, label agreement is
mIoU/Acc over the raw ids present, and range/remission agreement are
squared-error images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_transfer_tpu_torch.metrics.confusion import confusion_matrix


class CompareResult(NamedTuple):
    mean_iou: torch.Tensor        # scalar f32
    mean_acc: torch.Tensor        # scalar f32
    mse: torch.Tensor             # scalar f32: masked range MSE
    iou_per_class: torch.Tensor   # (max_label,) f32 IoU on raw ids
    present: torch.Tensor         # (max_label,) bool
    label_diff: torch.Tensor      # (H,W) i32: 1 where labels disagree
    range_diff: torch.Tensor      # (H,W) f32: squared range error
    remission_diff: torch.Tensor  # (H,W) f32: squared remission error


def compare_scans(source_label: torch.Tensor, source_mask: torch.Tensor,
                  source_range: torch.Tensor,
                  source_remission: torch.Tensor,
                  target_label: torch.Tensor, target_range: torch.Tensor,
                  target_remission: torch.Tensor,
                  max_label: int = 260) -> CompareResult:
    """Compare a source range image against a synthesized virtual scan
    (all (H,W); labels are raw ids below ``max_label``)."""
    src_lbl = source_label.to(torch.int32)
    tgt_lbl = target_label.to(torch.int32)
    black = (~source_mask) | (src_lbl == 0)
    src_lbl = torch.where(black, 0, src_lbl)
    # black source pixels are zeroed in the target too; after that the
    # label-0 background of the source equals the black set
    bg = src_lbl == 0
    tgt_lbl = torch.where(bg, 0, tgt_lbl)
    label_diff = (src_lbl != tgt_lbl).to(torch.int32)

    # preds = target, ground truth = source
    conf = confusion_matrix(tgt_lbl.reshape(-1).contiguous(),
                            src_lbl.reshape(-1).contiguous(), max_label)
    rows = conf.sum(dim=1)
    cols = conf.sum(dim=0)
    present = (rows + cols) > 0
    tp = torch.diagonal(conf)
    fp = rows - tp
    fn = cols - tp
    iou = tp.to(torch.float32) / ((tp + fp + fn).to(torch.float32) + 1e-15)
    n_present = torch.clamp(present.sum(), min=1)
    mean_iou = torch.where(present, iou, 0.0).sum() / n_present
    total = (torch.where(present, tp, 0).sum()
             + torch.where(present, fp, 0).sum()).to(torch.float32) + 1e-15
    mean_acc = tp.sum().to(torch.float32) / total

    src_rng = torch.where(bg, 0.0, source_range)
    tgt_rng = torch.where(bg, 0.0, target_range)
    range_diff = (src_rng - tgt_rng) ** 2
    mse = range_diff.sum() / range_diff.numel()
    src_rem = torch.where(bg, 0.0, source_remission)
    tgt_rem = torch.where(bg, 0.0, target_remission)
    rem_diff = (src_rem - tgt_rem) ** 2
    return CompareResult(mean_iou=mean_iou, mean_acc=mean_acc, mse=mse,
                         iou_per_class=iou, present=present,
                         label_diff=label_diff, range_diff=range_diff,
                         remission_diff=rem_diff)
