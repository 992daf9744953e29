"""Multi-scan window loading and merging (PyTorch).

Counterpart of ``lidar_transfer_tpu/pipeline/multiscan.py``: a window of
``nscans`` around the primary index (primary first), each scan padded to a
fixed capacity, its relative pose ``inv(pose[primary]) @ T @ pose[i]``
composed on the host in float64, ignore classes masked everywhere and
moving classes on the non-primary scans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_transfer_tpu_torch.config import TransferConfig
from lidar_transfer_tpu_torch.datasets import kitti
from lidar_transfer_tpu_torch.ops.projection import mask_classes
from lidar_transfer_tpu_torch.ops.transforms import transform_points
from lidar_transfer_tpu_torch.utils.runtime import upload


# window_indices / min_start_index / max_end_index are plain Python in
# lidar_transfer_tpu/pipeline/multiscan.py, whose package imports jax; they
# are copied here.
def window_indices(nscans: int, idx: int) -> list[int]:
    """Scan indices for a window around idx, primary first."""
    if nscans <= 1:
        return [idx]
    n_prev = nscans // 2
    n_next = nscans - n_prev
    rel = [r for r in range(-n_prev, n_next) if r != 0]
    rel.insert(0, 0)
    return [idx + r for r in rel]


def min_start_index(nscans: int) -> int:
    """First valid primary index (needs nscans//2 previous scans)."""
    return nscans // 2


def max_end_index(nscans: int, length: int) -> int:
    """One past the last valid primary index."""
    return length - (nscans - nscans // 2 - 1)


@dataclasses.dataclass
class ScanWindow:
    """A padded window of scans (tensors on one device), primary scan
    first. Points are raw (sensor frame); ``rel_pose`` maps each scan into
    the primary frame. A streamed batch carries a leading frame axis on
    every tensor."""

    points: torch.Tensor       # (S, C, 3) f32
    remissions: torch.Tensor   # (S, C) f32
    labels: torch.Tensor       # (S, C) i32
    valid: torch.Tensor        # (S, C) bool
    rel_pose: torch.Tensor     # (S, 4, 4) f32

    @property
    def nscans(self) -> int:
        return self.points.shape[-3]

    def frame(self, i: int) -> "ScanWindow":
        """Frame ``i`` of a streamed batch."""
        return ScanWindow(self.points[i], self.remissions[i],
                          self.labels[i], self.valid[i], self.rel_pose[i])


def load_window(seq: kitti.KittiSequence, cfg: TransferConfig, idx: int,
                capacity: int, device="cpu") -> ScanWindow:
    """Read, pad and mask the scan window around ``idx``.

    Raises IndexError when the centred window does not fit the sequence
    (negative indexing would silently wrap to its end).
    """
    n = cfg.number_of_scans
    if not (min_start_index(n) <= idx < max_end_index(n, len(seq))):
        raise IndexError(
            f"window of {n} scans around index {idx} does not fit the "
            f"{len(seq)}-scan sequence (valid primary range: "
            f"[{min_start_index(n)}, {max_end_index(n, len(seq))}))")
    pose_primary_inv = np.linalg.inv(seq.poses[idx])
    extra = cfg.transformation_matrix.astype(np.float64)
    cols = []
    for i in window_indices(n, idx):
        points, rem, labels = seq.read(i)
        p, r, l, m = kitti.pad_points(points, rem, labels, capacity)
        rel = (pose_primary_inv @ extra @ seq.poses[i]).astype(np.float32)
        cols.append((p, r, l, m, rel))
    p, r, l, m, rel = (upload(np.stack(c), device) for c in zip(*cols))
    window = ScanWindow(points=p, remissions=r, labels=l, valid=m,
                        rel_pose=rel)
    return apply_class_masks(window, cfg.ignore_classes, cfg.moving_classes)


def stack_windows(wins: list[ScanWindow]) -> ScanWindow:
    """Stack F windows on a leading frame axis (``transfer_stream``)."""
    return ScanWindow(
        points=torch.stack([w.points for w in wins]),
        remissions=torch.stack([w.remissions for w in wins]),
        labels=torch.stack([w.labels for w in wins]),
        valid=torch.stack([w.valid for w in wins]),
        rel_pose=torch.stack([w.rel_pose for w in wins]))


def apply_class_masks(window: ScanWindow, ignore_classes,
                      moving_classes) -> ScanWindow:
    """Mask ignore classes everywhere; moving classes on non-primary
    scans."""
    valid = mask_classes(window.labels, window.valid, tuple(ignore_classes))
    if window.nscans > 1 and moving_classes:
        non_primary = mask_classes(window.labels, valid,
                                   tuple(moving_classes))
        valid = torch.cat([valid[0:1], non_primary[1:]], dim=0)
    return dataclasses.replace(window, valid=valid)


def merge_window(window: ScanWindow):
    """Transform every scan into the primary frame and flatten to one cloud.

    -> (points (S*C,3), rem (S*C,), labels (S*C,), valid (S*C,)).
    """
    pts = transform_points(window.points, window.rel_pose)
    return (pts.reshape(-1, 3), window.remissions.reshape(-1),
            window.labels.reshape(-1), window.valid.reshape(-1))
