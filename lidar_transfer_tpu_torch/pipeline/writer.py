"""Virtual-scan dataset writer (KITTI-format output).

Counterpart of ``lidar_transfer_tpu/pipeline/writer.py``: drop no-data
pixels and (0,0,0) points, then write ``.bin`` + ``.label`` files.
"""

from __future__ import annotations

import os

import numpy as np

from lidar_transfer_tpu_torch.datasets import kitti
from lidar_transfer_tpu_torch.interop import to_numpy
from lidar_transfer_tpu_torch.pipeline.deform import VirtualScan


def filter_virtual_scan(vs: VirtualScan
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (points (N,3), remissions (N,), labels (N,)) of the pixels with
    data whose point is not the origin."""
    pts = to_numpy(vs.points).reshape(-1, 3)
    lbl = to_numpy(vs.label).reshape(-1).astype(np.int32)
    rem = to_numpy(vs.remission).reshape(-1)
    keep = (lbl >= 0) & to_numpy(vs.mask).reshape(-1)
    keep &= pts.sum(axis=1) != 0
    return pts[keep], rem[keep], lbl[keep]


def write_virtual_scan(out_path: str, idx: int, vs: VirtualScan) -> int:
    """Write <out>/velodyne/XXXXXX.bin + <out>/labels/XXXXXX.label.
    Returns the number of points written."""
    pts, rem, lbl = filter_virtual_scan(vs)
    kitti.write_scan_file(
        os.path.join(out_path, "velodyne", f"{idx:06d}.bin"), pts, rem)
    kitti.write_label_file(
        os.path.join(out_path, "labels", f"{idx:06d}.label"), lbl)
    return pts.shape[0]
