"""Reading a KITTI sequence for the plain references (numpy only).

The references read the scans the benchmark wrote, with this reader of
their own, and work out everything the program derives from them again.
"""

from __future__ import annotations

import os

import numpy as np


def scan_files(root: str, sub: str, ext: str) -> list[str]:
    d = os.path.join(root, "sequences", "00", sub)
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(ext))


def read_scan(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (points (N, 3) f32, remissions (N,) f32)."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return np.ascontiguousarray(scan[:, :3]), np.ascontiguousarray(scan[:, 3])


def read_labels(path: str) -> np.ndarray:
    """-> semantic labels (N,) int32 (the lower half-word)."""
    return (np.fromfile(path, dtype=np.uint32) & 0xFFFF).astype(np.int32)


def read_poses(root: str) -> np.ndarray:
    """-> (N, 4, 4) float64 poses in the sensor frame: Tr^-1 P Tr with the
    sequence's calibration Tr."""
    seq = os.path.join(root, "sequences", "00")
    tr = np.eye(4)
    with open(os.path.join(seq, "calib.txt")) as f:
        for line in f:
            key, vals = line.split(":")
            if key.strip() == "Tr":
                tr[:3, :4] = np.array(vals.split(), np.float64).reshape(3, 4)
    tr_inv = np.linalg.inv(tr)
    poses = []
    with open(os.path.join(seq, "poses.txt")) as f:
        for line in f:
            if line.strip():
                p = np.eye(4)
                p[:3, :4] = np.array(line.split(), np.float64).reshape(3, 4)
                poses.append(tr_inv @ p @ tr)
    return np.stack(poses)


def capacity(root: str, multiple: int = 8192) -> int:
    """The padded point count of every scan: the largest scan's point
    count rounded up to ``multiple``."""
    n = max(os.path.getsize(f) // 16
            for f in scan_files(root, "velodyne", ".bin"))
    return int(-(-n // multiple) * multiple)


def pad(points, rem, labels, cap: int):
    """-> (points (cap, 3), rem (cap,), labels (cap,), valid (cap,)),
    padded with zeros at the origin."""
    n = points.shape[0]
    p = np.zeros((cap, 3), np.float32)
    r = np.zeros(cap, np.float32)
    lab = np.zeros(cap, np.int32)
    m = np.zeros(cap, bool)
    p[:n], r[:n], lab[:n], m[:n] = points, rem, labels, True
    return p, r, lab, m
