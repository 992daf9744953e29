"""SemanticKITTI-format dataset IO (the port's own copy of
``lidar_transfer_tpu/datasets/kitti.py``, numpy only).

Rebuilds the reference's L1 foundation (SURVEY.md §1):
  - .bin scan reader        (reference auxiliary/laserscan.py:116-140)
  - .label reader           (reference auxiliary/laserscan.py:570-592)
  - calib.txt parser        (reference lidar_deform.py:13-38)
  - poses.txt parser        (reference lidar_deform.py:41-74, Tr^-1 P Tr)
  - vectorized writers      (reference laserscan.py:1162-1178 used per-point
                             struct.pack loops; we use numpy tofile)

All functions are host-side numpy; device arrays are produced downstream in
ops/ with fixed-capacity padding. The readers are the spans ``loader.read``
(with the ``bytes`` read) and the padding ``loader.pad``
(``utils/runtime``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from lidar_transfer_tpu_torch.utils.runtime import span


def read_scan_file(filename: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a KITTI .bin scan -> (points (N,3) f32, remissions (N,) f32)."""
    if not filename.endswith(".bin"):
        raise RuntimeError(f"not a KITTI scan file: {filename}")
    with span("loader.read") as sp:
        scan = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
        sp.set(bytes=scan.nbytes)
    return np.ascontiguousarray(scan[:, 0:3]), np.ascontiguousarray(scan[:, 3])


def read_label_file(filename: str, num_points: int | None = None
                    ) -> np.ndarray:
    """Read a .label file -> semantic labels (N,) int32.

    Keeps only the semantic lower half-word, as the reference does
    (laserscan.py:588: ``label & 0xFFFF``).
    """
    if not filename.endswith(".label"):
        raise RuntimeError(f"not a KITTI label file: {filename}")
    with span("loader.read") as sp:
        label = np.fromfile(filename, dtype=np.uint32)
        sp.set(bytes=label.nbytes)
    if num_points is not None and label.shape[0] != num_points:
        raise ValueError(
            f"scan and label point counts differ: {num_points} vs "
            f"{label.shape[0]} in {filename}")
    return (label & 0xFFFF).astype(np.int32)


def write_scan_file(filename: str, points: np.ndarray,
                    remissions: np.ndarray) -> None:
    """Write points+remissions as KITTI .bin (vectorized, not struct loops)."""
    n = points.shape[0]
    out = np.empty((n, 4), dtype=np.float32)
    out[:, 0:3] = points
    out[:, 3] = remissions
    out.tofile(filename)


def write_label_file(filename: str, labels: np.ndarray) -> None:
    labels.astype(np.uint32).tofile(filename)


def parse_calibration(filename: str) -> dict[str, np.ndarray]:
    """Parse KITTI calib.txt into {key: 4x4 matrix}.

    Same row layout as the reference (lidar_deform.py:13-38): 12 values fill
    rows 0..2, bottom row is [0,0,0,1].
    """
    calib: dict[str, np.ndarray] = {}
    with open(filename) as f:
        for line in f:
            if not line.strip():
                continue
            key, content = line.strip().split(":")
            values = np.array([float(v) for v in content.strip().split()],
                              dtype=np.float64)
            pose = np.zeros((4, 4), dtype=np.float64)
            pose[:3, :4] = values.reshape(3, 4)
            pose[3, 3] = 1.0
            calib[key] = pose
    return calib


def parse_poses(filename: str, calibration: dict[str, np.ndarray]
                ) -> np.ndarray:
    """Parse poses.txt -> (N,4,4) float64 poses in the velodyne frame.

    Applies Tr^-1 @ P @ Tr exactly as the reference (lidar_deform.py:71) to
    move camera-frame poses into the LiDAR frame.
    """
    Tr = calibration["Tr"]
    Tr_inv = np.linalg.inv(Tr)
    poses = []
    with open(filename) as f:
        for line in f:
            if not line.strip():
                continue
            values = np.array([float(v) for v in line.strip().split()],
                              dtype=np.float64)
            pose = np.zeros((4, 4), dtype=np.float64)
            pose[:3, :4] = values.reshape(3, 4)
            pose[3, 3] = 1.0
            poses.append(Tr_inv @ pose @ Tr)
    return np.stack(poses, axis=0)


def write_poses(filename: str, poses: np.ndarray,
                calibration: dict[str, np.ndarray] | None = None) -> None:
    """Inverse of parse_poses: write (N,4,4) poses as KITTI poses.txt rows."""
    if calibration is not None:
        Tr = calibration["Tr"]
        Tr_inv = np.linalg.inv(Tr)
        poses = np.einsum("ij,njk,kl->nil", Tr, poses, Tr_inv)
    with open(filename, "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.6e}" for v in p[:3, :4].reshape(-1)))
            f.write("\n")


def _sorted_files(directory: str, ext: str) -> list[str]:
    names = [os.path.join(dp, f)
             for dp, _, fn in os.walk(os.path.expanduser(directory))
             for f in fn if f.endswith(ext)]
    names.sort()
    return names


@dataclasses.dataclass(eq=False)   # identity hash: usable as a cache key
class KittiSequence:
    """One SemanticKITTI sequence: scan/label file lists + poses + calib.

    Mirrors the directory discovery of the reference's main script
    (lidar_deform.py:198-261): <root>/sequences/<seq>/{velodyne,labels,
    calib.txt, poses.txt} plus <root>/config.yaml for the sensor spec.
    """

    root: str
    sequence: str
    scan_files: list[str]
    label_files: list[str]
    poses: np.ndarray              # (N,4,4)
    calibration: dict[str, np.ndarray]

    @classmethod
    def open(cls, root: str, sequence: str = "00",
             require_labels: bool = True) -> "KittiSequence":
        seq_dir = os.path.join(root, "sequences", sequence)
        scan_dir = os.path.join(seq_dir, "velodyne")
        label_dir = os.path.join(seq_dir, "labels")
        if not os.path.isdir(scan_dir):
            raise FileNotFoundError(f"no velodyne dir at {scan_dir}")
        scan_files = _sorted_files(scan_dir, ".bin")
        label_files = (_sorted_files(label_dir, ".label")
                       if os.path.isdir(label_dir) else [])
        if require_labels and len(label_files) != len(scan_files):
            raise ValueError(
                f"scan/label count mismatch: {len(scan_files)} vs "
                f"{len(label_files)}")
        calib = parse_calibration(os.path.join(seq_dir, "calib.txt"))
        poses = parse_poses(os.path.join(seq_dir, "poses.txt"), calib)
        return cls(root=root, sequence=sequence, scan_files=scan_files,
                   label_files=label_files, poses=poses, calibration=calib)

    def __len__(self) -> int:
        return len(self.scan_files)

    def read(self, idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (points (N,3), remissions (N,), labels (N,) int32).

        Label-less sequences (``require_labels=False`` on a converted
        NCLT/Ford/nuScenes tree) return all-zero labels instead of
        raising on the empty ``label_files`` list — callers that used to
        hand-roll this bypass (visualize, lt-seg infer) get the same
        contract from the method now."""
        points, rem = read_scan_file(self.scan_files[idx])
        # pair labels only when the lists align 1:1 — a PARTIAL labels
        # dir would otherwise silently pair scan idx with the wrong file
        if len(self.label_files) == len(self.scan_files):
            labels = read_label_file(self.label_files[idx],
                                     points.shape[0])
        else:
            labels = np.zeros(points.shape[0], np.int32)
        return points, rem, labels


def pad_points(points: np.ndarray, remissions: np.ndarray,
               labels: np.ndarray, capacity: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad per-scan arrays to a fixed capacity for static XLA shapes.

    Returns (points (C,3), rem (C,), labels (C,), valid_mask (C,) bool).
    Padding points are placed at the origin; they carry depth 0 and are
    dropped by the projection ops (which mirrors the reference's removal of
    zero-depth points, laserscan.py:307-310).
    """
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"scan has {n} points > capacity {capacity}")
    with span("loader.pad"):
        p = np.zeros((capacity, 3), dtype=np.float32)
        r = np.zeros((capacity,), dtype=np.float32)
        l = np.zeros((capacity,), dtype=np.int32)
        m = np.zeros((capacity,), dtype=bool)
        p[:n] = points
        r[:n] = remissions
        l[:n] = labels
        m[:n] = True
    return p, r, l, m


def make_output_dirs(out_root: str, sequence: str,
                     write_png: bool = False) -> str:
    """Create <out>/sequences/<seq>/{velodyne,labels[,*_png]} dirs."""
    out_path = os.path.join(out_root, "sequences", sequence)
    for sub in ["velodyne", "labels"] + (
            ["velodyne_png", "labels_png"] if write_png else []):
        os.makedirs(os.path.join(out_path, sub), exist_ok=True)
    return out_path


def scan_capacity(num_points: int, multiple: int = 8192) -> int:
    """Round a point count up to a bucket for shape reuse across scans."""
    return int(-(-num_points // multiple) * multiple)
