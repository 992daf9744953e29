"""Sensor specs and transfer configuration.

The port's own copy of ``lidar_transfer_tpu/config.py`` (numpy and yaml
only), kept equal to it: typed dataclasses in place of the reference's three
YAML layers (``config/lidar_transfer.yaml``, per-dataset ``config.yaml``,
target yaml — consumed at ``lidar_deform.py:264-325``). YAML files in the
same schema are accepted for drop-in compatibility.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import yaml

# SemanticKITTI default label names (reference: config/lidar_transfer.yaml
# `labels:` block). Keys are raw label ids (lower 16 bit of .label files).
SEMANTICKITTI_LABELS: dict[int, str] = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
    15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
    30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
    44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
    51: "fence", 52: "other-structure", 60: "lane-marking", 70: "vegetation",
    71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
    99: "other-object", 252: "moving-car", 253: "moving-bicyclist",
    254: "moving-person", 255: "moving-motorcyclist", 256: "moving-on-rails",
    257: "moving-bus", 258: "moving-truck", 259: "moving-other-vehicle",
}

# BGR color map, exactly the reference's `color_map` block
# (config/lidar_transfer.yaml:47-81 — note: BGR order, as in the reference).
SEMANTICKITTI_COLOR_MAP_BGR: dict[int, tuple[int, int, int]] = {
    0: (0, 0, 0), 1: (0, 0, 255), 10: (245, 150, 100), 11: (245, 230, 100),
    13: (250, 80, 100), 15: (150, 60, 30), 16: (255, 0, 0), 18: (180, 30, 80),
    20: (255, 0, 0), 30: (30, 30, 255), 31: (200, 40, 255), 32: (90, 30, 150),
    40: (255, 0, 255), 44: (255, 150, 255), 48: (75, 0, 75), 49: (75, 0, 175),
    50: (0, 200, 255), 51: (50, 120, 255), 52: (0, 150, 255),
    60: (170, 255, 150), 70: (0, 175, 0), 71: (0, 60, 135), 72: (80, 240, 150),
    80: (150, 240, 255), 81: (0, 0, 255), 99: (255, 255, 50),
    252: (245, 150, 100), 253: (200, 40, 255), 254: (30, 30, 255),
    255: (90, 30, 150), 256: (255, 0, 0), 257: (250, 80, 100),
    258: (180, 30, 80), 259: (255, 0, 0),
}

DEFAULT_IGNORE_CLASSES = (0, 1)
DEFAULT_MOVING_CLASSES = (252, 253, 254, 255, 256, 257, 258, 259)


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    """Geometry of a spinning LiDAR sensor.

    Mirrors the per-dataset ``config.yaml`` schema of the reference
    (keys consumed at lidar_deform.py:264-277): name, fov_up, fov_down,
    beams, angle_res_hor, fov_hor, optional beam_angles.
    """

    name: str = "generic"
    beams: int = 64                 # vertical resolution H
    fov_up: float = 3.0             # degrees
    fov_down: float = -25.0         # degrees (negative = below horizon)
    fov_hor: float = 360.0          # degrees
    angle_res_hor: float = 0.17578125  # degrees/pixel -> W = 2048
    # RADIANS, ascending (yaml carries DEGREES like fov_up/fov_down;
    # from_dict converts — the conversion the reference left as a TODO,
    # laserscan.py:25, and consequently never applied)
    beam_angles: tuple[float, ...] | None = None

    @property
    def H(self) -> int:
        return self.beams

    @property
    def W(self) -> int:
        # reference: W = int(fov_hor / angle_res_hor)  (lidar_deform.py:277)
        return int(self.fov_hor / self.angle_res_hor)

    @classmethod
    def from_dict(cls, d: Mapping) -> "SensorSpec":
        beam_angles = d.get("beam_angles")
        if beam_angles is not None:
            beam_angles = tuple(sorted(
                float(np.deg2rad(b)) for b in beam_angles))
        return cls(
            name=str(d.get("name", "generic")),
            beams=int(d["beams"]),
            fov_up=float(d["fov_up"]),
            fov_down=float(d["fov_down"]),
            fov_hor=float(d.get("fov_hor", 360.0)),
            angle_res_hor=float(d["angle_res_hor"]),
            beam_angles=beam_angles,
        )

    @classmethod
    def from_yaml(cls, path: str) -> "SensorSpec":
        with open(path, "r") as f:
            return cls.from_dict(yaml.safe_load(f))

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "beams": self.beams,
            "fov_up": self.fov_up,
            "fov_down": self.fov_down,
            "fov_hor": self.fov_hor,
            "angle_res_hor": self.angle_res_hor,
        }
        if self.beam_angles is not None:
            d["beam_angles"] = [float(np.rad2deg(b))
                                for b in self.beam_angles]
        return d


# Common sensor presets.
HDL64 = SensorSpec(name="HDL64", beams=64, fov_up=3.0, fov_down=-25.0,
                   angle_res_hor=360.0 / 2048.0)
HDL32 = SensorSpec(name="HDL32", beams=32, fov_up=10.67, fov_down=-30.67,
                   angle_res_hor=360.0 / 2048.0)
VLP16 = SensorSpec(name="VLP16", beams=16, fov_up=15.0, fov_down=-15.0,
                   angle_res_hor=360.0 / 1024.0)


@dataclasses.dataclass(frozen=True)
class TransferConfig:
    """Tool-level configuration.

    Mirrors the reference tool config (config/lidar_transfer.yaml:1-16):
    transformation 4x4, adaption, number_of_scans, preserve_float,
    voxel_size, voxel_bounds, batch_interval, ignore, moving lists,
    plus labels and color_map.
    """

    adaption: str = "mergemesh"          # 'cp' | 'mesh' | 'mergemesh'
    number_of_scans: int = 1
    preserve_float: bool = True
    voxel_size: float = 0.05
    # rows x,y,z; cols min,max (meters)
    voxel_bounds: tuple[tuple[float, float], ...] = (
        (-50.0, 50.0), (-50.0, 50.0), (-5.0, 5.0))
    batch_interval: int = 1
    ignore_classes: tuple[int, ...] = DEFAULT_IGNORE_CLASSES
    moving_classes: tuple[int, ...] = DEFAULT_MOVING_CLASSES
    transformation: tuple[float, ...] = tuple(
        float(v) for v in np.eye(4).reshape(-1))
    labels: Mapping[int, str] = dataclasses.field(
        default_factory=lambda: dict(SEMANTICKITTI_LABELS))
    color_map_bgr: Mapping[int, Sequence[int]] = dataclasses.field(
        default_factory=lambda: dict(SEMANTICKITTI_COLOR_MAP_BGR))

    @property
    def nclasses(self) -> int:
        # reference: nclasses = len(color_dict)  (lidar_deform.py:359)
        return len(self.color_map_bgr)

    @property
    def transformation_matrix(self) -> np.ndarray:
        return np.asarray(self.transformation, dtype=np.float32).reshape(4, 4)

    @property
    def voxel_bounds_array(self) -> np.ndarray:
        return np.asarray(self.voxel_bounds, dtype=np.float32).reshape(3, 2)

    @classmethod
    def from_dict(cls, d: Mapping) -> "TransferConfig":
        kw: dict = {}
        if "adaption" in d:
            kw["adaption"] = str(d["adaption"])
        if "number_of_scans" in d:
            kw["number_of_scans"] = int(d["number_of_scans"])
        if "preserve_float" in d:
            kw["preserve_float"] = bool(d["preserve_float"])
        if "voxel_size" in d:
            kw["voxel_size"] = float(d["voxel_size"])
        if "voxel_bounds" in d:
            vb = np.asarray(d["voxel_bounds"], dtype=np.float32)
            # reference reshapes the flat [xmin xmax ymin ymax zmin zmax]
            # list to (3,2) (lidar_deform.py:347-350)
            kw["voxel_bounds"] = tuple(map(tuple, vb.reshape(3, 2)))
        if "batch_interval" in d:
            kw["batch_interval"] = int(d["batch_interval"])
        if "ignore" in d:
            kw["ignore_classes"] = tuple(int(c) for c in d["ignore"])
        if "moving" in d:
            kw["moving_classes"] = tuple(int(c) for c in d["moving"])
        if "transformation" in d:
            kw["transformation"] = tuple(
                float(v) for v in np.asarray(d["transformation"]).reshape(-1))
        if "labels" in d:
            kw["labels"] = {int(k): str(v) for k, v in d["labels"].items()}
        if "color_map" in d:
            kw["color_map_bgr"] = {
                int(k): tuple(v) for k, v in d["color_map"].items()}
        return cls(**kw)

    @classmethod
    def from_yaml(cls, path: str) -> "TransferConfig":
        with open(path, "r") as f:
            return cls.from_dict(yaml.safe_load(f))

    def to_dict(self) -> dict:
        return {
            "transformation": [float(v) for v in self.transformation],
            "adaption": self.adaption,
            "number_of_scans": self.number_of_scans,
            "preserve_float": self.preserve_float,
            "voxel_size": self.voxel_size,
            "batch_interval": self.batch_interval,
            "voxel_bounds": [
                float(v) for v in
                np.asarray(self.voxel_bounds).reshape(-1)],
            "ignore": list(self.ignore_classes),
            "moving": list(self.moving_classes),
            "labels": dict(self.labels),
            "color_map": {k: list(v) for k, v in self.color_map_bgr.items()},
        }

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f)


def make_color_lut(color_map_bgr: Mapping[int, Sequence[int]],
                   extra: int = 100) -> np.ndarray:
    """Dense (max_label_id+1+extra, 3) float32 LUT in [0,1].

    Equivalent to the reference's color LUT construction
    (auxiliary/laserscan.py:549-555): values / 255, +100 slack rows.
    Stays in the reference's BGR channel order.
    """
    max_key = max(color_map_bgr.keys()) + 1
    lut = np.zeros((max_key + extra, 3), dtype=np.float32)
    for key, value in color_map_bgr.items():
        lut[key] = np.asarray(value, np.float32) / 255.0
    return lut
