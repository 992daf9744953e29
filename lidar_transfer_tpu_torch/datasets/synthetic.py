"""Synthetic LiDAR scene generator (numpy, host-side; the port's own copy
of ``lidar_transfer_tpu/datasets/synthetic.py``).

The reference's de-facto integration fixture is ``minimal.zip`` (README:50-58)
— a stripped large blob not present here. This module replaces it with a
*procedural* KITTI-format dataset: an analytic scene (ground plane + boxes +
cylinders, each with a semantic class) is ray-cast exactly, so we can

  1. write .bin/.label/poses/calib trees for integration tests, and
  2. validate synthesized virtual scans against analytic ground truth for
     *any* target sensor spec — a stronger oracle than the reference ever had
     (SURVEY.md §4 implication (d)).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from lidar_transfer_tpu_torch.config import SensorSpec
from lidar_transfer_tpu_torch.datasets import kitti


@dataclasses.dataclass(frozen=True)
class Box:
    center: tuple[float, float, float]
    size: tuple[float, float, float]      # full extents
    label: int


@dataclasses.dataclass(frozen=True)
class Cylinder:
    center: tuple[float, float]           # x, y; axis = +z
    radius: float
    z_range: tuple[float, float]
    label: int


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Analytic sphere (vegetation canopies, bushes)."""

    center: tuple[float, float, float]
    radius: float
    label: int


@dataclasses.dataclass(frozen=True)
class Mover:
    """A box that translates by ``velocity`` meters per frame.

    Labels should come from SemanticKITTI's moving range 252-259 (the
    reference's ``moving`` list, config/lidar_transfer.yaml) so the
    multi-scan window masks it from non-primary scans
    (≡ laserscan.py:803-804) — the de-ghosting behavior that mask
    exists for."""

    box: Box                               # geometry at frame 0
    velocity: tuple[float, float, float]   # meters per frame

    def at_frame(self, frame: float) -> Box:
        c = self.box.center
        v = self.velocity
        return Box(center=(c[0] + v[0] * frame, c[1] + v[1] * frame,
                           c[2] + v[2] * frame),
                   size=self.box.size, label=self.box.label)


@dataclasses.dataclass(frozen=True)
class Scene:
    ground_z: float = -2.0
    ground_label: int = 40                # road
    boxes: tuple[Box, ...] = ()
    cylinders: tuple[Cylinder, ...] = ()
    spheres: tuple[Sphere, ...] = ()
    movers: tuple[Mover, ...] = ()        # dynamic objects (see Mover)
    max_range: float = 80.0

    def at_frame(self, frame: float) -> "Scene":
        """The static geometry this scene presents at ``frame`` (movers
        displaced to their positions and folded into ``boxes``)."""
        if not self.movers:
            return self
        return dataclasses.replace(
            self,
            boxes=self.boxes + tuple(m.at_frame(frame)
                                     for m in self.movers),
            movers=())

    @classmethod
    def default(cls) -> "Scene":
        """A small urban-ish scene: road, two buildings, a car, two trunks."""
        return cls(
            ground_z=-2.0,
            ground_label=40,
            boxes=(
                Box(center=(12.0, 6.0, 1.0), size=(8.0, 6.0, 6.0), label=50),
                Box(center=(-10.0, -8.0, 0.5), size=(6.0, 10.0, 5.0),
                    label=50),
                Box(center=(8.0, -3.0, -1.2), size=(4.0, 1.8, 1.6), label=10),
                Box(center=(-6.0, 4.0, -1.1), size=(3.8, 1.7, 1.5), label=10),
            ),
            cylinders=(
                Cylinder(center=(5.0, 10.0), radius=0.4, z_range=(-2.0, 4.0),
                         label=71),
                Cylinder(center=(-4.0, -12.0), radius=0.3,
                         z_range=(-2.0, 3.0), label=71),
            ),
        )

    @classmethod
    def urban(cls, seed: int = 0, dynamic: bool = True) -> "Scene":
        """A seeded rich urban scene with 13+ semantic classes (the
        multi-scene quality-statistics world; the analog of
        the reference's 11 KITTI sequences,
        experiments/grid_search_nframes_voxelsize.py:52-58).

        Classes emitted (SemanticKITTI ids, config/lidar_transfer.yaml's
        label map): 40 road (ground), 48 sidewalk, 72 terrain, 50
        building (varied L/stepped shapes), 51 fence, 52 other-structure,
        70 vegetation (canopies+bushes), 71 trunk, 80 pole, 81
        traffic-sign, 10 car, 18 truck, 11 bicycle, 30 person; with
        ``dynamic``: 252 moving-car and 253 moving-person movers.

        Layout is deterministic per ``seed``; the ego corridor
        (|y| < 2.6 for x in [-6, 36]) is kept clear of static geometry so
        ``straight_line_poses`` never drives inside an object (movers
        deliberately cross it).
        """
        rng = np.random.default_rng(seed)

        def u(lo, hi):
            return float(rng.uniform(lo, hi))

        def place(rmin=8.0, rmax=38.0, margin=3.2):
            """A ground spot outside the ego corridor."""
            for _ in range(64):
                x, y = u(-rmax, rmax), u(-rmax, rmax)
                if x * x + y * y < rmin * rmin:
                    continue
                if abs(y) < 2.6 + margin and -6.0 - margin < x < 36.0 + margin:
                    continue
                return x, y
            return rmax, rmax  # corner fallback (deterministic)

        gz = -2.0
        boxes: list[Box] = []
        cylinders: list[Cylinder] = []
        spheres: list[Sphere] = []

        # sidewalks (48): two strips flanking the road corridor
        for side in (-1.0, 1.0):
            boxes.append(Box(center=(15.0, side * u(4.5, 5.5), gz + 0.08),
                             size=(u(40.0, 55.0), u(2.5, 3.5), 0.16),
                             label=48))
        # terrain patches (72): low grass slabs farther out
        for _ in range(2):
            x, y = place(rmin=14.0)
            boxes.append(Box(center=(x, y, gz + 0.05),
                             size=(u(8.0, 16.0), u(6.0, 12.0), 0.1),
                             label=72))
        # buildings (50): 3-4, each 1-3 stacked/offset blocks (L-shapes,
        # stepped roofs — the "varied building shapes" requirement);
        # placement margin = the block's own half-extent + 0.5 so the
        # corridor-clearance invariant holds for any drawn size, and
        # wings stay INSIDE the parent footprint
        for _ in range(int(rng.integers(3, 5))):
            w, d = u(6.0, 14.0), u(5.0, 12.0)
            h = u(4.0, 12.0)
            x, y = place(rmin=10.0, margin=max(w, d) / 2 + 0.5)
            boxes.append(Box(center=(x, y, gz + h / 2), size=(w, d, h),
                             label=50))
            for _ in range(int(rng.integers(0, 3))):   # wing / step
                w2, d2 = u(3.0, w), u(2.5, d)
                h2 = u(2.5, max(2.6, h * 0.8))
                boxes.append(Box(
                    center=(x + u(-(w - w2) / 2, (w - w2) / 2),
                            y + u(-(d - d2) / 2, (d - d2) / 2),
                            gz + h2 / 2),
                    size=(w2, d2, h2), label=50))
        # fences (51): thin long runs near sidewalk edges
        for _ in range(2):
            run = u(8.0, 16.0)
            x, y = place(rmin=9.0, margin=run / 2 + 0.5)
            horiz = rng.random() < 0.5
            boxes.append(Box(
                center=(x, y, gz + 0.6),
                size=((run, 0.15, 1.2) if horiz
                      else (0.15, run, 1.2)), label=51))
        # other-structure (52): a bus-shelter-ish slab on posts
        x, y = place(rmin=9.0, margin=2.0)
        boxes.append(Box(center=(x, y, gz + 2.5), size=(3.0, 1.6, 0.2),
                         label=52))
        boxes.append(Box(center=(x, y, gz + 1.25), size=(0.2, 1.4, 2.5),
                         label=52))
        # trees: trunk (71) + canopy (70); bushes (70)
        for _ in range(int(rng.integers(3, 6))):
            x, y = place(rmin=8.0)
            th = u(2.0, 4.5)
            cylinders.append(Cylinder(center=(x, y), radius=u(0.2, 0.45),
                                      z_range=(gz, gz + th), label=71))
            spheres.append(Sphere(center=(x, y, gz + th + u(0.8, 1.8)),
                                  radius=u(1.2, 2.8), label=70))
        for _ in range(int(rng.integers(2, 4))):
            x, y = place(rmin=7.0)
            spheres.append(Sphere(center=(x, y, gz + u(0.3, 0.7)),
                                  radius=u(0.5, 1.1), label=70))
        # poles (80) + traffic signs (81 plate on a pole)
        for _ in range(int(rng.integers(2, 4))):
            x, y = place(rmin=6.0, margin=0.8)
            cylinders.append(Cylinder(center=(x, y), radius=u(0.06, 0.14),
                                      z_range=(gz, gz + u(4.0, 6.5)),
                                      label=80))
        x, y = place(rmin=6.0, margin=0.6)
        cylinders.append(Cylinder(center=(x, y), radius=0.08,
                                  z_range=(gz, gz + 3.0), label=80))
        boxes.append(Box(center=(x, y, gz + 3.2), size=(0.8, 0.1, 0.8),
                         label=81))
        # vehicles: cars (10), one truck (18), a bicycle (11)
        for _ in range(int(rng.integers(2, 4))):
            yaw_sz = ((u(3.6, 4.6), u(1.6, 1.9)) if rng.random() < 0.5
                      else (u(1.6, 1.9), u(3.6, 4.6)))
            x, y = place(rmin=6.0, margin=max(yaw_sz) / 2 + 0.5)
            boxes.append(Box(center=(x, y, gz + 0.75),
                             size=(yaw_sz[0], yaw_sz[1], 1.5), label=10))
        x, y = place(rmin=10.0, margin=4.5)
        boxes.append(Box(center=(x, y, gz + 1.6), size=(8.0, 2.5, 3.2),
                         label=18))
        x, y = place(rmin=5.0, margin=1.5)
        boxes.append(Box(center=(x, y, gz + 0.55), size=(1.7, 0.4, 1.1),
                         label=11))
        # static pedestrians (30): narrow vertical boxes
        for _ in range(int(rng.integers(1, 3))):
            x, y = place(rmin=5.0, margin=0.8)
            boxes.append(Box(center=(x, y, gz + 0.85),
                             size=(0.5, 0.5, 1.7), label=30))

        movers: tuple[Mover, ...] = ()
        if dynamic:
            movers = (
                # oncoming car crossing the ego corridor (252)
                Mover(box=Box(center=(u(12.0, 18.0), u(1.5, 2.5), gz + 0.8),
                              size=(4.2, 1.8, 1.6), label=252),
                      velocity=(-u(2.0, 3.0), 0.0, 0.0)),
                # pedestrian crossing the road (253) — the second mover
                # class
                Mover(box=Box(center=(u(8.0, 12.0), -u(4.0, 6.0),
                                      gz + 0.85),
                              size=(0.5, 0.5, 1.7), label=253),
                      velocity=(0.0, u(0.8, 1.4), 0.0)),
            )

        return cls(ground_z=gz, ground_label=40, boxes=tuple(boxes),
                   cylinders=tuple(cylinders), spheres=tuple(spheres),
                   movers=movers)

    @classmethod
    def default_dynamic(cls) -> "Scene":
        """The default scene plus an oncoming car (SemanticKITTI 252,
        moving-car): 2.5 m/frame along -x through the sensor's field —
        large per-frame displacement so a window that fuses stale
        positions produces unmistakable ghosts."""
        base = cls.default()
        return dataclasses.replace(
            base,
            movers=(Mover(box=Box(center=(14.0, 2.5, -1.2),
                                  size=(4.2, 1.8, 1.6), label=252),
                          velocity=(-2.5, 0.0, 0.0)),))


def _ray_ground(origins, dirs, ground_z):
    """t of intersection with plane z=ground_z; inf if none."""
    dz = dirs[:, 2]
    t = (ground_z - origins[:, 2]) / np.where(dz != 0, dz, 1e-30)
    return np.where((dz != 0) & (t > 1e-4), t, np.inf)


def _ray_box(origins, dirs, box: Box):
    """Slab test -> entry t; inf if miss (same math as a BBox slab test)."""
    c = np.asarray(box.center)
    h = np.asarray(box.size) / 2.0
    lo, hi = c - h, c + h
    inv = 1.0 / np.where(dirs != 0, dirs, 1e-30)
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    tmin = np.minimum(t0, t1).max(axis=1)
    tmax = np.maximum(t0, t1).min(axis=1)
    hit = (tmax >= np.maximum(tmin, 1e-4))
    # origin INSIDE the box (tmin <= eps < tmax): the nearest surface
    # along the ray is the exit face at tmax — returning inf would make
    # the oracle see THROUGH solid geometry for poses driven into an
    # object, silently inverting test verdicts
    entry = np.where(tmin > 1e-4, tmin, tmax)
    return np.where(hit, entry, np.inf)


def _ray_cylinder(origins, dirs, cyl: Cylinder):
    """Infinite-cylinder quadratic clipped to z_range; entry t or inf."""
    ox = origins[:, 0] - cyl.center[0]
    oy = origins[:, 1] - cyl.center[1]
    dx, dy = dirs[:, 0], dirs[:, 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyl.radius ** 2
    disc = b * b - 4 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = np.sqrt(np.maximum(disc, 0.0))
    denom = np.where(a > 1e-12, 2 * a, 1.0)
    # test BOTH quadratic roots against the z clip: a ray whose near
    # root lies outside z_range can still enter the clipped cylinder
    # wall at the far root (e.g. steep rays past the open cap)
    best = np.full(origins.shape[0], np.inf)
    for t in ((-b - sq) / denom, (-b + sq) / denom):
        z = origins[:, 2] + t * dirs[:, 2]
        good = ok & (t > 1e-4) & (z >= cyl.z_range[0]) \
            & (z <= cyl.z_range[1])
        best = np.where(good & (t < best), t, best)
    return best


def _ray_sphere(origins, dirs, sph: Sphere):
    """Sphere quadratic -> entry t (exit t if origin inside); inf if miss."""
    oc = origins - np.asarray(sph.center)
    b = 2.0 * (oc * dirs).sum(axis=1)
    c = (oc * oc).sum(axis=1) - sph.radius ** 2
    disc = b * b - 4.0 * c                      # dirs are unit: a == 1
    ok = disc >= 0
    sq = np.sqrt(np.maximum(disc, 0.0))
    near = (-b - sq) / 2.0
    far = (-b + sq) / 2.0
    t = np.where(near > 1e-4, near, far)        # inside -> exit surface
    return np.where(ok & (t > 1e-4), t, np.inf)


def raycast_scene(scene: Scene, origins: np.ndarray, dirs: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Exact nearest-hit raycast. -> (t (N,), label (N,) i32); misses: t=inf,
    label=0."""
    best_t = _ray_ground(origins, dirs, scene.ground_z)
    best_l = np.where(np.isfinite(best_t), scene.ground_label, 0)
    for obj in (list(scene.boxes) + list(scene.cylinders)
                + list(scene.spheres)):
        if isinstance(obj, Box):
            t = _ray_box(origins, dirs, obj)
        elif isinstance(obj, Cylinder):
            t = _ray_cylinder(origins, dirs, obj)
        else:
            t = _ray_sphere(origins, dirs, obj)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        best_l = np.where(closer, obj.label, best_l)
    too_far = best_t > scene.max_range
    best_t = np.where(too_far, np.inf, best_t)
    best_l = np.where(too_far, 0, best_l)
    return best_t, best_l.astype(np.int32)


def sensor_rays(spec: SensorSpec) -> np.ndarray:
    """(H*W, 3) unit ray directions for a sensor spec, row-major over (H,W).

    Beam pattern matches the reference's ``create_rays``
    (laserscan.py:1092-1119): yaw = linspace(0,360,W)+180 (wrapped), pitch =
    linspace(fov_up, fov_down, H); direction from (pi/2 - pitch) colatitude.
    """
    initial = 180.0
    yaw = np.linspace(0.0, 360.0, spec.W) + initial
    yaw[yaw > 360.0] -= 360.0
    yaw = np.deg2rad(yaw)
    pitch = np.deg2rad(np.linspace(spec.fov_up, spec.fov_down, spec.beams))
    colat = np.pi / 2.0 - pitch
    dirs = np.empty((spec.beams, spec.W, 3), dtype=np.float64)
    dirs[:, :, 0] = np.sin(colat)[:, None] * np.cos(-yaw)[None, :]
    dirs[:, :, 1] = np.sin(colat)[:, None] * np.sin(-yaw)[None, :]
    dirs[:, :, 2] = np.cos(colat)[:, None] * np.ones_like(yaw)[None, :]
    return dirs.reshape(-1, 3)


def remission_for(labels: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Deterministic synthetic remission in [0,1): label-keyed + z ripple."""
    base = (labels % 97).astype(np.float32) / 97.0
    ripple = 0.1 * np.sin(points[:, 2].astype(np.float32))
    return np.clip(base + ripple, 0.0, 0.999).astype(np.float32)


def simulate_scan(scene: Scene, spec: SensorSpec, pose: np.ndarray,
                  drop_misses: bool = True, frame: float = 0.0,
                  range_noise: float = 0.0, dropout: float = 0.0,
                  seed: int = 0
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Simulate one scan at a world pose. -> (points(sensor frame) (N,3) f32,
    remissions (N,), labels (N,) i32).

    ``frame`` places the scene's movers at their positions for that
    frame (``Scene.at_frame``); static scenes ignore it.

    Sensor-realism knobs (the "harder synthetic world" stand-in for the
    missing real-data gate): ``range_noise`` adds per-return Gaussian
    range error (sigma in meters; real spinning LiDARs sit around
    0.02-0.03 m), ``dropout`` drops each return independently with that
    probability (absorbing surfaces / outliers the sensor's firmware filters).
    Deterministic per ``seed``."""
    scene = scene.at_frame(frame)
    dirs_s = sensor_rays(spec)
    rot = pose[:3, :3]
    trans = pose[:3, 3]
    dirs_w = dirs_s @ rot.T
    origins = np.broadcast_to(trans, dirs_w.shape)
    t, labels = raycast_scene(scene, origins, dirs_w)
    hit = np.isfinite(t)
    if range_noise > 0.0 or dropout > 0.0:
        nrng = np.random.default_rng(seed)
        if range_noise > 0.0:
            t = np.where(hit, t + nrng.normal(0.0, range_noise, t.shape),
                         t)
        if dropout > 0.0:
            hit &= nrng.random(t.shape) >= dropout
            t = np.where(hit, t, np.inf)
    if drop_misses:
        t, labels, dirs_s = t[hit], labels[hit], dirs_s[hit]
    else:
        t = np.where(hit, t, 0.0)
        labels = np.where(hit, labels, 0)
    points = (dirs_s * t[:, None]).astype(np.float32)
    rem = remission_for(labels, points)
    return points, rem, labels


def straight_line_poses(n: int, step: float = 1.5) -> np.ndarray:
    """(n,4,4) poses driving along +x with a gentle yaw wobble."""
    poses = np.zeros((n, 4, 4), dtype=np.float64)
    for i in range(n):
        ang = 0.02 * np.sin(i * 0.7)
        ca, sa = np.cos(ang), np.sin(ang)
        poses[i] = np.array([
            [ca, -sa, 0.0, step * i],
            [sa, ca, 0.0, 0.1 * np.sin(i * 0.5)],
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ])
    return poses


def write_kitti_dataset(root: str, scene: Scene, spec: SensorSpec,
                        n_scans: int = 5, sequence: str = "00",
                        step: float = 1.5, range_noise: float = 0.0,
                        dropout: float = 0.0) -> str:
    """Write a synthetic KITTI-format dataset tree (the minimal.zip stand-in).

    Layout: <root>/config.yaml + <root>/sequences/<seq>/{velodyne,labels,
    poses.txt, calib.txt}. Poses are written through an identity Tr calib so
    parse_poses round-trips them. ``range_noise``/``dropout`` add sensor
    realism per scan (``simulate_scan``; the per-frame seed varies so
    noise is independent across scans).
    """
    seq_dir = os.path.join(root, "sequences", sequence)
    os.makedirs(os.path.join(seq_dir, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "labels"), exist_ok=True)

    import yaml
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(spec.to_dict(), f)

    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        ident = "1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0 0.0"
        for key in ["P0", "P1", "P2", "P3", "Tr"]:
            f.write(f"{key}: {ident}\n")

    poses = straight_line_poses(n_scans, step)
    calib = kitti.parse_calibration(os.path.join(seq_dir, "calib.txt"))
    kitti.write_poses(os.path.join(seq_dir, "poses.txt"), poses, calib)

    for i in range(n_scans):
        points, rem, labels = simulate_scan(
            scene, spec, poses[i], frame=i,
            range_noise=range_noise, dropout=dropout, seed=1000 + i)
        kitti.write_scan_file(
            os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"), points, rem)
        kitti.write_label_file(
            os.path.join(seq_dir, "labels", f"{i:06d}.label"), labels)
    return root
