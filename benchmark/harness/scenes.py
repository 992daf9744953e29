"""The benchmark's scans: an urban scene ray-cast on the card from the seed.

A frozen copy of the scene of ``lidar_transfer_tpu_torch/datasets/
synthetic.py`` (the primitives and ``Scene.urban``), whose ray-primitive
intersection is rewritten as PyTorch operations in float64 on the device:
one scan is a few dozen large operations instead of a host loop over
objects. ``simulate_scan`` returns what the port's numpy ``simulate_scan``
returns for the same scene, sensor and pose (``tests/test_perf_scans.py``
holds it to that on the CPU). ``write_sequence`` writes the scans as a
KITTI sequence, the form in which users hand a dataset to the program.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


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



def sensor_rays(beams: int, width: int, fov_up: float, fov_down: float
                ) -> np.ndarray:
    """(beams*width, 3) unit directions, row-major over (H, W): yaw =
    linspace(0, 360, W) + 180 (wrapped), pitch = linspace(fov_up,
    fov_down, H), as the reference's ``create_rays``."""
    yaw = np.linspace(0.0, 360.0, width) + 180.0
    yaw[yaw > 360.0] -= 360.0
    yaw = np.deg2rad(yaw)
    pitch = np.deg2rad(np.linspace(fov_up, fov_down, beams))
    colat = np.pi / 2.0 - pitch
    dirs = np.empty((beams, width, 3), dtype=np.float64)
    dirs[:, :, 0] = np.sin(colat)[:, None] * np.cos(-yaw)[None, :]
    dirs[:, :, 1] = np.sin(colat)[:, None] * np.sin(-yaw)[None, :]
    dirs[:, :, 2] = np.cos(colat)[:, None] * np.ones_like(yaw)[None, :]
    return dirs.reshape(-1, 3)


def straight_line_poses(n: int, step: float) -> np.ndarray:
    """(n, 4, 4) poses driving along +x with a gentle yaw wobble."""
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


def _first_hit(origins, dirs, scene: Scene):
    """Nearest hit of every ray over the ground and all primitives, in
    the port's object order (ground, boxes, cylinders, spheres: the first
    of equal t wins). -> (t (N,) inf on a miss, label (N,) int64)."""
    dev, f64 = dirs.device, torch.float64
    ts, labels = [], [scene.ground_label]
    dz = dirs[:, 2]
    t = (scene.ground_z - origins[:, 2]) / torch.where(dz != 0, dz, 1e-30)
    ts.append(torch.where((dz != 0) & (t > 1e-4), t, torch.inf))
    if scene.boxes:
        c = torch.tensor([b.center for b in scene.boxes], dtype=f64,
                         device=dev)
        h = torch.tensor([b.size for b in scene.boxes], dtype=f64,
                         device=dev) / 2.0
        lo, hi = c - h, c + h                                     # (B, 3)
        inv = 1.0 / torch.where(dirs != 0, dirs, 1e-30)           # (N, 3)
        t0 = (lo[None] - origins[:, None]) * inv[:, None]         # (N,B,3)
        t1 = (hi[None] - origins[:, None]) * inv[:, None]
        tmin = torch.minimum(t0, t1).amax(dim=2)
        tmax = torch.maximum(t0, t1).amin(dim=2)
        hit = tmax >= torch.clamp(tmin, min=1e-4)
        entry = torch.where(tmin > 1e-4, tmin, tmax)
        ts.extend(torch.where(hit, entry, torch.inf).unbind(1))
        labels += [b.label for b in scene.boxes]
    if scene.cylinders:
        cyl = scene.cylinders
        cxy = torch.tensor([c.center for c in cyl], dtype=f64, device=dev)
        rad = torch.tensor([c.radius for c in cyl], dtype=f64, device=dev)
        zr = torch.tensor([c.z_range for c in cyl], dtype=f64, device=dev)
        ox = origins[:, 0:1] - cxy[None, :, 0]
        oy = origins[:, 1:2] - cxy[None, :, 1]
        dx, dy = dirs[:, 0:1], dirs[:, 1:2]
        a = dx * dx + dy * dy
        b = 2.0 * (ox * dx + oy * dy)
        cc = ox * ox + oy * oy - rad[None] ** 2
        disc = b * b - 4 * a * cc
        ok = (disc >= 0) & (a > 1e-12)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        denom = torch.where(a > 1e-12, 2 * a, 1.0)
        best = torch.full_like(b, torch.inf)
        for t in ((-b - sq) / denom, (-b + sq) / denom):
            z = origins[:, 2:3] + t * dirs[:, 2:3]
            good = (ok & (t > 1e-4) & (z >= zr[None, :, 0])
                    & (z <= zr[None, :, 1]))
            best = torch.where(good & (t < best), t, best)
        ts.extend(best.unbind(1))
        labels += [c.label for c in cyl]
    if scene.spheres:
        sph = scene.spheres
        cen = torch.tensor([s.center for s in sph], dtype=f64, device=dev)
        rad = torch.tensor([s.radius for s in sph], dtype=f64, device=dev)
        oc = origins[:, None] - cen[None]                         # (N,S,3)
        b = 2.0 * (oc * dirs[:, None]).sum(dim=2)
        cc = (oc * oc).sum(dim=2) - rad[None] ** 2
        disc = b * b - 4.0 * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        near, far = (-b - sq) / 2.0, (-b + sq) / 2.0
        t = torch.where(near > 1e-4, near, far)
        ts.extend(torch.where((disc >= 0) & (t > 1e-4), t,
                              torch.inf).unbind(1))
        labels += [s.label for s in sph]
    best_t, which = torch.stack(ts, dim=1).min(dim=1)
    label = torch.tensor(labels, device=dev)[which]
    return best_t, torch.where(torch.isfinite(best_t), label, 0)


def simulate_scan(scene: Scene, dirs_s: torch.Tensor, pose: np.ndarray,
                  frame: float):
    """One scan at a world pose, the scene's movers placed for ``frame``.
    ``dirs_s``: the sensor's (N, 3) float64 directions on the device.
    -> (points in the sensor frame (M, 3) f32, remissions (M,) f32,
    labels (M,) int32) of the rays that hit within the scene's range."""
    scene = scene.at_frame(frame)
    pose_t = torch.as_tensor(pose, dtype=torch.float64, device=dirs_s.device)
    dirs_w = dirs_s @ pose_t[:3, :3].T
    origins = pose_t[:3, 3].expand_as(dirs_w)
    t, labels = _first_hit(origins, dirs_w, scene)
    hit = torch.isfinite(t) & (t <= scene.max_range)
    points = (dirs_s[hit] * t[hit][:, None]).to(torch.float32)
    labels = labels[hit].to(torch.int32)
    base = (labels % 97).to(torch.float32) / 97.0
    ripple = 0.1 * torch.sin(points[:, 2])
    rem = torch.clamp(base + ripple, 0.0, 0.999)
    return points, rem, labels


def write_sequence(root: str, scene: Scene, sensor: dict, n_scans: int,
                   step: float, device) -> str:
    """Simulate ``n_scans`` scans ``step`` metres apart along the scene's
    corridor and write them as sequence 00 of a KITTI tree under ``root``
    (``config.yaml``, ``sequences/00/{velodyne,labels,poses.txt,
    calib.txt}``, identity calibration). -> ``root``."""
    seq = os.path.join(root, "sequences", "00")
    for sub in ("velodyne", "labels"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        json.dump(sensor, f)        # JSON is YAML
    ident = "1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0 0.0"
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for key in ("P0", "P1", "P2", "P3", "Tr"):
            f.write(f"{key}: {ident}\n")
    poses = straight_line_poses(n_scans, step)
    with open(os.path.join(seq, "poses.txt"), "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.6e}" for v in p[:3, :4].reshape(-1)))
            f.write("\n")
    width = int(sensor["fov_hor"] / sensor["angle_res_hor"])
    dirs = torch.as_tensor(sensor_rays(
        sensor["beams"], width, sensor["fov_up"], sensor["fov_down"]),
        device=device)
    for i in range(n_scans):
        points, rem, labels = simulate_scan(scene, dirs, poses[i], i)
        scan = torch.cat([points, rem[:, None]], dim=1).cpu().numpy()
        scan.tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        labels.cpu().numpy().astype(np.uint32).tofile(
            os.path.join(seq, "labels", f"{i:06d}.label"))
    return root
