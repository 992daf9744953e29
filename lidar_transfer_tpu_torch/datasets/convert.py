"""Dataset converters: nuScenes / Ford Campus / NCLT -> KITTI layout (the
port's copy of ``lidar_transfer_tpu/datasets/convert.py``, numpy only,
writing through the port's ``datasets/kitti.py``; ``lt-convert-torch``).

Rebuild of the reference's ``auxiliary/convert/`` trio (SURVEY.md §2.1 C14)
with vectorized numpy IO instead of per-point ``struct.pack`` loops:

  - nuScenes (``nuscenes2kitti.py:12-106``): walk each scene's LIDAR_TOP
    chain, compose pose = ego_pose @ car_to_velo, rebase all poses to the
    first, min-max-normalize remission to [0,1], write .bin + poses.txt +
    dummy calib + original.txt. Requires the nuscenes devkit (gated import).
  - Ford (``ford2kitti.py:58-159``): .mat scans (SCAN.XYZ 3xN, SCAN.X_wv
    6-DoF x,y,z,roll,pitch,heading), rotate into the KITTI velodyne frame
    (rotZ(-90°), x forward), rebase to the first pose, zero remissions.
    Requires scipy (gated import).
  - NCLT (``nclt2kitti.py:21-88``): 8-byte records (uint16 x,y,z LE +
    uint8 intensity + uint8 laser id), 5 mm quantization with a -100 m
    offset, z negated (sensor mounted upside down).

Deviations from the reference (documented, deliberate):
  - everything is vectorized (`np.frombuffer` / `tofile`);
  - NCLT also gets a dummy calib.txt + identity poses.txt so the converted
    tree immediately loads in ``KittiSequence`` (the reference left that as
    a TODO — its output has no poses/calib);
  - Ford writes remission 0.0 like the reference, but in one array write.
"""

from __future__ import annotations

import os

import numpy as np

_DUMMY_CALIB = (
    "P0: 1 0 0 0 0 1 0 0 0 0 1 0\n"
    "P1: 1 0 0 0 0 1 0 0 0 0 1 0\n"
    "P2: 1 0 0 0 0 1 0 0 0 0 1 0\n"
    "P3: 1 0 0 0 0 1 0 0 0 0 1 0\n"
    "Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")


def write_dummy_calib(directory: str) -> None:
    """Identity calibration (≡ nuscenes2kitti.py:96-102)."""
    with open(os.path.join(directory, "calib.txt"), "w") as f:
        f.write(_DUMMY_CALIB)


def write_kitti_poses(filename: str, poses: np.ndarray) -> None:
    """(N,4,4) poses -> KITTI poses.txt (3x4 rows, first pose rebased).

    Rebasing here; the row serialization is kitti.write_poses' (one
    format for every poses.txt this repo emits)."""
    from lidar_transfer_tpu_torch.datasets.kitti import write_poses

    ref = np.linalg.inv(poses[0])
    write_poses(filename, np.einsum("ij,njk->nik", ref, poses))


# --------------------------------------------------------------------- NCLT

def nclt_decode(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Decode NCLT packed velodyne bytes -> (points (N,3) f32, rem (N,) f32).

    Record layout (≡ nclt2kitti.py:66-84): <u2 x, <u2 y, <u2 z, u1
    intensity, u1 laser-id. Distances were quantized at 5 mm with a +100 m
    offset (:21-30); the sensor is mounted upside down, so z is negated
    (:31-33). Trailing partial records are dropped like the reference's
    EOF break.
    """
    rec = np.dtype([("x", "<u2"), ("y", "<u2"), ("z", "<u2"),
                    ("i", "u1"), ("l", "u1")])
    n = len(raw) // rec.itemsize
    arr = np.frombuffer(raw, dtype=rec, count=n)
    scaling, offset = 0.005, -100.0
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = arr["x"].astype(np.float32) * scaling + offset
    pts[:, 1] = arr["y"].astype(np.float32) * scaling + offset
    pts[:, 2] = -(arr["z"].astype(np.float32) * scaling + offset)
    return pts, arr["i"].astype(np.float32)


def convert_nclt(input_dir: str, output_dir: str, scene_name: str,
                 verbose: bool = True) -> int:
    """Convert an NCLT velodyne tree to a KITTI sequence. Returns #scans."""
    from lidar_transfer_tpu_torch.datasets.kitti import (_sorted_files,
                                                    write_scan_file)

    scan_files = _sorted_files(input_dir, ".bin")

    scene_dir = os.path.join(output_dir, "sequences", scene_name)
    os.makedirs(os.path.join(scene_dir, "velodyne"), exist_ok=True)

    for idx, fname in enumerate(scan_files):
        with open(fname, "rb") as f:
            pts, rem = nclt_decode(f.read())
        write_scan_file(
            os.path.join(scene_dir, "velodyne", f"{idx:06d}.bin"), pts, rem)
        if verbose and idx % 100 == 0:
            print(f"NCLT scan {idx}/{len(scan_files)}")

    # usability addition: identity poses + calib so KittiSequence loads
    write_dummy_calib(scene_dir)
    eye = np.broadcast_to(np.eye(4), (max(len(scan_files), 1), 4, 4))
    write_kitti_poses(os.path.join(scene_dir, "poses.txt"), np.array(eye))
    return len(scan_files)


# --------------------------------------------------------------------- Ford

def rotxyz(r: float, p: float, h: float) -> np.ndarray:
    """Euler roll/pitch/heading -> 3x3 rotation (Ford X_wv convention,
    ≡ ford2kitti.py:20-34)."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    ch, sh = np.cos(h), np.sin(h)
    return np.array([
        [ch * cp, -sh * cr + ch * sp * sr, sh * sr + ch * sp * cr],
        [sh * cp, ch * cr + sh * sp * sr, -ch * sr + sh * sp * cr],
        [-sp, cp * sr, cp * cr]])


def rot_z(alpha: float) -> np.ndarray:
    c, s = np.cos(alpha), np.sin(alpha)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def ford_pose(x_wv: np.ndarray) -> np.ndarray:
    """6-DoF [x,y,z,r,p,h] -> 4x4 pose (≡ ford2kitti.py:49-56)."""
    x_wv = np.asarray(x_wv, np.float64).reshape(6)
    T = np.eye(4)
    T[:3, :3] = rotxyz(*x_wv[3:6])
    T[:3, 3] = x_wv[0:3]
    return T


def convert_ford(source: str, output_dir: str, sequence: str,
                 verbose: bool = True) -> int:
    """Convert a Ford Campus dataset (SCANS/*.mat) to a KITTI sequence.

    ≡ ford2kitti.py:58-159: KITTI-frame rotation rotZ(-90°) applied to the
    points, poses rebased to the first scan, remission written as 0.
    """
    import scipy.io  # gated: only needed for Ford

    from lidar_transfer_tpu_torch.datasets.kitti import write_scan_file

    scans_dir = os.path.join(source, "SCANS")
    scan_files = sorted(
        os.path.join(scans_dir, f) for f in os.listdir(scans_dir)
        if os.path.isfile(os.path.join(scans_dir, f)))
    if not scan_files:
        raise FileNotFoundError(f"no scan files under {scans_dir}")

    seq_dir = os.path.join(output_dir, "sequences", sequence)
    os.makedirs(os.path.join(seq_dir, "velodyne"), exist_ok=True)
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("Tr: 1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0 0.0\n")

    C = rot_z(np.deg2rad(-90.0))      # into KITTI velodyne frame, x forward
    poses = []
    ref_inv = None
    pose_fh = None
    n_written = 0
    for i, fname in enumerate(scan_files):
        # skip corrupt .mat files like the reference's per-scan
        # try/except (ford2kitti.py:155) — one bad scan must not abort
        # the run and strand the already-written tree without poses
        try:
            mat = scipy.io.loadmat(fname)
            scan = mat["SCAN"]
            pose = ford_pose(scan["X_wv"][0, 0])
            xyz = np.asarray(scan["XYZ"][0, 0], np.float64)  # (3, N)
        except Exception as e:          # noqa: BLE001 — matches reference
            print(f"Ford scan {fname}: skipped ({e})")
            continue
        poses.append(pose)
        pts = (C @ xyz).T.astype(np.float32)
        write_scan_file(
            os.path.join(seq_dir, "velodyne",
                         f"{n_written:06d}.bin"),
            pts, np.zeros(pts.shape[0], np.float32))
        n_written += 1
        # keep poses.txt in lockstep with the written scans (an
        # interrupted run leaves a loadable prefix tree) by APPENDING
        # one rebased row — rewriting the whole file per scan is O(N^2)
        # over a multi-thousand-scan log
        if ref_inv is None:
            ref_inv = np.linalg.inv(pose)
            pose_fh = open(os.path.join(seq_dir, "poses.txt"), "w")
        rel = ref_inv @ pose
        pose_fh.write(" ".join(
            f"{v:.6e}" for v in rel[:3, :4].reshape(-1)) + "\n")
        pose_fh.flush()
        if verbose and i % 50 == 0:
            print(f"Ford scan {i}/{len(scan_files)}")
    if pose_fh is not None:
        pose_fh.close()
    return n_written


# ----------------------------------------------------------------- nuScenes

def convert_nuscenes(dataroot: str, output_dir: str,
                     scene_name: str | None = None,
                     version: str = "v1.0-mini",
                     verbose: bool = True) -> dict[str, int]:
    """Convert nuScenes LIDAR_TOP chains to per-scene KITTI trees.

    ≡ nuscenes2kitti.py:12-106. Returns {scene_name: n_scans}. Requires the
    nuscenes devkit.
    """
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils.geometry_utils import transform_matrix
        from pyquaternion import Quaternion
    except ImportError as e:
        raise ImportError(
            "nuScenes conversion needs the nuscenes-devkit "
            "(pip install nuscenes-devkit)") from e

    nusc = NuScenes(version=version, dataroot=dataroot, verbose=verbose)
    name2id = {s["name"]: i for i, s in enumerate(nusc.scene)}
    if scene_name is not None:
        if scene_name not in name2id:
            raise ValueError(
                f"no scene {scene_name!r}; available: "
                f"{' '.join(name2id)}")
        names = [scene_name]
    else:
        names = list(name2id)

    out_counts: dict[str, int] = {}
    for name in names:
        # under sequences/<scene> so the converted tree loads directly in
        # KittiSequence / lt-compare-datasets, like the nclt/ford
        # converters (deviation from the reference nuscenes2kitti.py,
        # which wrote <out>/<scene> — a tree nothing here could open)
        scene_dir = os.path.join(output_dir, "sequences", name)
        velo_dir = os.path.join(scene_dir, "velodyne")
        os.makedirs(velo_dir, exist_ok=True)

        token = nusc.get(
            "sample",
            nusc.scene[name2id[name]]["first_sample_token"]
        )["data"]["LIDAR_TOP"]
        poses, original = [], []
        idx = 0
        while token:
            data = nusc.get("sample_data", token)
            calib = nusc.get("calibrated_sensor",
                             data["calibrated_sensor_token"])
            ego = nusc.get("ego_pose", data["ego_pose_token"])
            car_to_velo = transform_matrix(calib["translation"],
                                           Quaternion(calib["rotation"]))
            pose_car = transform_matrix(ego["translation"],
                                        Quaternion(ego["rotation"]))
            poses.append(pose_car @ car_to_velo)

            scan = np.fromfile(os.path.join(dataroot, data["filename"]),
                               dtype=np.float32).reshape(-1, 5)[:, :4].copy()
            lo, hi = scan[:, 3].min(), scan[:, 3].max()
            scan[:, 3] = (scan[:, 3] - lo) / max(hi - lo, 1e-12)
            out_name = f"{idx:05d}.bin"
            scan.tofile(os.path.join(velo_dir, out_name))
            original.append((out_name, data["filename"]))
            token = data["next"]
            idx += 1

        write_kitti_poses(os.path.join(scene_dir, "poses.txt"),
                          np.stack(poses))
        write_dummy_calib(scene_dir)
        with open(os.path.join(scene_dir, "original.txt"), "w") as f:
            for pair in original:
                f.write(f"{pair[0]}:{pair[1]}\n")
        out_counts[name] = idx
        if verbose:
            print(f"{name}: {idx} scans")
    return out_counts


# ----------------------------------------------------------------------- CLI

def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        "lt-convert", description="Convert foreign datasets to KITTI layout")
    p.add_argument("format", choices=["nclt", "ford", "nuscenes"])
    p.add_argument("source")
    p.add_argument("output")
    p.add_argument("--scene", default=None,
                   help="NCLT/Ford sequence name (required) or nuScenes "
                        "scene filter (optional).")
    p.add_argument("--version", default="v1.0-mini",
                   help="nuScenes dataset version.")
    args = p.parse_args(argv)

    if args.format == "nclt":
        if not args.scene:
            p.error("nclt requires --scene")
        n = convert_nclt(args.source, args.output, args.scene)
    elif args.format == "ford":
        if not args.scene:
            p.error("ford requires --scene")
        n = convert_ford(args.source, args.output, args.scene)
    else:
        counts = convert_nuscenes(args.source, args.output,
                                  scene_name=args.scene,
                                  version=args.version)
        n = sum(counts.values())
    print(f"{n} scans converted.")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
