"""PLY mesh export (the port's own copy of
``lidar_transfer_tpu/utils/plyio.py``, numpy only).

≡ reference ``meshwrite`` (fusion_lidar.py:462-495) — same element layout
(vertex: xyz + normal + uchar rgb; face: vertex index list) — but binary or
ASCII and vectorized row formatting instead of per-vertex Python writes
(SURVEY.md hot loop (g))."""

from __future__ import annotations

import numpy as np


def write_ply(filename: str, verts: np.ndarray, faces: np.ndarray,
              normals: np.ndarray | None = None,
              colors: np.ndarray | None = None,
              binary: bool = True) -> None:
    """Write an indexed triangle mesh.

    Args:
      verts:   (V,3) float
      faces:   (T,3) int
      normals: optional (V,3) float (zeros if absent)
      colors:  optional (V,3) uint8 (white if absent)
    """
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32)
    n = (np.asarray(normals, np.float32) if normals is not None
         else np.zeros_like(v))
    c = (np.asarray(colors, np.uint8) if colors is not None
         else np.full((v.shape[0], 3), 255, np.uint8))

    fmt = "binary_little_endian" if binary else "ascii"
    header = "\n".join([
        "ply",
        f"format {fmt} 1.0",
        f"element vertex {v.shape[0]}",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element face {f.shape[0]}",
        "property list uchar int vertex_index",
        "end_header",
    ]) + "\n"

    if binary:
        vert_dt = np.dtype([("xyz", np.float32, 3), ("n", np.float32, 3),
                            ("rgb", np.uint8, 3)])
        vrec = np.empty(v.shape[0], vert_dt)
        vrec["xyz"], vrec["n"], vrec["rgb"] = v, n, c
        face_dt = np.dtype([("cnt", np.uint8), ("idx", np.int32, 3)])
        frec = np.empty(f.shape[0], face_dt)
        frec["cnt"] = 3
        frec["idx"] = f
        with open(filename, "wb") as fh:
            fh.write(header.encode())
            fh.write(vrec.tobytes())
            fh.write(frec.tobytes())
    else:
        with open(filename, "w") as fh:
            fh.write(header)
            rows = np.hstack([v, n, c.astype(np.int32)])
            np.savetxt(fh, rows,
                       fmt="%f %f %f %f %f %f %d %d %d")
            np.savetxt(fh, np.hstack([np.full((f.shape[0], 1), 3), f]),
                       fmt="%d")


def read_ply(filename: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal reader for meshes written by write_ply -> (verts, faces)."""
    with open(filename, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        nv = int(next(h for h in header if h.startswith("element vertex")
                      ).split()[-1])
        nf = int(next(h for h in header if h.startswith("element face")
                      ).split()[-1])
        binary = any("binary" in h for h in header)
        if binary:
            vert_dt = np.dtype([("xyz", np.float32, 3), ("n", np.float32, 3),
                                ("rgb", np.uint8, 3)])
            vrec = np.frombuffer(fh.read(nv * vert_dt.itemsize), vert_dt)
            face_dt = np.dtype([("cnt", np.uint8), ("idx", np.int32, 3)])
            frec = np.frombuffer(fh.read(nf * face_dt.itemsize), face_dt)
            return vrec["xyz"].copy(), frec["idx"].copy()
        # ndmin=2: loadtxt squeezes single-row blocks to 1-D; empty
        # blocks additionally come back (0, 1)-shaped, so short-circuit
        verts = (np.loadtxt(fh, max_rows=nv,
                            ndmin=2)[:, :3].astype(np.float32)
                 if nv else np.zeros((0, 3), np.float32))
        faces = (np.loadtxt(fh, max_rows=nf, ndmin=2)[:, 1:4]
                 .astype(np.int32) if nf else
                 np.zeros((0, 3), np.int32))
        return verts, faces
