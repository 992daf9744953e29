"""Iso-surface extraction from TSDF volumes (marching tetrahedra, numpy).

Copy of ``marching_tetrahedra``, ``marching_tetrahedra_cells``,
``dedupe_mesh`` and ``extract_mesh`` (with their helpers) of
``lidar_transfer_tpu/ops/marching.py``: that module is numpy alone, but its
package's ``__init__`` imports jax, so the port keeps its own copy
(``extract_mesh`` also takes a state of tensors, in any of the port's
storage dtypes). Each cell splits into 6 tetrahedra around its main diagonal;
every tet has 3 non-trivial sign patterns, derived in code, and triangle
winding follows the TSDF gradient (normals point to positive/outside).
Host-side: only surface cells are processed, so the cost scales with the
surface area, not the volume.
"""

from __future__ import annotations

import numpy as np

# cube corners numbered by bit pattern (x, y, z)
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
                    dtype=np.int64)

# 6-tetrahedra decomposition around the 0-7 main diagonal
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype=np.int64)


def _interp(p0, p1, v0, v1, level):
    """Linear interpolation of the level crossing between two corners."""
    t = (level - v0) / np.where(np.abs(v1 - v0) > 1e-12, v1 - v0, 1e-12)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return p0 + t * (p1 - p0)


def marching_tetrahedra(tsdf: np.ndarray, level: float = 0.0,
                        valid: np.ndarray | None = None) -> np.ndarray:
    """Extract the level surface as a triangle soup.

    Args:
      tsdf:  (X,Y,Z) float array
      level: iso level (0 for TSDF surfaces)
      valid: optional (X,Y,Z) bool — cells are only processed where all 8
             corners are valid (used to exclude never-observed +1 regions
             touching real negatives would still cross; the class-aware TSDF
             relies on exactly that +1/-x crossing, so default is all-valid)

    Returns:
      (T, 3, 3) float32 triangle vertices in *voxel grid* coordinates
      (multiply by voxel_size and add the volume origin for world coords,
      matching fusion_lidar.py:412).
    """
    X, Y, Z = tsdf.shape
    # candidate cells: sign change among the 8 corners
    v = tsdf
    cell_min = v[:-1, :-1, :-1]
    cell_max = v[:-1, :-1, :-1]
    for dx, dy, dz in _CORNERS[1:]:
        c = v[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        cell_min = np.minimum(cell_min, c)
        cell_max = np.maximum(cell_max, c)
    cand = (cell_min < level) & (cell_max >= level)
    if valid is not None:
        ok = valid[:-1, :-1, :-1].copy()
        for dx, dy, dz in _CORNERS[1:]:
            ok &= valid[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        cand &= ok
    idx = np.argwhere(cand)                      # (C, 3)
    if idx.shape[0] == 0:
        return np.zeros((0, 3, 3), np.float32)

    # corner positions and values for candidate cells
    pos = idx[:, None, :] + _CORNERS[None, :, :]        # (C, 8, 3)
    vals = v[pos[..., 0], pos[..., 1], pos[..., 2]]     # (C, 8)
    tri, _, n = _tet_triangles(pos.astype(np.float64), vals, level)
    if tri.shape[0] == 0:
        return np.zeros((0, 3, 3), np.float32)

    # orient consistently: normal should point toward increasing TSDF
    # (outside). Sample the gradient at the triangle centroid.
    cent = tri.mean(axis=1)
    grad = _tsdf_gradient(tsdf, cent)
    flip = (n * grad).sum(axis=1) < 0
    tri[flip] = tri[flip][:, ::-1, :]
    return tri.astype(np.float32)


def _tet_triangles(pos, vals, level):
    """Shared tet core: candidate-cell corners -> triangle soup.

    Args:
      pos:  (C, 8, 3) float corner positions (grid coords)
      vals: (C, 8) corner field values
    Returns:
      (tri (T,3,3) float64, cell (T,) int64 — source cell row of each
      triangle, n (T,3) unnormalized normals) with degenerate slivers
      dropped; triangles are NOT yet consistently oriented.
    """
    tris, cells = [], []
    for tet in _TETS:
        tv = vals[:, tet]                                # (C, 4)
        tp = pos[:, tet, :]                              # (C, 4, 3)
        inside = tv < level                              # (C, 4)
        n_in = inside.sum(axis=1)

        # case |S| == 1 or 3: one triangle around the lone corner
        for lone_inside in (True, False):
            n_target = 1 if lone_inside else 3
            sel = np.where(n_in == n_target)[0]
            if sel.size == 0:
                continue
            ins = inside[sel] if lone_inside else ~inside[sel]
            lone = np.argmax(ins, axis=1)                # (S,)
            others = np.array([[j for j in range(4) if j != k]
                               for k in range(4)])[lone]  # (S, 3)
            s_idx = np.arange(sel.size)
            p_lone = tp[sel, lone]
            v_lone = tv[sel, lone]
            tri = np.stack([
                _interp(p_lone, tp[sel][s_idx, others[:, k]],
                        v_lone, tv[sel][s_idx, others[:, k]], level)
                for k in range(3)], axis=1)              # (S, 3, 3)
            tris.append(tri)
            cells.append(sel)

        # case |S| == 2: quad between the two in/out pairs -> 2 triangles
        sel = np.where(n_in == 2)[0]
        if sel.size:
            ins = inside[sel]
            # indices of the two inside and two outside corners
            order = np.argsort(~ins, axis=1, kind="stable")
            a, b = order[:, 0], order[:, 1]      # inside
            c, d = order[:, 2], order[:, 3]      # outside
            s = np.arange(sel.size)
            tps, tvs = tp[sel], tv[sel]
            e_ac = _interp(tps[s, a], tps[s, c], tvs[s, a], tvs[s, c], level)
            e_ad = _interp(tps[s, a], tps[s, d], tvs[s, a], tvs[s, d], level)
            e_bc = _interp(tps[s, b], tps[s, c], tvs[s, b], tvs[s, c], level)
            e_bd = _interp(tps[s, b], tps[s, d], tvs[s, b], tvs[s, d], level)
            tris.append(np.stack([e_ac, e_ad, e_bd], axis=1))
            cells.append(sel)
            tris.append(np.stack([e_ac, e_bd, e_bc], axis=1))
            cells.append(sel)

    if not tris:
        z = np.zeros((0, 3, 3), np.float64)
        return z, np.zeros((0,), np.int64), np.zeros((0, 3), np.float64)
    tri = np.concatenate(tris, axis=0)
    cell = np.concatenate(cells, axis=0)

    # drop degenerate slivers
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area2 = np.linalg.norm(n, axis=1)
    keep = area2 > 1e-10
    return tri[keep], cell[keep], n[keep]


def _trilinear_gradient(vals, local):
    """Gradient of the cell's trilinear interpolant at local (u,v,w).

    ``vals`` (C, 8) corner values in _CORNERS bit order (index =
    x + 2y + 4z); ``local`` (C, 3) in [0,1]^3. Exact for the trilinear
    field the marching interpolation lives in — unlike the classic
    path's nearest-voxel central difference, it needs no volume access.
    """
    u, v, w = local[:, 0], local[:, 1], local[:, 2]
    c = vals

    def lerp2(a, b, t):
        return a + (b - a) * t

    # differences along each axis at the 4 opposite-face corner pairs,
    # bilinearly weighted by the other two coords
    dx = lerp2(lerp2(c[:, 1] - c[:, 0], c[:, 3] - c[:, 2], v),
               lerp2(c[:, 5] - c[:, 4], c[:, 7] - c[:, 6], v), w)
    dy = lerp2(lerp2(c[:, 2] - c[:, 0], c[:, 3] - c[:, 1], u),
               lerp2(c[:, 6] - c[:, 4], c[:, 7] - c[:, 5], u), w)
    dz = lerp2(lerp2(c[:, 4] - c[:, 0], c[:, 5] - c[:, 1], u),
               lerp2(c[:, 6] - c[:, 2], c[:, 7] - c[:, 3], u), v)
    return np.stack([dx, dy, dz], axis=1)


def marching_tetrahedra_cells(cell_idx: np.ndarray, cell_vals: np.ndarray,
                              level: float = 0.0,
                              return_cells: bool = False):
    """Marching tetrahedra over PRE-EXTRACTED candidate cells.

    The volume-free companion of ``marching_tetrahedra`` for surfaces
    whose candidate cells were compacted on device
    (``ops.surface.extract_surface_cells``) — the full volume never
    reaches the host. Geometry is identical to the classic path on the
    same candidate set (same tet decomposition, same interpolation, same
    emission order when ``cell_idx`` is in C order); triangle WINDING is
    oriented by the trilinear gradient of the cell's own corners at the
    triangle centroid instead of the classic nearest-voxel central
    difference — equivalent for the trilinear surface model, but the two
    may disagree on cells where the central difference samples beyond
    the cell.

    Args:
      cell_idx:  (C, 3) integer cell coordinates
      cell_vals: (C, 8) corner values in _CORNERS order
      return_cells: also return (T,) row-into-``cell_idx`` per triangle
                    (for attribute lookups without the volume)

    Returns:
      (T, 3, 3) float32 triangles in grid coords [, (T,) int64 cells].
    """
    empty = np.zeros((0, 3, 3), np.float32)
    if cell_idx.shape[0] == 0:
        return (empty, np.zeros((0,), np.int64)) if return_cells else empty
    # keep the field values in their native dtype: the classic path
    # interpolates in the volume's f32, and bitwise-identical triangles
    # require the same arithmetic here
    cell_vals = np.asarray(cell_vals)
    pos = cell_idx[:, None, :].astype(np.float64) + _CORNERS[None, :, :]
    tri, cell, n = _tet_triangles(pos, cell_vals, level)
    if tri.shape[0] == 0:
        return (empty, cell) if return_cells else empty
    local = tri.mean(axis=1) - cell_idx[cell].astype(np.float64)
    grad = _trilinear_gradient(cell_vals.astype(np.float64)[cell],
                               np.clip(local, 0.0, 1.0))
    flip = (n * grad).sum(axis=1) < 0
    tri[flip] = tri[flip][:, ::-1, :]
    tri = tri.astype(np.float32)
    return (tri, cell) if return_cells else tri


def _tsdf_gradient(tsdf: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Central-difference gradient at grid-space points (nearest voxel)."""
    X, Y, Z = tsdf.shape
    gi = np.clip(np.round(points).astype(np.int64),
                 1, np.array([X - 2, Y - 2, Z - 2]))
    gx = (tsdf[gi[:, 0] + 1, gi[:, 1], gi[:, 2]]
          - tsdf[gi[:, 0] - 1, gi[:, 1], gi[:, 2]])
    gy = (tsdf[gi[:, 0], gi[:, 1] + 1, gi[:, 2]]
          - tsdf[gi[:, 0], gi[:, 1] - 1, gi[:, 2]])
    gz = (tsdf[gi[:, 0], gi[:, 1], gi[:, 2] + 1]
          - tsdf[gi[:, 0], gi[:, 1], gi[:, 2] - 1])
    return np.stack([gx, gy, gz], axis=1)


def dedupe_mesh(tri: np.ndarray, decimals: int = 5,
                return_index: bool = False):
    """Triangle soup -> (verts (V,3), faces (T,3)) with shared vertices.

    Produces the indexed layout the reference's mesh consumers use
    (verts/faces arrays, fusion_lidar.py:434-436).
    ``return_index`` additionally returns (V,) soup-vertex indices such
    that ``verts == tri.reshape(-1, 3)[index]`` — the volume-free cells
    path uses it to map each kept vertex back to its source triangle
    (``index // 3``) for attribute lookups.
    """
    flat = tri.reshape(-1, 3)
    key = np.round(flat, decimals)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    verts = flat[first]
    faces = inv.reshape(-1, 3)
    if return_index:
        return verts.astype(np.float32), faces.astype(np.int32), first
    return verts.astype(np.float32), faces.astype(np.int32)


def _host(vol, dtype) -> np.ndarray:
    """A volume as a host array of ``dtype``: a numpy array, or a tensor
    in any storage dtype (a bf16 tensor through float32, exactly)."""
    if hasattr(vol, "detach"):
        vol = vol.detach().cpu()
        vol = (vol.float() if vol.is_floating_point() else vol.int()).numpy()
    return np.asarray(vol, dtype)


def extract_mesh(state, spec, color_lut: np.ndarray | None = None):
    """TSDF state -> (verts_world (V,3), faces (T,3), normals (V,3),
    labels (V,), remissions (V,)).

    ≡ ``TSDFVolume.get_mesh`` (fusion_lidar.py:403-424): vertices in world
    coords, per-vertex attributes gathered from the volume at the rounded
    vertex voxel (the reference gathers color/remission the same way,
    :409-418). Labels are integer ids (no packed-color round-trip).
    """
    tsdf = _host(state.tsdf, np.float32)
    labels = _host(state.label, np.int32)
    rems = _host(state.rem, np.float32)
    tri = marching_tetrahedra(tsdf, 0.0)
    verts, faces = dedupe_mesh(tri)

    gi = np.clip(np.round(verts).astype(np.int64), 0,
                 np.array(tsdf.shape) - 1)
    v_lbl = labels[gi[:, 0], gi[:, 1], gi[:, 2]]
    v_rem = rems[gi[:, 0], gi[:, 1], gi[:, 2]]

    grad = _tsdf_gradient(tsdf, verts.astype(np.float64))
    nrm = grad / np.maximum(np.linalg.norm(grad, axis=1, keepdims=True),
                            1e-12)

    verts_world = verts * spec.voxel_size + np.asarray(spec.origin,
                                                       np.float32)
    return (verts_world.astype(np.float32), faces, nrm.astype(np.float32),
            v_lbl.astype(np.int32), v_rem.astype(np.float32))
