"""The partition of the ablate and parts probe kernels
(``csrc/probe_runs.cuh``), computed on the host.

An (X, Y, Z) volume is cut into runs of COLS consecutive (x, y) columns
(the last may be short); each warp walks ``bx`` of them in turn (warp w of
the grid's G takes runs w, w + G, ...), a block holds WARPS warps, and a
lane moves ``vec`` voxels per access: 8, or 4 or 1 where a last run ends
inside a wider vector or a pointer is off its alignment. The wrappers
build their launch from :func:`run_plan`; the CPU tests walk it with
:func:`run_walk` as the kernels walk it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: columns of a run, warps of a block, the voxels a lane may move per
#: access (widest first)
COLS, WARPS, VECS = 8, 8, (8, 4, 1)


class RunPlan(NamedTuple):
    """``runs`` of COLS columns, ``bx`` of them a warp, ``grid`` blocks of
    WARPS warps, ``vec`` voxels a lane moves per access."""

    runs: int
    bx: int
    grid: int
    vec: int


def run_plan(X: int, Y: int, Z: int, BX: int = 2, table_align: int = 16,
             out_align: int = 16, name: str = "probe") -> RunPlan:
    """The partition a wrapper launches; ``table_align`` and ``out_align``:
    the bytes a byte table's and the 2-byte outputs' pointers are aligned
    to (a lane's vec table bytes and 2 * vec output bytes move as one
    access)."""
    if BX < 1:
        raise ValueError(f"{name}: BX={BX} must be >= 1")
    cols = X * Y
    runs = -(-cols // COLS)
    grid = -(-runs // (WARPS * BX))
    vec = next(v for v in VECS if v == 1 or (
        (Z % v == 0 or cols % COLS == 0) and table_align % v == 0
        and out_align % (2 * v) == 0))
    return RunPlan(runs, BX, grid, vec)


def align_of(ptr: int) -> int:
    """The largest power of two up to 16 that divides ``ptr``."""
    return min(16, ptr & -ptr) if ptr else 16


def run_walk(plan: RunPlan, X: int, Y: int, Z: int):
    """What each warp of ``plan`` does, run by run, as the kernels walk:
    yields (run, folded, stored, rows), arrays of the voxel indices
    (into the flat (X, Y, Z) volume) the lanes fold, store and whose table
    rows they load, in the kernel's order of chunks and steps. The fold's
    index comes from the kernel's carry walk of (column, z)."""
    cols = X * Y
    lanes = np.arange(32)
    warps = plan.grid * WARPS
    for warp in range(warps):
        for k in range(plan.bx):
            run = warp + k * warps
            col0 = run * COLS
            if col0 >= cols:
                break
            n = min(COLS, cols - col0) * Z
            base = col0 * Z
            c, z = lanes // Z, lanes % Z
            folded, stored, rows = [], [], []
            chunk = 32 * plan.vec
            for i0 in range(0, n, chunk):
                starts = i0 + lanes * plan.vec
                have = starts < n
                rows.append(base + (starts[have, None]
                                    + np.arange(plan.vec)).ravel())
                for j in range(plan.vec):
                    i = i0 + j * 32 + lanes
                    live = i < n
                    folded.append(base + c[live] * Z + z[live])
                    if plan.vec == 1:
                        stored.append(base + i[live])
                    z = z + 32
                    while (z >= Z).any():
                        c = np.where(z >= Z, c + 1, c)
                        z = np.where(z >= Z, z - Z, z)
                if plan.vec > 1:
                    stored.append(rows[-1])
            yield (run, np.concatenate(folded), np.concatenate(stored),
                   np.concatenate(rows))
