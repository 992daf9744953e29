"""Surface-cell extraction from TSDF volumes on the volume's device (PyTorch).

Counterpart of ``lidar_transfer_tpu/ops/surface.py``. A mesh export only
needs the cells whose corners straddle the iso level, about 1 % of the
volume; at the reference operating point the whole state is 14 GB. So:

  pass 1 — per X-slab, an elementwise sweep marks candidate cells
           (corner min < level <= corner max) and lists them in C order
           (``nonzero``), on the volume's device;
  pass 2 — one gather fetches the 8 corner values (and corner labels on
           request) of the candidates, in the volume's native dtypes.

Only the candidates reach the host. The output feeds
``ops/marching.marching_tetrahedra_cells``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SurfaceCells(NamedTuple):
    """Compacted candidate cells (host numpy).

    idx:    (K, 3) int32 cell coordinates (cells span [idx, idx+1])
    vals:   (K, 8) float32 corner values, corner = x + 2y + 4z
    labels: (K, 8) int32 corner labels, or None
    """

    idx: np.ndarray
    vals: np.ndarray
    labels: np.ndarray | None


def _candidates(slab: torch.Tensor, level: float) -> torch.Tensor:
    """(C+1, Y, Z) slab -> (C, Y-1, Z-1) bool: the cell has a corner below
    ``level`` and one at or above it."""
    C1, Y, Z = slab.shape
    slab = slab.to(torch.float32)
    mn = mx = slab[:-1, :-1, :-1]
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = slab[dx:C1 - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
                mn = torch.minimum(mn, c)
                mx = torch.maximum(mx, c)
    return (mn < level) & (mx >= level)


def extract_surface_cells(tsdf: torch.Tensor, label: torch.Tensor = None,
                          *, level: float = 0.0, want_labels: bool = False,
                          x_chunk: int = 256) -> SurfaceCells:
    """Compact the volume's candidate surface cells.

    Args:
      tsdf:   (X, Y, Z) tensor (any float dtype)
      label:  (X, Y, Z) labels, required with ``want_labels``
      level:  iso level
      x_chunk: cell rows per slab; bounds the device temporaries

    Returns SurfaceCells (host numpy, f32/i32). Candidate order is the
    volume's C order, identical to ``np.argwhere`` on the full mask.
    """
    if want_labels and label is None:
        raise ValueError("label volume required for want_labels")
    X, Y, Z = tsdf.shape
    parts = []
    for x0 in range(0, X - 1, x_chunk):
        c = min(x_chunk, X - 1 - x0)
        idx = torch.nonzero(_candidates(tsdf[x0:x0 + c + 1], level))
        idx[:, 0] += x0
        parts.append(idx)
    idx = (torch.cat(parts) if parts
           else torch.zeros((0, 3), dtype=torch.int64, device=tsdf.device))
    base = (idx[:, 0] * Y + idx[:, 1]) * Z + idx[:, 2]
    # corner order x + 2y + 4z: z outer, x inner
    offs = torch.tensor([(dx * Y + dy) * Z + dz for dz in (0, 1)
                         for dy in (0, 1) for dx in (0, 1)],
                        device=tsdf.device)
    corners = base[:, None] + offs[None, :]                    # (K, 8)
    # native dtypes cross to the host; float32 holds bf16 exactly
    vals = tsdf.reshape(-1)[corners].cpu().to(torch.float32).numpy()
    labels = None
    if want_labels:
        labels = label.reshape(-1)[corners].cpu().to(torch.int32).numpy()
    return SurfaceCells(idx.to(torch.int32).cpu().numpy(), vals, labels)
