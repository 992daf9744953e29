"""Measurement probes of the TSDF integrate on the card.

Counterparts of the JAX package's probe scripts, each a hand-written CUDA
kernel beside its plain PyTorch version, at the scripts' own shape
(1024x1024x256, 268 M voxels):

  parts   ``scripts/probe_kernel_parts.py``      (:mod:`.parts`)
  ablate  ``scripts/probe_integrate_ablate.py``  (:mod:`.ablate`)
  alias   ``scripts/probe_alias.py``             (:mod:`.write`)
  write   ``scripts/probe_pallas_write.py``      (:mod:`.write`)

Run them on the card with ``python -m lidar_transfer_tpu_torch.probes
[parts|ablate|alias|write|all]``.
"""

from __future__ import annotations

PROBES = ("parts", "ablate", "alias", "write")


def run(which=PROBES, iters: int = 50, tag: str = "") -> list[dict]:
    """Run the named probes on the card; -> every row as a dict (probe,
    row, kernel ms, plain ms, rate, largest difference to the plain
    version)."""
    from lidar_transfer_tpu_torch.probes import ablate, parts, write

    runners = {"parts": parts.run, "ablate": ablate.run,
               "alias": write.run_alias, "write": write.run_write}
    rows = []
    for name in which:
        rows += runners[name](iters=iters, tag=tag)
    return rows
