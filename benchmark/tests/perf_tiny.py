"""Cells of the benchmark cut to a size the CPU tests can run: the
cell's own files with narrow scans, four of them (training: as many as
its checked steps take), and a two-stage network. The loops, the references and the checks are the benchmark's."""

from __future__ import annotations

import copy
import dataclasses

from harness.common import find_cell

WIDTH = 256
TINY_NET = {"stem_features": 16, "stage_blocks": [1, 1],
            "stage_features": [32, 64]}


def _narrow(sensor: dict) -> dict:
    return dict(sensor, angle_res_hor=360.0 / WIDTH)


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json cut to the CPU tests' size."""
    cell = copy.deepcopy(find_cell(name))
    cfg, tr = cell.config, cell.traffic
    cfg["sensor"] = _narrow(cfg["sensor"])
    if "stage_blocks" in cfg:
        cfg.update(TINY_NET)
    tr["scans"] = 4
    for key, value in (("warmup_frames", 2), ("warmup_scans", 2),
                       ("host_stack", 2), ("batch", 2),
                       ("sample_gap", 1), ("samples", 4)):
        if key in tr:
            tr[key] = value
    if "checked_steps" in tr:   # the cell's checked steps, on distinct scans
        tr["scans"] = tr["checked_steps"] * tr["batch"]
    return dataclasses.replace(cell, config=cfg, traffic=tr)
