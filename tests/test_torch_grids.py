"""The quality grids (``lidar_transfer_tpu_torch/experiments/grids.py``)
against the JAX package's ``grid_search`` on the same tree.

Two small urban sequences (``synthetic.Scene.urban(0)`` and ``(1)``, 3
scans of a 32 x 512 sensor whose beams lie 0.5 deg inside the configured
FOV, as a real sensor's: a beam on the FOV's edge is kept or lost on the
last ulp of asin, ROADMAP queue 3) run the identity mergemesh cells at
frames [1, 2] x voxel [0.25, 0.1] through the ``multiscene`` runner and
JAX's ``grid_search(sequences=("00", "01"))``, and sequence 00 through the
``full`` runner. Tolerances: each cell's iou and acc, and their ``_std``,
``_min`` and ``_max`` across the sequences, within 1e-3 (an atan2 or asin
ulp at a pixel boundary may move <= 0.1 % of pixels); mse within 1e-4
relative (measured: acc equal, iou within 1e-7, mse within 1e-6
relative). The runners' defaults are the scripts' apart from the
documented flags.
"""

import dataclasses
import json
import os

import pytest
import torch
import yaml

from lidar_transfer_tpu.experiments.grid_search import (
    grid_search as j_grid_search)
from lidar_transfer_tpu_torch.config import SensorSpec
from lidar_transfer_tpu_torch.datasets import synthetic
from lidar_transfer_tpu_torch.experiments import grids
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_scripts import parser_defaults, script_defaults
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


SPEC = SensorSpec(name="u32", beams=32, fov_up=5.0, fov_down=-24.0,
                  angle_res_hor=360.0 / 512.0)
AXES = dict(frames_list=[1, 2], voxel_sizes=[0.25, 0.1])
SEQS = ("00", "01")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The two sequences and JAX's grid over them."""
    root = str(tmp_path_factory.mktemp("grids"))
    inside = dataclasses.replace(SPEC, fov_up=SPEC.fov_up - 0.5,
                                 fov_down=SPEC.fov_down + 0.5)
    for i, seq in enumerate(SEQS):
        synthetic.write_kitti_dataset(root, synthetic.Scene.urban(i), inside,
                                      n_scans=3, sequence=seq)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(SPEC.to_dict(), f)
    want = j_grid_search(root, sequences=SEQS, frames_per_cell=1, offset=0,
                         adaption="mergemesh", verbose=False, **AXES)
    return root, want


def _close(got, want, what):
    for key in ("iou", "acc"):
        assert abs(got[key] - want[key]) <= 1e-3, (what, key)
    assert abs(got["mse"] - want["mse"]) <= 1e-4 * abs(want["mse"]), what


def _argv(grid, root, out, *extra):
    return [grid, "--dataset", root, "--out", out, "--device", "cpu",
            "--frames-list", "1", "2", "--voxel-sizes", "0.25", "0.1",
            *extra]


def test_multiscene_cells_match_jax(tree, tmp_path, capsys):
    root, want = tree
    out = str(tmp_path / "grid")
    assert grids.main(_argv("multiscene", root, out, "--scenes", "2")) == 0
    with open(os.path.join(out, "grid_search.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted([*want, "device"])
    assert got["device"] == "cpu"
    assert got["grid"] == dict(want["grid"], frames_list=[1, 2],
                               voxel_sizes=[0.25, 0.1])
    assert len(got["cells"]) == len(want["cells"]) == 4
    for g, w in zip(got["cells"], want["cells"]):
        cell = (g["number_of_scans"], g["voxel_size"])
        assert cell == (w["number_of_scans"], w["voxel_size"])
        assert sorted(g) == sorted(w)
        _close(g, w, cell)
        for key in ("iou", "acc"):
            for stat in ("_std", "_min", "_max"):
                assert abs(g[key + stat] - w[key + stat]) <= 1e-3, \
                    (cell, key + stat)
        for seq in SEQS:
            assert sorted(g["sequences"][seq]) == sorted(w["sequences"][seq])
            assert g["sequences"][seq]["frames"] == 1
            _close(g["sequences"][seq], w["sequences"][seq], (cell, seq))
    assert os.path.exists(os.path.join(out, "heatmap_iou.svg"))
    # each cell's line names its wall time (no peak memory on the CPU)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("nscans=")]
    assert len(lines) == 4 and all(ln.endswith(" s)") for ln in lines)


def test_full_cells_match_jax(tree, tmp_path):
    """The ``full`` runner at one frame a cell on sequence 00: JAX's
    per-sequence entries of the same cells."""
    root, want = tree
    out = str(tmp_path / "grid")
    assert grids.main(_argv("full", root, out, "--frames-per-cell",
                            "1")) == 0
    with open(os.path.join(out, "grid_search.json")) as f:
        got = json.load(f)
    assert got["grid"]["sequences"] == ["00"]
    for g, w in zip(got["cells"], want["cells"]):
        assert "iou_std" not in g
        _close(g, w["sequences"]["00"], (g["number_of_scans"],
                                         g["voxel_size"]))


@pytest.mark.parametrize("grid,script", [
    ("full", "scripts/run_grid_full.py"),
    ("multiscene", "scripts/run_grid_multiscene.py")])
def test_defaults_match_the_scripts(grid, script, tmp_path, monkeypatch):
    """Every flag's default is the script's apart from ``--cpu``
    (``--device``), ``--out`` and ``--dataset`` (under ``--work``); no
    card, exit 2 with nothing written."""
    ref = script_defaults(script)
    sub = next(a for a in grids.build_parser()._actions
               if a.dest == "grid").choices[grid]
    got = parser_defaults(sub)
    for flag in set(ref) - {"--cpu", "--out", "--dataset"}:
        assert got[flag] == ref[flag], flag
    assert got["--device"] == "cuda" and got["--out"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert grids.main([grid, "--work", str(tmp_path / "w")]) == 2
    assert not os.path.exists(tmp_path / "w")
