"""The upsampling workflow (``lidar_transfer_tpu_torch/experiments/
upsample.py``) against the JAX package's ``scripts/run_upsample_workflow.py``.

The fake 2x dataset: the same 32-beam tree goes through the port's and
JAX's ``generate_fake_dataset`` with the runner's 64-beam target yaml and
transfer config (mergemesh, voxel 0.1 m, here +-8 m). Each fake scan is
projected back onto the target's 64 x W grid. Tolerances: label and mask
equal on >= 99.9 % of pixels, range within 1e-4 m where both hold a point
(measured: every pixel equal, range within 1.9e-6 m). The source's beams
lie 0.5 deg inside the configured FOV, as a real sensor's: with a beam on
the FOV's lower edge (the runner's own synthetic sensor) the two packages
keep or lose that row's points on the last ulp of asin (measured 99.88 %
at 64 x 128, all in the bottom row; ROADMAP, queue 3). The chord counts
and the 4-row cap of the engine are JAX's, warning where JAX warns. The
runner's rows, their JSON keys and the flags' defaults are the script's.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch
import yaml

from lidar_transfer_tpu.config import SensorSpec as JSensorSpec
from lidar_transfer_tpu.config import TransferConfig as JTransferConfig
from lidar_transfer_tpu.experiments.workflows import (
    generate_fake_dataset as j_generate_fake_dataset)
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu_torch.config import SensorSpec
from lidar_transfer_tpu_torch.datasets import kitti, synthetic
from lidar_transfer_tpu_torch.experiments import upsample
from lidar_transfer_tpu_torch.experiments.workflows import (
    generate_fake_dataset)
from lidar_transfer_tpu_torch.models import RangeNetConfig
from lidar_transfer_tpu_torch.ops import projection as TP
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_scripts import REPO, parser_defaults, script_defaults


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


WIDTH = 128
ARGS = upsample.build_parser().parse_args(["--width", str(WIDTH)])


def _project(root, idx, spec):
    seq = kitti.KittiSequence.open(root)
    pts, rem, lbl = seq.read(idx)
    cap = kitti.scan_capacity(pts.shape[0] + 1)
    p, r, l, m = (torch.from_numpy(a)
                  for a in kitti.pad_points(pts, rem, lbl, cap))
    return TP.range_project(p, r, l, m, H=spec.H, W=spec.W,
                            fov_up_deg=spec.fov_up,
                            fov_down_deg=spec.fov_down)


def test_fake_dataset_matches_jax(tmp_path):
    spec_s, spec_t = upsample.sensors(ARGS)
    real = str(tmp_path / "real32")
    inside = dataclasses.replace(spec_s, fov_up=spec_s.fov_up - 0.5,
                                 fov_down=spec_s.fov_down + 0.5)
    synthetic.write_kitti_dataset(real, synthetic.Scene.default(), inside,
                                  n_scans=2, step=1.0)
    with open(os.path.join(real, "config.yaml"), "w") as f:
        yaml.safe_dump(spec_s.to_dict(), f)
    tgt = str(tmp_path / "target64.yaml")
    with open(tgt, "w") as f:
        yaml.safe_dump(spec_t.to_dict(), f)
    cfg = upsample.transfer_config(8.0)
    got = generate_fake_dataset(real, str(tmp_path / "fake"), cfg,
                                target_yaml=tgt, verbose=False,
                                device="cpu")
    want = j_generate_fake_dataset(
        real, str(tmp_path / "jfake"),
        JTransferConfig(**dataclasses.asdict(cfg)), target_yaml=tgt,
        verbose=False)
    assert SensorSpec.from_yaml(os.path.join(got, "config.yaml")) == spec_t
    for idx in range(2):
        a, b = _project(got, idx, spec_t), _project(want, idx, spec_t)
        same = (a.label == b.label) & (a.mask == b.mask)
        assert float(same.float().mean()) >= 0.999, idx
        both = a.mask & b.mask
        # the chords filled rows between the source's beams: far more
        # target pixels than the source has rows for
        assert int(both.sum()) > 0.6 * spec_s.H * spec_s.W
        assert float((a.range - b.range)[both].abs().max()) <= 1e-4


@pytest.mark.parametrize("src_beams", [32, 16])
@pytest.mark.parametrize("table", [False, True])
def test_chord_counts_match_jax(src_beams, table):
    """The 2x and 4x shapes: interior rows (1 and 4) and columns (0), the
    rows a chord bridges and the cap's warning, as JAX's engine computes
    them; with a beam table whose gap between two beams spans 6 rows the
    cap at 4 warns in both, and without one no chord spans more than a
    row."""
    args = upsample.build_parser().parse_args(
        ["--src-beams", str(src_beams)])
    spec_s, spec_t = upsample.sensors(args)
    if table:
        # half the beams a row apart from the top, the rest half a row
        # apart from 6 rows further down: a gap of 6 rows
        n = src_beams // 2
        rows = np.concatenate([np.arange(n), n + 5 + 0.5 * np.arange(n)])
        fov = spec_s.fov_up - spec_s.fov_down
        deg = spec_s.fov_up - (rows + 0.5) / src_beams * fov
        spec_s = dataclasses.replace(
            spec_s, beam_angles=tuple(np.radians(np.sort(deg)).tolist()))
    cfg = upsample.transfer_config(8.0)
    caught = []
    for make in (
            lambda: JD.TransferEngine(
                JSensorSpec(**dataclasses.asdict(spec_s)),
                JSensorSpec(**dataclasses.asdict(spec_t)),
                JTransferConfig(**dataclasses.asdict(cfg)), 4096),
            lambda: TD.TransferEngine(spec_s, spec_t, cfg, device="cpu")):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng = make()
        caught.append(([str(x.message) for x in w
                        if "chord interpolation" in str(x.message)],
                       (eng._interp_mv, eng._interp_mu,
                        eng._interp_vspan)))
    assert caught[0] == caught[1]
    mv, mu, vspan = caught[1][1]
    assert mu == 0
    if not table:
        assert mv == {32: 1, 16: 4}[src_beams]
    assert (vspan, len(caught[1][0])) == ((4, 1) if table else (1, 0))


def _keys(rel):
    with open(os.path.join(REPO, rel)) as f:
        return json.load(f)


def test_runner_rows_and_defaults(tmp_path, monkeypatch):
    """One ``--steps 2`` run on the CPU (darknet21, the trainer's default,
    made the tiny network here: the rows' plumbing is under test, not
    the model): the three rows, each with the keys of the JAX package's
    row JSONs (``experiments_artifacts/workflow_upsample_r03``); every
    flag's default is the script's apart from ``--cpu`` (``--device``),
    ``--work`` and ``--out``; no card, exit 2."""
    ref = script_defaults("scripts/run_upsample_workflow.py")
    got = parser_defaults(upsample.build_parser())
    for flag in set(ref) - {"--cpu", "--work", "--out"}:
        assert got[flag] == ref[flag], flag
    assert got["--device"] == "cuda"

    monkeypatch.setattr(RangeNetConfig, "darknet21", RangeNetConfig.tiny)
    work = str(tmp_path / "w")
    assert upsample.main(["--steps", "2", "--frames", "2", "--width", "64",
                          "--bounds", "8", "--device", "cpu", "--work",
                          work]) == 0
    names = ("fake64_on_real64", "real32_on_real64", "real64_on_fake64")
    assert sorted(os.listdir(os.path.join(work, "rows"))) \
        == sorted(f"{n}.json" for n in names)
    for name in names:
        row = json.load(open(os.path.join(work, "rows", f"{name}.json")))
        want = _keys(f"experiments_artifacts/workflow_upsample_r03/"
                     f"{name}.json")
        assert sorted(row) == sorted(want)
        assert (row["kind"], row["steps"], row["bounds"], row["scans"]) \
            == (name, 2, 8.0, 2)
        assert 0.0 <= row["acc"] <= 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert upsample.main(["--work", str(tmp_path / "none")]) == 2
    assert not os.path.exists(tmp_path / "none")


def test_urban_scene_aggregate(tmp_path, monkeypatch):
    """``--urban-scenes 2``: each row's JSON has the keys of the JAX
    package's multi-scene row (``workflow_upsample_multiscene_r05``), its
    per-scene rows carry ``scene_seed``, and mean, std, min and max are
    numpy's over them (the workflow itself stubbed: the runner above
    drives it)."""
    rng = np.random.default_rng(0)

    def one_scene(args, scene, work, device):
        return {n: {"miou": float(rng.random()),
                    "miou_present": float(rng.random()),
                    "acc": float(rng.random()), "scans": 2,
                    "iou_per_class": {}, "kind": n, "train_dataset": "a",
                    "eval_dataset": "b", "steps": args.steps,
                    "bounds": args.bounds}
                for n in ("fake64_on_real64", "real32_on_real64",
                          "real64_on_fake64")}

    monkeypatch.setattr(upsample, "one_scene", one_scene)
    out = tmp_path / "rows"
    assert upsample.main(["--urban-scenes", "2", "--device", "cpu",
                          "--out", str(out)]) == 0
    for name in ("fake64_on_real64", "real32_on_real64", "real64_on_fake64"):
        got = json.loads((out / f"{name}.json").read_text())
        want = _keys("experiments_artifacts/workflow_upsample_multiscene_r05"
                     f"/{name}.json")
        assert sorted(got) == sorted(want)
        assert sorted(got["per_scene"][0]) == sorted(want["per_scene"][0])
        assert [r["scene_seed"] for r in got["per_scene"]] == [0, 1]
        assert (got["backend"], got["scenes"], got["src_beams"],
                got["tgt_beams"], got["width"]) == ("cpu", 2, 32, 64, 512)
        for key in ("miou", "miou_present", "acc"):
            vals = [r[key] for r in got["per_scene"]]
            assert got[key] == float(np.mean(vals))
            assert got[key + "_std"] == float(np.std(vals))
            assert got[key + "_min"] == float(np.min(vals))
            assert got[key + "_max"] == float(np.max(vals))
