"""The checks that decide ``correct`` come out false: for the control (the
reference one precision down in the program's place) and, through a whole
run with the harness's look for a card skipped, for each fault a cell can
have, planted in the timed path underneath. At the CPU tests' size; the
readings at the cells' own size are in PERF.md."""

import pytest
import torch

import run
from harness.common import Spans
from perf_tiny import tiny_cell

from lidar_transfer_tpu_torch.models import postproc, rangenet

TR = "darknet53-64x2048.train-b8"
IN = "darknet53-64x2048.infer-knn"
CPU = torch.device("cpu")


def _run(name, tmp_path):
    return run.run_cell(tiny_cell(name), 2**31 + 11, 0.5, False, CPU,
                        work_dir=str(tmp_path / "d"))


@pytest.mark.parametrize("name", [TR, IN])
def test_control_is_not_correct(name, tmp_path):
    cell = tiny_cell(name)
    work = run.work_class(cell.traffic["loop"])(
        cell.config, cell.traffic, 5, CPU, str(tmp_path / "d"), Spans())
    work.window(0.5)
    readings = work.check("control")
    assert any(readings[k] > lim for k, lim in cell.limits.items()), readings


def test_sound_runs_are_correct(tmp_path):
    for name in (TR, IN):
        assert _run(name, tmp_path)["correct"], name


def test_train_step_leaves_state_unchanged(tmp_path, monkeypatch):
    def unchanged(model, optimizer, batch, group=None):
        with torch.no_grad():
            return rangenet.masked_cross_entropy(
                model(batch["features"]), batch["labels"], batch["weights"])

    monkeypatch.setattr(rangenet, "train_step", unchanged)
    out = _run(TR, tmp_path)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_rel"]["value"] == pytest.approx(1.0)


def test_train_step_on_half_the_batch(tmp_path, monkeypatch):
    step = rangenet.train_step

    def half(model, optimizer, batch, group=None):
        n = batch["features"].shape[0] // 2
        return step(model, optimizer, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(rangenet, "train_step", half)
    out = _run(TR, tmp_path)
    assert not out["correct"], out["checks"]


def test_infer_answer_altered(tmp_path, monkeypatch):
    """One point's class altered where the kNN cleanup produces it."""
    knn = postproc.knn_cleanup

    def altered(*a, **k):
        out = knn(*a, **k).clone()
        out[0] = (out[0] + 1) % k["num_classes"]
        return out

    monkeypatch.setattr(postproc, "knn_cleanup", altered)
    out = _run(IN, tmp_path)
    assert not out["correct"], out["checks"]


def test_infer_pixel_class_altered(tmp_path, monkeypatch):
    """Every pixel's class moved to the next one where the network's
    argmax is produced: the logit gap catches it."""
    infer = rangenet.infer

    def altered(model, features):
        return (infer(model, features) + 1) % model.cfg.num_classes

    monkeypatch.setattr(rangenet, "infer", altered)
    out = _run(IN, tmp_path)
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", [TR, IN])
def test_control_is_not_correct_at_the_cells_size(name, card, tmp_path):
    """The control at the cell's own size (``calibrate.py`` prints its
    readings beside the program's)."""
    from harness.common import find_cell

    cell = find_cell(name)
    work = run.work_class(cell.traffic["loop"])(
        cell.config, cell.traffic, 6, card, str(tmp_path / "d"), Spans())
    work.window(25.0)
    readings = work.check("control")
    assert any(readings[k] > lim for k, lim in cell.limits.items()), readings
