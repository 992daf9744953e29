"""The PT-v3m1 cell (``harness/ptv3.py``) at a size the CPU runs in
seconds: the cell's own loop, reference and limits, with the tests' narrow
scans and PT-v3m1 cut to two scales of 16 and 32 channels and patches of
64. Its check passes on a sound run and fails on the control (the
reference one precision down, float8 products) and on faults planted in
the timed path; its counts and metric readers read what they should."""

import copy

import pytest
import torch

import run
from harness import common, op_names, ptv3_counts
from harness.common import Spans
from perf_tiny import tiny_cell

from lidar_transfer_tpu_torch.models import ptv3 as P

NAME = "ptv3m1-base-hdl64.train-b4"
CPU = torch.device("cpu")
TINY = {"enc_channels": [16, 32], "enc_heads": [2, 4], "enc_depths": [2, 2],
        "dec_channels": [16], "dec_heads": [2], "dec_depths": [2],
        "patch_size": 64}


def tiny():
    cell = tiny_cell(NAME)
    cell.config.update(copy.deepcopy(TINY))
    return cell


def _run(tmp_path, seed=2**31 + 11):
    return run.run_cell(tiny(), seed, 0.5, False, CPU,
                        work_dir=str(tmp_path / "d"))


def test_sound_run_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_scans_per_s"]["value"] > 0


@pytest.mark.parametrize("stand_in", ["control", "half_batch"])
def test_stand_ins_are_not_correct(stand_in, tmp_path):
    cell = tiny()
    work = run.work_class(cell.traffic["loop"])(
        cell.config, cell.traffic, 5, CPU, str(tmp_path / "d"), Spans())
    work.window(0.5)
    work.release()
    readings = work.check(stand_in)
    assert any(readings[k] > lim for k, lim in cell.limits.items()), readings


def test_drop_path_ignoring_the_generator(tmp_path, monkeypatch):
    drop = P.drop_path

    def unseeded(x, p, generator, training):
        return drop(x, p, None, training)

    monkeypatch.setattr(P, "drop_path", unseeded)
    torch.manual_seed(0)    # the fault draws from the global generator
    out = _run(tmp_path)
    assert not out["correct"], out["checks"]


def test_train_step_leaves_state_unchanged(tmp_path, monkeypatch):
    def unchanged(model, optimizer, batch, generator=None):
        return torch.zeros(())

    monkeypatch.setattr(P, "train_step", unchanged)
    out = _run(tmp_path)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_rel"]["value"] == pytest.approx(1.0)


def test_the_cell_fails_cleanly_without_the_port(monkeypatch):
    """A program without ``models.ptv3`` fails at the loop's import, before
    any scan is made."""
    import sys

    from lidar_transfer_tpu_torch import models

    monkeypatch.delattr(models, "ptv3")
    monkeypatch.setitem(sys.modules, "lidar_transfer_tpu_torch.models.ptv3",
                        None)
    monkeypatch.delitem(sys.modules, "harness.ptv3", raising=False)
    with pytest.raises(ImportError):
        run.work_class("ptv3:TrainWork")


def _counts():
    return {"points": {0: 1000, 1: 300}, "patches": {0: 16, 1: 5},
            "padded": {0: 1024, 1: 320}, "scores": {0: 65536, 1: 20480},
            "pairs": {"k5.0": 9000, "k3.0": 4000, "k3.1": 1500},
            "steps": 1}


def test_flops_and_bytes_by_hand():
    cfg = dict(tiny().config)
    c = _counts()
    enc0 = 2 * (2 * 16 * 16 * 13 * 1000 + 2 * 16 * 16 * 4000
                + 4 * 16 * 65536)
    enc1 = 2 * (2 * 32 * 32 * 13 * 300 + 2 * 32 * 32 * 1500
                + 4 * 32 * 20480) + 2 * 16 * 32 * 1000
    dec0 = 2 * (2 * 16 * 16 * 13 * 1000 + 2 * 16 * 16 * 4000
                + 4 * 16 * 65536) + 2 * 16 * 16 * 1000 + 2 * 32 * 16 * 300
    stem, head = 2 * 4 * 16 * 9000, 2 * 16 * 26 * 1000
    assert ptv3_counts.forward_flops(cfg, c) == enc0 + enc1 + dec0 + stem \
        + head
    assert ptv3_counts.train_flops(cfg, c) == 3 * (enc0 + enc1 + dec0 + stem
                                                   + head)
    assert ptv3_counts.serialize_bytes(c) == 48 * 1300
    assert ptv3_counts.neighbor_bytes(cfg, c) == \
        1300 * (16 + 108) + 1000 * (16 + 500)


def _run_with(trace, counts):
    cell = common.find_cell(NAME)
    return common.Run(cell, 1.0, 8, 2.0, {"loader_wait": [0.001, 0.003]},
                      counts, trace)


def test_metric_readers(monkeypatch):
    """The cell's per-layer readers on a synthetic traced stretch of two
    steps: named operations, the counters of the stretch and the window."""
    gather = "void at::native::vectorized_gather_kernel"
    ops = [("void (anonymous namespace)::ptv3_neighbor_query_kernel(int)",
            0, 40.0),
           ("(anonymous namespace)::ptv3_serialize_kernel", 50, 10.0),
           ("pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>", 70,
            300.0),
           (gather + "<16, int>(char*)", 400, 100.0),
           (gather + "<16, long>(char*)", 500, 30.0),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 600, 20.0),
           ("ampere_sgemm", 700, 200.0)]
    tr = common.Trace(2, ops, [], [], (0.0, 2000.0), units=8)
    cfg = common.find_cell(NAME).config
    counts = {"batch": 4, "window": _counts(), "stretch": _counts()}
    r = _run_with(tr, counts)
    read = {n: common.metric_reader(n)(r)
            for n, _ in common.find_cell(NAME).per_layer}
    assert read["attention_device_ms.ptv3"] == pytest.approx(0.15)
    assert read["sparse_conv_device_ms.ptv3"] == pytest.approx(0.05)
    assert read["step_device_ms.ptv3"] == pytest.approx(0.7 / 8 * 4)
    assert read["device_idle_share.ptv3"] == pytest.approx(100 * (1 - 0.7
                                                                  / 2))
    assert read["loader_wait_ms.ptv3"] == pytest.approx(2.0)
    assert read["padding_share.ptv3"] == pytest.approx(
        100 * (1344 - 1300) / 1300)
    nb = ptv3_counts.neighbor_bytes(cfg, _counts())
    assert read["neighbor_map_roofline"] == pytest.approx(
        100 * nb / 3.35e12 / 40e-6)
    assert read["serialize_roofline"] == pytest.approx(
        100 * 48 * 1300 / 3.35e12 / 10e-6)
    assert read["train_mfu.ptv3"] == pytest.approx(
        100 * ptv3_counts.train_flops(cfg, _counts()) / 989e12 / 2.0)
    # nothing to read: no trace, no such operation, no counters
    assert op_names.ms_per_step(_run_with(None, counts), ("flash",)) is None
    assert op_names.ms_per_step(r, ("no_such_kernel",)) is None
    assert common.metric_reader("serialize_roofline")(
        _run_with(tr, {"batch": 4})) is None
    assert common.metric_reader("train_mfu.ptv3")(
        _run_with(None, {"batch": 4})) is None


#: the cell's readers of the port's spans, and the train-b8 cell's readers
#: of the same spans
SPAN_TWINS = {"loader_upload_ms.ptv3": "loader_upload_ms.train",
              "loader_read_ms.ptv3": "loader_read_ms.train",
              "loader_launch_ms.ptv3": "loader_launch_ms.train",
              "step_launch_ms.ptv3": "step_launch_ms",
              "h2d_copies.ptv3": "h2d_copies.train",
              "idle_loader_ms.ptv3": "idle_loader_ms.train"}


@pytest.mark.parametrize("name", sorted(SPAN_TWINS))
def test_port_span_readers_read_the_steps_spans(name, monkeypatch):
    """Each reader of the port's spans in this cell reads what train-b8's
    reader of the same spans reads, on the same stretch, nothing without a
    trace, and is appended after every entry train-b8's readers have."""
    import test_perf_port_spans as PS
    from harness import port_spans

    monkeypatch.setattr(port_spans, "recorded", PS._spans)
    new, old = common.metric_reader(name), common.metric_reader(
        SPAN_TWINS[name])
    assert new(PS._run()) == old(PS._run())
    assert new(PS._run(trace=False)) is None
    names = [m["name"] for m in PS.BENCH["per_layer"]]
    assert names.index(name) > names.index(PS.NEW[-1])
    assert name in {n for n, _ in common.find_cell(NAME).per_layer}
