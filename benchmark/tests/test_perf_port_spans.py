"""The port's spans against a traced stretch (``harness/port_spans.py``):
a synthetic trace, and recorder spans on a clock ``CLOCK`` µs behind the
trace's, with warm-up and earlier-attempt spans outside the stretch."""

import json
import os

import pytest

from harness import common, port_spans
from lidar_transfer_tpu_torch.utils.runtime import SpanRecord

CLOCK = 5000.0
BENCH = json.load(open(os.path.join(common.ROOT, "BENCHMARK.json")))
NEW = ["loader_upload_ms.train", "loader_read_ms.train",
       "loader_launch_ms.train", "step_launch_ms", "h2d_copies.train",
       "idle_loader_ms.train", "loader_upload_ms.infer",
       "loader_read_ms.infer", "loader_launch_ms.infer", "infer_launch_ms",
       "knn_host_ms", "h2d_copies.infer", "idle_loader_ms.infer"]


def _span(name, lo, hi, thread="MainThread", **attrs):
    """A recorder span at [lo, hi] µs of the trace's clock."""
    return SpanRecord(name, thread, 0, None, int((lo - CLOCK) * 1e3),
                      int((hi - CLOCK) * 1e3), attrs)


def _trace():
    """Two train steps of 2 scans in the stretch (5000, 45000): device
    operations at [6000,10000) [12000,18000) [20000,28000) [30000,35000)
    [36000,39000)."""
    ops = [("k", s, d) for s, d in ((6000, 4000), (12000, 6000),
                                    (20000, 8000), (30000, 5000),
                                    (36000, 3000))]
    host = [("step", 10000.0, 20000.0), ("step", 29800.0, 40000.0),
            ("loader_wait", 9000.0, 10000.0)]
    return common.Trace(2, ops, [], host, (5000.0, 45000.0), units=4)


def _spans():
    load = "lt-prefetch"
    return sorted([
        # an earlier attempt (its steps as far apart as those of no other
        # attempt) and the warm-up, outside the stretch
        _span("model.step", -900000, -890000),
        _span("model.step", -877000, -867000),
        _span("loader.upload", -899000, -898000, load, bytes=8),
        _span("model.step", 0, 4000), _span("loader.read", 500, 3000, load),
        # the stretch: the pairs start 2 and 4 µs after their host spans,
        # so every span lands 3 µs early
        _span("model.step", 10002, 19800), _span("model.step", 29804, 39800),
        _span("model.forward", 10003, 15000),
        _span("loader.read", 5500, 9000, load, bytes=12),
        _span("loader.upload", 9100, 9400, load, bytes=8),
        _span("loader.project", 9500, 15000, load),
        _span("loader.read", 25000, 29000, load, bytes=12),
        _span("loader.upload", 29100, 29200, load, bytes=8),
        _span("loader.project", 29300, 33000, load),
    ], key=lambda s: s.start_ns)


def _run(trace=True, batch=2):
    cell = common.find_cell("darknet53-64x2048.train-b8")
    return common.Run(cell, 1.0, 8, 1.0, {}, {"batch": batch},
                      _trace() if trace else None)


def test_the_alignment_recovers_the_offset():
    off, spread = port_spans.align(_trace(), _spans(), "step", "model.step")
    assert off == pytest.approx(CLOCK - 3.0) and spread == pytest.approx(1.0)


def test_only_the_final_stretch_is_summed():
    run, spans = _run(), _spans()
    placed = port_spans.place(run, spans)
    assert {p.name for p in placed} == {"model.step", "model.forward",
                                        "loader.read", "loader.upload",
                                        "loader.project"}
    assert len(placed) == 9 and all(5000 <= p.start <= 45000
                                    for p in placed)
    # a step is 2 scans of the stretch's 4: each sum is halved
    assert port_spans.span_ms(run, ("model.step",), spans) == \
        pytest.approx((9798 + 9996) / 1e3 / 2)
    assert port_spans.span_ms(run, ("loader.read", "loader.pad"), spans) \
        == pytest.approx((3500 + 4000) / 1e3 / 2)
    assert port_spans.span_count(run, ("*.upload",), spans) == 1.0
    assert port_spans.span_ms(run, ("loader.labels",), spans) is None


def test_idle_gaps_by_loader_span():
    """Placed 3 µs early, the loader's spans are read [5497,8997],
    project [9497,14997], read [24997,28997], project [29297,32997]. Gaps
    begin at 5000 (nothing open), 10000 (a project), 18000 (nothing),
    28000 (a read), 35000 and 39000 (nothing): 2000 + 2000 µs of the
    loader's, over 2 steps."""
    assert port_spans.idle_ms_in(_run(), spans=_spans()) == \
        pytest.approx(4.0 / 2)


@pytest.mark.parametrize("fault", ["one pair short", "shifted", "two in one",
                                   "no trace", "no spans"])
def test_no_reading_without_matching_pairs(fault):
    spans, run = _spans(), _run(trace=fault != "no trace")
    steps = [s for s in spans if s.name == "model.step"]
    if fault == "one pair short":       # the stretch's second step missing
        spans = [s for s in spans if s is not steps[-1]]
    elif fault == "shifted":            # the second pair 1 ms late
        spans = [s._replace(start_ns=s.start_ns + 10**6)
                 if s is steps[-1] else s for s in spans]
    elif fault == "two in one":
        spans = sorted(spans + [_span("model.step", 15000, 16000)],
                       key=lambda s: s.start_ns)
    elif fault == "no spans":
        spans = []
    assert port_spans.place(run, spans) is None
    assert port_spans.span_ms(run, ("model.step",), spans) is None
    assert port_spans.idle_ms_in(run, spans=spans) is None


def test_new_metrics_read_the_recorder_and_nothing_without_a_trace(
        monkeypatch):
    assert [m["name"] for m in BENCH["per_layer"]][-len(NEW):] == NEW
    monkeypatch.setattr(port_spans, "recorded", _spans)
    for name in NEW:
        assert common.metric_reader(name)(_run(trace=False)) is None
    read = {n: common.metric_reader(n)(_run()) for n in NEW
            if n.endswith(".train") or n == "step_launch_ms"}
    assert read["h2d_copies.train"] == 1.0
    assert read["idle_loader_ms.train"] == pytest.approx(2.0)
    assert read["loader_launch_ms.train"] == pytest.approx(9.2 / 2)
    monkeypatch.setattr(port_spans, "recorded", lambda: None)
    assert common.metric_reader("step_launch_ms")(_run()) is None
