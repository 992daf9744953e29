"""The port's span recorder (``lidar_transfer_tpu_torch/utils/runtime``):
off by default, on inside ``tracing()`` and under ``torch.profiler``, no
profiler range of its own, parents and threads, the spans of one loader
frame and of the kNN cleanup, and outputs equal with it on and off."""

import collections
import threading

import pytest
import torch
import torch.autograd.profiler
from torch.profiler import ProfilerActivity, profile

from lidar_transfer_tpu_torch.config import SensorSpec
from lidar_transfer_tpu_torch.datasets import kitti, synthetic
from lidar_transfer_tpu_torch.experiments.segmentation import (LabelMapper,
                                                               _frame_tensors)
from lidar_transfer_tpu_torch.models import postproc
from lidar_transfer_tpu_torch.models.rangenet import (RangeNet,
                                                      RangeNetConfig, infer,
                                                      train_step)
from lidar_transfer_tpu_torch.utils import runtime as RT
from lidar_transfer_tpu_torch.utils.prefetch import Prefetcher

SPEC = SensorSpec(name="t16", beams=16, fov_up=8.0, fov_down=-22.0,
                  angle_res_hor=360.0 / 128.0)
LOADER_SPANS = {"loader.read": 2, "loader.pad": 1, "loader.upload": 5,
                "loader.project": 1, "loader.labels": 1}


@pytest.fixture(autouse=True)
def _empty_recorder():
    RT.RECORDER.clear()
    yield
    RT.RECORDER.clear()


MAPPER = LabelMapper.from_labels({k: str(k) for k in (0, 1, 10, 40, 50,
                                                      252)})
CAPACITY = 8192


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trace_kitti"))
    synthetic.write_kitti_dataset(root, synthetic.Scene.default(), SPEC,
                                  n_scans=2)
    return kitti.KittiSequence.open(root)


def _frame(seq, i):
    return _frame_tensors(seq, i, SPEC, CAPACITY, MAPPER, "cpu")


def _names(spans):
    return collections.Counter(s.name for s in spans)


def test_off_records_nothing_and_shares_one_no_op(seq):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert RT.span("a") is RT.span("b", bytes=1) is RT._NO_SPAN
    with RT.span("a") as s:
        s.set(bytes=1)
    _frame(seq, 0)
    assert RT.RECORDER.spans() == [] and RT.RECORDER.dropped == 0


def test_outputs_equal_with_tracing_on_and_off(seq):
    def load(i):
        return _frame(seq, i % len(seq))

    def run():
        with Prefetcher(load, range(3), depth=2) as pf:
            return [t for _, ts in pf for t in ts]

    off = run()
    with RT.tracing():
        on = run()
    assert _names(RT.RECORDER.spans())["prefetch.load"] == 3
    assert len(on) == len(off) == 9
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_parents_threads_and_bytes(seq):
    with RT.tracing():
        with RT.span("outer"):
            with RT.span("inner"):
                pass
        with Prefetcher(lambda i: _frame(seq, i), [1]) as pf:
            list(pf)
    spans = RT.RECORDER.spans()
    by_id = {s.id: s for s in spans}
    outer, inner = (next(s for s in spans if s.name == n)
                    for n in ("outer", "inner"))
    assert outer.parent is None and inner.parent == outer.id
    assert outer.thread == inner.thread == threading.current_thread().name
    load = next(s for s in spans if s.name == "prefetch.load")
    loader = [s for s in spans if s.name.startswith("loader.")]
    assert _names(loader) == LOADER_SPANS
    assert load.thread == "lt-prefetch" and load.parent is None
    for s in loader:
        assert s.thread == "lt-prefetch"
        while s.parent != load.id:      # nested, at any depth, under it
            s = by_id[s.parent]
        assert load.start_ns <= s.start_ns <= s.end_ns <= load.end_ns
    RT.RECORDER.clear()     # the reads below are off the record
    points, rem, labels = seq.read(1)
    padded = kitti.pad_points(points, rem, labels, CAPACITY)
    assert sorted(s.attrs["bytes"] for s in loader
                  if s.name == "loader.upload") == sorted(
        [a.nbytes for a in padded] + [MAPPER.raw_to_index.nbytes])
    assert sorted(s.attrs["bytes"] for s in loader
                  if s.name == "loader.read") == sorted(
        [points.nbytes + rem.nbytes, labels.nbytes])


def test_profiler_turns_it_on_and_sees_no_range_of_it(seq):
    """The recorder follows ``torch.autograd.profiler._is_profiler_enabled``
    (a torch upgrade that renames it fails here) from every thread, and
    opens no profiler range: ``prof.events()`` holds none of its names."""
    seen = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = threading.Thread(target=lambda: seen.append(
            torch.autograd.profiler._is_profiler_enabled))
        t.start()
        t.join(timeout=10)
        with Prefetcher(lambda i: _frame(seq, i), [0]) as pf:
            list(pf)
        _frame(seq, 1)
    assert not t.is_alive() and seen == [True]
    assert torch.autograd.profiler._is_profiler_enabled is False
    spans = RT.RECORDER.spans()
    assert _names(spans) == dict({k: 2 * n for k, n in LOADER_SPANS.items()},
                                 **{"prefetch.load": 1})
    names = {e.name for e in prof.events()}   # the main thread's operations
    assert names and not names & {s.name for s in spans}


def test_one_frame_and_one_knn_call_count_their_spans(seq):
    with RT.tracing():
        _frame(seq, 0)
    assert _names(RT.RECORDER.spans()) == LOADER_SPANS
    RT.RECORDER.clear()
    H, W, N = 8, 16, 40
    g = torch.Generator().manual_seed(0)
    with RT.tracing():
        postproc.knn_cleanup(
            torch.rand(H, W, generator=g) * 20,
            torch.randint(0, 4, (H, W), generator=g),
            torch.ones(H, W, dtype=torch.bool),
            torch.rand(N, generator=g) * 20,
            torch.randint(0, W, (N,), generator=g),
            torch.randint(0, H, (N,), generator=g),
            torch.ones(N, dtype=torch.bool), num_classes=4)
    spans = RT.RECORDER.spans()
    assert _names(spans) == {"postproc.knn": 1, "postproc.upload": 1}
    knn, up = sorted(spans, key=lambda s: s.name)
    assert up.parent == knn.id and up.attrs["bytes"] == 25 * 4


def test_train_step_and_infer_spans():
    cfg = RangeNetConfig(num_classes=4, stage_blocks=(1, 1),
                         stage_features=(32, 64), stem_features=16,
                         input_channels=5, compute_dtype=torch.float32)
    torch.manual_seed(0)
    model = RangeNet(cfg)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    batch = dict(features=torch.rand(1, 8, 32, 5),
                 labels=torch.randint(0, 4, (1, 8, 32)),
                 weights=torch.ones(1, 8, 32))
    with RT.tracing():
        train_step(model, opt, batch)
        infer(model, batch["features"])
    spans = RT.RECORDER.spans()
    step = next(s for s in spans if s.name == "model.step")
    kids = [s.name for s in spans if s.parent == step.id]
    assert kids == ["model.forward", "model.backward", "model.optimizer"]
    assert [s.name for s in spans if s.parent is None] == ["model.step",
                                                          "model.infer"]


def test_the_buffer_drops_its_oldest_and_counts_them():
    rec = RT.Recorder(capacity=3)
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4"]
    assert rec.dropped == 2
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0
