"""``runtime.upload``, the port's one way from a numpy array to a device.

On the CPU it is ``torch.from_numpy(array).to(device)`` inside the span
``loader.upload``. On a CUDA card it stages the array in page-locked
memory (the span ``loader.upload.pin``) and copies it without blocking,
on the current stream, behind the work queued there. The tests marked
``card`` need a CUDA card and skip without one; this file imports no JAX,
so they run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_upload.py
"""

import collections
import time

import numpy as np
import pytest
import torch

from lidar_transfer_tpu_torch.config import SensorSpec
from lidar_transfer_tpu_torch.experiments.segmentation import (LabelMapper,
                                                               _frame_tensors)
from lidar_transfer_tpu_torch.utils import runtime as RT
from lidar_transfer_tpu_torch.utils.prefetch import Prefetcher
from lidar_transfer_tpu_torch.utils.runtime import upload
from torch_suite import shared_cores, time_limit  # noqa: F401

DTYPES = ("float32", "int32", "bool")
MAPPER = LabelMapper.from_labels({k: str(k) for k in (0, 1, 10, 40, 50,
                                                      252)})
#: the benchmark's sensor: 64 x 2048, HDL-64E's field of view
HDL64 = SensorSpec(name="hdl64", beams=64, fov_up=3.0, fov_down=-25.0,
                   angle_res_hor=360.0 / 2048.0)
#: device cycles of ``torch.cuda._sleep`` that keep the card busy for some
#: 50-60 ms (1.7-2 GHz)
SLEEP_CYCLES = 100_000_000


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    RT.cpu_warmup()


@pytest.fixture(autouse=True)
def _empty_recorder():
    RT.RECORDER.clear()
    yield
    RT.RECORDER.clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _array(dtype: str, n: int = 4099, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
    return rng.standard_normal((n, 3)).astype(np.float32)


class _Scans:
    """A sequence of ``n`` scans made in memory from ``seed``: ``count``
    points around the sensor at 2-80 m within HDL-64E's field of view,
    with remissions and raw labels, as ``KittiSequence.read`` gives."""

    def __init__(self, n: int, count: int, seed: int = 0):
        self.n, self.count, self.seed = n, count, seed

    def __len__(self):
        return self.n

    def read(self, idx: int):
        rng = np.random.default_rng([self.seed, idx])
        yaw = rng.uniform(-np.pi, np.pi, self.count)
        pitch = np.deg2rad(rng.uniform(-25.0, 3.0, self.count))
        r = rng.uniform(2.0, 80.0, self.count)
        pts = np.stack([r * np.cos(pitch) * np.cos(yaw),
                        r * np.cos(pitch) * np.sin(yaw),
                        r * np.sin(pitch)], axis=1).astype(np.float32)
        rem = rng.random(self.count).astype(np.float32)
        lbl = rng.choice(np.array([0, 1, 10, 40, 50, 252], np.uint32),
                         self.count)
        return pts, rem, lbl


def _pin_spans():
    return [s for s in RT.RECORDER.spans() if s.name.endswith(".pin")]


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_upload_is_from_numpy_to(dtype):
    a = _array(dtype)
    want = torch.from_numpy(a).to("cpu")
    for device in ("cpu", torch.device("cpu")):
        got = upload(a, device)
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)


def test_cpu_upload_records_its_span_and_no_pin():
    arrays = [_array(d) for d in DTYPES]
    with RT.tracing():
        for a in arrays:
            upload(a, "cpu")
        upload(arrays[0], "cpu", "postproc.upload")
    spans = RT.RECORDER.spans()
    assert collections.Counter(s.name for s in spans) == {
        "loader.upload": 3, "postproc.upload": 1}
    assert [s.attrs["bytes"] for s in spans] == [
        a.nbytes for a in arrays + arrays[:1]]


def test_prefetched_uploads_match_direct_ones():
    def load(i):
        return [upload(_array(d, seed=i), "cpu") for d in DTYPES]

    direct = [load(i) for i in range(5)]
    with Prefetcher(load, range(5), depth=2) as pf:
        got = list(pf)
    assert [i for i, _ in got] == list(range(5))
    for (_, ts), want in zip(got, direct):
        for t, w in zip(ts, want):
            assert t.dtype == w.dtype and torch.equal(t, w)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_copy_equals_the_pageable_copy(dtype, card):
    a = _array(dtype, n=1 << 20)
    got = upload(a, card)
    want = torch.from_numpy(a).to(card)
    assert got.dtype == want.dtype and got.device == want.device
    torch.cuda.synchronize(card)
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()


@pytest.mark.card
def test_card_copy_records_one_pin_span_inside_its_upload(card):
    arrays = [_array(d) for d in DTYPES]
    with RT.tracing():
        for a in arrays:
            upload(a, card)
    by_id = {s.id: s for s in RT.RECORDER.spans()}
    pins = _pin_spans()
    assert [s.name for s in pins] == ["loader.upload.pin"] * 3
    assert [s.attrs["bytes"] for s in pins] == [a.nbytes for a in arrays]
    for s in pins:
        outer = by_id[s.parent]
        assert outer.name == "loader.upload"
        assert outer.attrs["bytes"] == s.attrs["bytes"]


@pytest.mark.card
def test_card_copy_does_not_read_the_array_after_it_returns(card):
    """The copy is still queued behind a long kernel when the array is
    overwritten: the device gets the values ``upload`` was given."""
    a = _array("float32", n=1 << 18)
    want = a.copy()
    torch.cuda._sleep(SLEEP_CYCLES)
    got = upload(a, card)
    a[:] = -1.0
    torch.cuda.synchronize(card)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.card
def test_card_copy_does_not_wait_for_queued_work(card):
    a = _array("float32", n=1 << 20)
    upload(a, card)                 # the first staging block, allocated
    torch.cuda.synchronize(card)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    t0 = time.perf_counter()
    got = upload(a, card)
    host_ms = (time.perf_counter() - t0) * 1e3
    still_queued = not end.query()
    torch.cuda.synchronize(card)
    sleep_ms = start.elapsed_time(end)
    assert still_queued, (host_ms, sleep_ms)
    assert host_ms < sleep_ms / 4, (host_ms, sleep_ms)
    assert torch.equal(got.cpu(), torch.from_numpy(a))


@pytest.mark.card
def test_card_loader_does_not_wait_for_queued_work(card):
    """A scan read, padded, uploaded, projected and labelled on the card
    (``_frame_tensors``) returns while a long kernel queued before it
    still runs: nothing in the loader waits for the device."""
    seq, capacity = _Scans(2, 120_000), 122_880
    _frame_tensors(seq, 0, HDL64, capacity, MAPPER, card)   # the builds
    torch.cuda.synchronize(card)
    end = torch.cuda.Event()
    torch.cuda._sleep(4 * SLEEP_CYCLES)
    end.record()
    _frame_tensors(seq, 1, HDL64, capacity, MAPPER, card)
    assert not end.query()
    torch.cuda.synchronize(card)


@pytest.mark.card
def test_card_prefetched_batches_match_synchronous_loads(card):
    """Batches of the benchmark's size through a depth-2 ``Prefetcher``,
    while the main thread keeps the card busy between them, equal scans
    loaded one at a time with the card drained after each."""
    seq, capacity, batch = _Scans(6, 120_000), 122_880, 3

    def load(step):
        f, l, w = zip(*(_frame_tensors(seq, (step * batch + k) % len(seq),
                                       HDL64, capacity, MAPPER, card)
                        for k in range(batch)))
        return torch.stack(f), torch.stack(l), torch.stack(w)

    want = []
    for step in range(4):
        want.append(load(step))
        torch.cuda.synchronize(card)
    got = []
    with Prefetcher(load, range(4), depth=2) as pf:
        for _, tensors in pf:
            torch.cuda._sleep(SLEEP_CYCLES // 2)
            got.append(tuple(t.clone() for t in tensors))
    torch.cuda.synchronize(card)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
