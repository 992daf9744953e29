"""``models/rangenet.infer`` as a CUDA graph.

On a CUDA input ``infer`` replays a graph of the forward and its argmax,
captured once for each input shape and parameter storage; on the CPU it
runs the forward eagerly and captures nothing. The CPU tests hold the
eager path, the graph keys and the cache's cap; the tests marked ``card``
need a CUDA card and skip without one. This file imports no JAX, so they
run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_infer_graph.py
"""

import copy
import dataclasses
import gc
import pickle
import sys
import threading

import numpy as np
import pytest
import torch

from lidar_transfer_tpu_torch.config import SensorSpec
from lidar_transfer_tpu_torch.experiments.segmentation import _project
from lidar_transfer_tpu_torch.models import rangenet as TR
from lidar_transfer_tpu_torch.models.rangenet import (GraphCache, RangeNet,
                                                      RangeNetConfig,
                                                      graph_counts,
                                                      graph_keys, infer,
                                                      reset_graph_counts,
                                                      train_step)
from lidar_transfer_tpu_torch.utils import runtime as RT
from torch_suite import shared_cores, time_limit  # noqa: F401

#: darknet53's input at the benchmark's 64 x 2048, and a 32 x 1024 one
SHAPES = ((1, 64, 2048, 5), (1, 32, 1024, 5))
CLASSES = 26
#: HDL-64E's field of view at 64 x 2048
HDL64 = SensorSpec(name="hdl64", beams=64, fov_up=3.0, fov_down=-25.0,
                   angle_res_hor=360.0 / 2048.0)


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    RT.cpu_warmup()


@pytest.fixture(autouse=True)
def _fresh():
    RT.RECORDER.clear()
    reset_graph_counts()
    yield
    RT.RECORDER.clear()
    reset_graph_counts()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _model(cfg: RangeNetConfig, seed: int = 0, device="cpu") -> RangeNet:
    model = RangeNet(cfg)
    model.init_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def _tiny(**kw) -> RangeNet:
    return _model(dataclasses.replace(RangeNetConfig.tiny(num_classes=5),
                                      **kw))


def _inputs(shape, n: int, device, seed: int = 0) -> list[torch.Tensor]:
    """``n`` inputs of RangeNet's 5 channels, ranges to 80 m."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor([80.0, 80.0, 80.0, 20.0, 1.0])
    return [(torch.rand(shape, generator=g) * scale).to(device)
            for _ in range(n)]


@torch.no_grad()
def _eager(model, x) -> torch.Tensor:
    return torch.argmax(model(x), dim=-1).to(torch.int32)


# --- the CPU path and the cache, in plain Python -------------------------


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cpu_infer_is_the_eager_forward_and_captures_nothing(dtype):
    model = _tiny(compute_dtype=dtype)
    xs = _inputs((1, 8, 64, 5), 2, "cpu")
    with RT.tracing():
        got = [infer(model, x) for x in xs]
    for g, x in zip(got, xs):
        assert g.dtype == torch.int32 and torch.equal(g, _eager(model, x))
    assert graph_counts() == {"captures": 0, "replays": 0}
    assert model not in TR._graphs
    assert [s.name for s in RT.RECORDER.spans()] == ["model.infer"] * 2


def test_cache_makes_a_graph_once_a_key():
    cache, made = GraphCache(), []

    def make(key):
        return lambda: made.append(key) or f"graph {key}"

    for key in ("a", "b", "a", "b", "a"):
        assert cache.get((1, 2), key, make(key)) == f"graph {key}"
    assert made == ["a", "b"]


def test_cache_keeps_the_most_recently_used_up_to_its_cap():
    cache, made = GraphCache(), []
    keys = list(range(TR.MAX_GRAPHS + 1))
    for key in keys[:-1]:
        cache.get((), key, lambda key=key: made.append(key))
    cache.get((), keys[0], lambda: made.append("again"))   # used last
    cache.get((), keys[-1], lambda: made.append(keys[-1]))
    assert len(cache.graphs) == TR.MAX_GRAPHS
    assert list(cache.graphs) == keys[2:-1] + [keys[0], keys[-1]]
    cache.get((), keys[1], lambda: made.append("dropped"))
    assert made == keys + ["dropped"]


def test_cache_drops_every_graph_when_the_parameters_move():
    cache, made = GraphCache(), []
    for params, key in (((1,), "a"), ((1,), "b"), ((2,), "a"),
                        ((2,), "a"), ((1,), "b")):
        cache.get(params, key, lambda p=params, k=key: made.append((p, k)))
    assert made == [((1,), "a"), ((1,), "b"), ((2,), "a"), ((1,), "b")]
    assert list(cache.graphs) == ["b"] and cache.params == (1,)


def test_keys_follow_the_parameters_storage_not_their_values():
    model = _tiny()
    x = _inputs((1, 8, 64, 5), 1, "cpu")[0]
    params, key = graph_keys(model, x)
    assert key == ((1, 8, 64, 5), torch.float32, torch.device("cpu"))
    assert len(params) == len(list(model.parameters()))
    assert graph_keys(model, x.clone()) == (params, key)
    assert graph_keys(model, x[:, :4])[1] != key
    assert graph_keys(model, x.double())[1] != key
    # in place: an Adam step and load_state_dict's copy_
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    train_step(model, opt, dict(features=x,
                                labels=torch.zeros(1, 8, 64, dtype=torch.long),
                                weights=torch.ones(1, 8, 64)))
    model.load_state_dict(_tiny().state_dict())
    assert graph_keys(model, x)[0] == params
    # new storage: assigned tensors and a conversion (the first storage
    # held, so that no address comes back)
    kept = [p.detach() for p in model.parameters()]
    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()}, assign=True)
    moved = graph_keys(model, x)[0]
    assert moved != params
    model.to(torch.float64)
    assert graph_keys(model, x)[0] not in (params, moved)
    del kept


# --- on the card ---------------------------------------------------------


def _darknet(card, seed: int = 0) -> RangeNet:
    return _model(RangeNetConfig.darknet53(CLASSES), seed, card)


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES)
def test_card_replays_equal_the_eager_forward(shape, card):
    model = _darknet(card)
    xs = _inputs(shape, 3, card, seed=1)
    got = [infer(model, x) for x in xs]
    assert graph_counts() == {"captures": 1, "replays": 3}
    for g, x in zip(got, xs):
        assert g.shape == shape[:3] and g.dtype == torch.int32
        assert torch.equal(g, _eager(model, x))


@pytest.mark.card
def test_card_one_capture_a_shape_and_one_replay_a_call(card):
    model = _darknet(card)
    a, b = (_inputs(s, 2, card, seed=2) for s in SHAPES)
    for x in (a[0], b[0], a[1], b[1], a[0]):
        infer(model, x)
    assert graph_counts() == {"captures": 2, "replays": 5}
    assert len(TR._graphs[model].graphs) == 2


@pytest.mark.card
def test_card_results_hold_through_later_replays(card):
    model = _darknet(card)
    xs = _inputs(SHAPES[0], 16, card, seed=3)
    first = [infer(model, x) for x in xs[:8]]
    later = [infer(model, x) for x in xs[8:]]
    for g, x in zip(first + later, xs):
        assert torch.equal(g, _eager(model, x))
    assert len({g.data_ptr() for g in first + later}) == 16


@pytest.mark.card
def test_card_replays_read_weights_updated_in_place(card):
    model = _darknet(card)
    x, y = _inputs(SHAPES[1], 2, card, seed=4)
    infer(model, x)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    before = _eager(model, x)
    train_step(model, opt, dict(
        features=y, labels=torch.randint(0, CLASSES, SHAPES[1][:3],
                                         device=card),
        weights=torch.ones(SHAPES[1][:3], device=card)))
    after = _eager(model, x)
    assert not torch.equal(before, after)
    assert torch.equal(infer(model, x), after)
    model.load_state_dict(_darknet(card, seed=5).state_dict())
    assert torch.equal(infer(model, x), _eager(model, x))
    assert graph_counts() == {"captures": 1, "replays": 3}


@pytest.mark.card
def test_card_new_parameter_storage_captures_again(card):
    model = _darknet(card)
    x = _inputs(SHAPES[1], 1, card, seed=6)[0]
    infer(model, x)
    kept = [p.detach() for p in model.parameters()]     # old storage held
    model.cpu().to(card)
    assert torch.equal(infer(model, x), _eager(model, x))
    assert graph_counts() == {"captures": 2, "replays": 2}
    other = _darknet(card, seed=7).state_dict()
    model.load_state_dict(other, assign=True)
    assert torch.equal(infer(model, x), _eager(model, x))
    infer(model, x)
    assert graph_counts() == {"captures": 3, "replays": 4}
    assert len(TR._graphs[model].graphs) == 1
    del kept


@pytest.mark.card
def test_card_graphs_stay_off_the_module(card):
    model = _darknet(card)
    names = list(model.state_dict())
    x = _inputs(SHAPES[1], 1, card, seed=8)[0]
    want = infer(model, x)
    assert list(model.state_dict()) == names
    twin = copy.deepcopy(model)
    assert torch.equal(infer(twin, x), want)
    assert list(pickle.loads(pickle.dumps(model)).state_dict()) == names
    assert graph_counts()["captures"] == 2
    n = len(TR._graphs)
    del twin
    gc.collect()
    assert len(TR._graphs) == n - 1


@pytest.mark.card
def test_card_threads_sharing_a_model_each_get_their_own_classes(card):
    """Copy in, replay and clone are one step under the cache's lock:
    threads that call ``infer`` on one model at once, switching often,
    each get the classes of their own input."""
    model = _darknet(card)
    xs = _inputs(SHAPES[1], 6, card, seed=11)
    want = [_eager(model, x) for x in xs]
    got, errors = {}, []

    def work(t):
        try:
            for k in range(4):
                i = (t + k) % len(xs)
                got[t, k] = (i, infer(model, xs[i]))
        except BaseException as e:  # re-raised by the test
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(got) == 24
    for i, g in got.values():
        assert torch.equal(g, want[i]), i
    assert graph_counts() == {"captures": 1, "replays": 24}


class _Loader(threading.Thread):
    """Uploads and projects scans of ``count`` random points on the card
    until stopped, keeping each scan's features."""

    def __init__(self, card, count: int = 120_000):
        super().__init__(daemon=True)
        self.card, self.count = card, count
        self.stop, self.first = threading.Event(), threading.Event()
        self.got, self.error = [], None

    def scan(self, i: int):
        rng = np.random.default_rng(i)
        yaw = rng.uniform(-np.pi, np.pi, self.count)
        pitch = np.deg2rad(rng.uniform(-25.0, 3.0, self.count))
        r = rng.uniform(2.0, 80.0, self.count)
        pts = np.stack([r * np.cos(pitch) * np.cos(yaw),
                        r * np.cos(pitch) * np.sin(yaw),
                        r * np.sin(pitch)], axis=1).astype(np.float32)
        rem = rng.random(self.count).astype(np.float32)
        return pts, rem

    def load(self, i: int) -> torch.Tensor:
        """Scan ``i``'s features: four ``runtime.upload`` copies, then the
        projection."""
        pts, rem = self.scan(i)
        _, feats = _project(pts, rem, np.zeros(self.count, np.int32), HDL64,
                            122_880, self.card)
        return feats

    def run(self):
        try:
            while not self.stop.is_set():
                self.got.append(self.load(len(self.got)))
                self.first.set()
        except BaseException as e:  # re-raised by the test
            self.error = e
            self.first.set()


@pytest.mark.card
def test_card_capture_while_a_thread_uploads_and_projects(card):
    model = _darknet(card)
    x = _inputs(SHAPES[0], 1, card, seed=9)[0]
    loader = _Loader(card)
    loader.start()
    try:
        assert loader.first.wait(120)
        with RT.tracing():
            got = infer(model, x)
    finally:
        loader.stop.set()
        loader.join(120)
    assert loader.error is None, loader.error
    spans = RT.RECORDER.spans()
    cap = next(s for s in spans if s.name == "model.infer.capture")
    during = [s for s in spans if s.name == "loader.upload"
              and cap.start_ns <= s.start_ns <= cap.end_ns]
    assert during, "no upload ran while the graph was captured"
    for y in _inputs(SHAPES[0], 4, card, seed=10):
        infer(model, y)
    assert torch.equal(got, _eager(model, x))
    for i, feats in enumerate(loader.got):
        assert torch.equal(feats, loader.load(i)), i
    assert graph_counts() == {"captures": 1, "replays": 5}
