"""The port's kNN cleanup (``lidar_transfer_tpu_torch/models/postproc.py``)
against the JAX package's ``knn_cleanup`` and against the per-point numpy
oracle, on the same inputs: every point's class must be equal (exact, no
tolerance: the vote counts are integers and both sides compute the same
float32 distances)."""

import numpy as np
import pytest
import torch

from lidar_transfer_tpu.models import postproc as JP
from lidar_transfer_tpu_torch.models import postproc as TP
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


def _scene(seed, H=16, W=32, N=400, C=7):
    """The JAX package's test scene: ranges with holes, point ranges near
    their pixel's range (so votes happen), a tenth of points invalid."""
    rng = np.random.default_rng(seed)
    proj_range = rng.uniform(2.0, 40.0, (H, W)).astype(np.float32)
    mask = rng.uniform(size=(H, W)) > 0.15
    proj_range = np.where(mask, proj_range, -1.0).astype(np.float32)
    pred = rng.integers(0, C, (H, W)).astype(np.int32)
    pv = rng.integers(0, H, N).astype(np.int32)
    pu = rng.integers(0, W, N).astype(np.int32)
    pr = (proj_range[pv, pu] + rng.normal(0, 0.4, N)).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    return proj_range, pred, mask, pr, pu, pv, valid, C


def _three(args, C, **kw):
    """-> (port, JAX, oracle) per-point classes."""
    got = TP.knn_cleanup(*(torch.from_numpy(np.asarray(a)) for a in args),
                         num_classes=C, **kw)
    assert got.dtype == torch.int32
    jax_out = np.asarray(JP.knn_cleanup(*args, num_classes=C, **kw))
    oracle = TP.knn_cleanup_oracle(*args, num_classes=C, **kw)
    np.testing.assert_array_equal(
        oracle, JP.knn_cleanup_oracle(*args, num_classes=C, **kw))
    return got.numpy(), jax_out, oracle


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,ksize,cutoff", [(5, 5, 1.0), (3, 3, 1.0),
                                            (7, 5, 1.0), (30, 5, 0.5)])
def test_knn_matches_jax_and_oracle(seed, k, ksize, cutoff):
    *args, C = _scene(seed)
    got, want, oracle = _three(args, C, k=k, ksize=ksize, cutoff=cutoff)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


def test_knn_out_of_image_points_and_edges():
    """Points off the image clamp to its border; windows overhang every
    edge."""
    proj_range, pred, mask, pr, pu, pv, valid, C = _scene(5, H=6, W=7,
                                                          N=200)
    rng = np.random.default_rng(6)
    pu = rng.integers(-3, 10, pu.shape).astype(np.int32)
    pv = rng.integers(-3, 9, pv.shape).astype(np.int32)
    args = (proj_range, pred, mask, pr, pu, pv, valid)
    got, want, oracle = _three(args, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


def test_knn_tie_in_the_vote_goes_to_the_lowest_class():
    """Two classes with two votes each: class 2 (lower) beats class 5; the
    centre pixel's own class 5 does not decide."""
    H = W = 3
    proj_range = np.full((H, W), 10.0, np.float32)
    mask = np.zeros((H, W), bool)
    pred = np.full((H, W), 5, np.int32)
    mask[1, 1] = mask[0, 0] = mask[0, 2] = mask[2, 0] = True
    pred[0, 0] = pred[0, 2] = 2
    pred[2, 0] = 5
    args = (proj_range, pred, mask, np.asarray([10.0], np.float32),
            np.asarray([1], np.int32), np.asarray([1], np.int32),
            np.asarray([True]))
    for out in _three(args, 8, k=4, ksize=3):
        assert out.tolist() == [2]


def test_knn_neighbours_tied_at_the_kth_distance_all_vote():
    """k = 1 with four neighbours at the same scaled distance (the window's
    corners, one range): all four vote, 3 of class 4 outvote the 1 of
    class 1 (with only the first neighbour, class 1 would win)."""
    H = W = 3
    proj_range = np.full((H, W), 20.0, np.float32)
    pred = np.zeros((H, W), np.int32)
    mask = np.zeros((H, W), bool)
    for (v, u), c in zip([(0, 0), (0, 2), (2, 0), (2, 2)], [1, 4, 4, 4]):
        mask[v, u], pred[v, u] = True, c
    args = (proj_range, pred, mask, np.asarray([20.5], np.float32),
            np.asarray([1], np.int32), np.asarray([1], np.int32),
            np.asarray([True]))
    for out in _three(args, 6, k=1, ksize=3):
        assert out.tolist() == [4]


def test_knn_cutoff_and_invalid_points_keep_their_pixel():
    proj_range, pred, mask, pr, pu, pv, valid, C = _scene(3)
    far = pr + 100.0                           # every neighbour too far
    args = (proj_range, pred, mask, far, pu, pv, valid)
    got, want, _ = _three(args, C)
    np.testing.assert_array_equal(got, pred[pv, pu])
    np.testing.assert_array_equal(got, want)
    none_valid = (proj_range, pred, mask, pr, pu, pv, np.zeros_like(valid))
    got, want, _ = _three(none_valid, C)
    np.testing.assert_array_equal(got, pred[pv, pu])


def test_knn_labels_outside_the_classes_cast_no_vote():
    """A predicted class outside [0, C) casts no vote (as the JAX
    function's one-hot of it is all zeros); a point whose only votes are
    such keeps its own pixel's prediction."""
    proj_range, pred, mask, pr, pu, pv, valid, C = _scene(7)
    pred = np.where(np.random.default_rng(8).random(pred.shape) < 0.3,
                    C + 2, pred).astype(np.int32)
    args = (proj_range, pred, mask, pr, pu, pv, valid)
    got = TP.knn_cleanup(*(torch.from_numpy(a) for a in args),
                         num_classes=C)
    want = np.asarray(JP.knn_cleanup(*args, num_classes=C))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == C + 2).any()      # kept centre predictions
