"""The port's confusion matrix and metrics against the JAX package (CPU).

Held against ``lidar_transfer_tpu/metrics/confusion.py`` (the scatter and
one-hot versions, and the Pallas kernel in interpret mode),
``metrics/ioueval.py`` and ``metrics/compare.py``. Counts are exact;
ratios of float32 sums agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_transfer_tpu.metrics import compare as JC
from lidar_transfer_tpu.metrics import confusion as JF
from lidar_transfer_tpu.metrics import ioueval as JI
from lidar_transfer_tpu_torch.metrics import compare as TC
from lidar_transfer_tpu_torch.metrics import confusion as TF
from lidar_transfer_tpu_torch.metrics import ioueval as TI
from lidar_transfer_tpu_torch.probes.cases import confusion_labels
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


C = 260


def _ids(seed, n=50000):
    """Skewed ids in [0, C) plus out-of-range and negative ones."""
    rng = np.random.default_rng(seed)
    pred = rng.choice([0, 10, 40, 48, 50, 70, 252, 259], n).astype(np.int32)
    tgt = rng.integers(0, C, n).astype(np.int32)
    bad = rng.random(n) < 0.05
    pred[bad] = rng.choice([-1, -300, C, C + 7], bad.sum())
    bad = rng.random(n) < 0.05
    tgt[bad] = rng.choice([-2, C, 1000], bad.sum())
    return pred, tgt


@pytest.mark.parametrize("backend", ["scatter", "onehot", "pallas"])
def test_confusion_exact(backend):
    """confusion_matrix (plain on CPU) == every JAX backend, exactly."""
    pred, tgt = _ids(1)
    fn = {"scatter": JF.confusion_scatter,
          "onehot": JF.confusion_onehot,
          "pallas": lambda p, t, c: JF.confusion_pallas(p, t, c,
                                                        interpret=True)
          }[backend]
    ref = np.asarray(fn(jnp.asarray(pred), jnp.asarray(tgt), C))
    out = TF.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(tgt),
                              C)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        TF.confusion_scatter(torch.from_numpy(pred), torch.from_numpy(tgt),
                             C).numpy(), ref)


def test_ioueval_matches():
    """IoUEval / iou_from_confusion / acc_from_confusion against JAX's:
    counts exact, ratios to 1e-6."""
    j, t = JI.IoUEval(C, ignore=[0, 1]), TI.IoUEval(C, ignore=[0, 1])
    for seed in (2, 3):
        pred, tgt = _ids(seed)
        j.add_batch(pred, tgt)
        t.add_batch(torch.from_numpy(pred), torch.from_numpy(tgt))
    np.testing.assert_array_equal(t.conf, j.conf)
    np.testing.assert_allclose(t.get_iou()[1], j.get_iou()[1], rtol=1e-12)
    assert t.get_acc() == pytest.approx(j.get_acc(), rel=1e-12)
    mask = np.zeros(C, bool)
    mask[[0, 1]] = True
    conf = torch.from_numpy(j.conf.astype(np.int32))
    jm, jiou = JI.iou_from_confusion(jnp.asarray(j.conf.astype(np.int32)),
                                     jnp.asarray(mask))
    tm, tiou = TI.iou_from_confusion(conf, torch.from_numpy(mask))
    np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou), rtol=1e-6)
    assert float(tm) == pytest.approx(float(jm), rel=1e-6)
    ja = JI.acc_from_confusion(jnp.asarray(j.conf.astype(np.int32)),
                               jnp.asarray(mask))
    ta = TI.acc_from_confusion(conf, torch.from_numpy(mask))
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)


def test_compare_scans_matches():
    """compare_scans on the same (H,W) images: label diff exact, metrics
    and error images to 1e-6."""
    rng = np.random.default_rng(4)
    H, W = 32, 512
    classes = np.array([0, 10, 40, 48, 50, 70, 81], np.int32)
    src_l = rng.choice(classes, (H, W)).astype(np.int32)
    tgt_l = np.where(rng.random((H, W)) < 0.8, src_l,
                     rng.choice(classes, (H, W))).astype(np.int32)
    mask = rng.random((H, W)) < 0.9
    src_r = rng.uniform(1, 60, (H, W)).astype(np.float32)
    tgt_r = (src_r + rng.normal(0, 0.3, (H, W))).astype(np.float32)
    src_e = rng.random((H, W)).astype(np.float32)
    tgt_e = rng.random((H, W)).astype(np.float32)
    args = (src_l, mask, src_r, src_e, tgt_l, tgt_r, tgt_e)
    j = JC.compare_scans(*(jnp.asarray(a) for a in args))
    t = TC.compare_scans(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(t.label_diff.numpy(),
                                  np.asarray(j.label_diff))
    np.testing.assert_array_equal(t.present.numpy(), np.asarray(j.present))
    for f in ("mean_iou", "mean_acc", "mse", "iou_per_class",
              "range_diff", "remission_diff"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def _labels(seed, n, n_classes, skewed):
    """The card's check's labels: skewed (7 ids, 80 % on the diagonal, some
    out of range) or uniform ids."""
    return confusion_labels(np.random.default_rng(seed), n, n_classes,
                            skewed, stray=True)


@pytest.mark.parametrize("skewed", [True, False])
@pytest.mark.parametrize("n", [1, 2049, 131072])
@pytest.mark.parametrize("n_classes", [260, 20, 1, 37])
def test_confusion_sizes_match_pallas_and_onehot(n_classes, n, skewed):
    """The sizes the card's kernel is checked at (a matrix a block counts
    whole, C <= 64; one whose diagonal it counts; one sample; a compare
    image's 131,072), through confusion_matrix on CPU tensors: equal to
    confusion_pallas(interpret=True) and confusion_onehot, exactly."""
    pred, tgt = _labels(7, n, n_classes, skewed)
    out = TF.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(tgt),
                              n_classes).numpy()
    assert out.shape == (n_classes, n_classes) and out.dtype == np.int32
    jp, jt = jnp.asarray(pred), jnp.asarray(tgt)
    np.testing.assert_array_equal(
        out, np.asarray(JF.confusion_pallas(jp, jt, n_classes,
                                            interpret=True)))
    np.testing.assert_array_equal(
        out, np.asarray(JF.confusion_onehot(jp, jt, n_classes)))
    ok = (pred >= 0) & (pred < n_classes) & (tgt >= 0) & (tgt < n_classes)
    assert out.sum() == ok.sum()


@pytest.mark.parametrize("n_classes", [260, 20])
def test_confusion_empty_and_large(n_classes):
    """No sample gives zeros; 2^20 samples (the large N the card's kernel
    is timed at) equal the JAX scatter version."""
    none = torch.zeros(0, dtype=torch.int32)
    out = TF.confusion_matrix(none, none, n_classes)
    assert out.shape == (n_classes, n_classes) and int(out.sum()) == 0
    pred, tgt = _labels(8, 1 << 20, n_classes, True)
    np.testing.assert_array_equal(
        TF.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(tgt),
                            n_classes).numpy(),
        np.asarray(JF.confusion_scatter(jnp.asarray(pred), jnp.asarray(tgt),
                                        n_classes)))
