"""Each plain reference of the benchmark against the port's plain path
on the CPU at a small size. (The tests may import the port; the
references themselves import nothing of it.)"""

import os

import numpy as np
import pytest
import torch

from harness import scenes, segment
from perf_tiny import tiny_cell
from reference import projection as RP
from reference import rangenet as RR

from lidar_transfer_tpu_torch.config import SensorSpec
from lidar_transfer_tpu_torch.datasets import kitti
from lidar_transfer_tpu_torch.experiments import segmentation as seg
from lidar_transfer_tpu_torch.models import postproc, rangenet
from lidar_transfer_tpu_torch.ops import projection as P
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup


@pytest.fixture(scope="module", autouse=True)
def _warm():
    cpu_warmup()


@pytest.fixture(scope="module")
def tiny_seq(tmp_path_factory):
    cell = tiny_cell("darknet53-64x2048.infer-knn")
    root = str(tmp_path_factory.mktemp("seq"))
    scenes.write_sequence(root, scenes.Scene.urban(11),
                          cell.config["sensor"], 4, 1.0, "cpu")
    return cell, root


def test_reference_sources_import_nothing_of_the_port():
    ref = os.path.dirname(RR.__file__)
    for name in os.listdir(ref):
        if name.endswith(".py"):
            text = open(os.path.join(ref, name)).read()
            assert "lidar_transfer_tpu" not in text.replace(
                "lidar_transfer_tpu_torch/", ""), name
            assert "import jax" not in text and "from jax" not in text


def test_projection_matches_range_project():
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(5000, 3, generator=g) * 20
    rem = torch.rand(5000, generator=g)
    lab = torch.randint(0, 260, (5000,), generator=g, dtype=torch.int32)
    valid = torch.rand(5000, generator=g) > 0.1
    got = P.range_project(pts, rem, lab, valid, H=32, W=256, fov_up_deg=10.67,
                          fov_down_deg=-30.67)
    ref = RP.range_image(pts, rem, lab, valid, 10.67, -30.67, 32, 256)
    for k in ("range", "index", "remission", "label", "point_depth",
              "point_u", "point_v", "point_valid"):
        assert torch.equal(getattr(got, k), ref[k]), k
    assert torch.equal(got.mask, ref["mask"])


def _net(cfg, seed):
    flat = segment.make_weights(cfg, seed, torch.device("cpu"))
    model = rangenet.RangeNet(rangenet.RangeNetConfig(
        num_classes=cfg["num_classes"],
        stage_blocks=tuple(cfg["stage_blocks"]),
        stage_features=tuple(cfg["stage_features"]),
        stem_features=cfg["stem_features"], compute_dtype=torch.float32))
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == \
        [(n, s) for n, s, _ in RR.leaves(cfg)]
    torch.nn.utils.vector_to_parameters(flat.clone(), model.parameters())
    return flat, model


def test_rangenet_forward_and_steps_match_the_port():
    cfg = tiny_cell("darknet53-64x2048.train-b8").config
    flat, model = _net(cfg, 3)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 64, 5, generator=g)
    torch.testing.assert_close(
        RR.forward(RR.unflatten(flat, cfg), x, cfg), model(x),
        rtol=1e-5, atol=1e-5)
    batches = [(torch.randn(2, 64, 64, 5, generator=g),
                torch.randint(0, 26, (2, 64, 64), generator=g),
                (torch.rand(2, 64, 64, generator=g) > 0.3).float())
               for _ in range(2)]
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
    losses = [float(rangenet.train_step(model, opt, dict(
        features=f, labels=lab, weights=w))) for f, lab, w in batches]
    ref_losses, first, params = RR.train_steps(flat, batches, cfg, 1e-3)
    np.testing.assert_allclose(ref_losses, losses, rtol=1e-5)
    for name, p in model.named_parameters():
        torch.testing.assert_close(params[name], p.detach(), rtol=1e-5,
                                   atol=1e-7)
    # micro-batches of one row sum the same gradient in another order
    _, first_1, _ = RR.train_steps(flat, batches[:1], cfg, 1e-3, micro=1)
    for name, g in first.items():
        torch.testing.assert_close(first_1[name], g, rtol=1e-4, atol=1e-7)


def test_features_labels_and_knn_match_the_port(tiny_seq):
    cell, root = tiny_seq
    cfg = cell.config
    seq = kitti.KittiSequence.open(root)
    spec = SensorSpec.from_yaml(os.path.join(root, "config.yaml"))
    mapper = seg.LabelMapper.from_labels(
        {int(k): str(k) for k in cfg["labels"]},
        ignore_classes=tuple(cfg["ignore"]))
    to_index, raw_ids, ignore = segment.label_lut(cfg)
    np.testing.assert_array_equal(to_index, mapper.raw_to_index)
    assert list(raw_ids) == list(mapper.raw_ids)
    assert tuple(ignore) == mapper.ignore_indices
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    f, lab, w = seg._frame_tensors(seq, 1, spec, cap, mapper, "cpu")
    pts, rem, raw = seq.read(1)
    p, e, r, m = (torch.from_numpy(a) for a in
                  kitti.pad_points(pts, rem, raw, cap))
    F, L, Wt, ri = RR.features(p, e, r, m, cfg["sensor"],
                               torch.from_numpy(to_index), ignore)
    assert torch.equal(f, F) and torch.equal(lab, L) and torch.equal(w, Wt)
    g = torch.Generator().manual_seed(2)
    img = torch.randint(0, 26, ri["range"].shape, generator=g)
    knn = cfg["knn"]
    args = (ri["range"], img, ri["mask"], ri["point_depth"], ri["point_u"],
            ri["point_v"], ri["point_valid"])
    assert torch.equal(
        RR.knn_cleanup(*args, num_classes=26, **knn),
        postproc.knn_cleanup(*args, num_classes=26, **knn))
