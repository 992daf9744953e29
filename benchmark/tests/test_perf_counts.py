"""The benchmark's frozen operation and byte counts against the port's
``probes/bounds.py``."""

import json
import os

import pytest
import torch

from harness import counts
from harness.common import ROOT
from lidar_transfer_tpu_torch.models.rangenet import RangeNet, RangeNetConfig
from lidar_transfer_tpu_torch.probes import bounds

DARKNET = json.load(open(os.path.join(
    ROOT, "benchmark", "configs", "darknet53-64x2048.json")))


def test_peaks_are_the_published_ones():
    assert counts.H100_BF16_FLOPS == bounds.H100_BF16_TFLOPS * 1e12
    assert counts.H100_BYTES_PER_S == bounds.H100_TB_PER_S * 1e12


@pytest.mark.parametrize("blocks,features,stem,H,W", [
    ((1, 1), (32, 64), 16, 8, 64),
    ((1, 2, 8, 8, 4), (64, 128, 256, 512, 1024), 32, 2, 64),
])
def test_forward_flops_match_the_hooks(blocks, features, stem, H, W):
    cfg = dict(DARKNET, stage_blocks=list(blocks),
               stage_features=list(features), stem_features=stem)
    model = RangeNet(RangeNetConfig(
        num_classes=cfg["num_classes"], stage_blocks=blocks,
        stage_features=features, stem_features=stem,
        compute_dtype=torch.float32))
    x = torch.zeros(1, H, W, 5)
    assert counts.darknet_forward_flops(cfg, H, W) == \
        bounds.conv_flops(model, x)


def test_train_step_is_three_forwards():
    f = counts.darknet_forward_flops(DARKNET, 64, 2048)
    assert counts.train_step_flops(f) == bounds.train_step(f).flops
    # the published darknet53 at 64x2048: 0.741 TFLOP a scan's forward
    assert 0.74e12 < f < 0.742e12

