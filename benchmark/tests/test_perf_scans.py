"""The benchmark's scan generator against the port's numpy generator."""

import numpy as np
import pytest
import torch

from harness import scenes
from lidar_transfer_tpu_torch.config import SensorSpec
from lidar_transfer_tpu_torch.datasets import kitti, synthetic


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_urban_scene_is_the_ports(seed):
    ours, port = scenes.Scene.urban(seed), synthetic.Scene.urban(seed)
    for field in ("boxes", "cylinders", "spheres", "movers"):
        assert repr(getattr(ours, field)) == repr(getattr(port, field))
    for frame in (0, 5):
        assert repr(ours.at_frame(frame).boxes) == \
            repr(port.at_frame(frame).boxes)


@pytest.mark.parametrize("seed,pose", [(0, 0), (3, 17), (2**31 + 5, 63)])
def test_simulate_scan_matches_numpy(seed, pose):
    """Points and labels equal, remission within a float32 ulp of the
    sine (torch's and numpy's sin may round apart)."""
    spec = SensorSpec(name="t", beams=64, fov_up=3.0, fov_down=-25.0,
                      angle_res_hor=360.0 / 256)
    poses = scenes.straight_line_poses(64, 1.0)
    dirs = torch.as_tensor(scenes.sensor_rays(64, spec.W, 3.0, -25.0))
    p, r, lab = synthetic.simulate_scan(synthetic.Scene.urban(seed), spec,
                                        poses[pose], frame=pose)
    q, s, m = scenes.simulate_scan(scenes.Scene.urban(seed), dirs,
                                   poses[pose], pose)
    np.testing.assert_array_equal(q.numpy(), p)
    np.testing.assert_array_equal(m.numpy(), lab)
    np.testing.assert_allclose(s.numpy(), r, rtol=0, atol=1.2e-7)


def test_write_sequence_reads_back(tmp_path):
    sensor = {"name": "t", "beams": 16, "fov_up": 3.0, "fov_down": -25.0,
              "fov_hor": 360.0, "angle_res_hor": 360.0 / 128}
    scenes.write_sequence(str(tmp_path), scenes.Scene.urban(1), sensor, 3,
                          1.0, "cpu")
    seq = kitti.KittiSequence.open(str(tmp_path))
    assert len(seq) == 3
    np.testing.assert_allclose(seq.poses, scenes.straight_line_poses(3, 1.0),
                               atol=1e-6)
    spec = SensorSpec.from_yaml(str(tmp_path / "config.yaml"))
    assert (spec.H, spec.W) == (16, 128)
    pts, rem, lab = seq.read(2)
    dirs = torch.as_tensor(scenes.sensor_rays(16, 128, 3.0, -25.0))
    q, s, m = scenes.simulate_scan(scenes.Scene.urban(1), dirs,
                                   scenes.straight_line_poses(3, 1.0)[2], 2)
    np.testing.assert_array_equal(pts, q.numpy())
    np.testing.assert_array_equal(lab, m.numpy())
