"""Dataset I/O of the port: the KITTI reader and writers (``kitti``) and the
synthetic scene generator (``synthetic``), numpy only."""

from lidar_transfer_tpu_torch.datasets import kitti, synthetic  # noqa: F401

__all__ = ["kitti", "synthetic"]
