"""Dataset I/O of the port: the KITTI reader and writers (``kitti``), the
synthetic scene generator (``synthetic``) and the converters of other
datasets' trees (``convert``, imported on its own), numpy only."""

from lidar_transfer_tpu_torch.datasets import kitti, synthetic  # noqa: F401

__all__ = ["kitti", "synthetic"]
