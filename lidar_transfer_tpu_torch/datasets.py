"""Dataset I/O of the port.

The JAX package's KITTI reader and writers (``datasets.kitti``) and its
synthetic scene generator (``datasets.synthetic``) hold no jax: the port
uses them as they are, and callers of the port import them from here.
"""

from lidar_transfer_tpu.datasets import kitti, synthetic  # noqa: F401

__all__ = ["kitti", "synthetic"]
