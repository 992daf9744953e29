"""Sensor and tool configuration of the port.

The JAX package's ``config`` module holds no jax: the port uses its
``SensorSpec``, ``TransferConfig`` and sensor presets as they are, and
callers of the port import them from here.
"""

from lidar_transfer_tpu.config import (HDL32, HDL64, VLP16,  # noqa: F401
                                       SensorSpec, TransferConfig)

__all__ = ["HDL32", "HDL64", "VLP16", "SensorSpec", "TransferConfig"]
