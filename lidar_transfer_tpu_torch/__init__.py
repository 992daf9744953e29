"""lidar_transfer_tpu_torch — the PyTorch/CUDA port of lidar_transfer_tpu.

Transfers SemanticKITTI labels from one LiDAR geometry to another on an
NVIDIA H100. The JAX package ``lidar_transfer_tpu`` stays the reference;
this package imports ``torch`` and never ``jax``, mirrors its module names
(``ops/projection.py``, ``ops/splat.py``, ``ops/tsdf.py``,
``pipeline/deform.py``, ...), and reuses its jax-free modules
(``config``, ``datasets``, ``utils.runtime``, ``utils.prefetch``).

Ported so far: the ``lt-transfer`` main path (mergemesh adaption, splat
synthesis, deferred TSDF volume) and its metrics. Its three CUDA kernels
live in ``csrc/`` and build with ``nvcc`` at first use (``_build.py``):

  - the z-buffer (``ops/projection.zbuffer_winners``),
  - the confusion histogram (``metrics/confusion.confusion_matrix``),
  - the TSDF integrate (``ops/tsdf_cuda.integrate_cuda``).

Each has a plain PyTorch version beside it, which a CPU tensor takes.
"""

__version__ = "0.1.0"
