"""lidar_transfer_tpu_torch — the PyTorch/CUDA port of lidar_transfer_tpu.

Transfers SemanticKITTI labels from one LiDAR geometry to another on an
NVIDIA H100. The JAX package ``lidar_transfer_tpu`` stays the reference;
this package stands alone: it imports ``torch``, never ``jax`` and nothing
of ``lidar_transfer_tpu``. It mirrors that package's module names
(``ops/projection.py``, ``ops/splat.py``, ``ops/tsdf.py``,
``pipeline/deform.py``, ...) and keeps its own copies of the numpy-only
modules it needs (``config``, ``datasets``, ``utils``).

Ported so far: the ``lt-transfer`` CLI with the cp, mergemesh, mesh and
catmesh adaptions (splat synthesis, targets denser than the source
included; catmesh also on its per-category mesh ``"oracle"`` engine), the
deferred and materialised TSDF volume, PLY export and the metrics, the
integrate's measurement probes (``probes/``), and the segmentation model
and its experiments (``models/``, ``experiments/``: RangeNet training,
inference with the kNN cleanup, evaluation). The CUDA
kernels live in ``csrc/`` and build with ``nvcc`` at first use
(``_build.py``):

  - the z-buffer (``ops/projection.zbuffer_winners``),
  - the confusion histogram (``metrics/confusion.confusion_matrix``),
  - the TSDF integrate and its S-scan chain
    (``ops/tsdf_cuda.integrate_cuda``, ``integrate_chain_cuda``),
  - the geometry table (``ops/tsdf_cuda.precompute_geometry_cuda``),
  - the raymarch and its occupancy packing (``ops/raycast.raymarch``),
  - the mesh raycast, a BVH built on the card every call and its
    traversal (``ops/triangles.raycast_mesh``),
  - the probes (``probes/parts.py``, ``probes/ablate.py``,
    ``probes/write.py``).

Each has a plain PyTorch version beside it, which a CPU tensor takes.
``native/`` builds the C++ BVH raytracer with g++, the mesh raycast's CPU
oracle.
"""

__version__ = "0.1.0"
