"""Experiment harness, as the JAX package's ``experiments/``: everything
runs in-process with structured results.

  grid_search       frames x voxel-size sweep -> JSON + SVG heat maps
  segmentation      RangeNet train / infer / eval
  compare_datasets  per-class point histograms across datasets
  workflows         fake_on_fake / fake_on_real / real_on_fake pipelines
  multiscene        the workflow rows as mean ± std over urban scenes
"""

from lidar_transfer_tpu_torch.experiments.grid_search import (  # noqa: F401
    grid_search, evaluate_transfer)
from lidar_transfer_tpu_torch.experiments.segmentation import (  # noqa: F401
    LabelMapper, train_segmentation, write_predictions, evaluate_semantics)
