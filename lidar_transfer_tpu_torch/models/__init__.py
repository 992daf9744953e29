"""The RangeNet segmentation model (``rangenet``) and its kNN point
cleanup (``postproc``)."""

from lidar_transfer_tpu_torch.models.rangenet import (  # noqa: F401
    BF16MomentAdam,
    RangeNet,
    RangeNetConfig,
    make_train_state,
    train_step,
    infer,
)
