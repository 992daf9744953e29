"""Scale-out over several processes and cards (torch.distributed):
``sharding`` (meshes, DDP and tensor-parallel training, X-slab fusion and
synthesis, summed confusion counts, frame-parallel transfer) and
``multihost`` (joining the job, per-rank loading, the dryrun)."""

from lidar_transfer_tpu_torch.parallel.sharding import (  # noqa: F401
    frame_parallel_transfer,
    integrate_sharded,
    make_mesh,
    shard_params_tp,
    shard_volume,
    sharded_band_probe,
    sharded_confusion,
    sharded_train_step,
    splat_synthesize_sharded,
)
