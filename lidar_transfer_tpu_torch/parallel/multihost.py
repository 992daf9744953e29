"""Several processes, one rank each: joining the job, the meshes, per-rank
loading of frames, and a dryrun (PyTorch).

Counterpart of ``lidar_transfer_tpu/parallel/multihost.py``. Every process
joins one ``torch.distributed`` process group (``initialize``), loads ONLY
the frames its own "data" row runs (``load_global_windows``: disk reads
never cross processes), and runs the frame-parallel transfer of
``parallel/sharding.py``; collectives carry only candidate rows, metric
counts and the gathered outputs.

Dryrun: ``python -m lidar_transfer_tpu_torch.parallel.multihost
--process-id I --num-processes N --init-method file:///tmp/pg ...`` runs
one process of an N-process job, or all N under ``torchrun
--nproc-per-node N -m lidar_transfer_tpu_torch.parallel.multihost ...``
(rank and world from its environment). ``--device cpu`` runs on the CPU
with gloo; ``--sharded-volume`` runs the X-slab fusion and synthesis
across all ranks, held bit for bit against one process's volume.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: str, world_size: int, rank: int,
               backend: str | None = None, device="cuda") -> str:
    """Join the process group (``torch.distributed.init_process_group``) as
    ``rank`` of ``world_size``; ``init_method`` as torch takes it
    (``tcp://localhost:PORT``, ``file:///path``, ``env://``).

    ``backend``: None takes gloo for CPU tensors (``device`` "cpu") and
    NCCL for CUDA ones; "gloo" with CUDA tensors is honoured (two ranks
    can share one card under gloo, which NCCL refuses). With NCCL the
    rank's card is ``cuda:rank % device_count`` unless ``device`` names
    one. -> the backend.
    """
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device if device.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return backend


def initialize_from_env(device="cuda"):
    """Join the job that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); None when
    there is none or it has one rank. -> (backend, this rank's device)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    backend = initialize("env://", world, int(os.environ["RANK"]),
                         device=device)
    return backend, device


def global_data_mesh():
    """(n_ranks, 1) mesh with ("data", "model") axes, the layout
    ``frame_parallel_transfer`` takes, over every rank of the job."""
    from lidar_transfer_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(model=1)


def joint_mesh(model: int = 2):
    """A mesh over every rank of the job with a model axis of ``model``:
    the layout the X-slab path (``integrate_sharded``,
    ``splat_synthesize_sharded``) splits its volume over."""
    from lidar_transfer_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(model=model)


def sharded_volume_parity(mesh, *, device="cuda", slab_x: int = 8,
                          seed: int = 7) -> dict:
    """X-slab fusion and synthesis on ``mesh`` held bit for bit against one
    process's volume, on every rank.

    Every rank draws the same image from ``seed``, fuses it into its slab
    (``integrate_sharded``), synthesises from the slabs
    (``splat_synthesize_sharded``), fuses the whole volume itself and
    synthesises from it (``splat_synthesize(attrs="volume")``), and raises
    unless the two scans are equal. -> stats.
    """
    from lidar_transfer_tpu_torch.ops import raycast as RC
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.splat import splat_synthesize
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda
    from lidar_transfer_tpu_torch.parallel.sharding import (
        integrate_sharded, shard_volume, splat_synthesize_sharded)

    n_shards = int(np.prod(mesh.shape))
    # voxel 0.25 is exact in float32; the ownership at 0.05 is held in
    # tests/test_torch_parallel.py
    spec = TS.VolumeSpec(origin=(-8.0, -8.0, -2.0), voxel_size=0.25,
                         dims=(slab_x * n_shards, 64, 16))
    H, W = 16, 64
    rng = np.random.default_rng(seed)
    depth = (rng.random((H, W)) * 6 + 0.5).astype(np.float32)
    label = rng.choice(np.array([10, 40, 50], np.int32), size=(H, W))
    rem = rng.random((H, W)).astype(np.float32)
    d, lb, r = (torch.from_numpy(a).to(device) for a in (depth, label, rem))
    fov = dict(fov_up_deg=30.0, fov_down_deg=-30.0)

    state = integrate_sharded(shard_volume(spec, mesh, device=device), spec,
                              mesh, d, lb, r, **fov)
    rays = RC.generate_rays(H, W, 30.0, -30.0)
    rays = torch.as_tensor(rays, dtype=torch.float32, device=device)
    d_flat = d.reshape(-1)
    pts = rays * d_flat[:, None]
    tgt = dict(target_H=H, target_W=W, **fov)
    out_s = splat_synthesize_sharded(state, spec, mesh,
                                     [(d_flat, pts, d_flat > 0)], **tgt)
    state1 = integrate_cuda(spec.init_state(device), spec, d, lb, r, **fov)
    out_1 = splat_synthesize(
        state1, spec, [(d_flat, pts, d_flat > 0, torch.zeros_like(d_flat),
                        torch.zeros_like(d_flat))],
        vol_origin=spec.origin, attrs="volume", **tgt)
    names = ("range", "label", "remission", "endpoints", "mask")
    for name, a, b in zip(names, out_s, out_1):
        if not torch.equal(a, b):
            raise AssertionError(
                f"sharded-volume {name} differs from one process's "
                f"(mesh {tuple(mesh.shape)}, {n_shards} X-slabs)")
    hit = float(out_s[4].float().mean())
    if hit <= 0.0:
        raise AssertionError("sharded synthesis produced no hits")
    return {"hit": hit, "n_shards": n_shards, "dims": spec.dims}


def local_frame_indices(frame_indices, mesh) -> list[int]:
    """The frames of the global batch that THIS rank loads: those of its
    "data" row (each row runs ``len / n_data`` consecutive frames; the
    ranks of one row, replicated over "model", load the same ones)."""
    from lidar_transfer_tpu_torch.parallel.sharding import (axis_sizes,
                                                            mesh_coordinate)

    n_dev = axis_sizes(mesh)["data"]
    if len(frame_indices) % n_dev:
        raise ValueError(f"batch {len(frame_indices)} not divisible by "
                         f"{n_dev} devices")
    per = len(frame_indices) // n_dev
    d = mesh_coordinate(mesh)[0]
    return list(frame_indices[d * per:(d + 1) * per])


def load_global_windows(seq, cfg, frame_indices, capacity: int, mesh,
                        device="cuda"):
    """Per-rank loading -> the global batch as one ``ScanWindow`` whose
    leading axis holds every frame of ``frame_indices``: this rank's
    frames (``local_frame_indices``) read from disk, the others left as
    empty windows (zeros, nothing valid) that it never runs."""
    from lidar_transfer_tpu_torch.parallel.sharding import mesh_coordinate
    from lidar_transfer_tpu_torch.pipeline.multiscan import (load_window,
                                                             stack_windows)

    mine = local_frame_indices(frame_indices, mesh)
    local = [load_window(seq, cfg, i, capacity, device) for i in mine]
    if not local:
        raise ValueError("this rank owns no frames: shrink the mesh or "
                         "grow the batch")
    empty = type(local[0])(*(torch.zeros_like(getattr(local[0], f))
                             for f in ("points", "remissions", "labels",
                                       "valid", "rel_pose")))
    first = mesh_coordinate(mesh)[0] * len(mine)
    wins = [empty] * len(frame_indices)
    wins[first:first + len(mine)] = local
    return stack_windows(wins)


def _dryrun_main(argv=None) -> int:
    """One process of an N-process dryrun: per-rank loading, the global
    frame-parallel transfer and the confusion counts summed across
    processes; or, with ``--sharded-volume``, the X-slab parity."""
    import argparse

    p = argparse.ArgumentParser("lt-multihost-dryrun-torch")
    p.add_argument("--init-method", default="env://",
                   help="torch.distributed init method (file://PATH, "
                        "tcp://localhost:PORT; env:// under torchrun)")
    p.add_argument("--num-processes", type=int,
                   default=int(os.environ.get("WORLD_SIZE", "0")) or None)
    p.add_argument("--process-id", type=int,
                   default=(int(os.environ["RANK"]) if "RANK" in os.environ
                            else None))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--dataset", default=None,
                   help="KITTI-layout tree (required unless "
                        "--sharded-volume, which makes its own inputs)")
    p.add_argument("--out", default=None,
                   help="rank 0 writes the gathered outputs here (.npz)")
    p.add_argument("--sharded-volume", action="store_true",
                   help="X-slab fusion and synthesis across a (data, "
                        "model=2) mesh of all ranks, held bit for bit "
                        "against one process's volume")
    args = p.parse_args(argv)
    if args.num_processes is None or args.process_id is None:
        p.error("--num-processes and --process-id are required outside "
                "torchrun")
    if not args.sharded_volume and args.dataset is None:
        p.error("--dataset is required for the frame-parallel dryrun")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: pass --device cpu to run on the CPU")
            return 2
        if device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", args.process_id))
                % torch.cuda.device_count())
    if device.type == "cpu":
        torch.set_num_threads(1)        # N processes share the cores
    backend = initialize(args.init_method, args.num_processes,
                         args.process_id, device=device)
    rank = dist.get_rank()
    try:
        return _dryrun(args, device, backend, rank)
    finally:
        dist.destroy_process_group()


def _dryrun(args, device, backend, rank) -> int:
    if args.sharded_volume:
        mesh = joint_mesh(model=2 if args.num_processes % 2 == 0 else 1)
        stats = sharded_volume_parity(mesh, device=device)
        print(f"process {rank}: SHARDED-VOLUME OK mesh "
              f"data={mesh.shape[0]} model={mesh.shape[1]} "
              f"({stats['n_shards']} X-slabs over {args.num_processes} "
              f"processes, {backend}), hit {stats['hit']:.3f}, bit-identical "
              "to one process", flush=True)
        if args.out and rank == 0:
            np.savez(args.out, hit=stats["hit"], n_shards=stats["n_shards"])
        print(f"process {rank}: OK", flush=True)
        return 0

    from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
    from lidar_transfer_tpu_torch.datasets.kitti import KittiSequence
    from lidar_transfer_tpu_torch.parallel.sharding import (
        frame_parallel_transfer, sharded_confusion)
    from lidar_transfer_tpu_torch.pipeline.deform import TransferEngine

    seq = KittiSequence.open(args.dataset)
    source = SensorSpec.from_yaml(os.path.join(args.dataset, "config.yaml"))
    cfg = TransferConfig(adaption="mergemesh", number_of_scans=1,
                         voxel_size=0.25,
                         voxel_bounds=((-16.0, 16.0), (-16.0, 16.0),
                                       (-4.0, 4.0)))
    mesh = global_data_mesh()
    n_frames = mesh.shape[0]
    frame_indices = [i % len(seq) for i in range(n_frames)]
    windows = load_global_windows(seq, cfg, frame_indices, 8192, mesh,
                                  device)
    eng = TransferEngine(source, source, cfg, fixed_bounds=True,
                         device=device)
    rng, lbl, rem, ends, mask = frame_parallel_transfer(eng, windows, mesh)

    # the counts summed across processes: each rank its own frames'
    # labels against a shifted copy (the content is irrelevant; the
    # reduction across processes is the point)
    d = mesh.get_coordinate()[0]
    flat = torch.clamp(lbl[d:d + 1].reshape(1, -1), 0, 31).to(torch.int32)
    conf = sharded_confusion(mesh, n_classes=32)(
        flat, torch.roll(flat, 1, dims=1))
    total = int(conf.sum())
    hit = float(mask.float().mean())
    print(f"process {rank}: {n_frames} frames over {n_frames} ranks "
          f"({backend}, {device}), hit rate {hit:.3f}, confusion total "
          f"{total}", flush=True)
    if total != lbl.numel():
        raise AssertionError("the summed confusion counts lost pixels")
    if hit <= 0.05:
        raise AssertionError("frame-parallel transfer produced nothing")
    if args.out and rank == 0:
        np.savez(args.out, hit=hit, conf_total=total,
                 frame_indices=np.asarray(frame_indices),
                 range=rng.cpu().numpy(), label=lbl.cpu().numpy(),
                 mask=mask.cpu().numpy())
    print(f"process {rank}: OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(_dryrun_main())
