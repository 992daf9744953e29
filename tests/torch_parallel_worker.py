"""One rank of the process groups of ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py RANK WORLD INIT_FILE INPUTS OUT_DIR

Joins a gloo group of WORLD ranks on the CPU through ``file://INIT_FILE``,
runs every check of that world size on the inputs the test wrote
(``INPUTS``, a ``torch.save`` of numpy arrays and the port's configs) and
writes what it computed to ``OUT_DIR/rank<RANK>.pt``; the test holds it
against the JAX package and the port's single-process results. It imports
the port alone (no jax), and records whether anything imported jax.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _np(x):
    """Tensors (in a tuple, or a state dict's values) as numpy."""
    from lidar_transfer_tpu_torch.interop import to_numpy

    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return to_numpy(x)


def _meshes():
    """model=1 and the auto layout: 2x1 and 1x2 at two ranks, 4x1 and 2x2
    at four."""
    from lidar_transfer_tpu_torch.parallel import make_mesh

    return {"model1": make_mesh(model=1), "auto": make_mesh()}


def _volume_checks(inp, out, meshes):
    """integrate_sharded (fresh and carried slabs) and
    splat_synthesize_sharded on every mesh, float32 and compact."""
    from lidar_transfer_tpu_torch import interop
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.parallel import (integrate_sharded,
                                                   shard_volume,
                                                   splat_synthesize_sharded)

    fov = inp["fov"]
    im1 = [torch.from_numpy(a) for a in inp["image1"]]
    im2 = [torch.from_numpy(a) for a in inp["image2"]]
    spec = TS.VolumeSpec(*inp["integrate_spec"])
    for name, mesh in meshes.items():
        slab = shard_volume(spec, mesh, device="cpu")
        out[f"integrate/{name}"] = _np(
            integrate_sharded(slab, spec, mesh, *im1, **fov))
        carried = shard_volume(
            spec, mesh, device="cpu",
            state=interop.state_from_numpy(inp["jax_state1"]))
        out[f"carried/{name}"] = _np(
            integrate_sharded(carried, spec, mesh, *im2, **fov))
    srcs = [tuple(torch.from_numpy(a) for a in inp["sources"])]
    H, W = inp["image1"][0].shape
    for geom, args in inp["synth_specs"].items():
        spec = TS.VolumeSpec(*args)
        for compact in (False, True):
            # both meshes cut the same slabs (row-major ranks); they merge
            # the candidates over different axes
            key = f"{geom}/{compact}"
            slab = integrate_sharded(
                shard_volume(spec, meshes["auto"], device="cpu",
                             compact=compact),
                spec, meshes["auto"], *im1, **fov)
            out[f"slab_hash/{key}"] = [_hash(t) for t in slab]
            # the JAX package's volume, carried into this rank's slab
            carried = shard_volume(
                spec, meshes["auto"], device="cpu",
                state=interop.state_from_numpy(inp["jax_volumes"][geom],
                                               compact=compact))
            for name, mesh in meshes.items():
                out[f"synth/{key}/{name}"] = _np(splat_synthesize_sharded(
                    slab, spec, mesh, srcs, target_H=H, target_W=W, **fov))
                out[f"synth_jax/{key}/{name}"] = _np(
                    splat_synthesize_sharded(carried, spec, mesh, srcs,
                                             target_H=H, target_W=W, **fov))


def _hash(t: torch.Tensor) -> str:
    """The sha256 of a tensor's bytes (bf16 as its 16-bit words)."""
    import hashlib

    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def _confusion_checks(inp, out, meshes):
    from lidar_transfer_tpu_torch.parallel import sharded_confusion
    from lidar_transfer_tpu_torch.parallel.sharding import (axis_sizes,
                                                            mesh_coordinate)

    pred, tgt = (torch.from_numpy(a) for a in inp["confusion"])
    for name, mesh in meshes.items():
        per = pred.shape[0] // axis_sizes(mesh)["data"]
        d = mesh_coordinate(mesh)[0]
        fn = sharded_confusion(mesh, inp["n_classes"])
        out[f"confusion/{name}"] = _np(fn(pred[d * per:(d + 1) * per],
                                          tgt[d * per:(d + 1) * per]))


def _frame_checks(inp, out, mesh):
    """frame_parallel_transfer of each engine's global batch."""
    from lidar_transfer_tpu_torch import interop
    from lidar_transfer_tpu_torch.parallel import frame_parallel_transfer
    from lidar_transfer_tpu_torch.pipeline.deform import TransferEngine

    for name, (source, target, cfg, kw, wins) in inp["frames"].items():
        eng = TransferEngine(source, target, cfg, fixed_bounds=True,
                             device="cpu", **kw)
        try:
            got = frame_parallel_transfer(eng, interop.window_from_numpy(wins),
                                          mesh)
            out[f"frames/{name}"] = _np(got)
        except ValueError as err:
            out[f"frames/{name}"] = f"ValueError: {err}"


def _train(inp, mesh, tp: bool):
    """Three steps of the sharded step from the test's parameters; this
    rank's slice of the batch along "data". -> (losses, full params)."""
    from lidar_transfer_tpu_torch.models import rangenet as TR
    from lidar_transfer_tpu_torch.parallel import (shard_params_tp,
                                                   sharded_train_step)
    from lidar_transfer_tpu_torch.parallel.sharding import (axis_sizes,
                                                            mesh_coordinate,
                                                            tp_state_dict)

    model = TR.RangeNet(inp["model_cfg"])
    model.load_state_dict(inp["params"])
    if tp:
        shard_params_tp(model, mesh, min_features=32)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = sharded_train_step(model, opt, mesh)
    n = inp["batch"]["features"].shape[0]
    per = n // axis_sizes(mesh)["data"]
    d = mesh_coordinate(mesh)[0]
    batch = {k: torch.from_numpy(v[d * per:(d + 1) * per])
             for k, v in inp["batch"].items()}
    losses = [float(step(batch)) for _ in range(3)]
    assert step.ddp.module is model
    return losses, _np(tp_state_dict(model, mesh))


def _segmentation_checks(inp, out, out_dir, mesh):
    """train_segmentation under the group: checkpoint writes by rank, a
    run resumed at step 2 against a straight 3-step run; grid_search with
    the mesh against its sequential cell."""
    import dataclasses

    from lidar_transfer_tpu_torch.experiments import segmentation as SG
    from lidar_transfer_tpu_torch.experiments.grid_search import (
        evaluate_transfer, grid_search)

    saved = []
    real = SG.save_checkpoint

    def spy(*args, **kw):
        saved.append(kw.get("step"))
        real(*args, **kw)

    SG.save_checkpoint = spy
    ds = inp["seg_dataset"]
    kw = dict(batch_size=2, model_cfg=inp["seg_cfg"], seed=5, device="cpu",
              verbose=False)
    resumed = os.path.join(out_dir, "resumed.pt")
    SG.train_segmentation(ds, steps=2, checkpoint_path=resumed, **kw)
    SG.train_segmentation(ds, steps=3, checkpoint_path=resumed, resume=True,
                          **kw)
    straight = os.path.join(out_dir, "straight.pt")
    model, _, _ = SG.train_segmentation(ds, steps=3, checkpoint_path=straight,
                                        **kw)
    SG.save_checkpoint = real
    out["seg/saved"] = saved
    out["seg/params"] = _np(model.state_dict())

    base = inp["grid_cfg"]
    res = grid_search(ds, frames_list=[1], voxel_sizes=[0.25],
                      adaption="mergemesh", base_cfg=base,
                      frames_per_cell=3, verbose=False, mesh=mesh,
                      device="cpu", out_dir=os.path.join(out_dir, "grid"))
    cell_cfg = dataclasses.replace(base, adaption="mergemesh",
                                   number_of_scans=1, voxel_size=0.25)
    out["grid/mesh"] = res
    out["grid/sequential"] = evaluate_transfer(
        ds, cell_cfg, frames=3, fixed_bounds=True, device="cpu")


def run(inp, out, out_dir, world):
    from lidar_transfer_tpu_torch.parallel import make_mesh

    meshes = _meshes()
    try:
        make_mesh(2 * world)
    except ValueError as err:
        out["mesh_error"] = str(err)
    out["mesh_shapes"] = {k: tuple(m.shape) for k, m in meshes.items()}
    _volume_checks(inp, out, meshes)
    _confusion_checks(inp, out, meshes)
    if world == 2:
        _frame_checks(inp, out, meshes["model1"])
        out["ddp"] = _train(inp, meshes["model1"], tp=False)
        out["tp"] = _train(inp, meshes["auto"], tp=True)
        _segmentation_checks(inp, out, out_dir, meshes["model1"])
    else:
        out["dptp"] = _train(inp, meshes["auto"], tp=True)


def main(argv) -> int:
    rank, world = int(argv[1]), int(argv[2])
    init, inputs, out_dir = argv[3], argv[4], argv[5]
    torch.set_num_threads(1)
    from lidar_transfer_tpu_torch.parallel import multihost
    from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup

    cpu_warmup()
    multihost.initialize(f"file://{init}", world, rank, device="cpu")
    inp = torch.load(inputs, weights_only=False)
    out = {}
    try:
        run(inp, out, out_dir, world)
    finally:
        dist.destroy_process_group()
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "lidar_transfer_tpu"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
