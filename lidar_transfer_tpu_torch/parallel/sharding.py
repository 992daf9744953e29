"""Scale-out over several cards with torch.distributed (PyTorch).

Counterpart of ``lidar_transfer_tpu/parallel/sharding.py``. One process
runs each rank; a ``DeviceMesh`` with the axes ("data", "model") over the
ranks of the process group (``parallel/multihost.initialize``) stands where
the JAX package has a ``jax.sharding.Mesh``. A rank's place in the mesh is
row-major: ``data * n_model + model``, as JAX's
``axis_index("data") * n_model + axis_index("model")``.

  - **data parallel** RangeNet training: ``DistributedDataParallel`` over
    the "data" ranks in place of GSPMD's gradient psum
    (``sharded_train_step``);
  - **tensor parallel** convolutions: wide output-channel axes split over
    "model", the output gathered (``shard_params_tp``);
  - **X-slab TSDF fusion**: each rank holds only its slab of the volume
    and fuses into it with the integrate kernel (row 1) at an integer
    ``x_offset``, with no collective (``integrate_sharded``); synthesis
    probes the band on each slab and merges the candidates with one MIN
    and one SUM ``all_reduce`` (``sharded_band_probe``), then runs the
    target z-buffer (row A) on every rank (``splat_synthesize_sharded``);
  - **summed confusion counts** (row 3 on each rank's shard, one SUM,
    ``sharded_confusion``);
  - **frame-parallel transfer**: each "data" row of the mesh runs its own
    frames through the engine's bodies and the outputs are gathered to
    every rank (``frame_parallel_transfer``).

Collectives over CUDA tensors go through ``all_reduce`` alone (gathers as
SUMs of zero-padded buffers), which both NCCL and gloo take, so two gloo
ranks can share one card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from lidar_transfer_tpu_torch.metrics.confusion import confusion_matrix
from lidar_transfer_tpu_torch.ops import tsdf as TS
from lidar_transfer_tpu_torch.ops.splat import (SAMPLES_PER_RAY,
                                                _band_samples,
                                                assemble_candidate_parts)
from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda
from lidar_transfer_tpu_torch.pipeline.multiscan import (  # noqa: F401
    ScanWindow, stack_windows)

AXES = ("data", "model")


# ------------------------------------------------------------------ mesh
def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, str] = AXES,
              model: int | None = None):
    """A (data, model) ``DeviceMesh`` over the first ``n_devices`` ranks of
    the process group (all of them by default). ``model``: the model axis'
    size; None takes 2 when the count is even, else 1.

    Every rank of the group must call it (it makes the axes' process
    groups). Raises when the group has fewer ranks than asked: a smaller
    mesh would run unsharded without saying so.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested a {n}-rank mesh but the process group "
                         f"has {world} ranks")
    if model is None:
        model = 2 if n % 2 == 0 and n >= 2 else 1
    elif n % model:
        raise ValueError(f"{n} ranks not divisible by model={model}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=tuple(axis_names))


def axis_sizes(mesh) -> dict[str, int]:
    """{"data": n_data, "model": n_model} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_coordinate(mesh) -> tuple[int, int]:
    """This rank's (data, model) coordinate; raises outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh}")
    return int(coord[0]), int(coord[1])


def mesh_rank(mesh) -> int:
    """This rank's row-major place in the mesh, the index of its X-slab."""
    d, m = mesh_coordinate(mesh)
    return d * axis_sizes(mesh)["model"] + m


def _all_reduce(t: torch.Tensor, op, mesh, axes=AXES) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over ``axes`` of the mesh, one axis
    after the other (JAX's ``psum(psum(x, "model"), "data")``)."""
    for axis in reversed(axes):
        if axis_sizes(mesh)[axis] > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(axis))
    return t


# --------------------------------------------------------------- training
class _SumInputGrad(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model ranks, each of which holds the part its own output channels
    give."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ChannelGather(torch.autograd.Function):
    """Concatenate each model rank's output channels (dim 1). Every rank of
    the group computes the same loss from the gathered tensor, so the
    gradient of its own channels is its slice of the output's gradient
    (``torch.distributed.nn.functional.all_gather`` would sum the ranks'
    identical gradients, m times the true one)."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.rank = dist.get_rank(group)
        ctx.width = local.shape[1]
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.rank * ctx.width, ctx.width), None


def shard_params_tp(model: torch.nn.Module, mesh,
                    min_features: int = 256) -> torch.nn.Module:
    """Tensor-parallel placement, in place: every ``Conv2d`` with at least
    ``min_features`` output channels (a multiple of the model axis) keeps
    only this rank's block of them; its output is gathered over "model"
    (``_ChannelGather``) and its input's gradient summed over "model"
    (``_SumInputGrad``), so every rank computes the whole network with
    the exact gradient (GSPMD's collectives for a channel-sharded kernel);
    everything else stays replicated. The state-dict keys stay;
    ``tp_state_dict`` gathers the full tensors. Build the optimizer after
    this call."""
    m = axis_sizes(mesh)["model"]
    if m == 1:
        return model
    group = mesh.get_group("model")
    r = dist.get_rank(group)
    for conv in model.modules():
        if (isinstance(conv, torch.nn.Conv2d)
                and conv.out_channels >= min_features
                and conv.out_channels % m == 0):
            c = conv.out_channels // m
            conv.weight = torch.nn.Parameter(
                conv.weight.detach()[r * c:(r + 1) * c].clone())
            if conv.bias is not None:
                conv.bias = torch.nn.Parameter(
                    conv.bias.detach()[r * c:(r + 1) * c].clone())
            conv.out_channels = c
            conv.tp_width = m
            conv.register_forward_pre_hook(
                lambda mod, args: (_SumInputGrad.apply(args[0], group),))
            conv.register_forward_hook(
                lambda mod, args, out: _ChannelGather.apply(out, group))
    return model


def tp_state_dict(model: torch.nn.Module, mesh) -> dict:
    """The full (unsharded) state dict of a model placed by
    ``shard_params_tp``, on every rank of the model axis."""
    full = {}
    group = mesh.get_group("model") if axis_sizes(mesh)["model"] > 1 \
        else None
    split = {f"{name}.{p}" for name, mod in model.named_modules()
             if getattr(mod, "tp_width", 1) > 1 for p in ("weight", "bias")}
    for k, v in model.state_dict().items():
        if k in split:
            parts = [torch.empty_like(v)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, v.contiguous(), group=group)
            v = torch.cat(parts)
        full[k] = v.detach().clone()
    return full


def sharded_train_step(model: torch.nn.Module, optimizer, mesh):
    """A data-parallel train step: ``DistributedDataParallel`` over the
    mesh's "data" ranks around ``models.rangenet.train_step``, whose loss
    is the global batch's masked cross-entropy (see there). Each rank
    passes its slice of the global batch. -> ``step(batch) -> loss``, with
    ``step.ddp`` the wrapped model (its ``module`` is ``model``)."""
    from torch.nn.parallel import DistributedDataParallel

    from lidar_transfer_tpu_torch.models.rangenet import train_step

    dev = next(model.parameters()).device
    group = mesh.get_group("data")
    ddp = DistributedDataParallel(
        model, device_ids=[dev] if dev.type == "cuda" else None,
        process_group=group)

    def step(batch):
        return train_step(ddp, optimizer, batch, group=group)

    step.ddp = ddp
    return step


def sharded_confusion(mesh, n_classes: int):
    """-> ``fn(pred, target)``: the confusion counts of this rank's shard
    (row 3 on the card) summed over the "data" ranks with one
    ``all_reduce``; int32 (n_classes, n_classes), the same on every rank.
    Ranks of one "data" row hold the same shard (replicated over
    "model")."""

    def local(pred, target):
        cm = confusion_matrix(pred.reshape(-1).contiguous(),
                              target.reshape(-1).contiguous(), n_classes)
        return _all_reduce(cm, dist.ReduceOp.SUM, mesh, ("data",))

    return local


# ----------------------------------------------------------- the volume
def slab_range(spec: TS.VolumeSpec, mesh) -> tuple[int, int]:
    """-> (first global x, planes) of this rank's X-slab: the volume's X
    split over all ranks of the mesh (both axes, row-major)."""
    n = int(np.prod(mesh.shape))
    X = spec.dims[0]
    if X % n:
        raise ValueError(f"volume X dim {X} not divisible by {n}")
    slab = X // n
    return mesh_rank(mesh) * slab, slab


def _slab_spec(spec: TS.VolumeSpec, slab: int) -> TS.VolumeSpec:
    return TS.VolumeSpec(origin=spec.origin, voxel_size=spec.voxel_size,
                         dims=(slab,) + tuple(spec.dims[1:]))


def shard_volume(spec: TS.VolumeSpec, mesh, *, device="cuda",
                 compact: bool = False,
                 state: TS.TSDFState | None = None) -> TS.TSDFState:
    """This rank's X-slab of the volume, ``dims[0] / (data * model)``
    planes: a fresh float32 (or ``compact``) state, allocated for the slab
    alone; or, given a whole volume ``state``, a copy of its planes on
    ``device`` (its dtypes kept)."""
    x0, slab = slab_range(spec, mesh)
    if state is None:
        return _slab_spec(spec, slab).init_state(device, compact=compact)
    return TS.TSDFState(*(t[x0:x0 + slab].to(device).clone()
                          for t in state))


def integrate_sharded(state: TS.TSDFState, spec: TS.VolumeSpec, mesh,
                      depth_im, label_im, rem_im, *, fov_up_deg,
                      fov_down_deg, obs_weight: float = 1.0
                      ) -> TS.TSDFState:
    """Fuse one range image into this rank's X-slab ``state``, in place:
    ``integrate_cuda`` (row 1 on the card) with the GLOBAL origin, the full
    dims as the active dims and ``x_offset`` the slab's first plane. A
    voxel's update reads the image alone, so no collective runs.

    The global origin and an integer offset, not a per-slab float origin:
    ``origin + (x_offset + x) * voxel`` is then the same float32
    expression as in the whole volume, where a shifted origin would round
    again (0.05 is not exact in float32) and move voxels by ulps.
    """
    x0, slab = slab_range(spec, mesh)
    if tuple(state.tsdf.shape) != (slab,) + tuple(spec.dims[1:]):
        raise ValueError(f"integrate_sharded: slab shape "
                         f"{tuple(state.tsdf.shape)}, expected "
                         f"{(slab,) + tuple(spec.dims[1:])}")
    return integrate_cuda(
        state, _slab_spec(spec, slab), depth_im, label_im.to(torch.int32),
        rem_im, fov_up_deg=fov_up_deg, fov_down_deg=fov_down_deg,
        obs_weight=obs_weight, origin=spec.origin, active_dims=spec.dims,
        x_offset=x0)


def sharded_band_probe(state: TS.TSDFState, spec: TS.VolumeSpec, mesh,
                       rng_flat, pts_flat, valid_flat, *,
                       samples_per_ray: int = SAMPLES_PER_RAY,
                       label_probe: bool = False):
    """Truncation-band candidates of one source from the X-slabs.

    Each rank probes the samples that fall in its own slab
    (``ops/splat._band_samples`` with ``x_offset``: ownership by the
    global voxel index, so a sample lies in exactly one slab); the ray's
    winner, the smallest usable depth over all slabs, comes from one
    ``all_reduce(MIN)`` of ``where(found, t, inf)``, and the winner's
    tsdf, remission and label from one ``all_reduce(SUM)`` of int32 words
    that only the winning rank fills (the floats' bits: exact, -0.0
    kept). The position is ``dirs * t`` on every rank, the expression the
    winning rank used. Traffic is 16 bytes a ray, never the volume.

    Returns the candidates (pos (N,3), t, tsdf, label i32, rem, found),
    the same on every rank and equal to ``_band_samples`` on the whole
    volume wherever ``found``.
    """
    x0, slab = slab_range(spec, mesh)
    dev = rng_flat.device
    active = torch.tensor([slab] + list(spec.dims[1:]), dtype=torch.float32,
                          device=dev)
    origin = torch.as_tensor(np.asarray(spec.origin, np.float32),
                             device=dev)
    _, t, tsdf_v, lbl, rem, found = _band_samples(
        state.tsdf, state.label, state.rem, rng_flat, pts_flat, valid_flat,
        origin, active, spec.voxel_size, samples_per_ray,
        label_probe=label_probe, x_offset=x0)
    inf = torch.tensor(float("inf"), device=dev)
    tmin = _all_reduce(torch.where(found, t, inf), dist.ReduceOp.MIN, mesh)
    win = found & (t == tmin)
    words = torch.stack([tsdf_v.view(torch.int32), rem.view(torch.int32),
                         lbl.to(torch.int32)], dim=1)
    words = _all_reduce(torch.where(win[:, None], words, 0),
                        dist.ReduceOp.SUM, mesh)
    found_g = torch.isfinite(tmin)
    t_g = torch.where(found_g, tmin, 0.0)
    # _band_samples' own expression for the chosen sample's position
    dirs = pts_flat / torch.clamp(rng_flat, min=1e-6)[:, None]
    return (dirs * t_g[:, None], t_g, words[:, 0].view(torch.float32),
            words[:, 2].contiguous(), words[:, 1].view(torch.float32),
            found_g)


def splat_synthesize_sharded(state: TS.TSDFState, spec: TS.VolumeSpec,
                             mesh, sources, *, target_H: int, target_W: int,
                             fov_up_deg: float, fov_down_deg: float,
                             beam_angles=None,
                             samples_per_ray: int = SAMPLES_PER_RAY,
                             label_probe: bool = False, workspace=None):
    """Virtual-scan synthesis from an X-sharded fused volume: the
    distributed twin of ``ops/splat.splat_synthesize(attrs="volume")``.

    ``sources``: one (range_flat, points_flat (N,3), valid_flat) tuple per
    fused image (labels and remissions come from the volume). Each
    source's candidates come from ``sharded_band_probe``; the shared tail
    ``ops/splat.assemble_candidate_parts`` then z-buffers them into the
    target (row A) on every rank, so the outputs equal the single-process
    volume probe bit for bit. Returns (range, label, remission, endpoints,
    mask) on every rank.
    """
    parts = [sharded_band_probe(state, spec, mesh, r, p, v,
                                samples_per_ray=samples_per_ray,
                                label_probe=label_probe)
             for (r, p, v) in sources]
    return assemble_candidate_parts(
        parts, fov_up_deg=fov_up_deg, fov_down_deg=fov_down_deg,
        beam_angles=beam_angles, target_H=target_H, target_W=target_W,
        trunc=float(spec.trunc_margin), workspace=workspace)


# -------------------------------------------------------- frame parallel
def _frame_body(engine):
    """-> the engine body ``frame_parallel_transfer`` runs on a window,
    returning (range, label, remission, endpoints, mask); raises on the
    configurations the JAX package refuses."""
    adaption = engine.cfg.adaption
    use_fast = engine.synthesis == "splat"
    if adaption not in ("mergemesh", "mesh"):
        raise ValueError(f"frame_parallel_transfer supports mergemesh/mesh, "
                         f"got {adaption!r}")
    if adaption == "mesh":
        if not (use_fast and engine.mesh_attrs == "fold"):
            raise ValueError(
                "frame-parallel mesh needs the volume-free fold body "
                "(synthesis='splat', mesh_attrs='fold'): a materialised "
                "volume per frame does not fit")
        return lambda w: tuple(engine._mesh_fast_body(w)[0][:5])
    if use_fast and engine._interp_active:
        # a denser target keeps its chord candidates: the classic
        # deferred body, whose range image they are drawn in
        return lambda w: tuple(engine._mergemesh_core_deferred(w)[0][:5])
    if use_fast:
        return lambda w: tuple(engine._mergemesh_core_fast(w)[0])

    t = engine.target
    geom = engine._ensure_geom(t.fov_up, t.fov_down, engine.source.H)

    def materialised(w):
        # raymarch synthesis reads the volume: the resident one, reset by
        # the frame's integrate (with the placement's geometry table, as
        # in ``mergemesh()``)
        vs, _, state, _ = engine._mergemesh_core(w, engine._take_state(),
                                                 geom)
        engine._keep_state(state)
        return tuple(vs[:5])

    return materialised


def frame_parallel_transfer(engine, windows: ScanWindow, mesh=None):
    """Data-parallel transfer: each "data" row of the mesh runs its share
    of the frames, each frame with its own body (volume-free for the
    splat).

    Args:
      engine: a ``TransferEngine`` with ``fixed_bounds=True``, on this
        rank's card.
      windows: the global batch, a ``ScanWindow`` with a leading frame
        axis whose size the "data" axis divides (``stack_windows``); a
        rank reads only its own frames (``multihost.load_global_windows``
        loads no others).
      mesh: default ``make_mesh(model=1)``, every rank on the frame axis.

    Frame ``d * k + i`` runs on data row d (k frames a row), through the
    JAX engine's bodies: ``_mergemesh_core_fast``,
    ``_mergemesh_core_deferred`` for a denser target, ``_mesh_fast_body``
    for the mesh fold, ``_mergemesh_core`` (the volume fused in the frame)
    for raymarch synthesis. The outputs are gathered to every rank, as SUMs
    of zero-padded buffers over "data". Returns (range, label, remission,
    endpoints, mask) stacked over the global batch.
    """
    if not engine.fixed_bounds:
        raise ValueError("frame_parallel_transfer needs fixed_bounds=True")
    if mesh is None:
        mesh = make_mesh(model=1)
    n_dev = axis_sizes(mesh)["data"]
    batch = windows.points.shape[0]
    if batch % n_dev:
        raise ValueError(f"batch {batch} not divisible by {n_dev} devices")
    body = _frame_body(engine)
    per = batch // n_dev
    d = mesh_coordinate(mesh)[0]
    outs = [body(windows.frame(d * per + i)) for i in range(per)]
    gathered = []
    for j in range(5):
        local = torch.stack([o[j] for o in outs])
        gathered.append(_gather_frames(local, d * per, batch, mesh))
    return tuple(gathered)


def _gather_frames(local: torch.Tensor, first: int, batch: int, mesh):
    """Rows ``first..`` of a ``batch``-row tensor from each "data" row,
    gathered to every rank: one SUM of int32 words in a zero buffer, so
    float32 values (their bits, -0.0 kept), int32 and bool come back
    exact."""
    word = (local.to(torch.int32) if local.dtype == torch.bool
            else local.view(torch.int32))
    buf = torch.zeros((batch,) + tuple(local.shape[1:]), dtype=torch.int32,
                      device=local.device)
    buf[first:first + local.shape[0]] = word
    _all_reduce(buf, dist.ReduceOp.SUM, mesh, ("data",))
    return buf.bool() if local.dtype == torch.bool else buf.view(local.dtype)
