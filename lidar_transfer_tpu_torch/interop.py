"""Carry windows, volumes, range images and models between the packages.

The JAX package's ``ScanWindow``, ``TSDFState`` and ``RangeImage`` (or any
object with the same fields holding numpy-convertible arrays) become the
port's tensors on a chosen device, and :func:`to_numpy` turns the port's
tensors and tuples of tensors back into numpy arrays. A flax RangeNet's
parameter tree and its optax Adam state, as nested dicts of numpy arrays,
become the port's ``state_dict`` (:func:`rangenet_state_dict`) and
``torch.optim.Adam`` state (:func:`adam_state_from_optax`). This module
imports no jax: it only reads the fields.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_transfer_tpu_torch.models.rangenet import RangeNet, RangeNetConfig
from lidar_transfer_tpu_torch.ops.projection import RangeImage
from lidar_transfer_tpu_torch.ops.tsdf import (COMPACT_DTYPES, F32_DTYPES,
                                               TSDFState)
from lidar_transfer_tpu_torch.pipeline.multiscan import ScanWindow


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def window_from_numpy(window, device="cpu") -> ScanWindow:
    """A window with fields points/remissions/labels/valid/rel_pose (primary
    scan first) -> the port's ScanWindow."""
    return ScanWindow(
        points=_tensor(window.points, device),
        remissions=_tensor(window.remissions, device),
        labels=_tensor(window.labels, device),
        valid=_tensor(window.valid, device),
        rel_pose=_tensor(window.rel_pose, device))


def state_from_numpy(state, device="cpu", compact: bool = False
                     ) -> TSDFState:
    """A volume with fields tsdf/weight/label/rem -> the port's TSDFState:
    f32/f32/i32/f32, or with ``compact`` bf16/bf16/int16/bf16. A JAX
    compact state's values (bf16 and int16) cross over exactly either way;
    a float32 state becomes compact by rounding to nearest even."""
    dts = COMPACT_DTYPES if compact else F32_DTYPES
    # numpy has no bf16: values pass as float32 (exact for bf16 values);
    # np.array copies, so the port's in-place updates leave ``state`` be
    return TSDFState(*(
        torch.from_numpy(np.array(getattr(state, f), np.float32
                                  if dt.is_floating_point else np.int32)
                         ).to(device=device, dtype=dt)
        for f, dt in zip(TSDFState._fields, dts)))


def range_image_from_numpy(ri, device="cpu") -> RangeImage:
    """A range image with the RangeImage fields -> the port's RangeImage."""
    return RangeImage(*(_tensor(getattr(ri, f), device)
                        for f in RangeImage._fields))


def to_numpy(x):
    """Tensor -> numpy array (bf16 as float32); NamedTuple / tuple / list
    -> the same container of numpy arrays (other values pass through)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        # numpy has no bf16; float32 holds every bf16 value exactly
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x


def _rangenet_layers(cfg: RangeNetConfig) -> list[tuple[tuple[str, ...], str]]:
    """(flax module path, the port's module name) of every layer, in
    flax's auto-naming: ``Conv_i`` and ``GroupNorm_i`` count the stem, the
    stages' downsampling, then the decoder; the last ``Conv`` is the head;
    ``ResBlock_i`` holds ``Conv_0, GroupNorm_0, Conv_1, GroupNorm_1``."""
    n = len(cfg.stage_blocks)
    layers = [(("Conv_0",), "stem.conv"), (("GroupNorm_0",), "stem.norm")]
    for s in range(n):
        layers += [((f"Conv_{1 + s}",), f"down.{s}.conv"),
                   ((f"GroupNorm_{1 + s}",), f"down.{s}.norm")]
    for i in range(sum(cfg.stage_blocks)):
        for j, part in enumerate(("conv1", "conv2")):
            layers += [((f"ResBlock_{i}", f"Conv_{j}"),
                        f"blocks.{i}.{part}.conv"),
                       ((f"ResBlock_{i}", f"GroupNorm_{j}"),
                        f"blocks.{i}.{part}.norm")]
    for d in range(n):
        layers += [((f"Conv_{1 + n + d}",), f"up.{d}.conv"),
                   ((f"GroupNorm_{1 + n + d}",), f"up.{d}.norm")]
    return layers + [((f"Conv_{2 * n + 1}",), "head")]


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


#: flax leaf name -> (the port's parameter name, to the port's layout)
_LEAVES = {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)),
           "scale": ("weight", lambda a: a),
           "bias": ("bias", lambda a: a)}


def rangenet_state_dict(params: dict, cfg: RangeNetConfig
                        ) -> dict[str, torch.Tensor]:
    """A flax ``RangeNet(cfg)`` parameter tree (nested dicts of numpy
    arrays, with or without the outer ``"params"``) -> the port's
    ``RangeNet(cfg).state_dict()``, float32 on the CPU. Convolution
    kernels go from (kh, kw, in, out) to (out, in, kh, kw). Raises
    ``ValueError`` on a leaf left over, a parameter missing or a shape
    that differs."""
    if set(params) == {"params"}:
        params = params["params"]
    with torch.device("meta"):
        want = RangeNet(cfg).state_dict()
    flat = _flatten(params)
    out = {}
    for path, name in _rangenet_layers(cfg):
        for leaf, (pname, layout) in _LEAVES.items():
            if path + (leaf,) not in flat:
                continue
            a = np.asarray(flat.pop(path + (leaf,)), np.float32)
            key = f"{name}.{pname}"
            t = torch.from_numpy(np.array(layout(a)))
            if key not in want or tuple(t.shape) != tuple(want[key].shape):
                raise ValueError(
                    f"flax {'/'.join(path + (leaf,))} {a.shape} does not "
                    f"fit {key} "
                    f"{tuple(want[key].shape) if key in want else None}")
            out[key] = t
    if flat:
        raise ValueError("flax leaves left over: "
                         + ", ".join("/".join(p) for p in flat))
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"parameters missing from the flax tree: {missing}")
    return out


def adam_state_from_optax(optimizer: torch.optim.Optimizer,
                          model: RangeNet, mu: dict, nu: dict,
                          count) -> dict:
    """optax Adam state of ``model``'s flax counterpart (``mu``, ``nu``:
    parameter-shaped trees; ``count``: the step) -> a state dict for
    ``optimizer.load_state_dict`` (``exp_avg``, ``exp_avg_sq``, ``step``)
    on the parameters' devices. A bfloat16 ``mu`` (``optax.adam(...,
    mu_dtype=jnp.bfloat16)``) comes across as a bfloat16 ``exp_avg``,
    value for value, for ``models.BF16MomentAdam``. Raises as
    :func:`rangenet_state_dict`."""
    bf16 = {np.asarray(a).dtype.name
            for a in _flatten(mu).values()} == {"bfloat16"}
    m = rangenet_state_dict(mu, model.cfg)
    if bf16:
        # float32 holds every bfloat16 value: back to bfloat16 exactly
        m = {k: t.to(torch.bfloat16) for k, t in m.items()}
    v = rangenet_state_dict(nu, model.cfg)
    names = {id(p): n for n, p in model.named_parameters()}
    state, idx = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            state[idx] = {"step": torch.tensor(float(np.asarray(count))),
                          "exp_avg": m[name].to(p.device),
                          "exp_avg_sq": v[name].to(p.device)}
            idx += 1
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}
