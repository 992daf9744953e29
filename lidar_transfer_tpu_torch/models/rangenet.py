"""RangeNet-style range-image semantic segmentation (PyTorch).

Counterpart of ``lidar_transfer_tpu/models/rangenet.py`` (flax): the same
network, parameter for parameter, so ``interop.rangenet_state_dict`` carries
a flax parameter tree across and both give the same logits.

  - darknet-style residual encoder that downsamples the width only (range
    images are 64 x 2048: H is small, W carries the angular resolution);
  - GroupNorm (group size 16, epsilon 1e-6 as flax's) in place of the
    original's BatchNorm: no running statistics;
  - ``compute_dtype`` convolutions (bf16 by default, under ``torch.autocast``)
    on float32 parameters; the last 1x1 convolution runs in float32;
  - a skip-connected decoder (nearest x2 along W) to per-pixel logits;
  - masked cross-entropy (no-data pixels carry weight 0).

Inputs and logits are (B, H, W, C) float32, as in the JAX module; inside,
the network runs NCHW. Input features per pixel: (range, x, y, z,
remission), the classic RangeNet 5-channel encoding.

Spans (``utils/runtime``): ``train_step`` is ``model.step`` with the
children ``model.forward`` (the loss included), ``model.backward`` and
``model.optimizer``; ``infer`` is ``model.infer``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lidar_transfer_tpu_torch.utils.runtime import span

#: flax's GroupNorm epsilon (``nn.GroupNorm`` defaults to 1e-5)
GN_EPS = 1e-6
GROUP_SIZE = 16


@dataclasses.dataclass(frozen=True)
class RangeNetConfig:
    num_classes: int = 34
    # residual blocks per stage (darknet53 uses (1,2,8,8,4))
    stage_blocks: tuple[int, ...] = (1, 2, 8, 8, 4)
    stage_features: tuple[int, ...] = (64, 128, 256, 512, 1024)
    stem_features: int = 32
    compute_dtype: torch.dtype = torch.bfloat16
    input_channels: int = 5
    # recompute the encoder's residual blocks in the backward pass
    # (torch.utils.checkpoint); the parameters are the same either way
    remat: bool = False

    @classmethod
    def darknet53(cls, num_classes: int = 34) -> "RangeNetConfig":
        """lidar-bonnetal's published darknet53 backbone shape (1,2,8,8,4
        residual stages)."""
        return cls(num_classes=num_classes)

    @classmethod
    def darknet21(cls, num_classes: int = 34) -> "RangeNetConfig":
        return cls(num_classes=num_classes, stage_blocks=(1, 1, 2, 2, 1))

    @classmethod
    def tiny(cls, num_classes: int = 34) -> "RangeNetConfig":
        """For tests and dry runs."""
        return cls(num_classes=num_classes, stage_blocks=(1, 1),
                   stage_features=(32, 64), stem_features=16)


def _norm(features: int) -> nn.GroupNorm:
    return nn.GroupNorm(features // GROUP_SIZE, features, eps=GN_EPS)


class ConvNorm(nn.Module):
    """Bias-free convolution, GroupNorm, leaky ReLU (0.1); the result in
    the input's dtype. ``stride_w=2`` halves the width with flax's SAME
    padding of an even width: (0, 1), so output column j starts at input
    column 2j (``Conv2d(padding=1)`` would start it at 2j - 1)."""

    def __init__(self, cin: int, cout: int, ksize: int = 3,
                 stride_w: int = 1):
        super().__init__()
        self.stride_w = stride_w
        pad = ksize // 2
        self.conv = nn.Conv2d(cin, cout, ksize, stride=(1, stride_w),
                              padding=(pad, 0 if stride_w == 2 else pad),
                              bias=False)
        self.norm = _norm(cout)

    def forward(self, x):
        dt = x.dtype
        if self.stride_w == 2:
            x = F.pad(x, (0, 1))
        h = self.conv(x)
        return F.leaky_relu(self.norm(h), 0.1).to(dt)


class ResBlock(nn.Module):
    """1x1 to half the features, 3x3 back, each normalised; plus x."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = ConvNorm(features, features // 2, ksize=1)
        self.conv2 = ConvNorm(features // 2, features)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class RangeNet(nn.Module):
    """Width-downsampling darknet encoder + skip decoder."""

    def __init__(self, cfg: RangeNetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.stem = ConvNorm(c.input_channels, c.stem_features)
        widths = [c.stem_features] + list(c.stage_features)
        self.down = nn.ModuleList(
            ConvNorm(widths[s], widths[s + 1], stride_w=2)
            for s in range(len(c.stage_blocks)))
        # one flat list, in flax's ResBlock_<i> order
        self.blocks = nn.ModuleList(
            ResBlock(f) for n, f in zip(c.stage_blocks, c.stage_features)
            for _ in range(n))
        up, cin = [], widths[-1]
        for skip in reversed(widths[:-1]):
            up.append(ConvNorm(cin, max(skip, 32)))
            cin = max(skip, 32) + skip
        self.up = nn.ModuleList(up)
        self.head = nn.Conv2d(cin, c.num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, input_channels) -> (B, H, W, num_classes) float32."""
        c = self.cfg
        dt = c.compute_dtype
        x = x.permute(0, 3, 1, 2)
        # pad the width to a multiple of 2^stages by repeating the edge
        # column (the decoder's x2 resizes must land on their skips);
        # the logits are cropped back below
        W_in = x.shape[-1]
        pad_w = (-W_in) % (2 ** len(c.stage_blocks))
        if pad_w:
            x = F.pad(x, (0, pad_w, 0, 0), mode="replicate")
        with torch.autocast(x.device.type, dtype=dt,
                            enabled=dt != torch.float32):
            h = self.stem(x.to(dt))
            skips, blk = [], 0
            for down, n in zip(self.down, c.stage_blocks):
                skips.append(h)
                h = down(h)
                for block in self.blocks[blk:blk + n]:
                    if c.remat and torch.is_grad_enabled():
                        h = checkpoint(block, h, use_reentrant=False)
                    else:
                        h = block(h)
                blk += n
            for up, skip in zip(self.up, reversed(skips)):
                h = up(h.repeat_interleave(2, dim=-1))
                h = torch.cat([h, skip.to(h.dtype)], dim=1)
        with torch.autocast(x.device.type, enabled=False):
            logits = self.head(h.float())
        return logits[..., :W_in].permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers, drawn from ``generator`` (a CPU generator
        for the same draws on every device): convolution kernels from
        ``lecun_normal`` (a normal truncated at two standard deviations,
        rescaled to variance 1/fan_in), biases 0, GroupNorm scale 1 and
        bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / .87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def range_image_features(rng, xyz, remission, mask) -> torch.Tensor:
    """Stack the 5-channel RangeNet input from projection outputs.

    Args: rng (H,W), xyz (H,W,3), remission (H,W), mask (H,W) bool.
    """
    feats = torch.cat([rng[..., None], xyz,
                       torch.clamp(remission, min=0.0)[..., None]], dim=-1)
    return torch.where(mask[..., None], feats, 0.0)


def masked_cross_entropy(logits, labels, weights,
                         total: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over pixels with weight > 0; labels are class indices.
    ``total``: the weight sum to divide by (a 0-dim tensor; default this
    batch's), the global batch's where each rank holds a slice of it."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    w = weights.to(torch.float32)
    total = w.sum() if total is None else total
    return -(ll * w).sum() / torch.clamp(total, min=1.0)


class BF16MomentAdam(torch.optim.Optimizer):
    """Adam whose first moment is stored in bfloat16:
    ``optax.adam(lr, mu_dtype=jnp.bfloat16)``, step for step.

    As optax's ``scale_by_adam`` computes it: the new moment is
    ``(1 - b1) * g + b1' * mu`` in float32 from the stored bf16 ``mu``,
    where ``b1'`` is b1 rounded to bf16 (0.9 -> 0.8984375: JAX gives the
    Python float the moment's dtype), while the bias correction uses b1
    itself (``1 - b1 ** t`` in float32). This step's update uses the
    float32 moment unrounded; only then is it stored as bf16 (round to
    nearest even). The second moment stays float32. Optax's order within
    a step: ``m_hat = m / (1 - b1**t)``, ``v_hat = v / (1 - b2**t)``,
    ``p += -lr * (m_hat / (sqrt(v_hat) + eps))``. Plain PyTorch (one
    multi-tensor operation a term where the dtypes allow)."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    def load_state_dict(self, state_dict) -> None:
        # Optimizer.load_state_dict casts every state tensor to its
        # parameter's dtype; the bf16 values come back exactly
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = []
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(
                        p, dtype=torch.bfloat16,
                        memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                st["step"] += 1
                states.append(st)
            # one step count for the group, as optax's single count
            t = np.float32(states[0]["step"].item())
            grads = [p.grad for p in params]
            mu = [st["exp_avg"].float() for st in states]
            b1_bf16 = torch.tensor(b1, dtype=torch.bfloat16).item()
            torch._foreach_mul_(mu, b1_bf16)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            nu = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            # the corrections in float32, as optax's 1 - b ** count
            c1 = float(np.float32(1) - np.float32(b1) ** t)
            c2 = float(np.float32(1) - np.float32(b2) ** t)
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mu, c1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(params, upd, alpha=-group["lr"])
            for st, m in zip(states, mu):
                st["exp_avg"].copy_(m)
        return loss


def make_train_state(model: RangeNet, generator: torch.Generator,
                     learning_rate: float = 1e-3,
                     mu_bf16: bool = False) -> torch.optim.Optimizer:
    """Initialise ``model``'s parameters from ``generator`` and return its
    Adam optimizer, with optax.adam's defaults (b1 0.9, b2 0.999, eps
    1e-8); ``mu_bf16``: :class:`BF16MomentAdam` (optax's
    ``mu_dtype=bfloat16``)."""
    model.init_parameters(generator)
    if mu_bf16:
        return BF16MomentAdam(model.parameters(), lr=learning_rate)
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def train_step(model: RangeNet, optimizer: torch.optim.Optimizer,
               batch: dict, group=None) -> torch.Tensor:
    """One Adam step on ``batch`` (features, labels, weights); -> the loss,
    a device scalar (reading it waits for the device).

    ``group``: the process group of a ``DistributedDataParallel`` ``model``
    whose ranks each hold a slice of the global batch. The loss is then the
    global batch's: the weight sum is reduced before the backward, and each
    rank's share is scaled by the rank count, so that DDP's mean of the
    ranks' gradients is the gradient of the global ratio (a mean of the
    ranks' own ratios would weigh a pixel by its rank's valid-pixel count).
    The loss returned is the global one on every rank.
    """
    with span("model.step"):
        optimizer.zero_grad(set_to_none=True)
        w = batch["weights"]
        if group is None:
            with span("model.forward"):
                loss = masked_cross_entropy(model(batch["features"]),
                                            batch["labels"], w)
            with span("model.backward"):
                loss.backward()
        else:
            import torch.distributed as dist

            with span("model.forward"):
                total = w.to(torch.float32).sum()
                dist.all_reduce(total, group=group)
                loss = masked_cross_entropy(model(batch["features"]),
                                            batch["labels"], w, total=total)
            with span("model.backward"):
                (loss * dist.get_world_size(group)).backward()
            loss = loss.detach()
            dist.all_reduce(loss, group=group)
        with span("model.optimizer"):
            optimizer.step()
        return loss.detach()


@torch.no_grad()
def infer(model: RangeNet, features: torch.Tensor) -> torch.Tensor:
    """-> per-pixel argmax class indices, int32."""
    with span("model.infer"):
        return torch.argmax(model(features), dim=-1).to(torch.int32)
