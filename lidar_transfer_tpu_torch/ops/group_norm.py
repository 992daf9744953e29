"""GroupNorm, its affine and leaky ReLU (0.1) in one forward: CUDA kernel D
(``csrc/group_norm.cu``) and its plain version.

The forward of ``models/rangenet.ConvNorm`` after its convolution: under
bf16 autocast, GroupNorm casts the bf16 convolution output to float32, and
the leaky ReLU's float32 result is cast back to bf16.
:func:`group_norm_leaky_relu` takes :func:`group_norm_leaky_relu_plain`
(that composition) for a CPU tensor; a CUDA tensor launches the kernel,
which computes the same in float32 and rounds once to the input's dtype,
or raises. The kernel has no backward: it refuses an input that requires
grad while grad mode is on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lidar_transfer_tpu_torch import _build

SLOPE = 0.1
#: threads a block (``kThreads`` of the source)
THREADS = 256
#: blocks of the statistics kernel a call aims at: about four a SM of an
#: H100 at any batch
STATS_BLOCKS = 512
DTYPES = (torch.bfloat16, torch.float32)


def group_norm_leaky_relu_plain(x: torch.Tensor, groups: int,
                                weight: torch.Tensor, bias: torch.Tensor,
                                eps: float) -> torch.Tensor:
    """``leaky_relu(group_norm(x), 0.1)`` in ``x``'s dtype: ConvNorm's
    composition, as ATen computes it."""
    return F.leaky_relu(F.group_norm(x, groups, weight, bias, eps),
                        SLOPE).to(x.dtype)


def stats_layout(groups: int, span: int, vec: int) -> tuple[int, int]:
    """-> (S, chunk): each group's ``span`` elements cut into S chunks of
    ``chunk`` (the last may be shorter, none is empty), a multiple of
    ``vec``, so that ``groups * S`` is near ``STATS_BLOCKS``, in no more
    chunks than a vector a thread of a block would make."""
    per_group = -(-STATS_BLOCKS // groups)
    most = -(-span // (THREADS * vec))
    S = max(1, min(per_group, most))
    chunk = -(-span // S)
    chunk = -(-chunk // vec) * vec
    return -(-span // chunk), chunk


def _check(x, groups, weight, bias) -> None:
    """Raise unless the kernel takes these arguments (the device last, so
    that the CPU tests reach each other refusal)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"group_norm_leaky_relu: input {x.dtype}; the "
                        f"kernel takes {DTYPES}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"group_norm_leaky_relu: input of shape "
                         f"{tuple(x.shape)}; need a non-empty (N, C, ...)")
    if not x.is_contiguous():
        raise ValueError("group_norm_leaky_relu: input must be contiguous")
    C = x.shape[1]
    if groups <= 0 or C % groups:
        raise ValueError(f"group_norm_leaky_relu: {C} channels in {groups} "
                         "groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (C,) or not t.is_contiguous()):
            raise ValueError(f"group_norm_leaky_relu: {name} must be a "
                             f"contiguous float32 ({C},) tensor on "
                             f"{x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("group_norm_leaky_relu: the kernel has no "
                           "backward; call it with grad mode off or on "
                           "tensors that need no gradient")
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_leaky_relu: input on {x.device}; the "
                         "kernel takes a CUDA tensor")


def group_norm_leaky_relu_cuda(x: torch.Tensor, groups: int,
                               weight: torch.Tensor, bias: torch.Tensor,
                               eps: float) -> tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """Kernel D on the current stream; -> (output in ``x``'s dtype, each
    (sample, group)'s float32 mean and 1 / sqrt(biased variance + eps),
    (N, G) each)."""
    _check(x, groups, weight, bias)
    N, C = x.shape[:2]
    HW = x.numel() // (N * C)
    vec = 16 // x.element_size()
    if HW % vec or x.data_ptr() % 16:
        vec = 1
    S, chunk = stats_layout(N * groups, C // groups * HW, vec)
    part = torch.empty((N * groups * S, 3), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((2, N, groups), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _build.launch("group_norm", "lt_group_norm", x.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), N, C, groups, HW, eps,
                  int(x.dtype == torch.bfloat16), vec, S, chunk,
                  part.data_ptr(), y.data_ptr(), stats[0].data_ptr(),
                  stats[1].data_ptr(), _build.stream_handle(x.device))
    return y, stats[0], stats[1]


def group_norm_leaky_relu(x: torch.Tensor, groups: int,
                          weight: torch.Tensor, bias: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """``leaky_relu(group_norm(x, groups, weight, bias, eps), 0.1)`` in
    ``x``'s dtype: the plain version for a CPU tensor, kernel D for a CUDA
    one. The kernel gets ``x`` contiguous, as ATen's GroupNorm makes its
    input on the card: RangeNet's stem convolves the permuted (B, H, W, C)
    features, and the convolution answers them in channels-last."""
    if x.device.type == "cpu":
        return group_norm_leaky_relu_plain(x, groups, weight, bias, eps)
    return group_norm_leaky_relu_cuda(x.contiguous(), groups, weight, bias,
                                      eps)[0]
