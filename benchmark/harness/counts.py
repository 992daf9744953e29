"""The work of a step counted from shapes, and the card's
published peaks: the yardstick of the shares of a peak (``*_mfu``).

The convolution operations are counted from the darknet shape that the
configuration file states, not from the port's modules, so a change to
the modules leaves the count alone. ``tests/test_perf_counts.py`` holds
them to the port's ``probes/bounds.py``.
"""

from __future__ import annotations

#: published dense bf16 rate of an H100 SXM on its tensor cores, FLOP/s
H100_BF16_FLOPS = 989e12
#: published device-memory rate of an H100 SXM, bytes/s
H100_BYTES_PER_S = 3.35e12


def darknet_forward_flops(cfg: dict, H: int, W: int) -> int:
    """Operations (a multiply and an add each) of every convolution of one
    forward of the configuration's network on one (H, W) image: stem,
    the width-halving stage convolutions, the residual blocks (1x1 to
    half the features, 3x3 back), the decoder's 3x3 convolutions after
    each x2 upsampling, and the 1x1 head."""
    def conv(cin, cout, k, w):
        return 2 * cout * H * w * cin * k * k

    widths = [cfg["stem_features"]] + list(cfg["stage_features"])
    total = conv(cfg["input_channels"], widths[0], 3, W)
    w = W
    for s, n in enumerate(cfg["stage_blocks"]):
        w //= 2
        f = widths[s + 1]
        total += conv(widths[s], f, 3, w)
        total += n * (conv(f, f // 2, 1, w) + conv(f // 2, f, 3, w))
    cin = widths[-1]
    for skip in reversed(widths[:-1]):
        w *= 2
        total += conv(cin, max(skip, 32), 3, w)
        cin = max(skip, 32) + skip
    return total + conv(cin, cfg["num_classes"], 1, w)


def train_step_flops(forward_flops: int) -> int:
    """A train step: the forward and the backward's two products (the
    gradients of the inputs and of the weights), 3x the forward."""
    return 3 * forward_flops

