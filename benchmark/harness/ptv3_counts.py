"""PT-v3m1's work counted from the program's counters and the
configuration's widths: the products' operations of a train step and the
bytes of kernels E (neighbour map) and F (serialization), the yardsticks
of ``train_mfu.ptv3`` and of the two kernels' shares of their roofline.

The counters are ``models.ptv3.stage_counts()`` summed over the steps of
a stretch: points, padded tokens and query-key pairs a scale, neighbour
pairs a scale by kernel size. What a count means is fixed here, not by
the program's modules: a Linear is 2 C_in C_out operations a point, a
submanifold convolution 2 C_in C_out an occupied neighbour pair (the
gathered zeros of empty neighbours are not work), attention 4 C a
query-key pair of a padded patch (QK^T and AV), a backward twice the
forward.
"""

from __future__ import annotations

#: bytes a point kernel F reads (three int32 cells, an int32 cloud id) and
#: writes (four int64 codes)
SERIALIZE_BYTES = 16 + 4 * 8
#: bytes a point kernel E reads (cells and cloud id); it writes 4 an entry
NEIGHBOR_READ_BYTES = 16


def _by_scale(d: dict) -> dict:
    return {int(k): v for k, v in d.items()}


def forward_flops(cfg: dict, counts: dict) -> int:
    """Operations of the products of the forwards counted in ``counts``
    (``stage_counts()``)."""
    ec = list(cfg["enc_channels"])
    dc = list(cfg["dec_channels"]) + [ec[-1]]
    r = cfg["mlp_ratio"]
    pts, scores = _by_scale(counts["points"]), _by_scale(counts["scores"])
    pairs = counts["pairs"]

    def blocks(depth, c, s):
        per_point = 2 * c * c * (1 + 3 + 1 + 2 * r)   # cpe linear, qkv,
        return depth * (per_point * pts[s]            # proj, fc1, fc2
                        + 2 * c * c * pairs.get(f"k{cfg['cpe_kernel']}.{s}",
                                                0)
                        + 4 * c * scores[s])

    total = 2 * cfg["in_channels"] * ec[0] * pairs.get(
        f"k{cfg['stem_kernel']}.0", 0)
    for s in sorted(pts):
        total += blocks(cfg["enc_depths"][s], ec[s], s)
        if s:
            total += 2 * ec[s - 1] * ec[s] * pts[s - 1]
    for s in range(len(cfg["dec_channels"])):
        if s in pts:
            total += blocks(cfg["dec_depths"][s], dc[s], s)
            total += 2 * ec[s] * dc[s] * pts[s] \
                + 2 * dc[s + 1] * dc[s] * pts.get(s + 1, 0)
    return total + 2 * dc[0] * cfg["num_classes"] * pts.get(0, 0)


def train_flops(cfg: dict, counts: dict) -> int:
    """A train step's products: the forward and the backward's two (the
    gradients of the inputs and of the weights), 3x the forward."""
    return 3 * forward_flops(cfg, counts)


def serialize_bytes(counts: dict) -> int:
    """Kernel F's least traffic: every point of every scale serialized."""
    return SERIALIZE_BYTES * sum(counts["points"].values())


def neighbor_bytes(cfg: dict, counts: dict) -> int:
    """Kernel E's least traffic: each map reads its cells once and writes
    ``k^3`` entries a cell; the stem's map of kernel ``stem_kernel`` at
    scale 0 and one of ``cpe_kernel`` at every scale, a forward."""
    pts = _by_scale(counts["points"])
    total = 0
    for s, n in pts.items():
        total += n * (NEIGHBOR_READ_BYTES + 4 * cfg["cpe_kernel"] ** 3)
    return total + pts.get(0, 0) * (NEIGHBOR_READ_BYTES
                                    + 4 * cfg["stem_kernel"] ** 3)
