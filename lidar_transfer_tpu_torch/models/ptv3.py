"""Point Transformer V3 (PT-v3m1) for LiDAR point segmentation (PyTorch).

Wu et al., "Point Transformer V3: Simpler, Faster, Stronger", CVPR 2024,
as Pointcept's ``configs/semantic_kitti/semseg-pt-v3m1-0-base.py`` sets it
up (:meth:`PTv3Config.base`). The JAX package has no counterpart: the
port's reference is ``reference_ptv3.py``, plain float32 PyTorch.

Each scan's points ``[x, y, z, remission]`` go in whole; the step keeps
one point a 0.05 m cell (:func:`grid_sample`), its cell
``g = floor(p / 0.05) - min over the scan``. Then:

  - serialization: four space-filling-curve codes of every point
    (``ops/serialize``: z, z-trans, hilbert, hilbert-trans; kernel F on the
    card), their order shuffled at each of the five scales;
  - a 5^3 submanifold convolution stem (``ops/sparse_conv``: the neighbour
    map, kernel E on the card), BatchNorm, GELU;
  - blocks ``x += LN(Linear(SubMConv3(x)))``, ``x += DropPath(Attn(LN x))``,
    ``x += DropPath(MLP(LN x))``; block ``i`` of a stage attends in
    patches of ``K`` points along order ``i mod 4``;
  - stride-2 pooling of the cells of ``code >> 3`` (max of a Linear, BN,
    GELU), unpooling back to the skip (:class:`Unpool`), a Linear head.

``compute_dtype`` bfloat16 runs the products and attention under
``torch.autocast`` on float32 parameters; norms, softmax statistics and
the loss stay float32. The step's randomness (the cell picks, the order
shuffles, drop path by point) comes from the ``torch.Generator`` it takes,
in a fixed order, so a reference given the same generator draws the same.

Spans (``utils/runtime``), inside ``model.step`` or ``model.infer``:
``ptv3.grid_sample``, ``ptv3.serialize``, ``ptv3.neighbors``,
``ptv3.pool``, ``ptv3.unpool``. Counters (:func:`stage_counts`,
:func:`reset_stage_counts`): points, patches, padded tokens and
query-key pairs a scale, neighbour pairs a scale of each kernel size
(these only once a reset has started them: each costs a pass over its
map), summed over forwards.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from lidar_transfer_tpu_torch.ops import serialize as S
from lidar_transfer_tpu_torch.ops import sparse_conv as SC
from lidar_transfer_tpu_torch.utils.runtime import span

#: Pointcept's BatchNorm1d (eps 1e-3, momentum 0.01) and LayerNorm eps
BN_EPS, BN_MOMENTUM, LN_EPS = 1e-3, 0.01, 1e-5
#: attention's kernels: FlashAttention first; not cuDNN's, which builds a
#: plan for every new number of patches (some 300 ms of host time a step
#: of four scans)
SDPA_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.MATH]


@dataclasses.dataclass(frozen=True)
class PTv3Config:
    num_classes: int = 26
    in_channels: int = 4
    grid_size: float = 0.05
    enc_channels: tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_heads: tuple[int, ...] = (2, 4, 8, 16, 32)
    enc_depths: tuple[int, ...] = (2, 2, 2, 6, 2)
    dec_channels: tuple[int, ...] = (64, 64, 128, 256)
    dec_heads: tuple[int, ...] = (4, 4, 8, 16)
    dec_depths: tuple[int, ...] = (2, 2, 2, 2)
    patch_size: int = 1024
    mlp_ratio: int = 4
    drop_path: float = 0.3
    stem_kernel: int = 5
    cpe_kernel: int = 3
    compute_dtype: torch.dtype = torch.bfloat16
    learning_rate: float = 0.002
    block_learning_rate: float = 0.0002
    weight_decay: float = 0.005

    @classmethod
    def base(cls, num_classes: int = 26) -> "PTv3Config":
        """Pointcept's semseg-pt-v3m1-0-base (about 46 M parameters)."""
        return cls(num_classes=num_classes)

    @classmethod
    def tiny(cls, num_classes: int = 26) -> "PTv3Config":
        """Two scales of 16 and 32 channels, patches of 64: tests and
        dry runs."""
        return cls(num_classes=num_classes, enc_channels=(16, 32),
                   enc_heads=(2, 4), enc_depths=(2, 2), dec_channels=(16,),
                   dec_heads=(2,), dec_depths=(2,), patch_size=64)

    @classmethod
    def from_dict(cls, d: dict) -> "PTv3Config":
        """From a configuration file's keys (tuples for lists, the dtype by
        name); keys that are not fields are left out."""
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                v = d[f.name]
                kw[f.name] = (getattr(torch, v) if f.name == "compute_dtype"
                              else tuple(v) if isinstance(v, list) else v)
        return cls(**kw)

    def drop_paths(self) -> tuple[list[list[float]], list[list[float]]]:
        """Drop-path rates a block, as Pointcept spreads them: linearly
        from 0 to ``drop_path`` over the encoder's blocks, and over the
        decoder's, each decoder stage's slice reversed. -> (encoder, decoder)
        rates by stage (the decoder's by scale)."""
        def spread(depths):
            n = sum(depths)
            r = [self.drop_path * i / (n - 1) if n > 1 else 0.0
                 for i in range(n)]
            return [r[sum(depths[:s]):sum(depths[:s + 1])]
                    for s in range(len(depths))]
        return spread(self.enc_depths), [d[::-1] for d in
                                         spread(self.dec_depths)]


# ------------------------------------------------------------ counters
_counts: dict = dict(points={}, patches={}, padded={}, scores={}, pairs={})
#: whether forwards count the occupied neighbour pairs, a pass over each
#: map on the device: off until the first :func:`reset_stage_counts`
_count_pairs = False


def reset_stage_counts() -> None:
    """Clears the counters and counts the neighbour pairs from now on."""
    global _count_pairs
    for d in _counts.values():
        d.clear()
    _count_pairs = True


def _add(key: str, scale, value) -> None:
    d = _counts[key]
    d[scale] = d.get(scale, 0) + value


def stage_counts() -> dict:
    """Since the last :func:`reset_stage_counts`, summed over forwards:
    ``points``, ``patches``, ``padded`` (patches times ``K``) and
    ``scores`` (patches times ``K^2``, an attention's query-key pairs) by
    scale; ``pairs`` by ``"k<size>.<scale>"``, the occupied entries of the
    neighbour maps (read from the device here), counted only since the
    first reset."""
    return {**{k: dict(_counts[k]) for k in ("points", "patches", "padded",
                                             "scores")},
            "pairs": {k: int(v) for k, v in _counts["pairs"].items()}}


# ------------------------------------------------------- points, scales
def _clouds(counts: list[int], device) -> torch.Tensor:
    return torch.cat([torch.full((c,), b, dtype=torch.int64, device=device)
                      for b, c in enumerate(counts)])


def grid_sample(points: torch.Tensor, counts: list[int], size: float,
                generator: torch.Generator | None = None):
    """One point a cell of each scan. ``points`` (N, >=3) the scans one
    after the other, ``counts`` their sizes. A cell is
    ``floor(p / size) - min over the scan``; with ``generator`` each cell
    keeps a point drawn uniformly (a permutation from ``N`` uniforms),
    without one its first point. -> (picked point indices (M,) by (scan,
    cell key), cells (M, 3) int32, scan ids (M,), points a scan, each
    point's index into the picks (N,))."""
    with span("ptv3.grid_sample"):
        n, dev = points.shape[0], points.device
        cloud = _clouds(counts, dev)
        cell = torch.floor(points[:, :3] / size).long()
        lo = torch.full((len(counts), 3), torch.iinfo(torch.int64).max,
                        device=dev).scatter_reduce(
            0, cloud[:, None].expand(-1, 3), cell, "amin")
        g = cell - lo[cloud]
        key = SC.cell_keys(g, cloud)
        perm = (torch.arange(n, device=dev) if generator is None else
                torch.argsort(torch.rand(n, generator=generator, device=dev),
                              stable=True))
        sk, si = torch.sort(key[perm], stable=True)
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = sk[1:] != sk[:-1]
        pick = perm[si[first]]
        inverse = torch.empty_like(perm)
        inverse[perm[si]] = torch.cumsum(first, 0) - 1
        cl = cloud[pick]
        picked = torch.bincount(cl, minlength=len(counts)).tolist()
        return pick, g[pick].to(torch.int32), cl, picked, inverse


class Scale:
    """The points of one scale: cells, scan ids and counts, their four
    shuffled codes, orders and inverses, the attention's patch layout and
    the neighbour maps (built at first use)."""

    def __init__(self, index: int, grid: torch.Tensor, cloud: torch.Tensor,
                 counts: list[int]):
        self.index, self.grid, self.cloud, self.counts = (index, grid, cloud,
                                                          counts)
        self.n = grid.shape[0]
        self._maps: dict[int, torch.Tensor] = {}
        #: each point's cluster at the next scale (set by :func:`pool`)
        self.cluster: torch.Tensor | None = None

    def serialize(self, generator, patch_size: int) -> None:
        """The four codes in the generator's shuffled order, each order
        and inverse, and the patches: each scan's sequence in patches of
        ``K = min(patch_size, the smallest scan's points)``, its last patch
        filled with copies of the entries ``K`` places before."""
        with span("ptv3.serialize"):
            bits = S.depth(self.grid)
            if bits > 16:
                raise ValueError(f"ptv3: cells need {bits} bits an axis; "
                                 "the neighbour map takes 16")
            codes = S.encode(self.grid, self.cloud, bits)
            codes = codes[S.shuffle(generator, self.grid.device)]
            order, inverse = S.orders(codes)
            self.codes = codes
            K = min(patch_size, min(self.counts))
            dev = self.grid.device
            pads, unpads, off, pad_off = [], [], 0, 0
            for c in self.counts:
                cp = -(-c // K) * K
                j = torch.arange(cp, device=dev)
                pads.append(off + torch.where(j >= c, j - K, j))
                unpads.append(pad_off + torch.arange(c, device=dev))
                off, pad_off = off + c, pad_off + cp
            pad, unpad = torch.cat(pads), torch.cat(unpads)
            self.K, self.patches = K, pad_off // K
            #: (4, P K) point indices of each order's padded sequence
            self.seq = order[:, pad]
            #: (4, N) each point's first place in that sequence
            self.back = unpad[inverse]
            _add("points", self.index, self.n)
            _add("patches", self.index, self.patches)
            _add("padded", self.index, pad_off)
            _add("scores", self.index, pad_off * K)

    def neighbors(self, k: int) -> torch.Tensor:
        """The neighbour map of kernel ``k`` (N, k^3), built once."""
        if k not in self._maps:
            with span("ptv3.neighbors"):
                nbr = SC.neighbor_map(self.grid, self.cloud, k)
                if _count_pairs:
                    _add("pairs", f"k{k}.{self.index}", (nbr < self.n).sum())
                self._maps[k] = nbr
        return self._maps[k]


def pool(scale: Scale) -> Scale:
    """The next scale: clusters ``unique(codes[0] >> 3)`` (the first
    shuffled order), their cells ``g >> 1`` and scans; sets
    ``scale.cluster``."""
    with span("ptv3.pool"):
        code = scale.codes[0] >> 3
        uniq, cluster = torch.unique(code, sorted=True, return_inverse=True)
        m = uniq.shape[0]
        head = torch.empty(m, dtype=torch.int64, device=code.device)
        head.scatter_(0, cluster, torch.arange(scale.n, device=code.device))
        cloud = scale.cloud[head]
        counts = torch.bincount(cloud, minlength=len(scale.counts)).tolist()
        scale.cluster = cluster
        return Scale(scale.index + 1, scale.grid[head] >> 1, cloud, counts)


# -------------------------------------------------------------- modules
class SubMConv(nn.Module):
    """A submanifold convolution of kernel ``k`` (weight (k^3, C_in,
    C_out))."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool):
        super().__init__()
        self.k = k
        self.weight = nn.Parameter(torch.empty(k ** 3, cin, cout))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x, scale: Scale):
        return SC.subm_conv(x, scale.neighbors(self.k), self.weight,
                            self.bias)


def _bn(c: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class Stem(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = SubMConv(cin, cout, k, bias=False)
        self.norm = _bn(cout)

    def forward(self, x, scale):
        return F.gelu(self.norm(self.conv(x, scale).float()))


class CPE(nn.Module):
    """The conditional positional encoding: SubMConv3, Linear, LayerNorm."""

    def __init__(self, c: int, k: int):
        super().__init__()
        self.conv = SubMConv(c, c, k, bias=True)
        self.linear = nn.Linear(c, c)
        self.norm = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, x, scale):
        return self.norm(self.linear(self.conv(x, scale)).float())


class Attention(nn.Module):
    """Patch attention along one order of the scale, with a qkv bias and
    an output projection."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x, scale: Scale, order: int):
        n, c = x.shape
        h, K, P = self.heads, scale.K, scale.patches
        qkv = self.qkv(x)[scale.seq[order]]
        q, k, v = qkv.view(P, K, 3, h, c // h).permute(2, 0, 3, 1, 4)
        with sdpa_kernel(SDPA_BACKENDS):
            out = F.scaled_dot_product_attention(q, k, v)
        out = out.transpose(1, 2).reshape(P * K, c)[scale.back[order]]
        return self.proj(out)


class MLP(nn.Module):
    def __init__(self, c: int, ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(c, ratio * c)
        self.fc2 = nn.Linear(ratio * c, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def drop_path(x, p: float, generator, training: bool):
    """Each point's branch dropped with probability ``p`` (one uniform a
    point from ``generator``), the kept ones scaled by ``1 / (1 - p)``."""
    if p == 0.0 or not training:
        return x
    keep = 1.0 - p
    mask = torch.floor(keep + torch.rand(x.shape[0], 1, generator=generator,
                                         device=x.device))
    return x / keep * mask


class Block(nn.Module):
    def __init__(self, c: int, heads: int, cfg: PTv3Config, dp: float):
        super().__init__()
        self.dp = dp
        self.cpe = CPE(c, cfg.cpe_kernel)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attn = Attention(c, heads)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = MLP(c, cfg.mlp_ratio)

    def forward(self, x, scale, order, generator):
        x = x + self.cpe(x, scale)
        x = x + drop_path(self.attn(self.norm1(x.float()), scale, order),
                          self.dp, generator, self.training)
        return x + drop_path(self.mlp(self.norm2(x.float())), self.dp,
                             generator, self.training)


class Down(nn.Module):
    """Stride-2 pooling: max of a Linear over each cluster, BN, GELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.norm = _bn(cout)

    def forward(self, x, cluster, m: int):
        f = self.proj(x)
        # from -inf, counting the start: the backward of include_self=False
        # compares the start's values with the maxima too, so uninitialized
        # memory that equals a maximum would split its gradient
        out = f.new_full((m, f.shape[1]), -torch.inf).scatter_reduce_(
            0, cluster[:, None].expand_as(f), f, "amax")
        return F.gelu(self.norm(out.float()))


class Unpool(nn.Module):
    """``GELU(BN(Linear(skip))) + GELU(BN(Linear(coarse)))[cluster]``."""

    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.norm = _bn(cout)
        self.proj_skip = nn.Linear(cskip, cout)
        self.norm_skip = _bn(cout)

    def forward(self, x, skip, cluster):
        with span("ptv3.unpool"):
            up = F.gelu(self.norm(self.proj(x).float()))
            return F.gelu(self.norm_skip(self.proj_skip(skip).float())) \
                + up[cluster]


class Stage(nn.Module):
    def __init__(self, c: int, heads: int, depth: int, rates, cfg,
                 down: nn.Module | None = None, up: nn.Module | None = None):
        super().__init__()
        if down is not None:
            self.down = down
        if up is not None:
            self.up = up
        self.blocks = nn.ModuleList(Block(c, heads, cfg, rates[i])
                                    for i in range(depth))


class PTv3(nn.Module):
    """PT-v3m1: ``forward(feat, grid, cloud, counts, generator)`` ->
    logits (M, classes) of the grid-sampled points."""

    def __init__(self, cfg: PTv3Config):
        super().__init__()
        self.cfg = cfg
        ec, dc = cfg.enc_channels, tuple(cfg.dec_channels) + (
            cfg.enc_channels[-1],)
        enc_dp, dec_dp = cfg.drop_paths()
        self.embedding = Stem(cfg.in_channels, ec[0], cfg.stem_kernel)
        self.enc = nn.ModuleList(
            Stage(ec[s], cfg.enc_heads[s], cfg.enc_depths[s], enc_dp[s], cfg,
                  down=Down(ec[s - 1], ec[s]) if s else None)
            for s in range(len(ec)))
        self.dec = nn.ModuleList(
            Stage(dc[s], cfg.dec_heads[s], cfg.dec_depths[s], dec_dp[s], cfg,
                  up=Unpool(dc[s + 1], ec[s], dc[s]))
            for s in range(len(cfg.dec_channels)))
        self.head = nn.Linear(dc[0], cfg.num_classes)

    def init_parameters(self, generator: torch.Generator) -> None:
        """Pointcept's: every Linear's weight from a normal of std 0.02
        truncated at 2 sigma, the convolutions' at std 1/sqrt(fan-in),
        biases 0, norm scales 1."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if isinstance(self.get_submodule(name.rsplit(".", 1)[0]),
                              (nn.LayerNorm, nn.BatchNorm1d)):
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    std = (0.02 if p.dim() == 2 else
                           (p.shape[0] * p.shape[1]) ** -0.5)
                    cpu = torch.empty(p.shape)
                    nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    p.copy_(cpu)

    def forward(self, feat, grid, cloud, counts, generator=None):
        cfg = self.cfg
        with torch.autocast(feat.device.type, dtype=cfg.compute_dtype,
                            enabled=cfg.compute_dtype != torch.float32):
            scales = [Scale(0, grid, cloud, counts)]
            scales[0].serialize(generator, cfg.patch_size)
            x = self.embedding(feat, scales[0])
            skips = []
            for s, stage in enumerate(self.enc):
                if s:
                    prev = scales[-1]
                    scales.append(pool(prev))
                    x = stage.down(x, prev.cluster, scales[-1].n)
                    scales[-1].serialize(generator, cfg.patch_size)
                for i, blk in enumerate(stage.blocks):
                    x = blk(x, scales[s], i % len(S.ORDERS), generator)
                skips.append(x)
            for s in reversed(range(len(self.dec))):
                stage = self.dec[s]
                x = stage.up(x, skips[s], scales[s].cluster)
                for i, blk in enumerate(stage.blocks):
                    x = blk(x, scales[s], i % len(S.ORDERS), generator)
            return self.head(x)


# ----------------------------------------------------- loss, step, infer
def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multiclass Lovász-Softmax (Berman et al., CVPR 2018) over the
    classes present in ``labels``: each class's errors ``|fg - p|`` sorted
    down, dotted with the Lovász extension's gradient of the Jaccard loss;
    the mean over the classes."""
    fg = F.one_hot(labels, probs.shape[1]).T.float()
    present = fg.sum(1) > 0
    fg, p = fg[present], probs.T[present]
    err, perm = torch.sort((fg - p).abs(), dim=1, descending=True)
    fg = torch.gather(fg, 1, perm)
    gts = fg.sum(1, keepdim=True)
    jac = 1.0 - (gts - fg.cumsum(1)) / (gts + (1.0 - fg).cumsum(1))
    jac = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], 1)
    return (err * jac).sum(1).mean()


def seg_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the points whose label is not ignored (-1),
    plus Lovász-Softmax over them; in float32."""
    keep = labels >= 0
    lg, lb = logits[keep].float(), labels[keep]
    return F.cross_entropy(lg, lb) + lovasz_softmax(lg.softmax(-1), lb)


def make_optimizer(model: PTv3) -> torch.optim.Optimizer:
    """Pointcept's AdamW: weight decay ``cfg.weight_decay``, ``lr`` on
    every parameter but the blocks', which take ``block_learning_rate``."""
    cfg = model.cfg
    named = list(model.named_parameters())
    return torch.optim.AdamW(
        [{"params": [p for n, p in named if "block" not in n]},
         {"params": [p for n, p in named if "block" in n],
          "lr": cfg.block_learning_rate}],
        lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay)


def train_step(model, optimizer: torch.optim.Optimizer, batch: dict,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """One AdamW step on ``batch``: ``points`` (N, 4) the scans one after
    the other, ``labels`` (N,) class indices (-1 ignored), ``counts`` the
    scans' sizes. The cell picks, order shuffles and drop path draw from
    ``generator``. -> the loss, a device scalar."""
    cfg = model.cfg
    with span("model.step"):
        optimizer.zero_grad(set_to_none=True)
        with span("model.forward"):
            pick, grid, cloud, counts, _ = grid_sample(
                batch["points"], batch["counts"], cfg.grid_size, generator)
            logits = model(batch["points"][pick], grid, cloud, counts,
                           generator)
            loss = seg_loss(logits, batch["labels"][pick])
        with span("model.backward"):
            loss.backward()
        with span("model.optimizer"):
            optimizer.step()
        return loss.detach()


@torch.no_grad()
def predict(model: PTv3, points: torch.Tensor,
            counts: list[int]) -> torch.Tensor:
    """Each point's class, that of its cell's first point: the grid-sampled
    points through the network in eval mode (the model's mode is kept).
    -> (N,) int64."""
    was = model.training
    model.eval()
    try:
        with span("model.infer"):
            pick, grid, cloud, cnt, inverse = grid_sample(
                points, counts, model.cfg.grid_size)
            logits = model(points[pick], grid, cloud, cnt)
            return logits.argmax(-1)[inverse]
    finally:
        model.train(was)
