"""The plain reference of Point Transformer V3 (PT-v3m1): grid sampling,
serialization, submanifold convolution, patch attention, pooling, the
loss with Lovász-Softmax and AdamW, in functional float32 PyTorch.

It imports torch alone: nothing of the port's kernels or modules, and no
JAX. It follows the equations that ``models/ptv3.py`` implements, written
again the plain way: the codes bit by bit, the neighbour maps by a sort of
the cells' keys and a search, attention densely per patch in blocks of
patches (recomputed in the backward), every product in float32 (TF32 off
is the caller's: :func:`no_tf32`). It takes the same draws as the program
from the generator it is handed, in the same order: the cell picks (a
permutation from one uniform a point), four uniforms an order shuffle at
each scale, one uniform a point at each drop path.

``precision`` rounds the operands of every product in the forward (the
linears, the convolutions' gathers and weights, attention's q, k, v and
weights), the gradients passing through unrounded: None keeps float32;
"bfloat16" rounds to bfloat16; "float8" to float8 e4m3 at one scale a
tensor, the control one precision below a bfloat16 program.

The configuration is a dict of ``models/ptv3.PTv3Config``'s field names.
``benchmark/reference/ptv3.py`` is a copy of this file.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS, LN_EPS = 1e-3, 1e-5
FP8_MAX = 448.0
#: scores a block of the dense attention holds (patches x heads x K x K)
ATTN_BLOCK = 1 << 27
CELL = 1 << 16


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# --------------------------------------------------------------- layout
def leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, in the port's order; init
    is "linear" (normal, std 0.02), "conv" (std 1 / sqrt(fan-in)), "one"
    or "zero"."""
    out = []
    ec = list(cfg["enc_channels"])
    dc = list(cfg["dec_channels"]) + [ec[-1]]

    def linear(name, cin, cout):
        out.extend([(f"{name}.weight", (cout, cin), "linear"),
                    (f"{name}.bias", (cout,), "zero")])

    def norm(name, c):
        out.extend([(f"{name}.weight", (c,), "one"),
                    (f"{name}.bias", (c,), "zero")])

    def blocks(prefix, c, depth):
        k3, r = cfg["cpe_kernel"] ** 3, cfg["mlp_ratio"]
        for i in range(depth):
            b = f"{prefix}.blocks.{i}"
            out.extend([(f"{b}.cpe.conv.weight", (k3, c, c), "conv"),
                        (f"{b}.cpe.conv.bias", (c,), "zero")])
            linear(f"{b}.cpe.linear", c, c)
            norm(f"{b}.cpe.norm", c)
            norm(f"{b}.norm1", c)
            linear(f"{b}.attn.qkv", c, 3 * c)
            linear(f"{b}.attn.proj", c, c)
            norm(f"{b}.norm2", c)
            linear(f"{b}.mlp.fc1", c, r * c)
            linear(f"{b}.mlp.fc2", r * c, c)

    out.append(("embedding.conv.weight",
                (cfg["stem_kernel"] ** 3, cfg["in_channels"], ec[0]), "conv"))
    norm("embedding.norm", ec[0])
    for s, c in enumerate(ec):
        if s:
            linear(f"enc.{s}.down.proj", ec[s - 1], c)
            norm(f"enc.{s}.down.norm", c)
        blocks(f"enc.{s}", c, cfg["enc_depths"][s])
    for s in range(len(cfg["dec_channels"])):
        linear(f"dec.{s}.up.proj", dc[s + 1], dc[s])
        norm(f"dec.{s}.up.norm", dc[s])
        linear(f"dec.{s}.up.proj_skip", ec[s], dc[s])
        norm(f"dec.{s}.up.norm_skip", dc[s])
        blocks(f"dec.{s}", dc[s], cfg["dec_depths"][s])
    linear("head", dc[0], cfg["num_classes"])
    return out


def drop_rates(cfg: dict) -> tuple[list, list]:
    """Pointcept's drop-path rate of each block: (encoder by stage,
    decoder by scale)."""
    def spread(depths):
        n = sum(depths)
        r = [cfg["drop_path"] * i / (n - 1) if n > 1 else 0.0
             for i in range(n)]
        return [r[sum(depths[:s]):sum(depths[:s + 1])]
                for s in range(len(depths))]
    return (spread(cfg["enc_depths"]),
            [list(reversed(d)) for d in spread(cfg["dec_depths"])])


# ---------------------------------------------------------------- codes
def zorder(x, y, z, bits: int) -> torch.Tensor:
    code = torch.zeros_like(x)
    for b in range(bits):
        code |= (((x >> b) & 1) << (3 * b + 2)) | (((y >> b) & 1)
                                                   << (3 * b + 1)) \
            | (((z >> b) & 1) << (3 * b))
    return code


def hilbert(x, y, z, bits: int) -> torch.Tensor:
    """Skilling's transpose ("Programming the Hilbert curve", 2004) of
    (x, y, z), its words interleaved as the z-order's."""
    X = [x.clone(), y.clone(), z.clone()]
    for level in range(bits - 1, 0, -1):
        Q = 1 << level
        P = Q - 1
        for i in range(3):
            on = (X[i] & Q) > 0
            t = (X[0] ^ X[i]) & P
            new0 = torch.where(on, X[0] ^ P, X[0] ^ t)
            if i > 0:
                X[i] = torch.where(on, X[i], X[i] ^ t)
            X[0] = new0
    for i in (1, 2):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(x)
    for level in range(bits - 1, 0, -1):
        Q = 1 << level
        t = torch.where((X[2] & Q) > 0, t ^ (Q - 1), t)
    return zorder(X[0] ^ t, X[1] ^ t, X[2] ^ t, bits)


def codes(grid, cloud, bits: int) -> torch.Tensor:
    """(4, N): z, z-trans, hilbert, hilbert-trans, each with the cloud id
    above ``3 bits``."""
    x, y, z = (grid[:, i].long() for i in range(3))
    hi = cloud.long() << (3 * bits)
    return torch.stack([hi | zorder(x, y, z, bits), hi | zorder(y, x, z, bits),
                        hi | hilbert(x, y, z, bits),
                        hi | hilbert(y, x, z, bits)])


# -------------------------------------------------- sampling and scales
def grid_sample(points, counts, size: float, gen):
    """-> (picked indices by (cloud, cell), cells (M, 3), cloud ids (M,),
    points a cloud, each point's pick (N,)). With ``gen``: the point of
    least rank in a permutation drawn from ``N`` uniforms; else the
    first."""
    n, dev = points.shape[0], points.device
    cloud = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                    torch.tensor(counts, device=dev))
    cell = torch.floor(points[:, :3] / size).long()
    lo = torch.stack([cell[cloud == b].min(0).values
                      for b in range(len(counts))])
    g = cell - lo[cloud]
    key = ((cloud * CELL + g[:, 0]) * CELL + g[:, 1]) * CELL + g[:, 2]
    if gen is None:
        rank = torch.arange(n, device=dev)
    else:
        perm = torch.argsort(torch.rand(n, generator=gen, device=dev),
                             stable=True)
        rank = torch.empty_like(perm)
        rank[perm] = torch.arange(n, device=dev)
    ukeys, inv = torch.unique(key, return_inverse=True)
    best = torch.full((ukeys.shape[0],), n, device=dev).scatter_reduce(
        0, inv, rank, "amin")
    order = torch.empty_like(rank)
    order[rank] = torch.arange(n, device=dev)
    pick = order[best]
    cl = cloud[pick]
    return (pick, g[pick], cl,
            [int((cl == b).sum()) for b in range(len(counts))], inv)


def _serialize(grid, cloud, counts, gen, patch: int) -> dict:
    bits = int(grid.max() + 1).bit_length()
    c = codes(grid, cloud, bits)
    if gen is not None:
        c = c[torch.argsort(torch.rand(4, generator=gen, device=grid.device))]
    order = torch.argsort(c, dim=1)
    K = min(patch, min(counts))
    seqs, backs = [], []
    for o in range(4):
        seq, start = [], 0
        for cnt in counts:
            idx = order[o, start:start + cnt]
            tail = (-cnt) % K
            full = torch.cat([idx, idx[cnt - K:cnt - K + tail]]) if tail \
                else idx
            seq.append(full)
            start += cnt
        seq = torch.cat(seq)
        # a point's first place in the padded sequence
        p = torch.arange(seq.shape[0], device=grid.device)
        back = torch.full((grid.shape[0],), seq.shape[0],
                          device=grid.device).scatter_reduce(
            0, seq, p, "amin")
        seqs.append(seq)
        backs.append(back)
    return {"codes": c, "K": K, "seq": seqs, "back": backs}


def neighbor_map(grid, cloud, k: int) -> torch.Tensor:
    """(N, k^3): the index of the point at each offset (x-major), or N."""
    n = grid.shape[0]
    r = torch.arange(k, device=grid.device) - k // 2
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    g = grid.long()
    key = ((cloud.long() * CELL + g[:, 0]) * CELL + g[:, 1]) * CELL + g[:, 2]
    sk, si = torch.sort(key)
    out = torch.full((n, k ** 3), n, dtype=torch.long, device=grid.device)
    for d in range(k ** 3):
        q = g + off[d]
        ok = ((q >= 0) & (q < CELL)).all(1)
        qk = ((cloud.long() * CELL + q[:, 0]) * CELL + q[:, 1]) * CELL \
            + q[:, 2]
        j = torch.searchsorted(sk, qk).clamp(max=n - 1)
        hit = ok & (sk[j] == qk)
        out[hit, d] = si[j[hit]]
    return out


# ---------------------------------------------------------------- layers
def _round(x, precision):
    """``x`` rounded to ``precision`` in the forward; the backward passes
    the gradient through unrounded (a cast's own backward would round the
    gradient to the narrow type without a scale, which float8 flushes to
    zero at this network's gradient sizes)."""
    if precision is None:
        return x
    if precision == "bfloat16":
        q = x.detach().bfloat16().float()
    else:
        d = x.detach()
        scale = d.abs().max().clamp(min=1e-30) / FP8_MAX
        q = (d / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def _linear(p, name, x, precision):
    return _round(x, precision) @ _round(p[name + ".weight"], precision).T \
        + p[name + ".bias"]


def _take(x, idx):
    """Rows ``idx`` of ``x`` (``index_select``: its backward adds by
    atomics, where indexing's sorts every index)."""
    return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                      *x.shape[1:])


def _conv(p, name, x, nbr, precision, bias=True):
    rows = _take(torch.cat([x, x.new_zeros(1, x.shape[1])]), nbr).reshape(
        x.shape[0], -1)
    w = p[name + ".weight"]
    y = _round(rows, precision) @ _round(w.reshape(-1, w.shape[-1]),
                                         precision)
    return y + p[name + ".bias"] if bias else y


def _bn(p, name, x):
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[name + ".weight"] \
        + p[name + ".bias"]


def _ln(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], LN_EPS)


def _dense_attention(q, k, v, precision):
    s = _round(q, precision) @ _round(k, precision).transpose(-1, -2)
    a = torch.softmax(s * q.shape[-1] ** -0.5, dim=-1)
    return _round(a, precision) @ _round(v, precision)


def _attention(p, name, x, sc, o, heads, precision):
    n, c = x.shape
    qkv = _take(_linear(p, name + ".qkv", x, precision), sc["seq"][o])
    K = sc["K"]
    P = qkv.shape[0] // K
    q, k, v = qkv.reshape(P, K, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    step = max(1, ATTN_BLOCK // (heads * K * K))
    outs = [checkpoint(_dense_attention, q[a:a + step], k[a:a + step],
                       v[a:a + step], precision, use_reentrant=False)
            for a in range(0, P, step)]
    out = _take(torch.cat(outs).transpose(1, 2).reshape(P * K, c),
                sc["back"][o])
    return _linear(p, name + ".proj", out, precision)


def _drop(x, rate, gen, training):
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = torch.floor(keep + torch.rand(x.shape[0], 1, generator=gen,
                                         device=x.device))
    return x / keep * mask


def _block(p, b, x, sc, o, heads, rate, gen, training, precision):
    h = _conv(p, f"{b}.cpe.conv", x, sc["nbr3"], precision)
    x = x + _ln(p, f"{b}.cpe.norm", _linear(p, f"{b}.cpe.linear", h,
                                            precision))
    h = _attention(p, f"{b}.attn", _ln(p, f"{b}.norm1", x), sc, o, heads,
                   precision)
    x = x + _drop(h, rate, gen, training)
    h = _linear(p, f"{b}.mlp.fc2", F.gelu(_linear(
        p, f"{b}.mlp.fc1", _ln(p, f"{b}.norm2", x), precision)), precision)
    return x + _drop(h, rate, gen, training)


def forward(p: dict, feat, grid, cloud, counts, cfg: dict, gen=None,
            training: bool = True, precision=None):
    """Logits (M, classes) of the grid-sampled points ``feat`` (M, 4) at
    cells ``grid`` of clouds ``cloud`` (``counts`` a cloud)."""
    enc_rate, dec_rate = drop_rates(cfg)
    K = cfg["patch_size"]
    scales = []

    def scale(grid, cloud, counts):
        sc = _serialize(grid, cloud, counts, gen, K)
        sc.update(grid=grid, cloud=cloud, counts=counts,
                  nbr3=neighbor_map(grid, cloud, cfg["cpe_kernel"]))
        scales.append(sc)
        return sc

    sc = scale(grid, cloud, counts)
    x = F.gelu(_bn(p, "embedding.norm", _conv(
        p, "embedding.conv", feat,
        neighbor_map(grid, cloud, cfg["stem_kernel"]), precision,
        bias=False)))
    skips = []
    for s in range(len(cfg["enc_channels"])):
        if s:
            prev = scales[-1]
            uniq, cluster = torch.unique(prev["codes"][0] >> 3,
                                         return_inverse=True)
            m = uniq.shape[0]
            head = torch.zeros(m, dtype=torch.long, device=x.device)
            head[cluster] = torch.arange(x.shape[0], device=x.device)
            prev["cluster"] = cluster
            f = _linear(p, f"enc.{s}.down.proj", x, precision)
            pooled = torch.full((m, f.shape[1]), -torch.inf,
                                device=x.device).scatter_reduce(
                0, cluster[:, None].expand_as(f), f, "amax")
            x = F.gelu(_bn(p, f"enc.{s}.down.norm", pooled))
            ncl = prev["cloud"][head]
            sc = scale(prev["grid"][head] >> 1, ncl,
                       [int((ncl == b).sum()) for b in
                        range(len(prev["counts"]))])
        for i in range(cfg["enc_depths"][s]):
            x = _block(p, f"enc.{s}.blocks.{i}", x, scales[s], i % 4,
                       cfg["enc_heads"][s], enc_rate[s][i], gen, training,
                       precision)
        skips.append(x)
    for s in reversed(range(len(cfg["dec_channels"]))):
        u = f"dec.{s}.up"
        up = F.gelu(_bn(p, f"{u}.norm", _linear(p, f"{u}.proj", x,
                                                precision)))
        x = F.gelu(_bn(p, f"{u}.norm_skip", _linear(
            p, f"{u}.proj_skip", skips[s], precision))) \
            + _take(up, scales[s]["cluster"])
        for i in range(cfg["dec_depths"][s]):
            x = _block(p, f"dec.{s}.blocks.{i}", x, scales[s], i % 4,
                       cfg["dec_heads"][s], dec_rate[s][i], gen, training,
                       precision)
    return _linear(p, "head", x, precision)


# ------------------------------------------------------- loss and AdamW
def lovasz(probs, labels) -> torch.Tensor:
    """Multiclass Lovász-Softmax over the classes present, their mean."""
    losses = []
    for c in range(probs.shape[1]):
        fg = (labels == c).float()
        if fg.sum() == 0:
            continue
        err, perm = torch.sort((fg - probs[:, c]).abs(), descending=True)
        fs = fg[perm]
        inter = fs.sum() - fs.cumsum(0)
        union = fs.sum() + (1 - fs).cumsum(0)
        jac = 1 - inter / union
        grad = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        losses.append(torch.dot(err, grad))
    return torch.stack(losses).mean()


def loss(logits, labels) -> torch.Tensor:
    """Mean cross-entropy over the labels that are not -1, plus
    Lovász-Softmax."""
    keep = labels >= 0
    lg, lb = logits[keep], labels[keep]
    return F.cross_entropy(lg, lb) + lovasz(torch.softmax(lg, -1), lb)


class AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay;
    parameters named with "block" take ``block_lr``."""

    def __init__(self, params, lr, block_lr, wd):
        self.lr, self.block_lr, self.wd, self.t = lr, block_lr, wd, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            lr = self.block_lr if "block" in k else self.lr
            params[k].mul_(1 - lr * self.wd)
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            params[k] -= lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + 1e-8)


def train_steps(params0: dict, batches, cfg: dict, gens, precision=None):
    """AdamW steps from ``params0`` over ``batches`` of (points (N, 4),
    labels (N,), counts), step ``i`` drawing from ``gens[i]``. -> (losses,
    the first step's gradients, the parameters after the last), by
    leaf."""
    params = {k: v.clone() for k, v in params0.items()}
    opt = AdamW(params, cfg["learning_rate"], cfg["block_learning_rate"],
                cfg["weight_decay"])
    losses, first = [], None
    for (points, labels, counts), gen in zip(batches, gens):
        leaf = {k: v.detach().requires_grad_() for k, v in params.items()}
        pick, grid, cloud, cnt, _ = grid_sample(points, counts,
                                                cfg["grid_size"], gen)
        out = loss(forward(leaf, points[pick], grid, cloud, cnt, cfg, gen,
                           True, precision), labels[pick])
        out.backward()
        grads = {k: v.grad for k, v in leaf.items()}
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(out.detach()))
    return losses, first, params

