"""The plain reference of RangeNet's darknet network, its loss, Adam and
the kNN cleanup, in functional PyTorch.

It follows the published darknet shape as the configuration file states
it (a stem, five width-halving stages of residual blocks, a decoder of
nearest x2 upsamplings with skips, a 1x1 head) with the port's stated
departures (GroupNorm of group size 16 and epsilon 1e-6 after every
bias-free convolution, leaky ReLU 0.1, masked cross-entropy, Adam). The
weights are one flat float32 vector that the benchmark draws from the
seed; :func:`leaves` lays it out as named leaves. Everything runs in
float32 (TF32 off is the caller's: :func:`no_tf32`); ``fp8=True``
rounds every convolution's input and weight to float8 e4m3 (one scale a
tensor), the control one precision below the configuration's bfloat16.

Also here: the range image's network input and the label lookup
(``features``) and the kNN cleanup, a frozen copy of the port's
``models/postproc.knn_cleanup``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from reference.projection import range_image

GN_EPS = 1e-6
GROUP_SIZE = 16
FP8_MAX = 448.0


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


def leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], int]]:
    """(name, shape, fan_in) of every parameter, in the order the network
    registers them; fan_in is 0 for a norm's scale and bias and for the
    head's bias."""
    out = []

    def conv_norm(name, cin, cout, k):
        out.append((f"{name}.conv.weight", (cout, cin, k, k), cin * k * k))
        out.append((f"{name}.norm.weight", (cout,), 0))
        out.append((f"{name}.norm.bias", (cout,), 0))

    widths = [cfg["stem_features"]] + list(cfg["stage_features"])
    conv_norm("stem", cfg["input_channels"], widths[0], 3)
    for s in range(len(cfg["stage_blocks"])):
        conv_norm(f"down.{s}", widths[s], widths[s + 1], 3)
    i = 0
    for n, f in zip(cfg["stage_blocks"], cfg["stage_features"]):
        for _ in range(n):
            conv_norm(f"blocks.{i}.conv1", f, f // 2, 1)
            conv_norm(f"blocks.{i}.conv2", f // 2, f, 3)
            i += 1
    cin = widths[-1]
    for j, skip in enumerate(reversed(widths[:-1])):
        conv_norm(f"up.{j}", cin, max(skip, 32), 3)
        cin = max(skip, 32) + skip
    out.append(("head.weight", (cfg["num_classes"], cin, 1, 1), cin))
    out.append(("head.bias", (cfg["num_classes"],), 0))
    return out


def unflatten(flat: torch.Tensor, cfg: dict) -> dict[str, torch.Tensor]:
    """Views of ``flat`` as the named leaves."""
    params, at = {}, 0
    for name, shape, _ in leaves(cfg):
        n = int(np.prod(shape))
        params[name] = flat[at:at + n].view(shape)
        at += n
    return params


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at one scale for the tensor (its
    largest magnitude at the format's largest value)."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def _conv_norm(x, p, name, stride_w=1, fp8=False):
    w = p[f"{name}.conv.weight"]
    k = w.shape[-1]
    if stride_w == 2:
        x = F.pad(x, (0, 1))
    if fp8:
        x, w = _fp8(x), _fp8(w)
    h = F.conv2d(x, w, stride=(1, stride_w),
                 padding=(k // 2, 0 if stride_w == 2 else k // 2))
    h = F.group_norm(h, h.shape[1] // GROUP_SIZE, p[f"{name}.norm.weight"],
                     p[f"{name}.norm.bias"], eps=GN_EPS)
    return F.leaky_relu(h, 0.1)


def forward(p: dict, x: torch.Tensor, cfg: dict, fp8=False) -> torch.Tensor:
    """(B, H, W, C_in) features -> (B, H, W, classes) float32 logits."""
    stages = len(cfg["stage_blocks"])
    x = x.permute(0, 3, 1, 2)
    W = x.shape[-1]
    pad = (-W) % (2 ** stages)
    if pad:
        x = F.pad(x, (0, pad, 0, 0), mode="replicate")
    h = _conv_norm(x, p, "stem", fp8=fp8)
    skips, i = [], 0
    for s, n in enumerate(cfg["stage_blocks"]):
        skips.append(h)
        h = _conv_norm(h, p, f"down.{s}", stride_w=2, fp8=fp8)
        for _ in range(n):
            h = h + _conv_norm(_conv_norm(h, p, f"blocks.{i}.conv1",
                                          fp8=fp8),
                               p, f"blocks.{i}.conv2", fp8=fp8)
            i += 1
    for j, skip in enumerate(reversed(skips)):
        h = _conv_norm(h.repeat_interleave(2, dim=-1), p, f"up.{j}", fp8=fp8)
        h = torch.cat([h, skip], dim=1)
    logits = F.conv2d(h, p["head.weight"], p["head.bias"])
    return logits[..., :W].permute(0, 2, 3, 1)


def loss_sum(logits, labels, weights) -> torch.Tensor:
    """The weighted sum of the pixels' cross-entropy (the caller divides
    by the batch's weight sum)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -(ll * weights).sum()


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over a dict of leaves."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            params[k] -= self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + 1e-8)


def train_steps(flat: torch.Tensor, batches, cfg: dict, lr: float,
                micro: int = 2, fp8=False):
    """Adam steps from the weights ``flat`` over ``batches``, a list of
    (features, labels, weights) stacks; each step's gradient is summed
    over micro-batches of ``micro`` rows. -> (losses, the gradients of the
    first step, the parameters after the last), by leaf name."""
    params = {k: v.clone() for k, v in unflatten(flat, cfg).items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for feats, labels, weights in batches:
        total = torch.clamp(weights.sum(), min=1.0)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        loss = 0.0
        for lo in range(0, feats.shape[0], micro):
            sl = slice(lo, lo + micro)
            leaf = {k: v.detach().requires_grad_() for k, v in
                    params.items()}
            part = loss_sum(forward(leaf, feats[sl], cfg, fp8=fp8),
                            labels[sl], weights[sl]) / total
            part.backward()
            loss += float(part.detach())
            for k, v in leaf.items():
                grads[k] += v.grad
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(loss)
    return losses, first, params


def features(points, rem, labels, cap_valid, sensor: dict, raw_to_index,
             ignore_index):
    """One padded scan's network input and targets: (features (H, W, 5),
    label indices (H, W), weights (H, W)) and its range image."""
    H = sensor["beams"]
    W = int(sensor["fov_hor"] / sensor["angle_res_hor"])
    ri = range_image(points, rem, labels, cap_valid, sensor["fov_up"],
                     sensor["fov_down"], H, W)
    mask = ri["mask"]
    xyz = torch.where(mask[..., None],
                      points[torch.clamp(ri["index"], min=0).long()], 0.0)
    feats = torch.cat([ri["range"][..., None], xyz,
                       torch.clamp(ri["remission"], min=0.0)[..., None]],
                      dim=-1)
    feats = torch.where(mask[..., None], feats, 0.0)
    idx = raw_to_index[torch.clamp(ri["label"], 0,
                                   raw_to_index.shape[0] - 1).long()]
    weights = mask.to(torch.float32)
    for ig in ignore_index:
        weights = torch.where(idx == ig, 0.0, weights)
    return feats, idx, weights, ri


def _window_stack(img, ksize: int, fill):
    p = ksize // 2
    H, W = img.shape
    padded = img.new_full((H + 2 * p, W + 2 * p), fill)
    padded[p:p + H, p:p + W] = img
    return torch.stack([padded[dv:dv + H, du:du + W]
                        for dv in range(ksize) for du in range(ksize)],
                       dim=-1)


def knn_cleanup(proj_range, pred_img, mask_img, point_range, point_u,
                point_v, point_valid, *, num_classes: int, k: int,
                ksize: int, sigma: float, cutoff: float) -> torch.Tensor:
    """RangeNet++'s kNN vote of every point over a ksize x ksize window of
    its pixel: the k neighbours of closest range (scaled by an inverse
    gaussian of the offset) within ``cutoff`` vote, ties at the k-th
    distance all vote, a tied vote goes to the lowest class, and a point
    with no vote keeps its pixel's class. -> (N,) int32."""
    H, W = proj_range.shape
    S = ksize * ksize
    k = min(k, S)
    pred_img = pred_img.to(torch.int64)
    flat = (torch.clamp(point_v.to(torch.int64), 0, H - 1) * W
            + torch.clamp(point_u.to(torch.int64), 0, W - 1))
    rng_n = _window_stack(proj_range.float(), ksize,
                          float("inf")).reshape(H * W, S)[flat]
    pred_n = _window_stack(pred_img, ksize, 0).reshape(H * W, S)[flat]
    ok_n = _window_stack(mask_img, ksize, False).reshape(H * W, S)[flat]
    dist = torch.abs(rng_n - point_range.float()[:, None])
    p = ksize // 2
    d2 = np.asarray([(dv - p) ** 2 + (du - p) ** 2 for dv in range(ksize)
                     for du in range(ksize)], np.float32)
    wts = torch.from_numpy(np.exp(d2 / (2.0 * sigma ** 2))).to(
        proj_range.device)
    scaled = torch.where(ok_n, dist * wts, float("inf"))
    kth = torch.kthvalue(scaled, k, dim=-1).values
    in_range = (pred_n >= 0) & (pred_n < num_classes)
    votes = (scaled <= kth[:, None]) & (dist <= cutoff) & ok_n & in_range
    hist = torch.zeros((flat.shape[0], num_classes), dtype=torch.float32,
                       device=proj_range.device)
    hist.scatter_add_(1, torch.where(in_range, pred_n, 0),
                      votes.to(torch.float32))
    center = pred_img.reshape(-1)[flat]
    out = torch.where(hist.sum(dim=-1) > 0, torch.argmax(hist, dim=-1),
                      center)
    return torch.where(point_valid, out, center).to(torch.int32)
