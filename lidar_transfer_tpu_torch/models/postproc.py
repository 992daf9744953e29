"""kNN range-image post-processing for per-point label cleanup (PyTorch).

Counterpart of ``lidar_transfer_tpu/models/postproc.py``: RangeNet++'s KNN
post-processor. Every point looks at a ksize x ksize window around its
projected pixel, keeps the k neighbours whose range is closest to its own
(scaled by an inverse-gaussian spatial penalty), and takes the majority vote
of their predicted labels. Points that share a pixel with a nearer surface
thereby recover the label of their own depth.

The JAX function is an XLA function, no kernel; plain PyTorch is its
implementation here: the window stack by shifted slices, one row gather
per attribute, ``kthvalue`` for the k-th distance and a ``scatter_add_``
histogram. Semantics, as the JAX function's:
  - neighbours tied at the k-th distance all vote;
  - a tie in the vote goes to the lowest class index;
  - points whose every neighbour fails the range cutoff keep their own
    pixel's prediction.
A call is the span ``postproc.knn``, its copy of the spatial weights to the
device the child ``postproc.upload`` (``utils/runtime``).
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_transfer_tpu_torch.utils.runtime import span, upload


def _window_stack(img: torch.Tensor, ksize: int, fill) -> torch.Tensor:
    """(H, W) -> (H, W, S) shifted-window stack, S = ksize**2."""
    p = ksize // 2
    H, W = img.shape
    padded = img.new_full((H + 2 * p, W + 2 * p), fill)
    padded[p:p + H, p:p + W] = img
    return torch.stack([padded[dv:dv + H, du:du + W]
                        for dv in range(ksize) for du in range(ksize)],
                       dim=-1)


def _inv_gauss_weights(ksize: int, sigma: float) -> np.ndarray:
    """(S,) spatial penalty: 1/gaussian, centre = 1 (no penalty)."""
    p = ksize // 2
    d2 = np.asarray([(dv - p) ** 2 + (du - p) ** 2
                     for dv in range(ksize) for du in range(ksize)],
                    np.float32)
    return np.exp(d2 / (2.0 * sigma ** 2))


def knn_cleanup(proj_range: torch.Tensor, pred_img: torch.Tensor,
                mask_img: torch.Tensor, point_range: torch.Tensor,
                point_u: torch.Tensor, point_v: torch.Tensor,
                point_valid: torch.Tensor, *, num_classes: int,
                k: int = 5, ksize: int = 5, sigma: float = 1.0,
                cutoff: float = 1.0) -> torch.Tensor:
    """Per-point kNN-voted class indices.

    Args:
      proj_range:  (H, W) f32 range image (winner depth per pixel).
      pred_img:    (H, W) int per-pixel predicted class indices.
      mask_img:    (H, W) bool pixel-has-data mask.
      point_range: (N,) f32 range of every (padded) point.
      point_u/v:   (N,) int pixel coords per point (clamped here).
      point_valid: (N,) bool point survived projection filters.
      num_classes: C, the vote histogram's width.
      k:           neighbours that vote (<= ksize**2).
      ksize:       odd window side length.
      sigma:       gaussian sigma of the spatial penalty.
      cutoff:      max |range difference| (metres) for a vote to count.

    Returns (N,) int32: the voted class where >= 1 neighbour passes the
    cutoff, else the point's own pixel prediction.
    """
    with span("postproc.knn"):
        H, W = proj_range.shape
        S = ksize * ksize
        k = min(k, S)
        dev = proj_range.device

        pred_img = pred_img.to(torch.int64)
        flat = (torch.clamp(point_v.to(torch.int64), 0, H - 1) * W
                + torch.clamp(point_u.to(torch.int64), 0, W - 1))
        rng_n = _window_stack(proj_range.to(torch.float32), ksize,
                              float("inf")).reshape(H * W, S)[flat]
        pred_n = _window_stack(pred_img, ksize, 0).reshape(H * W, S)[flat]
        ok_n = _window_stack(mask_img.to(torch.bool), ksize,
                             False).reshape(H * W, S)[flat]

        dist = torch.abs(rng_n - point_range.to(torch.float32)[:, None])
        wts = upload(_inv_gauss_weights(ksize, sigma), dev, "postproc.upload")
        scaled = torch.where(ok_n, dist * wts, float("inf"))
        kth = torch.kthvalue(scaled, k, dim=-1).values
        # a label outside [0, C) casts no vote (as jax.nn.one_hot's zero row)
        in_range = (pred_n >= 0) & (pred_n < num_classes)
        votes_on = ((scaled <= kth[:, None]) & (dist <= cutoff) & ok_n
                    & in_range)

        hist = torch.zeros((flat.shape[0], num_classes),
                           dtype=torch.float32, device=dev)
        hist.scatter_add_(1, torch.where(in_range, pred_n, 0),
                          votes_on.to(torch.float32))
        # argmax returns the first maximum: the lowest class index on a tie
        voted = torch.argmax(hist, dim=-1)
        center = pred_img.reshape(-1)[flat]
        out = torch.where(hist.sum(dim=-1) > 0, voted, center)
        return torch.where(point_valid, out, center).to(torch.int32)


def knn_cleanup_oracle(proj_range, pred_img, mask_img, point_range,
                       point_u, point_v, point_valid, *, num_classes,
                       k=5, ksize=5, sigma=1.0, cutoff=1.0):
    """Per-point numpy loop with the same semantics (test oracle); a copy
    of the JAX package's ``knn_cleanup_oracle``."""
    H, W = proj_range.shape
    p = ksize // 2
    wts = _inv_gauss_weights(ksize, sigma).reshape(ksize, ksize)
    out = np.zeros(point_range.shape[0], np.int32)
    for i in range(point_range.shape[0]):
        v = int(np.clip(point_v[i], 0, H - 1))
        u = int(np.clip(point_u[i], 0, W - 1))
        center = int(pred_img[v, u])
        if not point_valid[i]:
            out[i] = center
            continue
        cand = []
        for dv in range(-p, p + 1):
            for du in range(-p, p + 1):
                vv, uu = v + dv, u + du
                if not (0 <= vv < H and 0 <= uu < W):
                    continue
                if not mask_img[vv, uu]:
                    continue
                d = abs(float(proj_range[vv, uu]) - float(point_range[i]))
                cand.append((d * wts[dv + p, du + p], d,
                             int(pred_img[vv, uu])))
        cand.sort(key=lambda t: t[0])
        if cand:
            kth = cand[min(k, len(cand)) - 1][0]
            hist = np.zeros(num_classes, np.int64)
            for sd, d, lab in cand:
                if sd <= kth and d <= cutoff:
                    hist[lab] += 1
            out[i] = int(hist.argmax()) if hist.sum() > 0 else center
        else:
            out[i] = center
    return out
