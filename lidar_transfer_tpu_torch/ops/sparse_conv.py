"""Submanifold sparse convolution over occupied cells: the neighbour map
(kernel E, ``csrc/neighbor_map.cu``, and its plain version) and the
convolution over it.

A submanifold convolution of kernel ``k`` computes, at each occupied cell
``i``, ``y_i = b + sum_d W_d x_j(i,d)`` over the offsets ``d`` of the
``k^3`` cube whose cell ``g_i + d`` is occupied in the same cloud. The map
holds ``j(i, d)`` at ``[i, d]``, or ``N`` where that cell is empty; ``d``
runs x-major: ``d = ((dx + r) k + (dy + r)) k + (dz + r)``, ``r = k // 2``.
The convolution gathers the rows of ``x`` with a row of zeros appended
(``index_select``) and multiplies the ``(N, k^3 C_in)`` gather by the
``(k^3 C_in, C_out)`` weight; its backward gathers the output's gradient
by the same map (:class:`_SubMConv`).
"""

from __future__ import annotations

import torch

from lidar_transfer_tpu_torch import _build

#: cells a word of the map's keys takes (16 bits an axis)
MAX_CELL = 1 << 16


def offsets(k: int, device=None) -> torch.Tensor:
    """The ``k^3`` offsets (k^3, 3) in the map's order."""
    r = torch.arange(k, device=device) - k // 2
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(-1, 3)


def _check(grid, cloud, k) -> None:
    if grid.dim() != 2 or grid.shape[1] != 3 or grid.shape[0] == 0:
        raise ValueError(f"neighbor_map: cells of shape {tuple(grid.shape)};"
                         " need a non-empty (N, 3)")
    if cloud.shape != grid.shape[:1]:
        raise ValueError("neighbor_map: one cloud id a cell")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"neighbor_map: kernel {k}; need an odd size")


def cell_keys(grid: torch.Tensor, cloud: torch.Tensor) -> torch.Tensor:
    """One int64 key a (cloud, cell), cells in ``[0, MAX_CELL)``."""
    g = grid.long()
    return (((cloud.long() * MAX_CELL + g[:, 0]) * MAX_CELL + g[:, 1])
            * MAX_CELL + g[:, 2])


def neighbor_map_plain(grid: torch.Tensor, cloud: torch.Tensor,
                       k: int) -> torch.Tensor:
    """The map (N, k^3) int32 by a sort of the cells' keys and a
    searchsorted of every query."""
    _check(grid, cloud, k)
    n = grid.shape[0]
    keys, idx = torch.sort(cell_keys(grid, cloud))
    q = grid.long()[:, None, :] + offsets(k, grid.device)[None]
    inside = ((q >= 0) & (q < MAX_CELL)).all(-1)
    qk = cell_keys(q.reshape(-1, 3), cloud.repeat_interleave(k ** 3))
    pos = torch.searchsorted(keys, qk).clamp_(max=n - 1)
    hit = (keys[pos] == qk) & inside.reshape(-1)
    return torch.where(hit, idx[pos], n).to(torch.int32).reshape(n, k ** 3)


def neighbor_map_cuda(grid: torch.Tensor, cloud: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Kernel E on the current stream: the same map."""
    _check(grid, cloud, k)
    g = grid.to(torch.int32).contiguous()
    c = cloud.to(torch.int32).contiguous()
    n = g.shape[0]
    capacity = 1 << (2 * n).bit_length()
    keys = torch.full((capacity,), -1, dtype=torch.int64, device=g.device)
    vals = torch.empty((capacity,), dtype=torch.int32, device=g.device)
    out = torch.empty((n, k ** 3), dtype=torch.int32, device=g.device)
    _build.launch("ptv3_neighbor_map", "lt_ptv3_neighbor_map", g.data_ptr(),
                  c.data_ptr(), n, k, keys.data_ptr(), vals.data_ptr(),
                  capacity, out.data_ptr(), _build.stream_handle(g.device))
    return out


def neighbor_map(grid: torch.Tensor, cloud: torch.Tensor,
                 k: int) -> torch.Tensor:
    """The map (N, k^3) int32: kernel E for a CUDA tensor, the plain
    version otherwise. ``grid`` in ``[0, MAX_CELL)``, one cell a point
    (both the caller's to hold)."""
    if grid.device.type == "cuda":
        return neighbor_map_cuda(grid, cloud, k)
    return neighbor_map_plain(grid, cloud, k)


class _SubMConv(torch.autograd.Function):
    """The convolution's product with a backward that gathers too.

    The map is symmetric: ``map[i, d] = j`` exactly where ``map[j, d'] =
    i``, ``d'`` the opposite offset (``k^3 - 1 - d`` in the map's order).
    So the gradient of the input, ``sum over (i, d) with map[i, d] = j of
    W_d^T dy_i``, is ``sum_d' W_(k^3-1-d')^T dy_map[j, d']``: the same
    gather of ``dy`` by the same map and one product with the weight's
    offsets reversed, where the gather's own backward (``index_add_``)
    would add ``k^3`` rows into each input row by atomics."""

    @staticmethod
    def forward(ctx, x, nbr, weight, dtype):
        n, cin = x.shape
        k3, _, cout = weight.shape
        xd = x.to(dtype)
        rows = torch.cat([xd, xd.new_zeros(1, cin)])
        g = rows.index_select(0, nbr.reshape(-1)).view(n, k3 * cin)
        w = weight.to(dtype)
        ctx.save_for_backward(g, nbr, w)
        ctx.dtypes = x.dtype, weight.dtype
        return g @ w.view(k3 * cin, cout)

    @staticmethod
    def backward(ctx, dy):
        g, nbr, w = ctx.saved_tensors
        k3, cin, cout = w.shape
        dy = dy.to(w.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            rows = torch.cat([dy, dy.new_zeros(1, cout)])
            gd = rows.index_select(0, nbr.reshape(-1)).view(-1, k3 * cout)
            dx = (gd @ w.flip(0).transpose(1, 2).reshape(k3 * cout, cin)
                  ).to(ctx.dtypes[0])
        if ctx.needs_input_grad[2]:
            dw = (g.T @ dy).view(k3, cin, cout).to(ctx.dtypes[1])
        return dx, None, dw, None


def subm_conv(x: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """``y_i = b + sum_d W_d x_j(i,d)``: ``x`` (N, C_in), ``nbr`` the map
    (N, k^3), ``weight`` (k^3, C_in, C_out). The gather and the product run
    in the autocast dtype where autocast is on, else in ``x``'s; the bias
    adds in float32."""
    dev = x.device.type
    dtype = (torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev)
             else x.dtype)
    y = _SubMConv.apply(x, nbr, weight, dtype)
    return y if bias is None else y + bias
