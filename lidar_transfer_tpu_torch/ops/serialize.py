"""Space-filling-curve serialization of point clouds for Point Transformer
V3: the four codes of every point (kernel F, ``csrc/serialize.cu``, and
its plain version), the orders they sort into and the inverses.

A point's code is ``cloud << 3b | enc(g)``: ``g`` its integer cell (x, y,
z) in ``[0, 2^b)``, ``b`` the batch's bit depth (:func:`depth`) and
``enc`` one of the orders of :data:`ORDERS`. Z-order interleaves the three
words, x in the highest bit of each triple; Hilbert interleaves Skilling's
transpose of (x, y, z) at ``b`` bits; ``-trans`` swaps x and y first. The
cloud id in the high bits keeps each cloud's points together in every
order.
"""

from __future__ import annotations

import torch

from lidar_transfer_tpu_torch import _build

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
#: the widest cell word the codes take (21 bits an axis fill 63 bits)
MAX_BITS = 21


def depth(grid: torch.Tensor) -> int:
    """``b = bit_length(max g + 1)`` over every cell of the batch (one
    read on the host)."""
    return (int(grid.max()) + 1).bit_length()


def _spread(x: torch.Tensor) -> torch.Tensor:
    """Each of the low 21 bits of ``x`` (int64) moved to bit 3i."""
    x = x & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    return (x | (x << 2)) & 0x1249249249249249


def _interleave(a, b, c) -> torch.Tensor:
    return (_spread(a) << 2) | (_spread(b) << 1) | _spread(c)


def _hilbert(a, b, c, bits: int) -> torch.Tensor:
    """Skilling's AxestoTranspose of (a, b, c) at ``bits`` bits, each step
    a ``where`` over the points, interleaved."""
    X = [a.clone(), b.clone(), c.clone()]
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            hit = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0 = torch.where(hit, X[0] ^ P, X[0] ^ t)
            if i:
                X[i] = torch.where(hit, X[i], X[i] ^ t)
            X[0] = x0
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[2])
    Q = 1 << (bits - 1)
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    return _interleave(X[0] ^ t, X[1] ^ t, X[2] ^ t)


def _check(grid: torch.Tensor, cloud: torch.Tensor, bits: int) -> None:
    if grid.dim() != 2 or grid.shape[1] != 3 or grid.shape[0] == 0:
        raise ValueError(f"serialize: cells of shape {tuple(grid.shape)}; "
                         "need a non-empty (N, 3)")
    if cloud.shape != grid.shape[:1]:
        raise ValueError("serialize: one cloud id a cell")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"serialize: {bits} bits a word; 1 to {MAX_BITS}")
    clouds = int(cloud.max()) + 1
    if 3 * bits + clouds.bit_length() > 63:
        raise ValueError(f"serialize: {clouds} clouds at {bits} bits do not "
                         "fit a 63-bit code")


def encode_plain(grid: torch.Tensor, cloud: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """The codes (4, N) int64 of :data:`ORDERS`, by PyTorch's elementwise
    calls."""
    _check(grid, cloud, bits)
    g = grid.long()
    x, y, z = g[:, 0], g[:, 1], g[:, 2]
    hi = cloud.long() << (3 * bits)
    return torch.stack([hi | _interleave(x, y, z), hi | _interleave(y, x, z),
                        hi | _hilbert(x, y, z, bits),
                        hi | _hilbert(y, x, z, bits)])


def encode_cuda(grid: torch.Tensor, cloud: torch.Tensor,
                bits: int) -> torch.Tensor:
    """Kernel F on the current stream: the same codes."""
    _check(grid, cloud, bits)
    g = grid.to(torch.int32).contiguous()
    c = cloud.to(torch.int32).contiguous()
    codes = torch.empty((4, g.shape[0]), dtype=torch.int64,
                        device=g.device)
    _build.launch("ptv3_serialize", "lt_ptv3_serialize", g.data_ptr(),
                  c.data_ptr(), g.shape[0], bits, codes.data_ptr(),
                  _build.stream_handle(g.device))
    return codes


def encode(grid: torch.Tensor, cloud: torch.Tensor,
           bits: int) -> torch.Tensor:
    """The codes (4, N) of :data:`ORDERS`: kernel F for a CUDA tensor, the
    plain version otherwise."""
    if grid.device.type == "cuda":
        return encode_cuda(grid, cloud, bits)
    return encode_plain(grid, cloud, bits)


def orders(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (order, inverse), (R, N) each: ``order[r]`` the points by
    ``codes[r]`` (unique codes), ``inverse[r][order[r]] = arange(N)``."""
    order = torch.argsort(codes, dim=1)
    inverse = torch.empty_like(order)
    inverse.scatter_(1, order, torch.arange(
        codes.shape[1], device=codes.device).expand_as(order))
    return order, inverse


def shuffle(generator: torch.Generator | None, device) -> torch.Tensor:
    """The permutation of the four orders (4,), from ``generator``'s draw
    of four uniforms on ``device``; without a generator, the identity."""
    if generator is None:
        return torch.arange(len(ORDERS), device=device)
    return torch.argsort(torch.rand(len(ORDERS), generator=generator,
                                    device=device))
