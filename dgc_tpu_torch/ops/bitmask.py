"""Forbidden-set bitmask planes and first-fit — the plain PyTorch version.

Port of ``dgc_tpu.ops.bitmask``. The forbidden set of a vertex is ``P``
planes of 32 bits, bit ``b`` of plane ``p`` standing for color ``32p+b``;
first-fit is the lowest clear bit below the budget ``k``.

The planes are held as ``int32`` bit patterns, not ``uint32``: PyTorch on
the CPU has no ``<<``, ``~`` or ``+`` for ``uint32``. A plane compares
equal to the JAX package's ``uint32`` plane viewed as ``int32``. PyTorch
also has no popcount and no OR-reduction, so the planes are packed from a
boolean presence table (each bit is set at most once per plane, so the sum
of the set bits is their OR) and the lowest set bit is found by a binary
search over its position.

These functions are what the superstep kernel (``kernels.superstep``) is
held against, and what its wrapper runs for tensors on the CPU.
"""

from __future__ import annotations

import torch


def num_planes_for(k_max: int) -> int:
    return max(1, -(-int(k_max) // 32))


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the same 32 bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def plane_masks(k, num_planes: int, device=None) -> torch.Tensor:
    """int32[P] bit patterns: bit b of plane p is set iff color 32p+b < k.

    The JAX original clips the shift to 31 and special-cases ``nbits ≥ 32``
    (a shift by 32 is undefined for 32-bit words); the mask is built in
    int64 here, so ``(1 << 32) - 1`` is the full plane directly.
    """
    p = torch.arange(num_planes, dtype=torch.int64, device=device)
    nbits = (torch.as_tensor(k, dtype=torch.int64, device=device)
             - 32 * p).clamp(0, 32)
    return _as_int32_bits((torch.ones_like(nbits) << nbits) - 1)


def forbidden_planes(neighbor_colors: torch.Tensor,
                     num_planes: int) -> torch.Tensor:
    """Build forbidden bitmask planes from gathered neighbor colors.

    ``neighbor_colors``: int32[V, W]; negative entries (uncolored neighbors
    / ELL padding) and colors at or beyond ``32·num_planes`` contribute
    nothing. Returns int32[V, P] bit patterns.
    """
    nc = neighbor_colors
    v = nc.shape[0]
    span = 32 * num_planes
    # one column past the window absorbs the entries that set no bit
    slot = torch.where((nc >= 0) & (nc < span), nc, span).to(torch.int64)
    present = torch.zeros((v, span + 1), dtype=torch.bool, device=nc.device)
    present.scatter_(1, slot, True)
    bits = present[:, :span].reshape(v, num_planes, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=nc.device) << \
        torch.arange(32, dtype=torch.int64, device=nc.device)
    return _as_int32_bits((bits * weights).sum(-1))


def _lowest_bit_index(word: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of each int64 word in [1, 2^32); the
    result for 0 is 0 (callers mask it)."""
    low = word & -word  # a single bit
    idx = torch.zeros_like(low)
    for s in (16, 8, 4, 2, 1):
        hi = low >= (1 << s)
        idx = idx + torch.where(hi, s, 0)
        low = torch.where(hi, low >> s, low)
    return idx


def first_fit(forbidden: torch.Tensor, k) -> tuple[torch.Tensor, torch.Tensor]:
    """Lowest color in [0, k) not present in the forbidden planes.

    Returns ``(candidate int32[V], fail bool[V])``; where ``fail`` is True
    the forbidden set covers all of [0, k) — the reference's sentinel −3
    (``coloring.py:53``) — and ``candidate`` is ``k``.
    """
    num_planes = forbidden.shape[-1]
    free = ~forbidden & plane_masks(k, num_planes, forbidden.device)[None, :]
    has_free = free != 0
    first_plane = torch.argmax(has_free.to(torch.int32), dim=-1)
    freew = torch.gather(free, 1, first_plane[:, None])[:, 0]
    bit_idx = _lowest_bit_index(freew.to(torch.int64) & 0xFFFFFFFF)
    candidate = first_plane * 32 + bit_idx
    fail = ~has_free.any(dim=-1)
    candidate = torch.where(fail, torch.as_tensor(k, device=forbidden.device),
                            candidate)
    return candidate.to(torch.int32), fail
