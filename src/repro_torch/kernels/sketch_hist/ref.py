"""Plain PyTorch version of the count-min sketch kernel."""

import torch


def sketch_cells(ids: torch.Tensor, multipliers, width: int) -> torch.Tensor:
    """Flat cell of every (slot, row, pair): ``(m, depth, K)`` int64.

    Cell ``(i * depth + r) * width + h_r(ids[i, t])`` with ``h_r(x) = (a_r
    * x mod 2^32) >> (32 - log2 width)``, ``x`` the id's uint32 bit pattern
    and ``a_r = multipliers[r]`` (host integers in ``[0, 2^32)``). The
    hash runs in int64 with ``& 0xFFFFFFFF`` masks, which gives the uint32
    wraparound of the reference for negative ids and for multipliers >=
    2^31 alike.
    """
    if width < 2 or width & (width - 1):
        raise ValueError(f"width must be a power of two >= 2, got {width}")
    shift = 32 - (width.bit_length() - 1)
    m = ids.shape[0]
    mult = torch.as_tensor([int(a) for a in multipliers], dtype=torch.int64,
                           device=ids.device)
    depth = mult.shape[0]
    x = (ids.to(torch.int64) & 0xFFFFFFFF)[:, None, :]        # (m, 1, K) uint32 value
    # a * x mod 2^32 from two products below 2^48, so no int64 overflows:
    # a = a_hi * 2^16 + a_lo.
    a_lo = (mult & 0xFFFF)[None, :, None]
    a_hi = (mult >> 16)[None, :, None]
    prod = (x * a_lo + (((x * a_hi) & 0xFFFF) << 16)) & 0xFFFFFFFF
    rows = torch.arange(m * depth, device=ids.device).view(m, depth, 1)
    return (prod >> shift) + rows * width


def sketch_hist_ref(ids: torch.Tensor, weights: torch.Tensor, multipliers,
                    width: int) -> torch.Tensor:
    """``out[i, r, b] = sum_t w[i, t] * (h_r(ids[i, t]) == b)``; (m, depth, width) f32.

    The hash of :func:`sketch_cells`, then one ``index_add_`` adds every
    row of every slot.
    """
    cells = sketch_cells(ids, multipliers, width)
    m, depth, k = cells.shape
    w = weights.to(torch.float32)[:, None, :].expand(m, depth, k)
    out = torch.zeros(m * depth * width, dtype=torch.float32, device=ids.device)
    out.index_add_(0, cells.reshape(-1), w.reshape(-1))
    return out.view(m, depth, width)
