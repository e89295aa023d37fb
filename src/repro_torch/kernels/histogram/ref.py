"""Plain PyTorch version of the per-slot histogram kernel."""

import torch


def histogram_ref(ids: torch.Tensor, weights: torch.Tensor, num_bins: int) -> torch.Tensor:
    """``out[i, b] = sum_t weights[i, t] * (ids[i, t] == b)``; (m, K) -> (m, num_bins) f32.

    Ids outside ``[0, num_bins)`` contribute nothing (they land in a dump
    bin that is dropped).
    """
    m = ids.shape[0]
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_bins)
    rows = torch.arange(m, device=ids.device)[:, None] * num_bins
    flat = torch.where(ok, ids + rows, m * num_bins)
    out = torch.zeros(m * num_bins + 1, dtype=torch.float32, device=ids.device)
    out.index_add_(0, flat.reshape(-1), weights.float().reshape(-1))
    return out[:-1].view(m, num_bins)
