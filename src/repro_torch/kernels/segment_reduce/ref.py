"""Plain PyTorch version of the sorted segment-sum kernel."""

import torch


def segment_reduce_sorted_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """``out[i, s] = sum_{t: seg_ids[i, t] == s} values[i, t]``; (m, S, V) f32.

    ``values (m, N, V)``, ``seg_ids (m, N)``. Ids outside ``[0,
    num_segments)`` contribute nothing (they land in a dump segment that
    is dropped). The plain version does not need ``seg_ids`` sorted.
    """
    m, n, v = values.shape
    seg = seg_ids.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    flat = seg + torch.arange(m, device=seg.device)[:, None] * (num_segments + 1)
    out = torch.zeros(m * (num_segments + 1), v, dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, flat.reshape(-1), values.float().reshape(-1, v))
    return out.view(m, num_segments + 1, v)[:, :-1]
