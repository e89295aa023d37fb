"""Plain PyTorch version of the fused gather + segment-sum kernel."""

import torch


def fused_gather_segment_reduce_ref(
    values: torch.Tensor, gather_idx: torch.Tensor, seg_ids: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """``out[i, s] = sum_{t: seg_ids[i, t] == s} values[i, gather_idx[i, t]]``.

    ``values (m, N, V)``, ``gather_idx``/``seg_ids (m, N)`` -> ``(m,
    num_segments, V)`` float32. Ids outside ``[0, num_segments)`` are
    padding and contribute nothing.
    """
    m, n, v = values.shape
    idx = gather_idx.long()[..., None].expand(m, n, v)
    rows = torch.gather(values, 1, idx).float()
    seg = seg_ids.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    flat = seg + torch.arange(m, device=seg.device)[:, None] * (num_segments + 1)
    out = torch.zeros(m * (num_segments + 1), v, dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, flat.reshape(-1), rows.reshape(-1, v))
    return out.view(m, num_segments + 1, v)[:, :-1]
