"""int8 gradient compression with error feedback.

The reference's ``repro.train.compression`` on tensors. int8 with a
per-tensor scale cuts the bytes of a cross-node gradient reduction 4x
against float32; error feedback (Seide et al. / EF-SGD) adds each step's
quantisation residual back before the next quantisation, so the noise
does not bias the update in the long run.

Usage (training loop):
    comp, err = compress_tree(grads, err)    # before the reduction
    g_hat = decompress_tree(comp)             # after

Trees are mappings from a name to a tensor.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch

__all__ = ["Compressed", "compress_leaf", "decompress_leaf",
           "compress_tree", "decompress_tree", "init_error"]


class Compressed(NamedTuple):
    q: torch.Tensor       # int8
    scale: torch.Tensor   # float32 scalar


def compress_leaf(g: torch.Tensor) -> Tuple[Compressed, torch.Tensor]:
    """Returns (compressed, residual error)."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    err = g32 - q.to(torch.float32) * scale
    return Compressed(q, scale), err


def decompress_leaf(c: Compressed, dtype=torch.float32) -> torch.Tensor:
    return (c.q.to(torch.float32) * c.scale).to(dtype)


def init_error(grads: Mapping[str, torch.Tensor]) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def compress_tree(grads: Mapping[str, torch.Tensor], error: Mapping[str, torch.Tensor]):
    """(grads + error) -> (compressed tree, new error tree)."""
    comp, errs = {}, {}
    for k, g in grads.items():
        comp[k], errs[k] = compress_leaf(g.to(torch.float32) + error[k])
    return comp, errs


def decompress_tree(comp: Mapping[str, Compressed], dtype=torch.float32) -> dict:
    return {k: decompress_leaf(c, dtype) for k, c in comp.items()}
