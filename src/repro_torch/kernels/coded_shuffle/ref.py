"""Plain PyTorch versions of the XOR word kernel's two instances."""

import torch


def xor_words_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a ^ b`` on int32/uint32 word slabs (the whole op).

    XOR runs on the int32 view: CUDA PyTorch has no uint32 ``bitwise_xor``,
    and the bits are the same either way.
    """
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(
            f"xor_words needs matching operands, got {tuple(a.shape)}/{a.dtype}"
            f" vs {tuple(b.shape)}/{b.dtype}")
    return torch.bitwise_xor(a.view(torch.int32), b.view(torch.int32)).view(a.dtype)


def pair_ok(m: int, device=None, senders=None, first_sender: int = 0) -> torch.Tensor:
    """``(senders, m, m)`` bool (``senders`` defaults to ``m``): block ``(r, d,
    q)`` of sender ``s = first_sender + r`` carries a packet, i.e. ``d != q``
    and neither is ``s``."""
    ids = torch.arange(m, device=device)
    rows = torch.arange(m if senders is None else senders, device=device) + first_sender
    s, d, q = rows[:, None, None], ids[None, :, None], ids[None, None, :]
    return (d != q) & (d != s) & (q != s)


def encode_packets_ref(slab: torch.Tensor, first_sender: int = 0) -> torch.Tensor:
    """The coded packets of one chunk's ``(R, m, m, ...)`` word slab of
    senders ``first_sender ..``: ``x[r, d, q] = slab[r, d, q] ^ slab[r, q, d]``
    where :func:`pair_ok`, else 0. int32/uint32 words; returns a new slab of
    the same shape."""
    words = slab.view(torch.int32)
    ok = pair_ok(slab.shape[1], slab.device, slab.shape[0], first_sender).view(
        *slab.shape[:3], *(1,) * (slab.dim() - 3))
    return torch.where(ok, words ^ words.transpose(1, 2), 0).view(slab.dtype)
