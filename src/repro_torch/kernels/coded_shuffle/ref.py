"""Plain PyTorch version of the XOR word kernel."""

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
