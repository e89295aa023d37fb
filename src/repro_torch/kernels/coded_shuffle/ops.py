"""Public wrapper of the coded-shuffle XOR kernel + payload word packing.

Two instances of one XOR word kernel carry the coded shuffle.
``encode_packets`` is the multicast encode: each sender XORs the two
destination slabs of every multicast pair into one packet, and blocks
without a pair are zero. ``xor_words`` is the flat XOR, the decode:
receivers XOR the packet against the slab they rebuild from their
replicas. CPU tensors run the plain versions; CUDA tensors launch
``csrc/xor_words.cu`` or raise.

The packing helpers give the engine one word-level wire format: float
payloads (f32/bf16) and quantized bytes (int8, or fp8 bit patterns) are
bit-cast into int32 words, XOR-combined and bit-cast back. XOR on the
word view is XOR on the payload bits, so decode is exact for every
payload dtype. Lanes sit little-endian within a word, as the reference's
``jax.lax.bitcast_convert_type`` puts them, so the words equal the
reference's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.coded_shuffle.ref import encode_packets_ref, xor_words_ref
from repro_torch.kernels.coded_shuffle.xor_words import encode_packets_cuda, xor_words_cuda

# Launches of the CUDA kernel since import (or since a caller reset them):
# +1 per launch, never for the plain versions on the CPU; and the same
# launches by instance.
launches = 0
launches_by_design = {"encode": 0, "flat": 0}

_BYTES_PER_WORD = 4
_WORD_DTYPES = (torch.int32, torch.uint32)
# The integer type of each payload width: the bit-cast carrier.
_LANE_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def xor_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a ^ b`` over ``(N, W)`` int32/uint32 word slabs.

    CUDA tensors launch the kernel's flat instance once over all ``N * W``
    words (counted in this module's ``launches``); both must be contiguous.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return xor_words_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"xor_words needs both slabs on one CUDA device (or the CPU), got"
            f" {a.device} and {b.device}")
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(
            f"xor_words needs (N, W) slabs of one shape, got {tuple(a.shape)}"
            f" and {tuple(b.shape)}")
    if a.dtype not in _WORD_DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"xor_words needs int32 or uint32 words of one type, got {a.dtype}"
            f" and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("xor_words needs contiguous slabs")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        xor_words_cuda(a, b, out)
    _count("flat")
    return out


def encode_packets(slab: torch.Tensor, first_sender: int = 0) -> torch.Tensor:
    """The coded packets of one chunk: ``x[r, d, q] = slab[r, d, q] ^ slab[r,
    q, d]`` where ``d != q`` and neither is the sender ``s = first_sender +
    r``, else 0.

    ``slab`` is the ``(R, m, m, cap, W)`` int32/uint32 spill (sender,
    partner, destination, row, word) of senders ``first_sender ..
    first_sender + R - 1``: every slot stacked (``R = m``, ``first_sender =
    0``) or one slot's own share (``R = 1``). CUDA slabs (contiguous) launch
    the kernel's encode instance once (counted in ``launches``); it reads
    each packet's two blocks once and writes no swapped copy.
    """
    if slab.dim() != 5 or slab.shape[1] != slab.shape[2]:
        raise ValueError(f"encode_packets needs an (R, m, m, cap, W) slab, got"
                         f" {tuple(slab.shape)}")
    senders, m = slab.shape[0], slab.shape[1]
    if not (0 <= first_sender and first_sender + senders <= m):
        raise ValueError(f"senders {first_sender}..{first_sender + senders - 1} are not"
                         f" slots of an m={m} mesh")
    if slab.device.type == "cpu":
        return encode_packets_ref(slab, first_sender)
    if slab.device.type != "cuda":
        raise ValueError(f"encode_packets needs a CUDA (or CPU) slab, got {slab.device}")
    if slab.dtype not in _WORD_DTYPES:
        raise TypeError(f"encode_packets needs int32 or uint32 words, got {slab.dtype}")
    if senders * m * (m + 1) // 2 > 65535:
        raise ValueError(f"encode_packets takes at most 65535 (sender, pair) items (the"
                         f" kernel's grid has one row each), got {senders} senders of m={m}")
    if not slab.is_contiguous():
        raise ValueError("encode_packets needs a contiguous slab")
    out = torch.empty_like(slab)
    if slab.numel() == 0:
        return out
    with torch.cuda.device(slab.device):
        encode_packets_cuda(slab, out, first_sender)
    _count("encode")
    return out


def _count(design: str) -> None:
    global launches
    launches += 1
    launches_by_design[design] += 1


def packed_width(v_dim: int, dtype: torch.dtype) -> int:
    """Words per row when packing ``v_dim`` lanes of ``dtype`` into int32."""
    group = _BYTES_PER_WORD // dtype.itemsize
    return -(-v_dim // group)


def pack_payload_words(x: torch.Tensor) -> torch.Tensor:
    """Bit-cast an ``(..., V)`` payload into ``(..., W)`` int32 words.

    Lanes are grouped ``4 // itemsize`` to a word (f32 one, bf16 two,
    int8/fp8 four); ``V`` is zero-padded up to a whole group, so padding
    bits are zero and XOR-neutral. Exact round trip through
    :func:`unpack_payload_words` for every payload dtype.
    """
    itemsize = x.dtype.itemsize
    if itemsize > _BYTES_PER_WORD:
        raise ValueError(f"payload dtype {x.dtype} wider than a word")
    lanes = x.view(_LANE_INT[itemsize])
    pad = (-x.shape[-1]) % (_BYTES_PER_WORD // itemsize)
    if pad:
        lanes = F.pad(lanes, (0, pad))
    return lanes.contiguous().view(torch.int32)


def unpack_payload_words(words: torch.Tensor, dtype: torch.dtype,
                         v_dim: int) -> torch.Tensor:
    """Invert :func:`pack_payload_words` back to ``(..., v_dim)`` of ``dtype``."""
    if words.shape[-1] != packed_width(v_dim, dtype):
        raise ValueError(
            f"word slab width {words.shape[-1]} does not match v_dim={v_dim}"
            f" of {dtype}")
    lanes = words.contiguous().view(_LANE_INT[dtype.itemsize])
    return lanes[..., :v_dim].view(dtype)
