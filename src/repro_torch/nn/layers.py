"""Primitive layers of the port: ``nn.Module``s that hold their weights.

Counterparts of the reference's ``repro.nn.layers`` (``init_*`` + apply
functions over value trees). The weights keep the reference's layouts: a
linear weight is ``(d_in, d_out)`` and applies as ``x @ w``, an embedding
is ``(vocab, d)``. Weights are made empty here and filled by
``models.model.init_model`` (random, from a ``torch.Generator``) or by
``models.convert.params_from_reference`` (the reference's values). They
are made with ``requires_grad=False``, so a serving path builds no
autograd graph; the trainer (``train.loop.Trainer``) switches a model to
training with ``model.requires_grad_(True)``.

Norms compute in float32 and cast back to the input's type, as the
reference does; RoPE and M-RoPE rotate split halves (``_rotate``), not
interleaved pairs; the sinusoidal table is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Linear", "Embedding", "RMSNorm", "LayerNorm", "make_norm",
    "rope_freqs", "apply_rope", "apply_mrope", "sinusoidal_positions", "ACTIVATIONS",
]


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """``y = x @ w (+ b)``, the weight cast to the input's type first."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = _weight((d_in, d_out), dtype, device)
        self.b = _weight((d_out,), dtype, device) if bias else None

    def reset(self, gen: torch.Generator) -> None:
        """The reference's init: ``normal * d_in^-0.5``, zero bias."""
        _fill_normal(self.w, gen, self.w.shape[0] ** -0.5)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


class Embedding(nn.Module):
    """Rows of a ``(vocab, d)`` table."""

    def __init__(self, vocab: int, d: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.w = _weight((vocab, d), dtype, device)

    def reset(self, gen: torch.Generator) -> None:
        _fill_normal(self.w, gen, self.w.shape[1] ** -0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w[ids.long()]


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype=torch.float32, device=None, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _weight((d,), dtype, device)

    def reset(self) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, dtype=torch.float32, device=None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = _weight((d,), dtype, device)
        self.bias = _weight((d,), dtype, device)

    def reset(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


def make_norm(kind: str, d: int, *, dtype, device) -> nn.Module:
    """``"layernorm"`` or (anything else, as in the reference) ``"rmsnorm"``."""
    if kind == "layernorm":
        return LayerNorm(d, dtype=dtype, device=device)
    return RMSNorm(d, dtype=dtype, device=device)


def _fill_normal(w: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Standard normals drawn in float32 from ``gen``, times ``scale``, in place."""
    draw = torch.randn(w.shape, generator=gen, device=w.device, dtype=torch.float32)
    w.copy_(draw.mul_(scale))


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies for half the head dim (float32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., T, H, D) or (..., T, D); positions: (..., T)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)
    ang = positions[..., None].float() * inv             # (..., T, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:                    # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, sections,
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.

    ``positions_3d``: (..., T, 3), the temporal, height and width position
    of each token (all three equal the text position for text);
    ``sections`` says how many of the D/2 frequency slots read each of the
    three (e.g. (16, 24, 24) at head dim 128).
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to D/2 = {d // 2}")
    inv = rope_freqs(d, theta, device=x.device)
    # output_size: the length is known on the host, so nothing is read back.
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.as_tensor(sections, device=x.device),
                                     output_size=d // 2)
    index = sec_id.expand(positions_3d.shape[:-1] + (d // 2,))
    pos = torch.gather(positions_3d.float(), -1, index)   # (..., T, D/2)
    ang = pos * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions_3d.dim() + 1:                  # (..., T, H, D)
        cos, sin = cos[..., None, :], sin[..., None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings, (length, d) float32."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}
