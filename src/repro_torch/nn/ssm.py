"""Mamba2 (SSD) layer of the port: chunkwise-parallel scan and O(1)
recurrent decode (the reference's ``repro.nn.ssm``).

Used by zamba2-2.7b (a Mamba2 backbone with a shared attention block).

The SSD (state-space dual) form splits the sequence into chunks: within a
chunk the token-token interaction is a small quadratic matmul with
exponential decay masks; across chunks a recurrence over the ``(heads,
head_dim, state)`` tensor carries the SSM state. Decode is the pure
recurrence, one token at a time.

Conventions: x (B, L, H, P); dt (B, L, H); A (H,) negative; B/C (B, L, G, N)
with G groups broadcast over H (G | H). The scan body runs in float32. The
reference recomputes each chunk body in the backward (``jax.checkpoint``);
here each chunk is a ``torch.utils.checkpoint`` call whenever a gradient
is recorded, so that only the ``(b, h, p, n)`` state carry is kept per
chunk, never its ``(b, h, c, c)`` decay tensors.

The plain ops here are the reference's ``jnp`` and ``lax.scan`` code: the
JAX package has no Pallas kernel for this layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import layers as L

__all__ = ["SSMArgs", "Mamba2", "mamba2", "mamba2_decode", "ssd_chunked",
           "ssd_recurrent_ref", "causal_conv", "softplus"]


@dataclasses.dataclass(frozen=True)
class SSMArgs:
    d_model: int
    d_inner: int          # expand * d_model
    head_dim: int = 64
    d_state: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 128

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` exactly, as ``jax.nn.softplus`` (``logaddexp(x,
    0)``): ``F.softplus`` returns ``x`` itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def recompute_in_backward(fn, *args):
    """``fn(*args)``, recomputed in the backward (``torch.utils.checkpoint``)
    when a gradient is being recorded for one of ``args``; a plain call
    otherwise."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x (B, L, C); w (K, C). Returns ``(y,
    new_state)``; ``state`` is the last K-1 inputs of the previous segment
    (decode), and ``new_state`` this segment's (zeros in front of a short
    first segment)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # (B, L+K-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b
    return y, xp[:, -(k - 1):, :]


def _ssd_chunk(s_prev, xz, dtz, bz, cz, a, rep: int):
    """One chunk of the SSD scan: ``(S_new, y)``; float32 throughout."""
    c = xz.shape[1]
    tri = torch.ones((c, c), dtype=torch.bool, device=xz.device).tril()
    bz = bz.repeat_interleave(rep, dim=2).float()
    cz = cz.repeat_interleave(rep, dim=2).float()
    xf = xz.float()
    cum = torch.cumsum(dtz * a, dim=1)                       # (b, c, h), negative
    total = cum[:, -1]                                       # (b, h)
    # intra: att[i, j] = C_i . B_j e^{cum_i - cum_j} dt_j (j <= i). The
    # exponent is masked, not the exponential: above the diagonal it is
    # positive, and exp -> inf would give NaN gradients through a mask.
    cb = torch.einsum("bihn,bjhn->bhij", cz, bz)
    ct = cum.transpose(1, 2)                                 # (b, h, c)
    decay = torch.exp(torch.where(tri, ct[:, :, :, None] - ct[:, :, None, :], 0.0))
    att = cb * decay * tri
    att = att * dtz.transpose(1, 2)[:, :, None, :]
    y = torch.einsum("bhij,bjhp->bihp", att, xf)
    # inter: e^{cum_i} C_i . S_prev
    y = y + torch.einsum("bihn,bhpn->bihp", cz * torch.exp(cum)[..., None], s_prev)
    w_state = torch.exp(total[:, None, :] - cum) * dtz      # (b, c, h)
    s_new = s_prev * torch.exp(total)[:, :, None, None] + torch.einsum(
        "bjh,bjhn,bjhp->bhpn", w_state, bz, xf)
    return s_new, y


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunkwise SSD. Returns ``(y (b, l, h, p) in x's type, final_state
    (b, h, p, n) float32)``.

    x (b, l, h, p); dt (b, l, h) >= 0; A (h,) < 0; Bm/Cm (b, l, g, n). The
    sequence is padded to a multiple of ``chunk`` with zeros and dt = 0,
    which leaves the state as it was."""
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (l + pad) // chunk
    dtf = dt.float()
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for i in range(nc):
        rows = slice(i * chunk, (i + 1) * chunk)
        s, y = recompute_in_backward(_ssd_chunk, s, x[:, rows], dtf[:, rows], Bm[:, rows],
                                     Cm[:, rows], A, rep)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :l]
    return y.to(x.dtype), s


def ssd_recurrent_ref(x, dt, A, Bm, Cm, init_state=None):
    """Step-by-step oracle (also the decode semantics)."""
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    bf = Bm.repeat_interleave(rep, dim=2).float()
    cf = Cm.repeat_interleave(rep, dim=2).float()
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(l):
        dtt = dt[:, t].float()
        s = s * torch.exp(dtt * A)[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtt, bf[:, t], x[:, t].float())
        ys.append(torch.einsum("bhn,bhpn->bhp", cf[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype), s


class Mamba2(nn.Module):
    """The reference's ``init_mamba2`` parameters: ``in_proj``, the depthwise
    ``conv_w`` ``(K, conv_dim)`` and ``conv_b``, ``A_log``, ``D`` and
    ``dt_bias`` (float32 whatever the model's type), the gated ``norm`` and
    ``out_proj``."""

    def __init__(self, a: SSMArgs, *, dtype=torch.float32, device=None):
        super().__init__()
        self.args = a
        d_in_proj = 2 * a.d_inner + 2 * a.n_groups * a.d_state + a.n_heads
        kw = dict(dtype=dtype, device=device)
        self.in_proj = L.Linear(a.d_model, d_in_proj, **kw)
        self.conv_w = L._weight((a.conv_kernel, a.conv_dim), dtype, device)
        self.conv_b = L._weight((a.conv_dim,), dtype, device)
        self.A_log = L._weight((a.n_heads,), torch.float32, device)
        self.D = L._weight((a.n_heads,), torch.float32, device)
        self.dt_bias = L._weight((a.n_heads,), torch.float32, device)
        self.norm = L.RMSNorm(a.d_inner, **kw)
        self.out_proj = L.Linear(a.d_inner, a.d_model, **kw)

    def reset(self, gen: torch.Generator) -> None:
        """The reference's init: linears ``normal * d_in^-0.5``, ``conv_w``
        ``normal * 0.2``, ``A_log = log(linspace(1, 16, heads))``, ``D`` 1,
        zero biases."""
        self.in_proj.reset(gen)
        L._fill_normal(self.conv_w, gen, 0.2)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, self.args.n_heads,
                                                  dtype=torch.float32)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.reset()
        self.out_proj.reset(gen)

    def _conv_branch(self, x, conv_state):
        """in_proj, the causal conv and SiLU: ``(z, xs, Bm, Cm, dt_pre,
        new_conv)``, xs (b, l, h, p) and Bm/Cm (b, l, g, n)."""
        a = self.args
        b, l, _ = x.shape
        z, xbc, dt_pre = torch.split(self.in_proj(x), [a.d_inner, a.conv_dim, a.n_heads],
                                     dim=-1)
        xbc, new_conv = causal_conv(xbc, self.conv_w.to(x.dtype), self.conv_b.to(x.dtype),
                                    state=conv_state)
        xbc = F.silu(xbc)
        gn = a.n_groups * a.d_state
        xs, bm, cm = torch.split(xbc, [a.d_inner, gn, gn], dim=-1)
        return (z, xs.reshape(b, l, a.n_heads, a.head_dim),
                bm.reshape(b, l, a.n_groups, a.d_state),
                cm.reshape(b, l, a.n_groups, a.d_state), dt_pre, new_conv)

    def forward(self, x, *, init_state=None, conv_state=None, return_state: bool = False):
        return mamba2(self, x, init_state=init_state, conv_state=conv_state,
                      return_state=return_state)


def mamba2(p: Mamba2, x, *, init_state=None, conv_state=None, return_state: bool = False):
    """x (B, L, d_model) -> (B, L, d_model): the training and prefill path;
    with ``return_state`` also ``{"ssm": (B, H, P, N) float32, "conv": (B,
    K-1, conv_dim)}``."""
    a = p.args
    b, l, _ = x.shape
    z, xs, bm, cm, dt_pre, new_conv = p._conv_branch(x, conv_state)
    dt = softplus(dt_pre.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, state = ssd_chunked(xs, dt, A, bm, cm, a.chunk, init_state=init_state)
    y = y + xs.to(y.dtype) * p.D[None, None, :, None].to(y.dtype)
    y = p.norm(y.reshape(b, l, a.d_inner) * F.silu(z))
    out = p.out_proj(y)
    if return_state:
        return out, {"ssm": state, "conv": new_conv}
    return out


def mamba2_decode(p: Mamba2, x, state: dict):
    """One-token step. x (B, 1, d_model); ``state`` ``{"ssm", "conv"}``.
    Returns ``(y, new_state)``."""
    a = p.args
    b = x.shape[0]
    z, xs, bm, cm, dt_pre, new_conv = p._conv_branch(x, state["conv"])
    xs = xs.reshape(b, a.n_heads, a.head_dim)
    rep = a.n_heads // a.n_groups
    bf = bm.reshape(b, a.n_groups, a.d_state).repeat_interleave(rep, dim=1).float()
    cf = cm.reshape(b, a.n_groups, a.d_state).repeat_interleave(rep, dim=1).float()
    dt = softplus(dt_pre[:, 0].float() + p.dt_bias)                # (b, h)
    A = -torch.exp(p.A_log)
    s = state["ssm"] * torch.exp(dt * A)[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt, bf, xs.float())
    y = torch.einsum("bhn,bhpn->bhp", cf, s)
    y = y + xs.to(y.dtype) * p.D[None, :, None]
    y = y.reshape(b, 1, a.d_inner).to(x.dtype)
    y = p.norm(y * F.silu(z))
    return p.out_proj(y), {"ssm": s, "conv": new_conv}
