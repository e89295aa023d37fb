"""xLSTM layers of the port: the mLSTM (matrix memory, chunkwise-parallel)
and the sLSTM (a recurrence over time), the reference's ``repro.nn.xlstm``.

xlstm-1.3b stacks mLSTM blocks with an sLSTM block every 8th layer (7:1).
The mLSTM is attention-free with a per-head (dk x dv) matrix memory and
exponential input / sigmoid forget gates; its chunkwise form mirrors the
SSD decomposition (intra-chunk quadratic + inter-chunk state recurrence)
with a running-max stabiliser carried across chunks. Decode is the O(1)
recurrent update.

The sLSTM's hidden state feeds its gates, so training and prefill run a
loop over time steps (the reference's ``lax.scan``); as the reference does,
the loop is cut into 64-step chunks, each recomputed in the backward
(``torch.utils.checkpoint``) so that the carry is kept once a chunk, not
once a step. Each step is a handful of eager launches: the JAX package has
no Pallas kernel for either layer.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import layers as L
from repro_torch.nn.ssm import causal_conv, recompute_in_backward

__all__ = [
    "XLSTMArgs", "MLSTM", "SLSTM", "mlstm", "mlstm_decode", "slstm", "slstm_decode",
    "mlstm_cell_chunked", "mlstm_cell_recurrent_ref",
]

M_INIT = -1e30


@dataclasses.dataclass(frozen=True)
class XLSTMArgs:
    d_model: int
    n_heads: int = 4
    expand: int = 2          # mLSTM up-projection factor
    conv_kernel: int = 4
    chunk: int = 64
    ffn_factor: float = 4 / 3  # sLSTM post-FFN

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ffn(self) -> int:
        return int(self.ffn_factor * self.d_model / 64 + 1) * 64


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise-parallel and recurrent forms
# ---------------------------------------------------------------------------


def _mlstm_chunk(C, n, m_prev, qz, kz, vz, li, lf, scale: float):
    """One chunk: ``(C_new, n_new, m_new, h_out)``; float32 throughout."""
    c = qz.shape[1]
    tri = torch.ones((c, c), dtype=torch.bool, device=qz.device).tril()[None, :, :, None]
    li, lf = li.float(), lf.float()
    kf, vf = kz.float(), vz.float()
    bcum = torch.cumsum(lf, dim=1)                                  # (b, c, h) inclusive
    # D[i, j] = bcum_i - bcum_j + li_j (j <= i)
    dm = bcum[:, :, None, :] - bcum[:, None, :, :] + li[:, None, :, :]   # (b, i, j, h)
    dm = torch.where(tri, dm, M_INIT)
    inter_scale = bcum + m_prev[:, None, :]                         # (b, i, h)
    m_i = torch.maximum(dm.amax(dim=2), inter_scale)                # (b, i, h)

    qs = qz.float() * scale
    sc = torch.einsum("bihd,bjhd->bijh", qs, kf)
    w = torch.exp(dm - m_i[:, :, None, :]) * torch.where(tri, 1.0, 0.0)
    num_intra = torch.einsum("bijh,bjhd->bihd", sc * w, vf)
    den_intra = torch.einsum("bijh,bijh->bih", sc, w)
    inter_w = torch.exp(inter_scale - m_i)                          # (b, i, h)
    num_inter = torch.einsum("bihd,bhde->bihe", qs, C) * inter_w[..., None]
    den_inter = torch.einsum("bihd,bhd->bih", qs, n) * inter_w
    num = num_intra + num_inter
    den = den_intra + den_inter
    h_out = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]

    # The state at the chunk's end.
    bq = bcum[:, -1, :]                                             # (b, h)
    m_new = torch.maximum(m_prev + bq, (bq[:, None, :] - bcum + li).amax(dim=1))
    kw = torch.exp(bq[:, None, :] - bcum + li - m_new[:, None, :])  # (b, j, h)
    decay = torch.exp(m_prev + bq - m_new)
    C_new = C * decay[..., None, None] + torch.einsum("bjh,bjhd,bjhe->bhde", kw, kf, vf)
    n_new = n * decay[..., None] + torch.einsum("bjh,bjhd->bhd", kw, kf)
    return C_new, n_new, m_new, h_out


def _initial_cell(b: int, h: int, d: int, device):
    return (torch.zeros((b, h, d, d), dtype=torch.float32, device=device),
            torch.zeros((b, h, d), dtype=torch.float32, device=device),
            torch.full((b, h), M_INIT, dtype=torch.float32, device=device))


def mlstm_cell_chunked(q, k, v, log_i, log_f, chunk: int, state=None):
    """q, k, v (b, l, h, d); log_i / log_f (b, l, h). Returns ``(h_out in
    q's type, (C (b, h, d, d), n (b, h, d), m (b, h)))``, the state
    tilde-scaled by ``e^-m``. The sequence is padded to a multiple of
    ``chunk``: q, k, v and ``log_f`` with zeros, ``log_i`` with -1e30 (no
    input), which leaves the state as it was."""
    b, l, h, d = q.shape
    scale = d ** -0.5
    pad = (-l) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=M_INIT)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    C, n, m = _initial_cell(b, h, d, q.device) if state is None else state
    hs = []
    for i in range(nc):
        rows = slice(i * chunk, (i + 1) * chunk)
        C, n, m, h_out = recompute_in_backward(
            _mlstm_chunk, C, n, m, q[:, rows], k[:, rows], v[:, rows], log_i[:, rows],
            log_f[:, rows], scale)
        hs.append(h_out)
    return torch.cat(hs, dim=1)[:, :l].to(q.dtype), (C, n, m)


def mlstm_cell_recurrent_ref(q, k, v, log_i, log_f, state=None):
    """Step-by-step oracle; also the decode semantics."""
    b, l, h, d = q.shape
    scale = d ** -0.5
    C, n, m = _initial_cell(b, h, d, q.device) if state is None else state
    outs = []
    for t in range(l):
        li, lf = log_i[:, t].float(), log_f[:, t].float()
        kt, vt = k[:, t].float(), v[:, t].float()
        m_new = torch.maximum(lf + m, li)
        f_w, i_w = torch.exp(lf + m - m_new), torch.exp(li - m_new)
        C = C * f_w[..., None, None] + i_w[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", kt, vt)
        n = n * f_w[..., None] + i_w[..., None] * kt
        m = m_new
        qs = q[:, t].float() * scale
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        den = torch.einsum("bhd,bhd->bh", qs, n)
        outs.append(num / torch.maximum(den.abs(), torch.exp(-m))[..., None])
    return torch.stack(outs, dim=1).to(q.dtype), (C, n, m)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """The reference's ``init_mlstm``: up-projections ``up_u`` and ``up_z``,
    the causal conv, per-head block-diagonal ``q``, ``k``, ``v`` ``(heads,
    hd, hd)``, the gate linears (with biases), the head-wise ``hnorm`` and
    ``down``."""

    def __init__(self, a: XLSTMArgs, *, dtype=torch.float32, device=None):
        super().__init__()
        self.args = a
        di, hd = a.d_inner, a.head_dim
        kw = dict(dtype=dtype, device=device)
        self.up_u = L.Linear(a.d_model, di, **kw)
        self.up_z = L.Linear(a.d_model, di, **kw)
        self.conv_w = L._weight((a.conv_kernel, di), dtype, device)
        self.conv_b = L._weight((di,), dtype, device)
        self.q = L._weight((a.n_heads, hd, hd), dtype, device)
        self.k = L._weight((a.n_heads, hd, hd), dtype, device)
        self.v = L._weight((a.n_heads, hd, hd), dtype, device)
        self.gate_i = L.Linear(di, a.n_heads, bias=True, **kw)
        self.gate_f = L.Linear(di, a.n_heads, bias=True, **kw)
        self.hnorm = L.RMSNorm(hd, **kw)
        self.down = L.Linear(di, a.d_model, **kw)

    def reset(self, gen: torch.Generator) -> None:
        """The reference's scales: linears ``d_in^-0.5``, ``conv_w`` 0.2,
        q / k / v ``hd^-0.5``; zero biases, unit norm."""
        hd = self.args.head_dim
        self.up_u.reset(gen)
        self.up_z.reset(gen)
        L._fill_normal(self.conv_w, gen, 0.2)
        self.conv_b.zero_()
        for w in (self.q, self.k, self.v):
            L._fill_normal(w, gen, hd ** -0.5)
        self.gate_i.reset(gen)
        self.gate_f.reset(gen)
        self.hnorm.reset()
        self.down.reset(gen)

    def forward(self, x, *, state=None, conv_state=None, return_state: bool = False):
        return mlstm(self, x, state=state, conv_state=conv_state, return_state=return_state)


def _mlstm_qkv_gates(p: MLSTM, x, conv_state=None):
    a = p.args
    b, l, _ = x.shape
    u, z = p.up_u(x), p.up_z(x)
    c, new_conv = causal_conv(u, p.conv_w.to(x.dtype), p.conv_b.to(x.dtype), state=conv_state)
    ch = F.silu(c).reshape(b, l, a.n_heads, a.head_dim)
    uh = u.reshape(b, l, a.n_heads, a.head_dim)
    q = torch.einsum("blhd,hde->blhe", ch, p.q.to(x.dtype))
    k = torch.einsum("blhd,hde->blhe", ch, p.k.to(x.dtype))
    v = torch.einsum("blhd,hde->blhe", uh, p.v.to(x.dtype))
    log_i = p.gate_i(u).float()                                      # (b, l, h)
    log_f = F.logsigmoid(p.gate_f(u).float() + 2.0)
    return q, k, v, log_i, log_f, z, new_conv


def _mlstm_out(p: MLSTM, h, z):
    b, l = h.shape[0], h.shape[1]
    h = p.hnorm(h).reshape(b, l, p.args.d_inner)                     # head-wise norm
    return p.down(h * F.silu(z))


def mlstm(p: MLSTM, x, *, state=None, conv_state=None, return_state: bool = False):
    """x (B, L, d_model) -> (B, L, d_model); with ``return_state`` also
    ``{"cell": (C, n, m), "conv": (B, K-1, d_inner)}``."""
    q, k, v, log_i, log_f, z, new_conv = _mlstm_qkv_gates(p, x, conv_state)
    h, cell = mlstm_cell_chunked(q, k, v, log_i, log_f, p.args.chunk, state=state)
    out = _mlstm_out(p, h, z)
    if return_state:
        return out, {"cell": cell, "conv": new_conv}
    return out


def mlstm_decode(p: MLSTM, x, state: dict):
    """One-token step (the recurrent form). Returns ``(y, new_state)``."""
    q, k, v, log_i, log_f, z, new_conv = _mlstm_qkv_gates(p, x, state["conv"])
    h, cell = mlstm_cell_recurrent_ref(q, k, v, log_i, log_f, state=state["cell"])
    return _mlstm_out(p, h, z), {"cell": cell, "conv": new_conv}


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, a recurrence over time)
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """The reference's ``init_slstm``: input gates ``w_gates`` (with bias),
    per-head recurrent gates ``r_gates`` ``(heads, shd, 4 shd)``, the
    head-wise ``hnorm`` and the gated post-FFN."""

    def __init__(self, a: XLSTMArgs, *, dtype=torch.float32, device=None):
        super().__init__()
        self.args = a
        d, hd, nh = a.d_model, a.s_head_dim, a.n_heads
        kw = dict(dtype=dtype, device=device)
        self.w_gates = L.Linear(d, 4 * d, bias=True, **kw)
        self.r_gates = L._weight((nh, hd, 4 * hd), dtype, device)
        self.hnorm = L.RMSNorm(hd, **kw)
        self.ffn_up = L.Linear(d, a.d_ffn, **kw)
        self.ffn_gate = L.Linear(d, a.d_ffn, **kw)
        self.ffn_down = L.Linear(a.d_ffn, d, **kw)

    def reset(self, gen: torch.Generator) -> None:
        self.w_gates.reset(gen)
        L._fill_normal(self.r_gates, gen, self.args.s_head_dim ** -0.5)
        self.hnorm.reset()
        self.ffn_up.reset(gen)
        self.ffn_gate.reset(gen)
        self.ffn_down.reset(gen)

    def forward(self, x, *, state=None, return_state: bool = False):
        return slstm(self, x, state=state, return_state=return_state)


def _slstm_step(r, carry, gx):
    """One time step; ``carry = (h, c, n, m)``, each (b, nh, hd)."""
    h, c, n, m = carry
    g = gx + torch.einsum("bhd,hdk->bhk", h, r)                     # (b, nh, 4 hd)
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    log_f = F.logsigmoid(gf + 1.0)
    m_new = torch.maximum(log_f + m, gi)
    i_p = torch.exp(gi - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * torch.tanh(gz)
    n = f_p * n + i_p
    h_new = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
    return h_new, c, n, m_new


def _slstm_steps(r, h, c, n, m, gx):
    """The steps over ``gx`` (b, t, nh, 4 hd): ``(h, c, n, m, hs (b, t, nh,
    hd))``."""
    carry, hs = (h, c, n, m), []
    for t in range(gx.shape[1]):
        carry = _slstm_step(r, carry, gx[:, t])
        hs.append(carry[0])
    return (*carry, torch.stack(hs, dim=1))


def slstm(p: SLSTM, x, *, state=None, return_state: bool = False, time_chunk: int = 64):
    """x (B, L, d_model) -> (B, L, d_model); with ``return_state`` also the
    final ``(h, c, n, m)``, each (B, heads, shd) float32. Below ``time_chunk``
    steps, or when it does not divide L, one loop; else a loop over chunks
    of ``time_chunk`` steps, each recomputed in the backward."""
    a = p.args
    b, l, d = x.shape
    nh, hd = a.n_heads, a.s_head_dim
    gx = p.w_gates(x).reshape(b, l, nh, 4 * hd).float()
    if state is None:
        zero = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        state = (zero, zero, zero, torch.full((b, nh, hd), M_INIT, dtype=torch.float32,
                                               device=x.device))
    r = p.r_gates.float()
    tc = min(time_chunk, l)
    if l % tc == 0 and l > tc:
        carry, hs = tuple(state), []
        for i in range(l // tc):
            *carry, hc = recompute_in_backward(_slstm_steps, r, *carry,
                                               gx[:, i * tc:(i + 1) * tc])
            hs.append(hc)
        hs = torch.cat(hs, dim=1)
    else:
        *carry, hs = _slstm_steps(r, *state, gx)
    y = p.hnorm(hs.to(x.dtype)).reshape(b, l, d)
    y = y + p.ffn_down(F.silu(p.ffn_gate(y)) * p.ffn_up(y))
    if return_state:
        return y, tuple(carry)
    return y


def slstm_decode(p: SLSTM, x, state):
    """One step: the same function on a length-1 input."""
    return slstm(p, x, state=state, return_state=True)
