"""MoE layer with OS4M operation-level load balancing (the paper's technique).

The mapping: a routed expert's token group is a Reduce *operation
cluster* (all pairs of one key ↔ all tokens of one expert); expert slots
are Reduce *slots*; the router-count histogram summed over the slots is
the §4.1 communication mechanism; the host-side BSS scheduler
(:mod:`repro_torch.core.balancer`) solves P||C_max for the expert → slot
*placement*; and the static per-slot dispatch **capacity is the scheduled
max-load**.

The reference runs one ``shard_map`` island per MoE layer over a mesh
whose model axis holds the expert shards. Here that axis is an explicit
``ep_slots``, the number of expert slots, **stacked on one device** as
the MapReduce engine's ``backend="stacked"`` stacks its slots: every
per-slot tensor has a leading slot axis, the all-to-all is a transpose of
the ``(src, dst, cap, d)`` bucket tensor, and the ``psum`` over the model
axis is a sum over that axis. The data axis is 1.

* EP regime (``num_experts % ep_slots == 0``): slot ``j`` holds expert
  weight rows ``j * per .. (j + 1) * per - 1``. Prefill (``t > 1``,
  ``t % ep_slots == 0``) takes the a2a path: tokens are split over the
  slots along the sequence, counting-sorted into per-destination buckets,
  exchanged, run through per-expert buckets and sent back.
* TP regime (fewer experts than slots divide): every slot runs every
  expert on its contiguous slice of the hidden dim, dropless, and the
  partial outputs sum.

Decode steps (``t = 1``) and ``strategy="broadcast"`` take the broadcast
body: every slot sees every token and runs its own experts; the outputs
sum over the slots. The expert FFNs are plain batched matrix products, as
the reference's are (outside any Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.nn import layers as L

__all__ = ["MoEArgs", "MoE", "init_moe", "moe", "default_placement",
           "balanced_placement", "capacity_for"]


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    num_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden
    shared_experts: int = 0        # DeepSeek-style always-on experts
    act: str = "silu"
    gated: bool = True
    capacity_factor: float = 1.25  # slack over the *scheduled* max-load
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2
    # EP dispatch strategy: "a2a" (counting-sort into per-destination
    # buckets + all-to-all) or "broadcast" (every slot computes its
    # experts on all local tokens, summed).
    strategy: str = "a2a"
    # Chunked-dispatch pipelining: the a2a send buckets split into this
    # many capacity slabs (1 = single-shot a2a). Per-expert capacity drops
    # use global in-expert ranks (a carry across slabs), so the kept /
    # dropped COUNT per expert matches single-shot dispatch.
    pipeline_chunks: int = 1

    def ep_size(self, ep_slots: int) -> int:
        return ep_slots

    def is_ep(self, ep_slots: int) -> bool:
        return self.num_experts % self.ep_size(ep_slots) == 0

    def experts_per_shard(self, ep_slots: int) -> int:
        return self.num_experts // self.ep_size(ep_slots)


def default_placement(args: MoEArgs, ep_slots: int, device=None) -> torch.Tensor:
    """The static hash-class baseline (paper eq. 3-1): expert e → slot by id.

    A ``(2, E)`` int32 table ``[slot; row within the slot]``. Slot ``j``'s
    local row ``s`` holds weight row ``j * per + s``; rebalancing permutes
    the *weight rows* together with the table
    (:func:`repro_torch.core.balancer.permute_expert_weights`). TP regime:
    every expert lives on every slot, row = expert id.
    """
    e = torch.arange(args.num_experts, dtype=torch.int32, device=device)
    if args.is_ep(ep_slots):
        per = args.experts_per_shard(ep_slots)
        return torch.stack([e // per, e % per])
    return torch.stack([torch.zeros_like(e), e])


def balanced_placement(args: MoEArgs, ep_slots: int, counts, speeds=None, device=None):
    """The OS4M placement for one layer's measured expert loads.

    ``counts`` is the (E,) per-expert token histogram (the §4.1 key
    distribution); ``speeds`` the optional per-slot relative speeds
    (Q||C_max; ``None`` is the P||C_max placement). Returns ``(placement
    (2, E) int32, perm (E,) np.int64)``: the table :func:`moe` takes and
    the weight-row permutation that must go with it. The TP regime keeps
    :func:`default_placement` and the identity.
    """
    from repro_torch.core.balancer import (placement_from_assignment,
                                           schedule_balanced_cardinality)

    if not args.is_ep(ep_slots):
        return default_placement(args, ep_slots, device), np.arange(args.num_experts)
    assignment = schedule_balanced_cardinality(
        np.asarray(counts, np.float64), ep_slots, args.experts_per_shard(ep_slots),
        speeds=speeds)
    placement, perm = placement_from_assignment(assignment, ep_slots)
    return torch.as_tensor(placement, dtype=torch.int32, device=device), perm


def capacity_for(args: MoEArgs, tokens_per_src_shard: int, ep_slots: int,
                 max_load_ratio: float = 1.0) -> int:
    """Static bucket capacity from the scheduled max-load.

    ``max_load_ratio`` is the scheduler's max-load / ideal-load. Capacity
    is ideal · ratio · slack, rounded up to a multiple of 8. For the a2a
    strategy ``tokens_per_src_shard`` is a slot's token count and the
    result the per-(src, dst) send bucket; for broadcast it is every
    token and the result the per-slot bucket.
    """
    if not args.is_ep(ep_slots):
        return tokens_per_src_shard * args.top_k  # dropless TP regime
    ideal = tokens_per_src_shard * args.top_k / args.ep_size(ep_slots)
    cap = int(ideal * max_load_ratio * args.capacity_factor) + 1
    return max(8, -(-cap // 8) * 8)


def _fill_normal(w: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """:func:`repro_torch.nn.layers._fill_normal` an expert's ``(d, f)`` block
    at a time, so the float32 draw is one block, not the stacked whole."""
    for row in w:
        L._fill_normal(row, gen, scale)


class MoE(nn.Module):
    """Router ``(d, E)`` (float32), stacked expert weights ``up`` / ``gate``
    ``(E, d, f)`` and ``down`` ``(E, f, d)``, and the optional shared
    experts, over ``ep_slots`` stacked expert slots."""

    def __init__(self, args: MoEArgs, ep_slots: int = 1, *, dtype=torch.float32, device=None):
        super().__init__()
        if ep_slots < 1:
            raise ValueError(f"ep_slots must be >= 1, got {ep_slots}")
        if not args.is_ep(ep_slots) and args.d_ff % ep_slots:
            raise ValueError(
                f"the TP regime slices d_ff={args.d_ff} over {ep_slots} expert slots;"
                " it must divide")
        self.args, self.ep_slots = args, ep_slots
        e, d, f = args.num_experts, args.d_model, args.d_ff
        self.router = L._weight((d, e), torch.float32, device)
        self.up = L._weight((e, d, f), dtype, device)
        self.down = L._weight((e, f, d), dtype, device)
        self.gate = L._weight((e, d, f), dtype, device) if args.gated else None
        self.shared = None
        if args.shared_experts:
            fs = args.shared_experts * f
            self.shared = nn.ModuleDict({
                "up": L.Linear(d, fs, dtype=dtype, device=device),
                "gate": L.Linear(d, fs, dtype=dtype, device=device),
                "down": L.Linear(fs, d, dtype=dtype, device=device),
            })

    def reset(self, gen: torch.Generator) -> None:
        """The reference's init scales: router and up/gate ``d^-0.5``, down
        ``f^-0.5``, the shared experts as linears."""
        d, f = self.args.d_model, self.args.d_ff
        _fill_normal(self.router[None], gen, d ** -0.5)
        _fill_normal(self.up, gen, d ** -0.5)
        _fill_normal(self.down, gen, f ** -0.5)
        if self.gate is not None:
            _fill_normal(self.gate, gen, d ** -0.5)
        if self.shared is not None:
            for name in ("up", "gate", "down"):
                self.shared[name].reset(gen)

    def forward(self, x, placement=None, capacity=None):
        return moe(self, x, placement=placement, capacity=capacity)


def init_moe(args: MoEArgs, ep_slots: int = 1, *, seed: int = 0, dtype=torch.float32,
             device=None, generator: Optional[torch.Generator] = None) -> MoE:
    """An :class:`MoE` with random weights from ``generator`` (default: one
    on ``device`` seeded with ``seed``). The CPU is used only when named."""
    from repro_torch.device import default_device

    device = default_device(device, "init_moe")
    module = MoE(args, ep_slots, dtype=dtype, device=device)
    module.reset(generator if generator is not None
                 else torch.Generator(device=device).manual_seed(seed))
    return module


# ---------------------------------------------------------------------------
# Slot-stacked bodies: every per-slot tensor has a leading slot axis S.
# ---------------------------------------------------------------------------


def _route(args: MoEArgs, xs: torch.Tensor, router: torch.Tensor):
    """Top-k routing of ``xs (S, N, d)``: ``(logits, probs, top_p, top_e)``."""
    logits = xs.float() @ router.float()                      # (S, N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, args.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, top_p, top_e


def _aux_loss(args: MoEArgs, counts, mean_probs, logits) -> torch.Tensor:
    """Switch-style balance loss + router z-loss of ``logits (S, N, E)``,
    each slot's tokens.

    The reference computes the z-loss per slot and returns the loss out of
    its ``shard_map`` as replicated: the value is slot 0's, while the
    gradient is that of the mean of the slots' z-losses. Both are kept:
    slot 0's value plus the mean's gradient (a zero-valued term)."""
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    aux = args.aux_coef * args.num_experts * (frac_tokens * mean_probs).sum()
    z = args.router_z_coef * (torch.logsumexp(logits, dim=-1) ** 2).mean(dim=-1)
    z_mean = z.mean()
    return aux + (z[0].detach() + (z_mean - z_mean.detach()))


def _slot_weights(module: MoE, is_ep: bool):
    """Each slot's expert weights as ``(S * n_local, ...)`` batches: the
    EP regime's contiguous row blocks (views), or the TP regime's hidden
    slices of every expert."""
    if is_ep:       # E = S * n_local rows, slot-major
        return [module.up, module.gate, module.down]
    s = module.ep_slots
    e, d, f = module.up.shape
    fs = f // s

    def cut_in(w):      # (E, d, f) → (S * E, d, f / S)
        return w.view(e, d, s, fs).permute(2, 0, 1, 3).reshape(s * e, d, fs)

    return [cut_in(module.up), None if module.gate is None else cut_in(module.gate),
            module.down.view(e, s, fs, d).transpose(0, 1).reshape(s * e, fs, d)]


def _expert_bucket_run(rx_s, rslot_s, n_local: int, weights, args: MoEArgs,
                       cap_rows: Optional[int] = None, rank_offset=None):
    """Dense grouped matmul over sorted rows via static per-expert buckets.

    ``rx_s (S, M, d)`` sorted by ``rslot_s (S, M)`` within each slot; rows
    with slot >= n_local are padding. The drop *budget* per expert =
    capacity_factor × cap_rows / n_local (rounded to 8); rows beyond it
    are dropped (drop-newest) and counted. ``cap_rows`` defaults to M —
    chunked callers pass the full receive size so every slab shares the
    unchunked budget — and ``rank_offset`` ((S, n_local), rows each expert
    already received in earlier slabs) makes the drop decision use global
    in-expert ranks. The bucket (and the matmul) is sized min(budget, M):
    rows scatter at their slab-local rank. ``weights`` are the slots'
    ``(S * n_local, ...)`` up, gate, down. Returns ``(y (S, M, d)`` in the
    input order, overflow count).
    """
    s, m_rows, d = rx_s.shape
    dev = rx_s.device
    base = m_rows if cap_rows is None else cap_rows
    budget = int(base / max(n_local, 1) * args.capacity_factor) + 1
    budget = min(max(8, -(-budget // 8) * 8), base)
    c_e = min(budget, m_rows)
    idx = torch.arange(m_rows, device=dev)
    start = torch.searchsorted(rslot_s, rslot_s, side="left")
    local_rank = idx - start
    valid = rslot_s < n_local
    rank = local_rank
    if rank_offset is not None:
        rank = rank + torch.where(
            valid, rank_offset.gather(1, rslot_s.clamp(0, n_local - 1)), 0)
    ok = valid & (rank < budget)
    pos = torch.where(ok, rslot_s * c_e + local_rank, n_local * c_e)
    rows = torch.arange(s, device=dev)[:, None]
    bucket = torch.zeros((s, n_local * c_e + 1, d), dtype=rx_s.dtype, device=dev)
    bucket[rows, pos] = torch.where(ok[..., None], rx_s, 0)
    bucket = bucket[:, :-1].reshape(s * n_local, c_e, d)
    up, gate, down = weights
    h = torch.bmm(bucket, up.to(rx_s.dtype))
    if args.gated:
        h = L.ACTIVATIONS[args.act](torch.bmm(bucket, gate.to(rx_s.dtype))) * h
    else:
        h = L.ACTIVATIONS[args.act](h)
    yb = torch.bmm(h, down.to(rx_s.dtype)).reshape(s, n_local * c_e, d)
    y = torch.where(ok[..., None], yb[rows, pos.clamp(max=n_local * c_e - 1)], 0)
    overflow = valid.sum() - ok.sum()
    return y, overflow


def _moe_shard_body(module: MoE, x, placement, *, capacity: int, n_local: int,
                    is_ep: bool):
    """The broadcast body (decode steps, ``strategy="broadcast"``, the TP
    regime): every slot sees every token ``x (N, d)``, dispatches the
    assignments of its own experts into a static-capacity bucket sorted by
    local expert row, and runs them; the outputs sum over the slots."""
    args, s = module.args, module.ep_slots
    n, d = x.shape
    k, e = args.top_k, args.num_experts
    dev = x.device
    logits, probs, top_p, top_e = _route(args, x[None], module.router)
    flat_e = top_e.reshape(-1)                     # (N*k,)
    flat_w = top_p.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_w))
    aux = _aux_loss(args, counts, probs[0].mean(0), logits)

    shard_of, slot_of = placement[0].long(), placement[1].long()
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k)
    me = torch.arange(s, device=dev)[:, None]
    if is_ep:
        mine = shard_of[flat_e][None] == me        # (S, N*k)
    else:
        mine = torch.ones((s, n * k), dtype=torch.bool, device=dev)
    sort_key = torch.where(mine, slot_of[flat_e][None], n_local)
    order = torch.argsort(sort_key, dim=1, stable=True)   # mine first, by row
    sel = order[:, :capacity]                     # static-capacity bucket
    bucket_tok = flat_tok[sel]
    bucket_w = torch.where(mine.gather(1, sel), flat_w[sel], 0.0)
    bucket_slot = sort_key.gather(1, sel)         # n_local = invalid

    # Group sizes per local expert, truncated by capacity (drop-newest).
    slot_counts = torch.zeros((s, n_local + 1), dtype=torch.int64, device=dev).scatter_add_(
        1, sort_key, torch.ones_like(sort_key))[:, :-1]
    cum = torch.cumsum(slot_counts, dim=1)
    prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    group_sizes = cum.clamp(max=capacity) - prev.clamp(max=capacity)
    overflow = mine.sum() - group_sizes.sum()

    gathered = x[bucket_tok] * (bucket_slot < n_local)[..., None].to(x.dtype)
    y, run_overflow = _expert_bucket_run(gathered, bucket_slot, n_local,
                                         _slot_weights(module, is_ep), args)
    # Each bucket row is one assignment (token, k) of its slot: write it at
    # that index, then sum over the slots (the psum) and the token's k
    # assignments in a fixed order, so the bits depend neither on the
    # placement nor on the order of atomic adds.
    out = torch.zeros((s, n * k, d), dtype=y.dtype, device=dev)
    out[me, sel] = y * bucket_w[..., None].to(y.dtype)
    out = out.sum(dim=0).view(n, k, d).sum(dim=1)
    return out, {"counts": counts, "aux_loss": aux, "overflow": overflow + run_overflow}


def _moe_a2a_shard_body(module: MoE, x, placement, *, send_cap: int, n_local: int,
                        chunk_slabs: Tuple[Tuple[int, int], ...]):
    """The paper's shuffle, per MoE layer: tokens split over the slots
    along the sequence, a counting sort of (token, k) assignments into
    per-destination buckets ("bucket file per operation cluster", §4.4),
    the all-to-all (the "copy", a transpose of the stacked buckets), per
    expert buckets on the receiver (the "run") and the reverse exchange
    for the combine. ``chunk_slabs`` (``moe_dispatch.plan_capacity_slabs``)
    cut the capacity axis into pipeline chunks, walked in the reference's
    double-buffered order with a carry of global in-expert ranks."""
    args, m = module.args, module.ep_slots
    b, t, d = x.shape
    tl = t // m
    n, k, e = b * tl, args.top_k, args.num_experts
    dev = x.device
    xs = x.reshape(b, m, tl, d).transpose(0, 1).reshape(m, n, d)   # slot j: x[:, j*tl:]
    logits, probs, top_p, top_e = _route(args, xs, module.router)

    # §4.1: each slot's local histogram, summed over the slots.
    flat_e = top_e.reshape(m, -1)                   # (S, N*k)
    flat_w = top_p.reshape(m, -1)
    local_counts = torch.zeros((m, e), dtype=torch.float32, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_w))
    counts = local_counts.sum(dim=0)
    aux = _aux_loss(args, counts, probs.mean(dim=1).sum(dim=0) / m, logits)

    shard_of, slot_of = placement[0].long(), placement[1].long()
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k)
    dest = shard_of[flat_e]                          # destination slot
    order = torch.argsort(dest * (n_local + 1) + slot_of[flat_e], dim=1, stable=True)
    dest_s = dest.gather(1, order)
    start = torch.searchsorted(dest_s, dest_s, side="left")
    pos = torch.arange(n * k, device=dev) - start
    ok = pos < send_cap
    overflow = (~ok).sum()
    flat_slot = torch.where(ok, dest_s * send_cap + pos, m * send_cap)
    rows = torch.arange(m, device=dev)[:, None]
    tok_o = flat_tok[order]

    def bucketize(vals, fill):
        out = torch.full((m, m * send_cap + 1) + vals.shape[2:], fill, dtype=vals.dtype,
                         device=dev)
        out[rows, flat_slot] = vals
        return out[:, :-1].reshape((m, m, send_cap) + vals.shape[2:])

    send_x = bucketize(xs[rows, tok_o], 0)                            # (S, m, C, d)
    send_slot = bucketize(torch.where(ok, slot_of[flat_e].gather(1, order), n_local),
                          n_local)
    send_w = bucketize(torch.where(ok, flat_w.gather(1, order), 0.0), 0.0)
    # The assignment (token * k + its rank among the token's k) each row
    # carries; n * k for the padding.
    assign = bucketize(torch.where(ok, order, n * k), n * k)
    weights = _slot_weights(module, True)

    def copy_slab(s0: int, z: int):
        """The "copy" of one capacity slab: (src, dst, z) → (dst, src, z)."""
        rx = send_x[:, :, s0:s0 + z].transpose(0, 1).reshape(m, m * z, d)
        rs = send_slot[:, :, s0:s0 + z].transpose(0, 1).reshape(m, m * z)
        return rx, rs

    def run_slab(rx, rslot, carry):
        """The "sort" (by local expert row) + "run" of one received slab."""
        rorder = torch.argsort(rslot, dim=1, stable=True)
        y_sorted, ovf = _expert_bucket_run(
            rx[rows, rorder], rslot.gather(1, rorder), n_local, weights, args,
            cap_rows=m * send_cap, rank_offset=carry)
        slab_counts = torch.zeros((m, n_local + 1), dtype=torch.int64, device=dev).scatter_add_(
            1, rslot.clamp(0, n_local), (rslot < n_local).long())[:, :-1]
        y = torch.empty_like(y_sorted)
        y[rows, rorder] = y_sorted
        return y, ovf, carry + slab_counts

    # One row an assignment of each slot's tokens (and one for the padding):
    # every returned expert output lands at its own row, and a token's k
    # outputs are summed in rank order at the end, so the bits depend
    # neither on the placement nor on the order of atomic adds.
    out = torch.zeros((m, n * k + 1, d), dtype=x.dtype, device=dev)
    run_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    carry = torch.zeros((m, n_local), dtype=torch.int64, device=dev)
    recv = copy_slab(*chunk_slabs[0])
    for ci, (s0, z) in enumerate(chunk_slabs):
        cur = recv
        if ci + 1 < len(chunk_slabs):
            recv = copy_slab(*chunk_slabs[ci + 1])
        y, ovf, carry = run_slab(*cur, carry)
        run_overflow = run_overflow + ovf
        y_back = y.reshape(m, m, z, d).transpose(0, 1).reshape(m, m * z, d)
        yw = y_back * send_w[:, :, s0:s0 + z].reshape(m, -1, 1).to(y.dtype)
        out[rows, assign[:, :, s0:s0 + z].reshape(m, -1)] = yw.to(out.dtype)
    out = out[:, :-1].view(m, n, k, d).sum(dim=2)
    out = out.reshape(m, b, tl, d).transpose(0, 1)
    return (out.reshape(b, t, d),
            {"counts": counts, "aux_loss": aux, "overflow": overflow + run_overflow})


def moe(module: MoE, x: torch.Tensor, *, placement=None, capacity: Optional[int] = None):
    """``x (B, T, d)`` → ``(y, stats)``, stats ``{"counts" (E,), "aux_loss",
    "overflow"}`` as device tensors.

    ``placement`` is the ``(2, E)`` [slot; row] table from the OS4M
    balancer (default: the hash baseline of eq. 3-1). ``capacity`` is the
    static per-slot bucket size (default: :func:`capacity_for` of the
    scheduled max-load). The path is the reference's: the a2a body for
    EP prefills whose length the slots divide, else the broadcast body.
    """
    from repro_torch.kernels.moe_dispatch.ops import plan_capacity_slabs

    args, m = module.args, module.ep_slots
    is_ep = args.is_ep(m)
    n_local = args.experts_per_shard(m) if is_ep else args.num_experts
    b, t, d = x.shape
    if placement is None:
        placement = default_placement(args, m, device=x.device)
    placement = placement.to(x.device)
    if is_ep and args.strategy == "a2a" and t % m == 0 and t > 1:
        n_src = b * (t // m)
        send_cap = capacity if capacity is not None else capacity_for(args, n_src, m)
        send_cap = min(send_cap, n_src * args.top_k)
        y, stats = _moe_a2a_shard_body(
            module, x, placement, send_cap=send_cap, n_local=n_local,
            chunk_slabs=plan_capacity_slabs(send_cap, args.pipeline_chunks))
    else:
        cap = capacity if capacity is not None else capacity_for(args, b * t, m)
        cap = min(cap, b * t * args.top_k)
        yf, stats = _moe_shard_body(module, x.reshape(b * t, d), placement,
                                    capacity=cap, n_local=n_local, is_ep=is_ep)
        y = yf.reshape(b, t, d)
    y = y.to(x.dtype)
    if module.shared is not None:
        sh = module.shared
        h = L.ACTIVATIONS[args.act](sh["gate"](x)) * sh["up"](x)
        y = y + sh["down"](h)
    return y, stats
