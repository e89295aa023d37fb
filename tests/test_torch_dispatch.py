"""The port's dispatch ranks and bucket scatter against the reference's.

On the CPU ``dispatch_ranks`` runs its plain version (a one-hot cumsum),
held exactly against the reference's Pallas kernel in interpret mode;
``dispatch_to_buckets``, its chunked form and ``plan_capacity_slabs`` are
held against the reference's. The ``gpu`` cases hold the CUDA kernel's
ranks and counts exactly against the plain version on the card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels.moe_dispatch import ops as md_ops
from repro_torch.kernels.moe_dispatch.moe_dispatch import (
    TILE_TOKENS,
    dispatch_ranks_model,
    lookback,
    lookback_rows,
)
from repro_torch.kernels.moe_dispatch.ref import dispatch_ranks_ref
from repro_torch.kernels.span_split import span_split


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dest(seed, t, e, lo=-1, hi=None):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, e + 1 if hi is None else hi, t).astype(np.int32)


# The reference's sweep (tests/test_kernels.py:80-81) and more: out-of-range
# ids on both sides, one destination, several token blocks.
CASES = [(100, 8, 16), (2048, 64, 64), (513, 16, 8), (5, 3, 2), (1, 1, 1),
         (3000, 1, 2000), (1500, 130, 4)]


@pytest.mark.parametrize("t,e,cap", CASES)
def test_ranks_equal_pallas(t, e, cap):
    import jax.numpy as jnp

    from repro.kernels.moe_dispatch.moe_dispatch import dispatch_ranks_pallas

    dest = _dest(t + e, t, e, lo=-2, hi=e + 3)
    r_ref, c_ref = dispatch_ranks_pallas(jnp.asarray(dest), e, interpret=True)
    rank, counts = md_ops.dispatch_ranks(torch.from_numpy(dest), e)
    assert rank.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(rank.numpy(), np.asarray(r_ref))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("t,e,cap", CASES)
def test_buckets_equal_reference(t, e, cap):
    import jax.numpy as jnp

    from repro.kernels.moe_dispatch.ops import dispatch_to_buckets as ref_buckets

    dest = _dest(7 * t + e, t, e)
    vals = np.random.default_rng(t).standard_normal((t, 4)).astype(np.float32)
    b_ref, c_ref, o_ref = ref_buckets(jnp.asarray(vals), jnp.asarray(dest), e, cap)
    buckets, counts, overflow = md_ops.dispatch_to_buckets(
        torch.from_numpy(vals), torch.from_numpy(dest), e, cap)
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(b_ref))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    assert int(overflow) == int(o_ref)


@pytest.mark.parametrize("capacity,num_chunks", [(1, 4), (7, 1), (10, 3), (64, 4), (5, 8)])
def test_capacity_slabs_equal_reference(capacity, num_chunks):
    from repro.kernels.moe_dispatch.ops import plan_capacity_slabs as ref_slabs

    assert md_ops.plan_capacity_slabs(capacity, num_chunks) == ref_slabs(capacity, num_chunks)


@pytest.mark.parametrize("t,e,cap,chunks", [(300, 8, 24, 3), (64, 4, 20, 4)])
def test_chunked_buckets_equal_reference(t, e, cap, chunks):
    import jax.numpy as jnp

    from repro.kernels.moe_dispatch.ops import dispatch_to_buckets_chunked as ref_chunked

    dest = _dest(t, t, e)
    vals = np.random.default_rng(e).standard_normal((t, 3)).astype(np.float32)
    s_ref, c_ref, o_ref = ref_chunked(jnp.asarray(vals), jnp.asarray(dest), e, cap, chunks)
    slabs, counts, overflow = md_ops.dispatch_to_buckets_chunked(
        torch.from_numpy(vals), torch.from_numpy(dest), e, cap, chunks)
    assert len(slabs) == len(s_ref)
    for got, want in zip(slabs, s_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
    assert int(overflow) == int(o_ref)


@pytest.mark.parametrize("seed", range(6))
def test_ranks_are_stable(seed):
    """Within each destination the ranks are 0..count-1 in token order, so
    drop-newest keeps exactly the earliest ``capacity`` tokens."""
    rng = np.random.default_rng(seed)
    t, e = int(rng.integers(1, 400)), int(rng.integers(1, 12))
    dest = rng.integers(-1, e + 1, t).astype(np.int32)
    rank, counts = (x.numpy() for x in md_ops.dispatch_ranks(torch.from_numpy(dest), e))
    for g in range(e):
        np.testing.assert_array_equal(rank[dest == g], np.arange(np.sum(dest == g)))
    assert np.all(rank[(dest < 0) | (dest >= e)] == -1)
    np.testing.assert_array_equal(counts, np.bincount(dest[(dest >= 0) & (dest < e)],
                                                      minlength=e))


@given(st.integers(1, 5000), st.integers(1, 40), st.sampled_from([256, 512, 1024, TILE_TOKENS]),
       st.floats(0.0, 0.6), st.floats(0.0, 1.0), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=20, deadline=None)
def test_model_of_the_single_pass_equals_pallas(t, e, tile, pad, ready, seed):
    """The kernel's decomposition in numpy (per-warp match ranks, warp
    offsets, tile aggregates, a look-back over a snapshot in which each
    predecessor had published its prefix with probability ``ready``)
    against the reference's Pallas kernel in interpret mode, exactly."""
    import jax.numpy as jnp

    from repro.kernels.moe_dispatch.moe_dispatch import dispatch_ranks_pallas

    rng = np.random.default_rng(seed)
    dest = rng.integers(-2, e + 2, t).astype(np.int32)
    dest[rng.random(t) < pad] = -1
    snapshot = rng.random((-(-t // tile), e)) < ready
    rank, counts = dispatch_ranks_model(dest, e, tile, prefix_ready=snapshot)
    r_ref, c_ref = dispatch_ranks_pallas(jnp.asarray(dest), e, interpret=True)
    np.testing.assert_array_equal(rank, np.asarray(r_ref))
    np.testing.assert_array_equal(counts, np.asarray(c_ref))


@given(st.integers(1, 300), st.integers(1, 50), st.sampled_from([1, 2, 5, 64, 256]),
       st.floats(0.0, 1.0), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=150, deadline=None)
def test_lookback_gives_the_exclusive_prefix(tiles, e, window, ready, seed):
    """Whatever each predecessor had published (aggregate or inclusive
    prefix), the look-back's sum is the exclusive prefix of the tiles'
    aggregates, after at most ceil(tile / window) windows."""
    rng = np.random.default_rng(seed)
    aggregates = rng.integers(0, 1000, (tiles, e))
    snapshot = rng.random((tiles, e)) < ready
    for tile in range(1, tiles):
        found, windows = lookback(tile, snapshot, aggregates, window)
        np.testing.assert_array_equal(found, aggregates[:tile].sum(axis=0))
        assert 1 <= windows <= -(-tile // window)


@given(st.integers(0, 2 ** 40), st.integers(0, TILE_TOKENS))
@settings(max_examples=300, deadline=None)
def test_span_split_reads_every_word_once(first_word, words):
    """Kernel 8 reads a tile of tokens as a head, 16-byte loads and a
    tail: every word once, in order, the loads aligned in memory and in the
    stage, and the span at most 3 words into its stage."""
    shift, head, units, tail = span_split(first_word, words)
    covered = (list(range(head))
               + [head + 4 * u + j for u in range(units) for j in range(4)]
               + [head + 4 * units + j for j in range(tail)])
    assert covered == list(range(words))
    assert 0 <= head <= 3 and 0 <= tail <= 3 and 0 <= shift == first_word % 4 <= 3
    if units:
        assert (first_word + head) % 4 == 0 and (shift + head) % 4 == 0


def test_lookback_rows_fill_a_window_of_loads():
    assert [lookback_rows(e) for e in (1, 64, 160, 1024)] == [8192, 128, 51, 8]


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError, match=r"\(T,\)"):
        md_ops.dispatch_ranks(torch.zeros((2, 2), dtype=torch.int32), 4)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version, exactly.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("t,e", [(1, 1), (5, 3), (255, 7), (256, 64), (257, 64),
                                 (30_000, 1024), (1 << 18, 64), (70_000, 1)])
def test_dispatch_kernel_matches_plain_on_gpu(t, e):
    dev = _cuda()
    dest = torch.from_numpy(_dest(t, t, e, lo=-2, hi=e + 2)).to(dev)
    before = md_ops.launches
    rank, counts = md_ops.dispatch_ranks(dest, e)
    want_rank, want_counts = dispatch_ranks_ref(dest.cpu(), e)
    torch.cuda.synchronize()
    assert md_ops.launches == before + 1
    assert torch.equal(rank.cpu(), want_rank) and torch.equal(counts.cpu(), want_counts)


@pytest.mark.gpu
def test_dispatch_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    dest = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="destinations"):
        md_ops.dispatch_ranks(dest, 1025)
    with pytest.raises(TypeError, match="int32"):
        md_ops.dispatch_ranks(dest.long(), 4)


def _np_ranks(dest: np.ndarray, e: int):
    """Stable ranks and counts by a stable argsort (an oracle for sizes
    whose one-hot plain version would not fit)."""
    d = dest.astype(np.int64)
    valid = (d >= 0) & (d < e)
    key = np.where(valid, d, e)
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    rank = np.empty(len(d), np.int64)
    rank[order] = np.arange(len(d)) - np.searchsorted(sorted_key, sorted_key, side="left")
    rank[~valid] = -1
    return rank.astype(np.int32), np.bincount(d[valid], minlength=e).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("e", [1, 64, 160, 1024])
@pytest.mark.parametrize("t", [1, 4095, 4097, (1 << 20) + 3])
def test_single_pass_exact_at_tile_edges(t, e):
    """One tile less or more than a tile's 4,096 tokens, and 2^20 + 3."""
    dev = _cuda()
    dest = _dest(t * 7 + e, t, e, lo=-2, hi=e + 2)
    rank, counts = md_ops.dispatch_ranks(torch.from_numpy(dest).to(dev), e)
    want_rank, want_counts = _np_ranks(dest, e)
    np.testing.assert_array_equal(rank.cpu().numpy(), want_rank)
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_destination", "all_invalid", "unaligned"])
@pytest.mark.parametrize("e", [1, 64, 1024])
def test_single_pass_exact_on_edge_inputs(case, e):
    """All tokens to one destination (ranks 0..T-1), none valid (all -1,
    counts 0), and a view one to three tokens into its buffer (the load's
    scalar head)."""
    dev = _cuda()
    t = 3 * 4096 + 11
    for off in ((1, 2, 3) if case == "unaligned" else (0,)):
        dest = _dest(t + off + e, t + off, e, lo=-2, hi=e + 2)
        if case == "one_destination":
            dest[:] = e - 1
        elif case == "all_invalid":
            dest[:] = np.where(np.arange(t + off) % 2, -1, e)
        view = torch.from_numpy(dest).to(dev)[off:]
        rank, counts = md_ops.dispatch_ranks(view, e)
        want_rank, want_counts = _np_ranks(dest[off:], e)
        np.testing.assert_array_equal(rank.cpu().numpy(), want_rank)
        np.testing.assert_array_equal(counts.cpu().numpy(), want_counts)


@pytest.mark.gpu
def test_single_pass_on_two_streams_equals_serial():
    """Two calls in flight at once on two streams (each stream has its own
    scratch) give what the same calls give one after the other."""
    dev = _cuda()
    a = torch.from_numpy(_dest(1, 1 << 20, 64)).to(dev)
    b = torch.from_numpy(_dest(2, 1 << 20, 160)).to(dev)
    want_a, want_b = md_ops.dispatch_ranks(a, 64), md_ops.dispatch_ranks(b, 160)
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    for _ in range(20):
        with torch.cuda.stream(s1):
            got_a = md_ops.dispatch_ranks(a, 64)
        with torch.cuda.stream(s2):
            got_b = md_ops.dispatch_ranks(b, 160)
        torch.cuda.synchronize()
        for got, want in ((got_a, want_a), (got_b, want_b)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_single_pass_stays_exact_over_repeated_calls():
    """1,000 calls on one stream reuse its scratch, one epoch each."""
    dev = _cuda()
    dest = torch.from_numpy(_dest(3, 300_000, 64)).to(dev)
    want_rank, want_counts = _np_ranks(dest.cpu().numpy(), 64)
    outs = [md_ops.dispatch_ranks(dest, 64) for _ in range(1000)]
    torch.cuda.synchronize()
    for rank, counts in outs:
        np.testing.assert_array_equal(rank.cpu().numpy(), want_rank)
        np.testing.assert_array_equal(counts.cpu().numpy(), want_counts)
