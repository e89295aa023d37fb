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

from repro_torch.kernels.moe_dispatch import ops as md_ops
from repro_torch.kernels.moe_dispatch.ref import dispatch_ranks_ref


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
