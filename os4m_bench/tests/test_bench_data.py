"""The benchmark's traffic generator, plain reference and work counts, on the CPU."""

import numpy as np
import pytest
import torch

from os4m_bench import reference, roofline, traffic

TINY = {"slots": 4, "pairs_per_slot": 1024, "values_per_pair": 3, "num_keys": 5000,
        "zipf_s": 1.0, "invalid_share": 0.02, "value_range": [-1.0, 1.0]}
MIX = {"pool": 3, "shape_seed": 0}


def test_same_seed_same_batches_and_every_seed_same_sizes():
    seed = 2 ** 31 + 12345
    a = traffic.draw_pool(TINY, MIX, seed, "cpu")
    b = traffic.draw_pool(TINY, MIX, seed, "cpu")
    c = traffic.draw_pool(TINY, MIX, seed + 1, "cpu")
    assert len(a) == len(b) == len(c) == MIX["pool"]
    for x, y, z in zip(a, b, c):
        for tx, ty, tz in zip(x.inputs(), y.inputs(), z.inputs()):
            assert torch.equal(tx, ty)
            assert tx.shape == tz.shape and tx.dtype == tz.dtype
        assert x.valid_pairs == y.valid_pairs == int(x.valid.sum())
    assert not torch.equal(a[0].keys, c[0].keys)
    assert not torch.equal(a[0].values, c[0].values)
    assert not torch.equal(a[0].keys, a[1].keys)     # the pool's batches differ


def test_every_seed_has_the_same_pairs_in_another_order():
    a = traffic.draw_pool(TINY, MIX, 1, "cpu")
    c = traffic.draw_pool(TINY, MIX, 2 ** 31 + 5, "cpu")
    for x, z in zip(a, c):
        assert x.valid_pairs == z.valid_pairs
        for slot in range(TINY["slots"]):
            for want, got in ((x.keys[slot][x.valid[slot]], z.keys[slot][z.valid[slot]]),
                              (x.keys[slot], z.keys[slot])):
                assert torch.equal(torch.sort(want).values, torch.sort(got).values)
    other = traffic.draw_pool(TINY, dict(MIX, shape_seed=1), 1, "cpu")
    assert not torch.equal(torch.sort(a[0].keys).values, torch.sort(other[0].keys).values)


def test_the_fresh_batch_draws_its_keys_from_the_seed():
    seed = 2 ** 31 + 99
    a, b = traffic.draw_fresh(TINY, seed, "cpu"), traffic.draw_fresh(TINY, seed, "cpu")
    c = traffic.draw_fresh(TINY, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.inputs(), b.inputs()))
    pool = traffic.draw_pool(TINY, MIX, seed, "cpu")
    for other in pool + [c]:
        assert other.keys.shape == a.keys.shape
        assert not torch.equal(torch.sort(a.keys.flatten()).values,
                               torch.sort(other.keys.flatten()).values)


def test_batch_contents_follow_the_configuration():
    batch = traffic.draw_pool(TINY, MIX, 7, "cpu")[0]
    m, k, v = TINY["slots"], TINY["pairs_per_slot"], TINY["values_per_pair"]
    assert batch.keys.shape == (m, k) and batch.keys.dtype == torch.int32
    assert batch.values.shape == (m, k, v) and batch.values.dtype == torch.float32
    assert batch.valid.shape == (m, k) and batch.valid.dtype == torch.bool
    assert -1.0 <= batch.values.min().item() and batch.values.max().item() < 1.0
    assert abs(batch.values.mean().item()) < 0.05
    # No lower-precision wire carries the values unchanged.
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        kept = (batch.values.to(dtype).to(torch.float32) == batch.values).float().mean()
        assert kept.item() < 0.01, dtype
    assert 0.0 < 1.0 - batch.valid.float().mean().item() < 0.06
    hashes = traffic.key_hashes(TINY["num_keys"], "cpu")
    assert bool(torch.isin(batch.keys, hashes).all())


def test_key_hash_is_the_uint32_multiplicative_hash():
    want = (np.arange(70000, dtype=np.uint32) * np.uint32(2654435761)).view(np.int32)
    assert np.array_equal(traffic.key_hashes(70000, "cpu").numpy(), want)


def test_zipf_cdf_ends_at_one_and_favours_low_ranks():
    cdf = traffic.zipf_cdf(1000, 0.97, "cpu")
    assert cdf[-1].item() == pytest.approx(1.0, abs=1e-12)
    p = torch.diff(cdf, prepend=torch.zeros(1, dtype=torch.float64))
    assert bool((p[1:] < p[:-1]).all())


def numpy_reference(keys, values, valid, n):
    """An independent count: numpy's int32 abs and floor-mod, bincount."""
    cid = np.mod(np.abs(keys[valid]), n)
    vals = values[valid].astype(np.float64)
    sums, squares = (np.stack([np.bincount(cid, weights=w[:, c], minlength=n)
                               for c in range(vals.shape[1])], axis=1)
                     for w in (vals, vals * vals))
    return sums, squares, np.bincount(cid, minlength=n).astype(np.float64)


@pytest.mark.parametrize("n", [44, 352])
def test_reference_matches_an_independent_numpy_count(n):
    g = torch.Generator().manual_seed(n)
    m, k, v = 4, 1024, 11
    keys = torch.randint(-2 ** 31, 2 ** 31, (m, k), generator=g, dtype=torch.int64)
    keys = keys.to(torch.int32)
    keys[0, :3] = torch.tensor([-2 ** 31, 2 ** 31 - 1, 0], dtype=torch.int32)
    values = torch.rand((m, k, v), generator=g) * 2 - 1
    valid = torch.rand((m, k), generator=g) >= 0.02
    with np.errstate(over="ignore"):
        want = numpy_reference(keys.numpy(), values.numpy(), valid.numpy(), n)
    got = reference.reduce_sum(keys, values, valid, n, block_slots=3)
    for g_, w_ in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g_, w_, rtol=1e-12, atol=1e-12)
    assert np.array_equal(got[2], want[2])


def test_cluster_id_of_int32_min_wraps_as_int32_abs_does():
    keys = torch.tensor([-2 ** 31, -7, 7], dtype=torch.int32)
    assert reference.cluster_ids(keys, 352).tolist() == [(-2 ** 31) % 352, 7, 7]


def test_work_counts_match_the_kernel_table_bounds():
    # PERF.md's kernel table: kernel 1 at (32, 2^21) into 352 bins 0.100 ms,
    # kernel 2 over a main run's 65.8 M valid pairs of V = 11 0.943 ms.
    assert roofline.stats_work(32, 2 ** 21, 352).bound_s() * 1e3 == pytest.approx(0.100, abs=1e-3)
    assert roofline.reduce_work(65_800_000, 352, 11).bound_s() * 1e3 == pytest.approx(
        0.943, abs=1e-3)
    whole = roofline.job_work(32, 2 ** 21, 352, 13, 65_800_000)
    assert whole.nbytes == 32 * 2 ** 21 * 57 + 352 * 56
    assert whole.bound_s() == whole.nbytes / roofline.HBM_BYTES_PER_S
