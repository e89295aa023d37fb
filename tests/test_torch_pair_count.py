"""The histogram and sketch kernels' shared host logic, and phase A's mask.

CPU tests: the wrapper's choice of instance by the weights' dtype; the
row split's Python mirror (``kernels/pair_split.py``), which the kernels
follow, covers every pair once with a body aligned for the int32 ids and
the uint8 mask or float32 weights alike (by cases and by hypothesis); and
phase A, which hands the validity mask to the statistics as a bool
weight, gives the reference's states bit for bit (exact and sketch, with
and without a streaming prefix).

``gpu`` tests hold both kernel instances against their plain versions on
the card: rows of k % 4 = 1, 2, 3, one slot, a bin that takes every pair,
ids out of range, pointers whose phases disagree, the cluster path (2^17
bins) and the windows past a cluster, multipliers >= 2^31, and one launch
a call. The reference is imported inside the CPU tests only.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import mapreduce as tmr
from repro_torch.core import stats_provider as tsp
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.pair_split import PAIRS_A_LOAD, instance, row_split, split_phase
from repro_torch.kernels.sketch_hist import ops as sk_ops
from repro_torch.kernels.sketch_hist.ref import sketch_hist_ref


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The instance and the row split.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,want", [(torch.bool, "mask"), (torch.float32, "float")])
def test_instance_follows_the_weights_dtype(dtype, want):
    assert instance(dtype) == want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16, torch.uint8,
                                   torch.int32])
def test_instance_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        instance(dtype)
    ids = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        hist_ops.histogram(ids, torch.ones((1, 4), dtype=dtype), 4)
    with pytest.raises(TypeError):
        sk_ops.sketch_hist(ids, torch.ones((1, 4), dtype=dtype), [3], 8)


def _check_split(ids_ptr, w_ptr, itemsize, m, k):
    """Every pair of every row read once; the body starts a 16-byte load of
    ids and a 4-pair load of weights; no body only where none could."""
    phase = split_phase(ids_ptr, w_ptr, itemsize)
    aligned = [g for g in range(PAIRS_A_LOAD)
               if (ids_ptr + 4 * g) % 16 == 0 and (w_ptr + itemsize * g) % (4 * itemsize) == 0]
    assert (phase < 0) == (not aligned)
    for row in range(m):
        head, units = row_split(phase, k, row)
        tail = k - head - PAIRS_A_LOAD * units
        assert 0 <= head < PAIRS_A_LOAD and units >= 0 and 0 <= tail
        if phase < 0:
            assert (head, units) == (0, 0)
            continue
        assert tail < PAIRS_A_LOAD
        if units:
            g = row * k + head
            assert (ids_ptr + 4 * g) % 16 == 0
            assert (w_ptr + itemsize * g) % (4 * itemsize) == 0
        # The head is the shortest: no earlier pair of the row starts both loads.
        for t in range(head):
            g = row * k + t
            assert (ids_ptr + 4 * g) % 16 or (w_ptr + itemsize * g) % (4 * itemsize)


@pytest.mark.parametrize("itemsize", [1, 4])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 13])
def test_row_split_cases(itemsize, k):
    for ids_off in range(0, 16, 4):
        for w_off in range(0, 4 * itemsize * 4, itemsize):
            _check_split(1024 + ids_off, 4096 + w_off, itemsize, 6, k)


@given(st.integers(0, 2 ** 20), st.integers(0, 2 ** 20), st.sampled_from([1, 4]),
       st.integers(1, 9), st.integers(1, 4099))
@settings(max_examples=200, deadline=None)
def test_row_split_hypothesis(ids_words, w_items, itemsize, m, k):
    _check_split(4 * ids_words, itemsize * w_items, itemsize, m, k)


def test_split_phase_of_misaligned_pointers():
    assert split_phase(16, 32, 1) == 0
    assert split_phase(20, 33, 1) == 1
    assert split_phase(20, 32, 1) == -1
    assert split_phase(20, 36, 4) == 1
    assert split_phase(22, 36, 4) == -1   # an int32 pointer off its own alignment
    assert split_phase(20, 38, 4) == -1


# ---------------------------------------------------------------------------
# Phase A passes the mask.
# ---------------------------------------------------------------------------


def _batch(m, k, n, seed):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, size=(m, k)) % (4 * n)).astype(np.int32)
    keys[:, ::5] *= -1
    values = rng.integers(-3, 4, size=(m, k, 2)).astype(np.float32)
    valid = rng.random((m, k)) > 0.1
    return keys, values, valid


@pytest.mark.parametrize("kind", ["exact", "sketch"])
@pytest.mark.parametrize("prefix", [None, 0.25, 0.6])
def test_phase_a_mask_matches_reference(kind, prefix):
    import jax
    import jax.numpy as jnp

    from repro.core import mapreduce as rmr
    from repro.core import stats_provider as rsp

    m, k, n = 4, 1001, 40
    keys, values, valid = _batch(m, k, n, seed=7 + (prefix is None))
    if kind == "exact":
        port, ref = tsp.ExactStats(n), rsp.ExactStats(n)
    else:
        port = tsp.SketchStats(n, width=64, depth=4, seed=3)
        ref = rsp.SketchStats(n, width=64, depth=4, seed=3, use_kernel=True)
    calls = []

    def collect(cluster_ids, weights):
        calls.append(weights.dtype)
        return port.collect(cluster_ids, weights)

    (kh, _, vd), state = tmr._phase_a(
        (torch.from_numpy(keys), torch.from_numpy(values), torch.from_numpy(valid)),
        lambda b: b, n, collect, prefix)
    assert calls == [torch.bool] * (1 if prefix is None else 2)
    assert vd.dtype == torch.bool and torch.equal(vd, torch.from_numpy(valid))

    def shard(key, val, ok):
        return rmr._phase_a_shard((key, val, ok), lambda b: b, n, ref.collect, prefix)[1]

    want = np.asarray(jax.vmap(shard)(jnp.asarray(keys), jnp.asarray(values),
                                      jnp.asarray(valid)))
    got = state.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # The float32 weights phase A passed before give the same bits.
    ids = tmr._cluster_ids(torch.from_numpy(keys), n)
    w = torch.from_numpy(valid).to(torch.float32)
    before = port.collect(ids, w)
    if prefix is not None:
        cut = int(np.ceil(prefix * k))
        before = torch.cat([before, port.collect(ids, w * (torch.arange(k) < cut).float())], 1)
    assert torch.equal(state, before)


def test_local_key_histogram_without_weights_counts_every_pair():
    from repro_torch.core.stats import local_key_histogram

    ids = torch.as_tensor(np.random.default_rng(0).integers(-1, 9, (3, 50)), dtype=torch.int32)
    want = histogram_ref(ids, torch.ones(ids.shape), 8)
    assert torch.equal(local_key_histogram(ids, 8), want)
    assert torch.equal(local_key_histogram(ids, 8, weights=torch.ones(ids.shape, dtype=torch.bool)),
                       want)
    assert torch.equal(local_key_histogram(ids, 8, weights=torch.ones(ids.shape, dtype=torch.int64)),
                       want)


# ---------------------------------------------------------------------------
# The kernels on the card.
# ---------------------------------------------------------------------------

HIGH = np.array([0x9E3779B1, 0xFFFFFFFF, 0x80000001, 0xC2B2AE35], np.uint32)


def _pairs(rng, m, k, lo, hi, dev):
    ids = torch.as_tensor(rng.integers(lo, hi, (m, k)).astype(np.int32), device=dev)
    mask = torch.as_tensor(rng.random((m, k)) < 0.8, device=dev)
    real = torch.as_tensor(rng.random((m, k)).astype(np.float32), device=dev)
    return ids, mask, real


def _hist_both(ids, mask, real, n):
    """Both instances against the plain version: the mask bitwise, 0/1 float
    weights bitwise (integer sums), real weights allclose."""
    before = hist_ops.launches
    got = hist_ops.histogram(ids, mask, n)
    torch.cuda.synchronize()
    assert hist_ops.launches == before + 1
    assert torch.equal(got, histogram_ref(ids, mask, n))
    assert torch.equal(hist_ops.histogram(ids, mask.float(), n), histogram_ref(ids, mask, n))
    torch.testing.assert_close(hist_ops.histogram(ids, real, n), histogram_ref(ids, real, n),
                               rtol=1e-5, atol=1e-4)


def _sketch_both(ids, mask, real, mult, width):
    before = sk_ops.launches
    got = sk_ops.sketch_hist(ids, mask, mult, width)
    torch.cuda.synchronize()
    assert sk_ops.launches == before + 1
    assert torch.equal(got, sketch_hist_ref(ids, mask, mult, width))
    assert torch.equal(sk_ops.sketch_hist(ids, mask.float(), mult, width),
                       sketch_hist_ref(ids, mask, mult, width))
    torch.testing.assert_close(sk_ops.sketch_hist(ids, real, mult, width),
                               sketch_hist_ref(ids, real, mult, width), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("k", [4097, 4098, 4099, 70_001])
@pytest.mark.parametrize("n", [1, 352, 2 ** 17, 2 ** 19 + 5])
def test_histogram_instances_match_plain(m, k, n):
    """Unaligned rows (k % 4 = 1, 2, 3), one slot, out-of-range ids; 2^17
    bins take the cluster path, 2^19 + 5 its windows."""
    dev = _cuda()
    ids, mask, real = _pairs(np.random.default_rng(m * k + n), m, k, -3, n + 3, dev)
    _hist_both(ids, mask, real, n)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("k", [4097, 4098, 4099, 70_001])
@pytest.mark.parametrize("width,depth", [(1024, 4), (2 ** 16, 2), (2 ** 18, 2)])
def test_sketch_instances_match_plain(m, k, width, depth):
    """Ids over all of int32 hashed by multipliers >= 2^31; 2 x 2^16 cells
    take the cluster path, 2 x 2^18 its windows."""
    dev = _cuda()
    ids, mask, real = _pairs(np.random.default_rng(m * k + width), m, k, -2 ** 31, 2 ** 31, dev)
    _sketch_both(ids, mask, real, HIGH[:depth], width)


@pytest.mark.gpu
@pytest.mark.parametrize("ids_off,w_off", [(0, 0), (1, 0), (0, 1), (1, 1), (3, 2), (2, 3)])
def test_instances_at_pointer_offsets(ids_off, w_off):
    """Views whose ids and weights start off a 16-byte boundary: equal or
    different phases (the latter read every pair alone)."""
    dev = _cuda()
    rng = np.random.default_rng(ids_off * 4 + w_off)
    m, k, n = 3, 10_001, 352
    ids_all, mask_all, real_all = _pairs(rng, 1, m * k + 4, -2, n + 2, dev)
    ids = ids_all[0, ids_off:ids_off + m * k].view(m, k)
    mask = mask_all[0, w_off:w_off + m * k].view(m, k)
    real = real_all[0, w_off:w_off + m * k].view(m, k)
    _hist_both(ids, mask, real, n)
    _sketch_both(ids, mask, real, HIGH, 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["mask", "float"])
def test_one_hot_bin_is_exact(weights):
    """Every pair in one bin at k = 2^20: one address takes every add."""
    dev = _cuda()
    k = 2 ** 20
    ids = torch.full((2, k), 7, dtype=torch.int32, device=dev)
    w = torch.ones((2, k), dtype=torch.bool if weights == "mask" else torch.float32, device=dev)
    got = hist_ops.histogram(ids, w, 352)
    assert torch.equal(got, histogram_ref(ids, w, 352)) and float(got[0, 7]) == k
    sk = sk_ops.sketch_hist(ids, w, HIGH, 1024)
    assert torch.equal(sk, sketch_hist_ref(ids, w, HIGH, 1024))
