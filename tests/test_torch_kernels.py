"""The port's kernels against the reference's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version, which is held
against the JAX function (Pallas in interpret mode) on the same numpy
inputs. The ``gpu`` cases hold each CUDA kernel against its plain version
on the card and skip where there is none. The reference is imported inside
the CPU tests only, so the ``gpu`` cases also run where JAX is absent
(``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels.coded_shuffle import ops as cs_ops
from repro_torch.kernels.coded_shuffle.ref import xor_words_ref
from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
from repro_torch.kernels.fused_shuffle_reduce.fused_shuffle_reduce import (
    TILE_ROWS,
    tile_plan,
)
from repro_torch.kernels.fused_shuffle_reduce.ref import fused_gather_segment_reduce_ref
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.segment_reduce import ops as seg_ops
from repro_torch.kernels.segment_reduce.ref import segment_reduce_sorted_ref
from repro_torch.kernels.sketch_hist import ops as sk_ops
from repro_torch.kernels.sketch_hist.ref import sketch_hist_ref


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Histogram.
# ---------------------------------------------------------------------------


def _hist_inputs(rng, m, k, n, weights):
    ids = rng.integers(-2, n + 3, size=(m, k)).astype(np.int32)  # -1, -2, >= n too
    if weights in ("binary", "mask"):
        w = rng.random((m, k)) < 0.8
        if weights == "binary":
            w = w.astype(np.float32)
    else:
        w = rng.random((m, k)).astype(np.float32)
    return ids, w


@pytest.mark.parametrize("k", [1, 7, 1000, 3000])
@pytest.mark.parametrize("n", [1, 24, 1500])
@pytest.mark.parametrize("weights", ["binary", "random", "mask"])
def test_histogram_plain_matches_pallas(k, n, weights):
    """``mask``: bool weights (the kernel's mask instance) against the
    reference given the same mask as float32, bitwise."""
    import jax.numpy as jnp

    from repro.kernels.histogram.histogram import histogram_pallas

    m = 2
    ids, w = _hist_inputs(np.random.default_rng(k * 7 + n), m, k, n, weights)
    got = hist_ops.histogram(torch.from_numpy(ids), torch.from_numpy(w), n).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    for i in range(m):
        want = np.asarray(histogram_pallas(
            jnp.asarray(ids[i]), jnp.asarray(w[i].astype(np.float32)), n, interpret=True))
        if weights != "random":
            np.testing.assert_array_equal(got[i], want)
        else:
            np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 1000, 24), (4, 70_001, 1500),
                                   (2, 50_000, 100_000)])
def test_histogram_kernel_matches_plain(m, k, n):
    dev = _cuda()
    rng = np.random.default_rng(m + k + n)
    ids, w = _hist_inputs(rng, m, k, n, "binary")
    ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
    before = hist_ops.launches
    got = hist_ops.histogram(ids_t, w_t, n)
    torch.cuda.synchronize()
    assert hist_ops.launches == before + 1
    # 0/1 weights: integer sums, exact in any order of the atomics.
    assert torch.equal(got, histogram_ref(ids_t, w_t, n))
    # The same weights as a bool mask: the mask instance, one more launch.
    assert torch.equal(hist_ops.histogram(ids_t, w_t > 0, n), histogram_ref(ids_t, w_t, n))
    assert hist_ops.launches == before + 2
    ids, w = _hist_inputs(rng, m, k, n, "random")
    ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
    torch.testing.assert_close(hist_ops.histogram(ids_t, w_t, n),
                               histogram_ref(ids_t, w_t, n), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Fused gather + segment-sum.
# ---------------------------------------------------------------------------


def _fused_inputs(rng, m, n_rows, num_segments, v, kind, pad_rows):
    """Per slot: a permutation gather, sorted segment ids, a padding tail."""
    if kind == "int":
        values = rng.integers(-3, 4, size=(m, n_rows, v)).astype(np.float32)
    else:
        values = rng.standard_normal((m, n_rows, v)).astype(np.float32)
    idx = np.stack([rng.permutation(n_rows) for _ in range(m)]).astype(np.int32)
    seg = np.sort(rng.integers(0, num_segments, size=(m, n_rows)), axis=1)
    seg[:, n_rows - pad_rows:] = num_segments + rng.integers(0, 3, size=(m, pad_rows))
    seg = np.sort(seg, axis=1).astype(np.int32)
    return values, idx, seg


def _exact_segment_sums(values, idx, seg, num_segments):
    """Float64 segment sums and sums of magnitudes: the float oracle."""
    ok = (seg >= 0) & (seg < num_segments)
    rows = torch.gather(values.double(), 1, idx.long()[..., None].expand_as(values))
    m, n, v = values.shape
    flat = torch.where(ok, seg.long(), num_segments)
    flat = flat + torch.arange(m, device=seg.device)[:, None] * (num_segments + 1)
    exact = torch.zeros(m * (num_segments + 1), v, dtype=torch.float64, device=values.device)
    scale = torch.zeros_like(exact)
    exact.index_add_(0, flat.reshape(-1), rows.reshape(-1, v))
    scale.index_add_(0, flat.reshape(-1), rows.abs().reshape(-1, v))
    shape = (m, num_segments + 1, v)
    return exact.view(shape)[:, :-1], scale.view(shape)[:, :-1]


CASES = [
    # (rows, segments, V, padding rows): rows not a multiple of 512,
    # segments spanning 512 boundaries, padding ids >= num_segments.
    (1, 1, 1, 0),
    (700, 3, 1, 50),
    (1300, 24, 11, 200),
    (2048, 5, 11, 0),
    (513, 96, 1, 1),
]


@pytest.mark.parametrize("n_rows,num_segments,v,pad", CASES)
@pytest.mark.parametrize("kind", ["int", "normal"])
def test_fused_plain_matches_pallas(n_rows, num_segments, v, pad, kind):
    import jax.numpy as jnp

    from repro.kernels.fused_shuffle_reduce.fused_shuffle_reduce import (
        fused_gather_segment_reduce_pallas,
    )

    m = 2
    values, idx, seg = _fused_inputs(
        np.random.default_rng(n_rows + v), m, n_rows, num_segments, v, kind, pad)
    got, counts = fused_ops.fused_shuffle_reduce(
        torch.from_numpy(values), torch.from_numpy(idx), torch.from_numpy(seg),
        num_segments)
    got = got.numpy()
    assert got.shape == (m, num_segments, v) and got.dtype == np.float32
    assert counts.shape == (m, num_segments) and counts.dtype == torch.float32
    for i in range(m):
        want = np.asarray(fused_gather_segment_reduce_pallas(
            jnp.asarray(values[i]), jnp.asarray(idx[i]), jnp.asarray(seg[i]),
            num_segments, interpret=True))
        if kind == "int":
            np.testing.assert_array_equal(got[i], want)
        else:
            np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


def _skewed_seg(rng, m, n_rows, num_segments, pad_rows, hot_share):
    """Sorted ids where one segment holds ``hot_share`` of the valid rows,
    a few negative ids lead, ids past ``num_segments`` pad the tail, and
    some segments are empty."""
    valid = n_rows - pad_rows
    seg = np.empty((m, n_rows), np.int64)
    for i in range(m):
        hot = rng.integers(0, num_segments)
        hot -= hot % 7 == 3
        ids = rng.integers(0, num_segments, size=valid)
        ids[rng.random(valid) < hot_share] = hot
        ids[ids % 7 == 3] = hot          # every id = 3 (mod 7) stays empty
        lead = min(5, valid // 2)
        ids[:lead] = -1 - rng.integers(0, 3, size=lead)
        seg[i] = np.concatenate([np.sort(ids), num_segments + rng.integers(0, 3, pad_rows)])
    return seg.astype(np.int32)


COUNT_CASES = [
    # (rows, segments, padding rows, hot share): a segment with more than
    # half the rows, segments many tiles long, empty segments, padding.
    (5000, 10, 300, 0.6),
    (3 * TILE_ROWS + 17, 4, 0, 0.9),
    (40 * TILE_ROWS, 3, 2 * TILE_ROWS + 5, 0.0),
    (700, 50, 650, 0.0),
]


@pytest.mark.parametrize("n_rows,num_segments,pad,hot", COUNT_CASES)
def test_fused_plain_counts_match_reference(n_rows, num_segments, pad, hot):
    import jax
    import jax.numpy as jnp

    m, v = 2, 3
    rng = np.random.default_rng(n_rows + num_segments)
    seg = _skewed_seg(rng, m, n_rows, num_segments, pad, hot)
    values = rng.integers(-3, 4, size=(m, n_rows, v)).astype(np.float32)
    idx = np.stack([rng.permutation(n_rows) for _ in range(m)]).astype(np.int32)
    out, counts = fused_ops.fused_shuffle_reduce(
        torch.from_numpy(values), torch.from_numpy(idx), torch.from_numpy(seg), num_segments)
    for i in range(m):
        ok = (seg[i] >= 0) & (seg[i] < num_segments)
        want = np.asarray(jax.ops.segment_sum(
            jnp.asarray(ok, jnp.float32), jnp.asarray(np.where(ok, seg[i], 0)), num_segments))
        np.testing.assert_array_equal(counts[i].numpy(), want)
        exact, _ = _exact_segment_sums(torch.from_numpy(values[i:i + 1]),
                                       torch.from_numpy(idx[i:i + 1]),
                                       torch.from_numpy(seg[i:i + 1]), num_segments)
        np.testing.assert_array_equal(out[i].numpy(), exact[0].numpy())
    assert counts.sum() == ((seg >= 0) & (seg < num_segments)).sum()


def _plan_rows(seg, num_segments, tile_rows):
    """Every row of the tile plan, with the checks of its layout."""
    plan = tile_plan(seg, num_segments, tile_rows)
    rows = []
    for block, which, s, start, end in plan:
        lo = int(np.searchsorted(seg, s, side="left"))
        assert (start - lo) % tile_rows == 0 and 0 < end - start <= tile_rows
        assert block * tile_rows <= start < (block + 1) * tile_rows
        assert which == (0 if seg[block * tile_rows] == s else 1)
        assert (seg[start:end] == s).all()
        rows.extend(range(start, end))
    return plan, rows


@pytest.mark.parametrize("n_rows,num_segments,pad,hot", COUNT_CASES)
def test_tile_plan_covers_every_valid_row_once(n_rows, num_segments, pad, hot):
    seg = _skewed_seg(np.random.default_rng(n_rows), 1, n_rows, num_segments, pad, hot)[0]
    for tile_rows in (32, 96, TILE_ROWS):
        plan, rows = _plan_rows(seg, num_segments, tile_rows)
        valid = np.flatnonzero((seg >= 0) & (seg < num_segments))
        assert sorted(rows) == valid.tolist()
        # At most one tile start of each segment, and at most two multi-tile
        # partials ("which" 0 and 1), in a block.
        keys = [(b, s) for b, _, s, _, _ in plan]
        assert len(keys) == len(set(keys))


@given(st.lists(st.integers(-2, 12), min_size=1, max_size=400),
       st.sampled_from([32, 64, 160]))
@settings(max_examples=60, deadline=None)
def test_tile_plan_hypothesis(ids, tile_rows):
    seg = np.sort(np.asarray(ids, np.int32))
    num_segments = 10
    _, rows = _plan_rows(seg, num_segments, tile_rows)
    valid = np.flatnonzero((seg >= 0) & (seg < num_segments))
    assert sorted(rows) == valid.tolist()


def _tiled_sums(values, idx, seg, num_segments, tile_rows=TILE_ROWS):
    """The kernel's float32 arithmetic, in numpy, for one slot: lane j of a
    tile adds rows start + j, + 32, ... in order; a shuffle-down tree
    (16, 8, 4, 2, 1) leaves the tile's sum in lane 0; a segment adds its
    tiles' sums in tile order."""
    v = values.shape[1]
    rows = values[idx]
    out = np.zeros((num_segments, v), np.float32)
    tiles = {}
    for _, _, s, start, end in tile_plan(seg, num_segments, tile_rows):
        chunk = rows[start:end]
        lanes = np.zeros((32, v), np.float32)
        for i in range(0, end - start, 32):
            part = chunk[i:i + 32]
            lanes[:len(part)] = lanes[:len(part)] + part
        for offset in (16, 8, 4, 2, 1):
            lanes[:32 - offset] = lanes[:32 - offset] + lanes[offset:]
        tiles.setdefault(s, []).append((start, lanes[0].copy()))
    for s, parts in tiles.items():
        acc = None
        for _, p in sorted(parts, key=lambda t: t[0]):
            acc = p if acc is None else acc + p
        out[s] = acc
    return out


def test_tiled_sums_emulation_is_close_to_exact():
    rng = np.random.default_rng(5)
    n, num_segments, v = 3000, 4, 3
    seg = _skewed_seg(rng, 1, n, num_segments, 100, 0.7)[0]
    values = rng.standard_normal((n, v)).astype(np.float32)
    idx = rng.permutation(n).astype(np.int32)
    got = _tiled_sums(values, idx, seg, num_segments, tile_rows=64)
    exact, scale = _exact_segment_sums(torch.from_numpy(values[None]),
                                       torch.from_numpy(idx[None]),
                                       torch.from_numpy(seg[None]), num_segments)
    assert (np.abs(got - exact[0].numpy()) <= 1e-5 * scale[0].numpy()).all()


def _repadded(values, idx, seg, num_segments, lead, extra):
    """The same streams with ``lead`` padding rows (id -1) in front, whose
    values are appended to the table, and ``extra`` padding rows behind."""
    m, n, v = values.shape
    dev = values.device
    values2 = torch.cat([values, torch.ones((m, lead + extra, v), device=dev)], dim=1)
    idx2 = torch.cat([torch.full((m, lead), n, dtype=torch.int32, device=dev), idx,
                      torch.zeros((m, extra), dtype=torch.int32, device=dev)], dim=1)
    seg2 = torch.cat([torch.full((m, lead), -1, dtype=torch.int32, device=dev), seg,
                      torch.full((m, extra), num_segments, dtype=torch.int32, device=dev)],
                     dim=1)
    return values2, idx2, seg2


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,num_segments,v,pad", CASES + [(300_000, 40, 17, 1000)])
def test_fused_kernel_matches_plain(n_rows, num_segments, v, pad):
    dev = _cuda()
    rng = np.random.default_rng(n_rows + num_segments)
    for kind in ("int", "normal"):
        values, idx, seg = (torch.from_numpy(a).to(dev) for a in _fused_inputs(
            rng, 3, n_rows, num_segments, v, kind, pad))
        before = fused_ops.launches
        got, counts = fused_ops.fused_shuffle_reduce(values, idx, seg, num_segments)
        torch.cuda.synchronize()
        assert fused_ops.launches == before + 1
        want, want_counts = fused_gather_segment_reduce_ref(values, idx, seg, num_segments)
        assert torch.equal(counts, want_counts)
        if kind == "int":
            assert torch.equal(got, want)
        else:
            # Both sum float32 in different orders (the plain version with
            # atomics); each stays within 1e-5 * sum|x| of the exact sum.
            exact, scale = _exact_segment_sums(values, idx, seg, num_segments)
            for out in (got, want):
                assert ((out.double() - exact).abs() <= 1e-5 * scale).all()
        # A longer padded slab, and the stream shifted by leading padding,
        # leave every segment's sum bit-identical.
        for lead, extra in ((0, 777), (5, 0), (TILE_ROWS + 3, 1)):
            again = fused_ops.fused_shuffle_reduce(
                *_repadded(values, idx, seg, num_segments, lead, extra), num_segments)
            assert torch.equal(again[0], got) and torch.equal(again[1], counts)
        # One slot's stream amid many blocks of padding on both sides, as a
        # chunk's segment row over every sender's pairs gives it (m = 1).
        for i in range(values.shape[0]):
            again = fused_ops.fused_shuffle_reduce(*_repadded(
                values[i:i + 1], idx[i:i + 1], seg[i:i + 1], num_segments,
                40 * TILE_ROWS + 5, 60 * TILE_ROWS + 9), num_segments)
            assert torch.equal(again[0], got[i:i + 1]) and torch.equal(again[1], counts[i:i + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,num_segments,pad,hot", COUNT_CASES)
def test_fused_kernel_hot_segments_match_tile_order(n_rows, num_segments, pad, hot):
    """On normals the kernel's bits are the tile plan's float32 order, and
    re-padding or shifting the stream changes none of them."""
    dev = _cuda()
    m, v = 2, 11
    rng = np.random.default_rng(n_rows + 1)
    seg = _skewed_seg(rng, m, n_rows, num_segments, pad, hot)
    values = rng.standard_normal((m, n_rows, v)).astype(np.float32)
    idx = np.stack([rng.permutation(n_rows) for _ in range(m)]).astype(np.int32)
    vt, it, st_ = (torch.from_numpy(a).to(dev) for a in (values, idx, seg))
    got, counts = fused_ops.fused_shuffle_reduce(vt, it, st_, num_segments)
    for i in range(m):
        np.testing.assert_array_equal(
            got[i].cpu().numpy(), _tiled_sums(values[i], idx[i], seg[i], num_segments))
    assert torch.equal(counts, fused_gather_segment_reduce_ref(vt, it, st_, num_segments)[1])
    for lead, extra in ((1, 0), (31, 4096), (TILE_ROWS, 0)):
        again, _ = fused_ops.fused_shuffle_reduce(
            *_repadded(vt, it, st_, num_segments, lead, extra), num_segments)
        assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# Count-min sketch.
# ---------------------------------------------------------------------------

# Odd multipliers below and above 2^31 (the reference draws them over all
# of uint32), and the extremes.
MULTIPLIERS = np.array([0x9E3779B1, 12345, 0xFFFFFFFF, 2 ** 31 + 1], np.uint32)


def _sketch_inputs(rng, m, k, weights):
    """Ids over all of int32 (negatives, INT32_MIN, INT32_MAX, 0), 0/1 or real weights."""
    ids = rng.integers(-2 ** 31, 2 ** 31, size=(m, k), dtype=np.int64).astype(np.int32)
    ids.flat[:4] = [-2 ** 31, 2 ** 31 - 1, 0, -1][:ids.size]
    if weights == "binary":
        w = (rng.random((m, k)) < 0.8).astype(np.float32)
    else:
        w = rng.random((m, k)).astype(np.float32)
    return ids, w


@pytest.mark.parametrize("k", [1, 1000, 2500])
@pytest.mark.parametrize("width", [8, 64, 1024, 4096])
@pytest.mark.parametrize("depth", [1, 4])
def test_sketch_plain_matches_pallas(k, width, depth):
    import jax.numpy as jnp

    from repro.kernels.sketch_hist.sketch_hist import sketch_hist_pallas

    m = 2
    ids, w = _sketch_inputs(np.random.default_rng(k + width + depth), m, k, "binary")
    mult = MULTIPLIERS[:depth]
    got = sk_ops.sketch_hist(torch.from_numpy(ids), torch.from_numpy(w), mult, width).numpy()
    assert got.shape == (m, depth, width) and got.dtype == np.float32
    # The same weights as a bool mask (the kernel's mask instance).
    got_mask = sk_ops.sketch_hist(torch.from_numpy(ids), torch.from_numpy(w > 0), mult,
                                  width).numpy()
    for i in range(m):
        want = np.asarray(sketch_hist_pallas(
            jnp.asarray(ids[i]), jnp.asarray(w[i]), jnp.asarray(mult), width,
            interpret=True))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got_mask[i], want)


def test_sketch_provider_multipliers_match_reference():
    from repro.core import stats_provider as ref_sp

    from repro_torch.core import stats_provider as port_sp

    for width, depth, seed in ((8, 1, 0), (1024, 4, 0), (4096, 5, 7)):
        ref = ref_sp.CountMinParams(width=width, depth=depth, seed=seed)
        port = port_sp.CountMinParams(width=width, depth=depth, seed=seed)
        np.testing.assert_array_equal(port.multipliers, ref.multipliers)
        assert port.multipliers.dtype == ref.multipliers.dtype
        ids = np.arange(-50, 3000)
        np.testing.assert_array_equal(port.bin_ids(ids), ref.bin_ids(ids))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,width,depth", [(1, 1, 8, 1), (3, 1000, 64, 4),
                                             (4, 70_001, 1024, 4), (2, 50_000, 16384, 4),
                                             (2, 30_000, 2 ** 16, 2)])
def test_sketch_kernel_matches_plain(m, k, width, depth):
    dev = _cuda()
    rng = np.random.default_rng(m + k + width)
    mult = MULTIPLIERS[:depth]
    ids, w = _sketch_inputs(rng, m, k, "binary")
    ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
    before = sk_ops.launches
    got = sk_ops.sketch_hist(ids_t, w_t, mult, width)
    torch.cuda.synchronize()
    assert sk_ops.launches == before + 1
    # 0/1 weights: integer sums, exact in any order of the atomics.
    assert torch.equal(got, sketch_hist_ref(ids_t, w_t, mult, width))
    # The same weights as a bool mask: the mask instance, one more launch.
    assert torch.equal(sk_ops.sketch_hist(ids_t, w_t > 0, mult, width),
                       sketch_hist_ref(ids_t, w_t, mult, width))
    assert sk_ops.launches == before + 2
    ids, w = _sketch_inputs(rng, m, k, "random")
    ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
    torch.testing.assert_close(sk_ops.sketch_hist(ids_t, w_t, mult, width),
                               sketch_hist_ref(ids_t, w_t, mult, width),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Sorted segment-sum.
# ---------------------------------------------------------------------------


def _segment_inputs(rng, m, n_rows, num_segments, v, kind, pad_rows):
    """Per slot: sorted segment ids with a few negatives and a padding tail."""
    if kind == "int":
        values = rng.integers(-3, 4, size=(m, n_rows, v)).astype(np.float32)
    else:
        values = rng.standard_normal((m, n_rows, v)).astype(np.float32)
    seg = rng.integers(-1, num_segments, size=(m, n_rows))
    seg[:, n_rows - pad_rows:] = num_segments + rng.integers(0, 3, size=(m, pad_rows))
    seg = np.sort(seg, axis=1).astype(np.int32)
    return values, seg


@pytest.mark.parametrize("n_rows,num_segments,v,pad", CASES)
@pytest.mark.parametrize("kind", ["int", "normal"])
def test_segment_plain_matches_pallas(n_rows, num_segments, v, pad, kind):
    import jax.numpy as jnp

    from repro.kernels.segment_reduce.segment_reduce import segment_reduce_sorted_pallas

    m = 2
    values, seg = _segment_inputs(
        np.random.default_rng(n_rows + v + 1), m, n_rows, num_segments, v, kind, pad)
    got = seg_ops.segment_reduce_sorted(
        torch.from_numpy(values), torch.from_numpy(seg), num_segments).numpy()
    assert got.shape == (m, num_segments, v) and got.dtype == np.float32
    for i in range(m):
        want = np.asarray(segment_reduce_sorted_pallas(
            jnp.asarray(values[i]), jnp.asarray(seg[i]), num_segments, interpret=True))
        if kind == "int":
            np.testing.assert_array_equal(got[i], want)
        else:
            # Both sum float32 in different orders over segments of up to
            # ~400 rows: a relative 1e-6 of the sum does not hold where the
            # sum cancels, 1e-5 of the sum of magnitudes does.
            ok = (seg[i] >= 0) & (seg[i] < num_segments)
            scale = np.zeros((num_segments, v))
            np.add.at(scale, seg[i][ok], np.abs(values[i][ok]).astype(np.float64))
            assert (np.abs(got[i].astype(np.float64) - want) <= 1e-5 * scale).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,num_segments,v,pad", CASES + [(300_000, 40, 17, 1000)])
def test_segment_kernel_matches_plain(n_rows, num_segments, v, pad):
    dev = _cuda()
    rng = np.random.default_rng(n_rows + num_segments + 1)
    for kind in ("int", "normal"):
        values, seg = (torch.from_numpy(a).to(dev) for a in _segment_inputs(
            rng, 3, n_rows, num_segments, v, kind, pad))
        before = seg_ops.launches
        got = seg_ops.segment_reduce_sorted(values, seg, num_segments)
        torch.cuda.synchronize()
        assert seg_ops.launches == before + 1
        want = segment_reduce_sorted_ref(values, seg, num_segments)
        if kind == "int":
            assert torch.equal(got, want)
        else:
            idx = torch.arange(n_rows, dtype=torch.int32, device=dev).expand(3, n_rows)
            exact, scale = _exact_segment_sums(values, idx.contiguous(), seg, num_segments)
            for out in (got, want):
                assert ((out.double() - exact).abs() <= 1e-5 * scale).all()
        # A longer padded slab leaves every segment's sum bit-identical.
        extra = 777
        values2 = torch.cat([values, torch.ones_like(values[:, :extra])], dim=1)
        seg2 = torch.cat([seg, torch.full_like(seg[:, :extra], num_segments)], dim=1)
        assert torch.equal(seg_ops.segment_reduce_sorted(values2, seg2, num_segments), got)


@given(st.integers(1, 2500), st.integers(1, 30), st.sampled_from([32, 64, 2048]),
       st.integers(0, 400), st.sampled_from([1, 3, 11]), st.integers(0, 2 ** 31 - 1))
@settings(max_examples=12, deadline=None)
def test_segment_tile_order_matches_pallas(n_rows, num_segments, tile_rows, pad, v, seed):
    """Kernel 3 adds a segment's rows in kernel 2's tile order (lane j of a
    tile takes rows start + j, + 32, ...; a shuffle tree; tiles in order).
    That order, in numpy, against the reference's Pallas kernel in interpret
    mode: exact on integers, within 1e-5 of the sum of magnitudes on
    normals; the port's plain version likewise."""
    import jax.numpy as jnp

    from repro.kernels.segment_reduce.segment_reduce import segment_reduce_sorted_pallas

    rng = np.random.default_rng(seed)
    pad = min(pad, n_rows - 1)
    values, seg = _segment_inputs(rng, 1, n_rows, num_segments, v, "int", pad)
    normals = rng.standard_normal(values.shape).astype(np.float32)
    ident = np.arange(n_rows)
    ok = (seg[0] >= 0) & (seg[0] < num_segments)
    scale = np.zeros((num_segments, v))
    np.add.at(scale, seg[0][ok], np.abs(normals[0][ok]).astype(np.float64))
    for kind, x in (("int", values), ("normal", normals)):
        want = np.asarray(segment_reduce_sorted_pallas(
            jnp.asarray(x[0]), jnp.asarray(seg[0]), num_segments, interpret=True))
        tiled = _tiled_sums(x[0], ident, seg[0], num_segments, tile_rows)
        plain = seg_ops.segment_reduce_sorted(torch.from_numpy(x), torch.from_numpy(seg),
                                              num_segments)[0].numpy()
        if kind == "int":
            np.testing.assert_array_equal(tiled, want)
            np.testing.assert_array_equal(plain, want)
        else:
            for got in (tiled, plain):
                assert (np.abs(got.astype(np.float64) - want) <= 1e-5 * scale).all()


def _gathered_case(n_rows, num_segments, v, pad, hot, seed, dev):
    """Skewed sorted ids, a permutation gather, normals; the same rows in
    rank order for kernel 3 (all on ``dev``)."""
    m = 2
    rng = np.random.default_rng(seed)
    seg = torch.from_numpy(_skewed_seg(rng, m, n_rows, num_segments, pad, hot)).to(dev)
    values = torch.from_numpy(rng.standard_normal((m, n_rows, v)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(
        np.stack([rng.permutation(n_rows) for _ in range(m)]).astype(np.int32)).to(dev)
    rows = torch.gather(values, 1, idx.long()[..., None].expand(m, n_rows, v)).contiguous()
    return values, idx, seg, rows


SEG_BITS_CASES = [
    # (rows, segments, V, padding rows, hot share): V = 11 (the path's),
    # V below and at the 12 columns a pass, V past it (two passes); hot
    # segments many tiles long; tiny slabs.
    (5000, 10, 11, 300, 0.6),
    (3 * TILE_ROWS + 17, 4, 11, 0, 0.9),
    (40 * TILE_ROWS + 5, 3, 11, 2 * TILE_ROWS + 5, 0.0),
    (9000, 6, 3, 10, 0.5),
    (9000, 6, 12, 10, 0.5),
    (7000, 5, 17, 30, 0.5),
    (33, 2, 1, 1, 0.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,num_segments,v,pad,hot", SEG_BITS_CASES)
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_segment_kernel_equals_fused_kernel_bitwise(n_rows, num_segments, v, pad, hot, offset):
    """On normals, kernel 3 on the rank-sorted rows gives kernel 2's bits on
    the gathered ones, and the tile order's bits in numpy, wherever the
    rows start in memory (``offset`` floats past a 16-byte boundary)."""
    dev = _cuda()
    values, idx, seg, rows = _gathered_case(n_rows, num_segments, v, pad, hot,
                                            n_rows + v + offset, dev)
    m = rows.shape[0]
    shifted = torch.cat([torch.zeros(offset, device=dev), rows.reshape(-1)])[offset:]
    shifted = shifted.view(m, n_rows, v)
    before = seg_ops.launches
    got = seg_ops.segment_reduce_sorted(shifted, seg, num_segments)
    fused, _ = fused_ops.fused_shuffle_reduce(values, idx, seg, num_segments)
    torch.cuda.synchronize()
    assert seg_ops.launches == before + 1
    assert torch.equal(got, fused)
    rows_np, seg_np = rows.cpu().numpy(), seg.cpu().numpy()
    for i in range(m):
        np.testing.assert_array_equal(
            got[i].cpu().numpy(),
            _tiled_sums(rows_np[i], np.arange(n_rows), seg_np[i], num_segments))


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,num_segments,v,pad,hot", SEG_BITS_CASES[:3])
def test_segment_kernel_pad_and_shift_invariant(n_rows, num_segments, v, pad, hot):
    """A longer padded slab, and the stream shifted by leading padding,
    leave every bit of kernel 3's sums."""
    dev = _cuda()
    _, _, seg, rows = _gathered_case(n_rows, num_segments, v, pad, hot, n_rows, dev)
    got = seg_ops.segment_reduce_sorted(rows, seg, num_segments)
    m = rows.shape[0]
    for lead, extra in ((0, 777), (5, 0), (TILE_ROWS + 3, 1), (31, 4096)):
        rows2 = torch.cat([torch.ones((m, lead, v), device=dev), rows,
                           torch.ones((m, extra, v), device=dev)], dim=1)
        seg2 = torch.cat([torch.full((m, lead), -1, dtype=torch.int32, device=dev), seg,
                          torch.full((m, extra), num_segments, dtype=torch.int32, device=dev)],
                         dim=1)
        assert torch.equal(seg_ops.segment_reduce_sorted(rows2, seg2, num_segments), got)


# ---------------------------------------------------------------------------
# XOR word slabs (the coded shuffle; CPU parity in test_torch_coded.py).
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,w", [(1, 1), (1, 13), (7, 5), (1000, 13), (3001, 5),
                                 (70_001, 13), (1 << 20, 4)])
@pytest.mark.parametrize("word", [torch.int32, torch.uint32])
def test_xor_kernel_matches_plain(n, w, word):
    dev = _cuda()
    rng = np.random.default_rng(n + w)
    raw = rng.integers(0, 2 ** 32, (2, n * w + 1), dtype=np.uint32).view(np.int32)
    a_buf, b_buf = (torch.from_numpy(r).to(dev).view(word) for r in raw)
    a, b = a_buf[:-1].view(n, w), b_buf[:-1].view(n, w)
    before = cs_ops.launches
    got = cs_ops.xor_words(a, b)
    torch.cuda.synchronize()
    assert cs_ops.launches == before + 1
    assert torch.equal(got, xor_words_ref(a, b))
    # A view one word into its slab takes the one-word loop: same bits.
    shifted = a_buf[1:].view(n, w)
    assert torch.equal(cs_ops.xor_words(shifted, b), xor_words_ref(shifted, b))
    # Self-inverse, as decode needs.
    assert torch.equal(cs_ops.xor_words(got, b), a)


@pytest.mark.gpu
def test_xor_wrapper_rejects_bad_inputs():
    dev = _cuda()
    a = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cs_ops.xor_words(a.float(), a.float())
    with pytest.raises(TypeError):
        cs_ops.xor_words(a, a.to(torch.int64))
    with pytest.raises(ValueError):
        cs_ops.xor_words(a, a[:, :2])
    with pytest.raises(ValueError):
        cs_ops.xor_words(a, a.cpu())
    with pytest.raises(ValueError):
        cs_ops.xor_words(a.t(), a.t())
    with pytest.raises(ValueError):
        cs_ops.xor_words(a.view(-1), a.view(-1))


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs():
    dev = _cuda()
    ids = torch.zeros((2, 8), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        hist_ops.histogram(ids, torch.ones((2, 8), device=dev), 4)
    values = torch.zeros((2, 8, 3), dtype=torch.float64, device=dev)
    idx = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fused_ops.fused_shuffle_reduce(values, idx, idx, 4)
    with pytest.raises(ValueError):
        fused_ops.fused_shuffle_reduce(values.float().transpose(0, 1), idx.t(), idx.t(), 4)
    with pytest.raises(TypeError):
        sk_ops.sketch_hist(ids, torch.ones((2, 8), device=dev), MULTIPLIERS, 64)
    with pytest.raises(ValueError):
        sk_ops.sketch_hist(ids.int(), torch.ones((2, 8), device=dev), MULTIPLIERS, 48)
    with pytest.raises(TypeError):
        seg_ops.segment_reduce_sorted(values, idx, 4)
    with pytest.raises(ValueError):
        seg_ops.segment_reduce_sorted(values.float().transpose(0, 1), idx.t(), 4)
