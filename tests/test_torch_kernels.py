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

from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
from repro_torch.kernels.fused_shuffle_reduce.ref import fused_gather_segment_reduce_ref
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.histogram.ref import histogram_ref


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Histogram.
# ---------------------------------------------------------------------------


def _hist_inputs(rng, m, k, n, weights):
    ids = rng.integers(-2, n + 3, size=(m, k)).astype(np.int32)  # -1, -2, >= n too
    if weights == "binary":
        w = (rng.random((m, k)) < 0.8).astype(np.float32)
    else:
        w = rng.random((m, k)).astype(np.float32)
    return ids, w


@pytest.mark.parametrize("k", [1, 7, 1000, 3000])
@pytest.mark.parametrize("n", [1, 24, 1500])
@pytest.mark.parametrize("weights", ["binary", "random"])
def test_histogram_plain_matches_pallas(k, n, weights):
    import jax.numpy as jnp

    from repro.kernels.histogram.histogram import histogram_pallas

    m = 2
    ids, w = _hist_inputs(np.random.default_rng(k * 7 + n), m, k, n, weights)
    got = hist_ops.histogram(torch.from_numpy(ids), torch.from_numpy(w), n).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    for i in range(m):
        want = np.asarray(histogram_pallas(
            jnp.asarray(ids[i]), jnp.asarray(w[i]), n, interpret=True))
        if weights == "binary":
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
    got = fused_ops.fused_shuffle_reduce(
        torch.from_numpy(values), torch.from_numpy(idx), torch.from_numpy(seg),
        num_segments).numpy()
    assert got.shape == (m, num_segments, v) and got.dtype == np.float32
    for i in range(m):
        want = np.asarray(fused_gather_segment_reduce_pallas(
            jnp.asarray(values[i]), jnp.asarray(idx[i]), jnp.asarray(seg[i]),
            num_segments, interpret=True))
        if kind == "int":
            np.testing.assert_array_equal(got[i], want)
        else:
            np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,num_segments,v,pad", CASES + [(300_000, 40, 17, 1000)])
def test_fused_kernel_matches_plain(n_rows, num_segments, v, pad):
    dev = _cuda()
    rng = np.random.default_rng(n_rows + num_segments)
    for kind in ("int", "normal"):
        values, idx, seg = (torch.from_numpy(a).to(dev) for a in _fused_inputs(
            rng, 3, n_rows, num_segments, v, kind, pad))
        before = fused_ops.launches
        got = fused_ops.fused_shuffle_reduce(values, idx, seg, num_segments)
        torch.cuda.synchronize()
        assert fused_ops.launches == before + 1
        want = fused_gather_segment_reduce_ref(values, idx, seg, num_segments)
        if kind == "int":
            assert torch.equal(got, want)
        else:
            # Both sum float32 in different orders (the plain version with
            # atomics); each stays within 1e-5 * sum|x| of the exact sum.
            exact, scale = _exact_segment_sums(values, idx, seg, num_segments)
            for out in (got, want):
                assert ((out.double() - exact).abs() <= 1e-5 * scale).all()
        # A longer padded slab leaves every segment's sum bit-identical.
        extra = 777
        values2 = torch.cat([values, torch.ones_like(values[:, :extra])], dim=1)
        idx2 = torch.cat([idx, torch.zeros_like(idx[:, :extra])], dim=1)
        seg2 = torch.cat([seg, torch.full_like(seg[:, :extra], num_segments)], dim=1)
        assert torch.equal(
            fused_ops.fused_shuffle_reduce(values2, idx2, seg2, num_segments), got)


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
