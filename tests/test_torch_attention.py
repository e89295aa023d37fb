"""The port's attention against the reference's.

On the CPU the flash wrapper runs its plain version, which is held against
the reference's Pallas kernel in interpret mode over the sweep of the
reference's own kernel tests, plus the rows that see no key (``T > S``).
``decode_attention``, the blocked path and the naive oracle are held
against their reference functions. The ``gpu`` cases hold the CUDA kernel
against its plain version on the card. Inputs are numpy draws from a seed,
handed to both sides.

Tolerances: float32 2e-5 absolute and bfloat16 3e-2, the reference's own
(``tests/test_kernels.py``); the two sides sum in other orders.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_ref
from repro_torch.nn import attention as port_attn

F32_ATOL, BF16_ATOL = 2e-5, 3e-2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(seed, b, hq, hkv, t, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _to_torch(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _to_jax(arrays, dtype=None):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a, dtype or jnp.float32) for a in arrays)


# The reference's sweep (tests/test_kernels.py:40-50) and two more.
SWEEP = [
    (1, 2, 2, 128, 128, 64, True, 64, 64),
    (2, 4, 2, 100, 100, 32, True, 64, 64),     # GQA, ragged seq
    (1, 8, 1, 256, 256, 64, False, 128, 128),  # MQA, non-causal
    (2, 2, 2, 64, 192, 32, True, 32, 64),      # suffix-aligned causal
    (1, 4, 4, 33, 177, 16, True, 32, 64),
    (1, 6, 2, 40, 40, 20, True, 16, 16),       # smollm-like head dim 20
    (2, 4, 2, 17, 90, 8, False, 16, 32),       # non-causal, T < S
]


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,bq,bk", SWEEP)
def test_flash_plain_matches_pallas(b, hq, hkv, t, s, d, causal, bq, bk):
    from repro.kernels.flash_attention.ops import flash_attention as ref_flash

    arrays = _qkv(b * 1000 + t, b, hq, hkv, t, s, d)
    want = np.asarray(ref_flash(*_to_jax(arrays), causal=causal, block_q=bq, block_k=bk))
    got = fa_ops.flash_attention(*_to_torch(arrays), causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_dtypes(dtype):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as ref_flash

    arrays = _qkv(7, 1, 2, 2, 64, 64, 32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = ref_flash(*_to_jax(arrays, jdt), causal=True, block_q=32, block_k=32)
    got = fa_ops.flash_attention(*_to_torch(arrays, tdt), causal=True, block_q=32, block_k=32)
    assert got.dtype == tdt
    atol = BF16_ATOL if dtype == "bfloat16" else F32_ATOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def test_rows_that_see_no_key_give_zero():
    """T > S, causal: query rows before the first key give 0 in the Pallas
    kernel and in the port, where the reference's oracle gives NaN."""
    from repro.kernels.flash_attention.ops import flash_attention as ref_flash
    from repro.kernels.flash_attention.ref import attention_ref as ref_oracle

    arrays = _qkv(3, 2, 4, 2, 48, 20, 16)
    want = np.asarray(ref_flash(*_to_jax(arrays), causal=True, block_q=16, block_k=16))
    got = fa_ops.flash_attention(*_to_torch(arrays), causal=True).numpy()
    blind = 48 - 20                                   # rows i with (S - T) + i < 0
    assert np.all(got[:, :, :blind] == 0) and np.all(want[:, :, :blind] == 0)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    oracle = np.asarray(ref_oracle(*_to_jax(arrays), causal=True))
    assert np.isnan(oracle[:, :, :blind]).all()
    assert np.isnan(attention_ref(*_to_torch(arrays), causal=True).numpy()[:, :, :blind]).all()


@pytest.mark.parametrize("causal", [True, False])
def test_naive_oracle_matches_reference(causal):
    from repro.kernels.flash_attention.ref import attention_ref as ref_oracle

    arrays = _qkv(11, 2, 4, 2, 24, 40, 16)
    want = np.asarray(ref_oracle(*_to_jax(arrays), causal=causal))
    got = attention_ref(*_to_torch(arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("cache_len", [40, [40, 17]], ids=["scalar", "per-lane"])
def test_decode_attention_matches_reference(cache_len):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import decode_attention as ref_decode

    rng = np.random.default_rng(5)
    b, hq, hkv, d, s = 2, 4, 2, 32, 64
    kc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    q1 = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    want = np.asarray(ref_decode(jnp.asarray(q1), jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.asarray(cache_len)))
    got = fa_ops.decode_attention(torch.from_numpy(q1), torch.from_numpy(kc),
                                  torch.from_numpy(vc), torch.as_tensor(cache_len))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("t,s,block_k,causal,q_pos", [
    (32, 32, 8, True, None),
    (20, 45, 16, True, None),     # suffix-aligned, padded last block
    (16, 64, 64, False, None),
    (8, 32, 8, True, "shard"),    # a sequence shard's own query positions
])
def test_blocked_matches_reference(t, s, block_k, causal, q_pos):
    import jax.numpy as jnp

    from repro.nn.attention import blocked_attention as ref_blocked

    arrays = _qkv(t + s, 2, 4, 2, t, s, 16)
    pos = None if q_pos is None else 8 + np.arange(t)
    want = np.asarray(ref_blocked(*_to_jax(arrays), causal=causal, block_k=block_k,
                                  q_pos=None if pos is None else jnp.asarray(pos)))
    got = port_attn.blocked_attention(*_to_torch(arrays), causal=causal, block_k=block_k,
                                      q_pos=None if pos is None else torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("impl", ["blocked", "pallas", "naive"])
def test_run_attention_routes_like_reference(impl):
    from repro.nn.attention import _run_attention as ref_run

    arrays = _qkv(13, 1, 4, 2, 24, 24, 16)
    want = np.asarray(ref_run(*_to_jax(arrays), causal=True, impl=impl, block_q=8,
                              block_k=8))
    got = port_attn._run_attention(*_to_torch(arrays), causal=True, impl=impl,
                                   block_q=8, block_k=8)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"), (torch.float32, 20, "simt"),
    (torch.bfloat16, 20, "simt"), (torch.bfloat16, 200, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 256, "simt"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 192, "wgmma"),   # zamba2's, MLA's
    (torch.float32, 80, "simt"), (torch.float32, 192, "simt"),
])
def test_flash_design_by_dtype_and_head_dim(dtype, d, want):
    """bf16 at D = 64, 80, 128 and 192 take the tensor-core instance;
    float32 (TF32 there) and every other D take the float32 SIMT one."""
    assert fa_ops.design(dtype, d) == want


def test_flash_wrapper_rejects_bad_shapes():
    q, k, v = _to_torch(_qkv(1, 1, 3, 2, 4, 4, 8))
    with pytest.raises(ValueError, match="GQA"):
        fa_ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="B, Hkv, S, D"):
        fa_ops.flash_attention(q, k[..., :4], v)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version.
# ---------------------------------------------------------------------------

GPU_CASES = [
    (8, 32, 8, 300, 300, 128, True, torch.bfloat16),   # the serve path's prefill
    (2, 4, 2, 100, 100, 32, True, torch.float32),
    (2, 2, 2, 64, 192, 64, True, torch.float32),       # T < S
    (2, 4, 2, 70, 30, 64, True, torch.float32),        # T > S: rows that see no key
    (1, 8, 1, 256, 256, 64, False, torch.bfloat16),
    (2, 3, 1, 50, 50, 20, True, torch.float32),        # generic head dim
    (1, 2, 2, 130, 130, 256, True, torch.bfloat16),
    (1, 2, 1, 77, 300, 200, False, torch.float32),
    # The wgmma instance (bf16, D = 64 or 128).
    (8, 32, 8, 504, 504, 128, True, torch.bfloat16),   # the serve path's longest prefill
    (2, 8, 2, 1, 300, 128, True, torch.bfloat16),      # ragged T < S
    (2, 8, 2, 65, 300, 128, True, torch.bfloat16),
    (2, 8, 2, 130, 300, 128, True, torch.bfloat16),
    (2, 4, 2, 130, 60, 128, True, torch.bfloat16),     # T > S: rows that see no key
    (1, 4, 4, 257, 257, 128, True, torch.bfloat16),    # GQA group 1
    (1, 8, 1, 200, 200, 128, True, torch.bfloat16),    # GQA group 8
    (2, 4, 4, 300, 300, 64, True, torch.bfloat16),     # D = 64
    (2, 8, 2, 70, 30, 64, True, torch.bfloat16),       # D = 64, T > S
    (2, 4, 2, 130, 700, 128, False, torch.bfloat16),   # non-causal, T < S
    (1, 4, 1, 1000, 1000, 128, True, torch.bfloat16),  # many key tiles
    # The wgmma instance at MLA's D = 192 (64-key tiles) and zamba2's D = 80
    # (a second panel half zero fill).
    (1, 4, 4, 300, 300, 192, True, torch.bfloat16),    # MLA-like
    (2, 4, 4, 65, 300, 192, True, torch.bfloat16),     # ragged T < S
    (2, 4, 4, 130, 60, 192, True, torch.bfloat16),     # T > S: rows that see no key
    (2, 4, 4, 130, 700, 192, False, torch.bfloat16),   # non-causal
    (2, 8, 4, 200, 200, 192, True, torch.bfloat16),    # GQA group 2
    (1, 4, 4, 1000, 1000, 80, True, torch.bfloat16),   # zamba2-like
    (2, 4, 4, 65, 300, 80, True, torch.bfloat16),      # ragged T < S
    (2, 4, 4, 130, 60, 80, True, torch.bfloat16),      # T > S: rows that see no key
    (2, 4, 4, 130, 700, 80, False, torch.bfloat16),    # non-causal
    (2, 8, 4, 200, 200, 80, True, torch.bfloat16),     # GQA group 2
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,dtype", GPU_CASES)
def test_flash_kernel_matches_plain_on_gpu(b, hq, hkv, t, s, d, causal, dtype):
    dev = _cuda()
    q, k, v = (x.to(dev) for x in _to_torch(_qkv(t * s, b, hq, hkv, t, s, d), dtype))
    kind = fa_ops.design(dtype, d)
    before, before_kind = fa_ops.launches, fa_ops.launches_by_design[kind]
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1 and got.dtype == dtype
    assert fa_ops.launches_by_design[kind] == before_kind + 1
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if t > s and causal:
        assert torch.all(got[:, :, :t - s] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [192, 80])
def test_flash_simt_instance_still_right_in_bf16(d):
    """The simt instance, called directly in bf16 at the head dims the wgmma
    instance took from it, against the plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

    dev = _cuda()
    q, k, v = (x.to(dev) for x in _to_torch(_qkv(d, 2, 4, 2, 130, 300, d), torch.bfloat16))
    got = torch.empty_like(q)
    before = dict(fa_ops.launches_by_design)
    flash_attention_cuda(q, k, v, got, True, d ** -0.5, "simt")
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.launches_by_design == before     # the wrapper counts, not the binding
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    q, k, v = (x.to(dev) for x in _to_torch(_qkv(2, 1, 2, 2, 8, 8, 16)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    big = torch.zeros(1, 1, 4, 272, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_attention(big, big, big)
    # The wgmma instance reads q, k, v by TMA: 16-byte aligned starts only.
    flat = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16, device=dev)
    odd = flat[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_ops.flash_attention(odd, odd, odd)
