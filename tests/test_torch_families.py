"""The attention families the serving engine serves, against the reference:
DeepSeek-V2's MLA (deepseek-v2-236b), the encoder-decoder (whisper-base)
and M-RoPE with patch embeddings (qwen2-vl-7b).

Layers: ``apply_mrope``, ``sinusoidal_positions`` and the M-RoPE position
ids (scalar and per-lane starts) against the reference's functions;
cross-attention through ``kv_override`` and the ``MLA`` module (prefill,
and absorbed decode at scalar and per-lane positions) against the
reference's ``attention`` and ``mla_attention`` with the same values.
Models: the reference's random parameters (``init_model`` with a JAX key,
as numpy float32) loaded by ``params_from_reference``, then the same
numpy tokens and patch or frame embeddings through both ``forward``s:
train, prefill and decode logits for each ``attn_impl``, the caches
after each step (``init_cache`` layouts: ``tests/test_torch_model.py``).
Serving: ``Engine`` token
streams equal to the reference engine's (whisper and qwen2-vl with
``extra_embed``; deepseek-v2 at one expert slot in process and at four
against the reference's (1, 4) mesh in a subprocess with four forced
host devices), the vlm engine's decode positions pinned, and the
launcher on the three archs.

Tolerance: ``LOGIT_ATOL = 1e-4`` absolute on float32 logits of magnitude
~4 (``tests/test_torch_model.py``; observed ~6e-6), 1e-5 on caches and
layer outputs.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import _positions, forward, init_cache, init_model
from repro_torch.nn import attention as PA
from repro_torch.nn import layers as PL
from repro_torch.serve.engine import Engine, EngineConfig, Request

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
LOGIT_ATOL = 1e-4
ATOL = 1e-5
FAMILIES = ["deepseek-v2-236b", "whisper-base", "qwen2-vl-7b"]
IMPLS = ["blocked", "pallas", "naive"]


def _ref_model(arch, seed=0, **over):
    """The reference's config (with ``over``), values and numpy values."""
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.models.model import init_model as ref_init
    from repro.nn import layers as RL

    cfg_ref = dataclasses.replace(ref_smoke(arch), **over)
    vals, _ = RL.split(ref_init(jax.random.PRNGKey(seed), cfg_ref))
    return cfg_ref, vals, jax.tree.map(lambda a: np.asarray(a, np.float32), vals)


def _extra(cfg, b, rng):
    """Patch embeddings (vlm) or frame embeddings (whisper), else None."""
    if cfg.n_patches:
        return rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        return rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return None


def _jnp(a):
    import jax.numpy as jnp

    return None if a is None else jnp.asarray(a)


def _leaves(tree, prefix=()):
    """(path, leaf) of a nested dict / tuple of arrays or tensors."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            yield from _leaves(item, prefix + (i,))
    else:
        yield prefix, tree


def _assert_trees_close(port, ref, atol):
    got, want = list(_leaves(port)), list(_leaves(ref))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b), atol=atol, rtol=0,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# Layers: M-RoPE, sinusoidal positions, M-RoPE position ids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,sections,theta", [
    ((2, 5, 3, 16), (2, 3, 3), 1e6),       # (B, T, H, D), positions (B, T, 3)
    ((2, 5, 16), (4, 2, 2), 1e6),          # (B, T, D)
    ((1, 7, 2, 128), (16, 24, 24), 1e4),   # qwen2-vl's head dim and sections
])
def test_apply_mrope_matches_reference(shape, sections, theta):
    from repro.nn import layers as RL

    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 300, shape[:2] + (3,)).astype(np.int32)
    want = RL.apply_mrope(_jnp(x), _jnp(pos), sections, theta)
    got = PL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="sum to D/2"):
        PL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (1, 1, 1), theta)


@pytest.mark.parametrize("length,d", [(16, 64), (1500, 512), (7, 10)])
def test_sinusoidal_positions_match_reference(length, d):
    from repro.nn import layers as RL

    got = PL.sinusoidal_positions(length, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(RL.sinusoidal_positions(length, d)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("start", [0, 3, 9, [0, 2, 5], [4, 11, 1]],
                         ids=["s0", "s3", "s9", "lanes-a", "lanes-b"])
@pytest.mark.parametrize("t", [1, 6])
def test_mrope_positions_match_reference(start, t):
    """Patches at (0, idx // g, idx % g), text from idx - n_patches + 1,
    across the patch boundary (n_patches = 4), scalar or per-lane start."""
    import jax.numpy as jnp

    from repro.configs import get_smoke as ref_smoke
    from repro.models.model import _positions as ref_positions

    cfg = get_smoke("qwen2-vl-7b")
    start_np = np.asarray(start, np.int32)
    want = ref_positions(ref_smoke("qwen2-vl-7b"), 3, t, start=jnp.asarray(start_np))
    got = _positions(cfg, 3, t, start=torch.as_tensor(start_np))
    assert tuple(got.shape) == (3, t, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Without M-RoPE the ids are the stream positions, as before.
    flat = _positions(get_smoke("llama3-8b"), 3, t, start=torch.as_tensor(start_np))
    np.testing.assert_array_equal(flat.numpy(), np.broadcast_to(
        start_np.reshape(-1, 1) + np.arange(t), (3, t)))


# ---------------------------------------------------------------------------
# Cross-attention and MLA against the reference's functions
# ---------------------------------------------------------------------------


def _attn_values(seed, d, h, hkv, hd, bias):
    import jax

    from repro.nn import attention as RA
    from repro.nn import layers as RL

    vals, _ = RL.split(RA.init_attention(jax.random.PRNGKey(seed), d, h, hkv, hd, bias=bias))
    return vals, jax.tree.map(lambda a: np.asarray(a, np.float32), vals)


def _load_attention(module, values):
    with torch.no_grad():
        for name, tree in values.items():
            lin = getattr(module, name)
            lin.w.copy_(torch.tensor(tree["w"]))
            if "b" in tree:
                lin.b.copy_(torch.tensor(tree["b"]))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("t", [1, 6])
def test_cross_attention_kv_override_matches_reference(impl, t):
    """Given (k, v) of S = 11 encoder rows, T = 1 (the decode step, full
    length) or 6 queries, non-causal, with qkv biases; no cache is read or
    written, even when one is passed."""
    from repro.nn import attention as RA

    d, h, hkv, hd, s, b = 32, 4, 2, 8, 11, 2
    jvals, values = _attn_values(1, d, h, hkv, hd, bias=True)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    want, want_cache = RA.attention(jvals, _jnp(x), n_heads=h, n_kv=hkv, head_dim=hd,
                                    positions=None, rope_kind="none", causal=False,
                                    kv_override=(_jnp(k), _jnp(v)), impl=impl,
                                    block_q=4, block_k=4)
    module = PA.Attention(d, h, hkv, hd, bias=True, device="cpu")
    _load_attention(module, values)
    cache = {"k": torch.zeros(b, 16, hkv, hd), "v": torch.zeros(b, 16, hkv, hd)}
    got, got_cache = module(torch.from_numpy(x), positions=None, rope_kind="none",
                            causal=False, cache=cache, cache_pos=3,
                            kv_override=(torch.from_numpy(k), torch.from_numpy(v)),
                            impl=impl, block_q=4, block_k=4)
    assert want_cache is None and got_cache is None
    assert torch.all(cache["k"] == 0) and torch.all(cache["v"] == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _mla_values(seed, d, h, m):
    import jax

    from repro.nn import attention as RA
    from repro.nn import layers as RL

    vals, _ = RL.split(RA.init_mla(jax.random.PRNGKey(seed), d, h, kv_lora=m["kv_lora"],
                                   q_lora=m["q_lora"], qk_nope=m["qk_nope"],
                                   qk_rope=m["qk_rope"], v_dim=m["v_dim"]))
    return vals, jax.tree.map(lambda a: np.asarray(a, np.float32), vals)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("per_lane", [True, False], ids=["per-lane", "scalar"])
def test_mla_prefill_and_absorbed_decode_match_reference(impl, per_lane):
    """A prefill of T = 7 with a cache (per-head K/V at qk_nope + qk_rope,
    v padded), then one decode step in the absorbed form: outputs and the
    compressed cache ``{"c_kv", "k_pe"}`` equal to the reference's."""
    import jax.numpy as jnp

    from repro.nn import attention as RA

    d, h, b, t, max_len = 32, 4, 3, 7, 12
    m = dict(kv_lora=16, q_lora=24, qk_nope=8, qk_rope=4, v_dim=6)
    jvals, values = _mla_values(2, d, h, m)
    module = PA.MLA(d, h, device="cpu", **m)
    with torch.no_grad():
        for name, tree in values.items():
            part = getattr(module, name)
            if "w" in tree:
                part.w.copy_(torch.tensor(tree["w"]))
            else:
                part.scale.copy_(torch.tensor(tree["scale"]))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    kw = dict(n_heads=h, kv_lora=m["kv_lora"], qk_nope=m["qk_nope"], qk_rope=m["qk_rope"],
              v_dim=m["v_dim"], impl=impl, block_q=4, block_k=4)
    zero = {"c_kv": jnp.zeros((b, max_len, m["kv_lora"])),
            "k_pe": jnp.zeros((b, max_len, m["qk_rope"]))}
    want, want_cache = RA.mla_attention(jvals, _jnp(x), positions=_jnp(pos), cache=zero,
                                        cache_pos=jnp.int32(0), **kw)
    cache = {"c_kv": torch.zeros(b, max_len, m["kv_lora"]),
             "k_pe": torch.zeros(b, max_len, m["qk_rope"])}
    got, got_cache = module(torch.from_numpy(x), positions=torch.from_numpy(pos), cache=cache,
                            impl=impl, block_q=4, block_k=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    _assert_trees_close(got_cache, want_cache, ATOL)

    step = rng.standard_normal((b, 1, d)).astype(np.float32)
    at = np.array([t, t - 3, t + 2], np.int32) if per_lane else np.int32(t)
    at_pos = (at.reshape(-1, 1) if per_lane else np.full((b, 1), at)).astype(np.int32)
    want2, want_cache2 = RA.mla_attention(jvals, _jnp(step), positions=_jnp(at_pos),
                                          cache=want_cache, cache_pos=_jnp(at), **kw)
    got2, got_cache2 = module(torch.from_numpy(step), positions=torch.from_numpy(at_pos),
                              cache=got_cache, cache_pos=torch.as_tensor(at), impl=impl)
    assert got_cache2["c_kv"] is cache["c_kv"], "decode writes the cache in place"
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=ATOL, rtol=0)
    _assert_trees_close(got_cache2, want_cache2, ATOL)


# ---------------------------------------------------------------------------
# The three families' models
# ---------------------------------------------------------------------------


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("per_lane", [True, False], ids=["per-lane", "scalar"])
def test_family_logits_match_reference(arch, impl, per_lane):
    """Train logits, prefill logits and cache, then a decode step at scalar
    or per-lane positions past the stream (for qwen2-vl past the patches
    too), logits and cache."""
    import jax.numpy as jnp

    from repro.models.model import forward as ref_forward, init_cache as ref_cache

    over = dict(attn_impl=impl, attn_block_q=4, attn_block_k=4)
    cfg_ref, jvals, values = _ref_model(arch, **over)
    cfg = dataclasses.replace(get_smoke(arch), **over)
    model = params_from_reference(values, cfg, "cpu")
    rng = np.random.default_rng(len(arch))
    b, t, max_len = 3, 9, 24
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    extra = _extra(cfg, b, rng)

    want = ref_forward(jvals, cfg_ref, tokens=_jnp(toks), extra_embed=_jnp(extra))
    got = forward(model, cfg, tokens=torch.from_numpy(toks), extra_embed=extra)
    assert got.cache is None and tuple(got.logits.shape) == (b, t + cfg.n_patches, cfg.vocab)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=LOGIT_ATOL,
                               rtol=0)

    r_pre = ref_forward(jvals, cfg_ref, tokens=_jnp(toks), extra_embed=_jnp(extra),
                        mode="prefill", cache=ref_cache(cfg_ref, b, max_len, jnp.float32),
                        cache_pos=jnp.int32(0))
    cache = init_cache(cfg, b, max_len, torch.float32, device="cpu")
    p_pre = forward(model, cfg, tokens=torch.from_numpy(toks), extra_embed=extra,
                    mode="prefill", cache=cache)
    np.testing.assert_allclose(p_pre.logits.numpy(), np.asarray(r_pre.logits),
                               atol=LOGIT_ATOL, rtol=0)
    assert all(torch.all(a == 0) for _, a in _leaves(cache)), "prefill left the cache as it was"
    _assert_trees_close(p_pre.cache, r_pre.cache, ATOL)

    nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    end = t + cfg.n_patches
    pos = np.array([end, end - 4, end + 2], np.int32) if per_lane else np.int32(end)
    r_dec = ref_forward(jvals, cfg_ref, tokens=_jnp(nxt), mode="decode", cache=r_pre.cache,
                        cache_pos=_jnp(pos))
    p_dec = forward(model, cfg, tokens=torch.from_numpy(nxt), mode="decode",
                    cache=_clone_tree(p_pre.cache), cache_pos=torch.as_tensor(pos))
    np.testing.assert_allclose(p_dec.logits.numpy(), np.asarray(r_dec.logits),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_trees_close(p_dec.cache, r_dec.cache, ATOL)
    if cfg.moe is not None:
        np.testing.assert_array_equal(p_dec.stats["expert_counts"].numpy(),
                                      np.asarray(r_dec.stats["expert_counts"]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_continues_the_full_forward(arch):
    """Prefill, then decode steps one token at a time (qwen2-vl at
    ``n_patches + p + i``, after its patches), equal to the train-mode
    forward of the whole stream at those positions (float32)."""
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="pallas")
    model = init_model(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    b, t, p = 2, 12, 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, t)))
    extra = _extra(cfg, b, rng)
    full = forward(model, cfg, tokens=toks, extra_embed=extra).logits
    out = forward(model, cfg, tokens=toks[:, :p], extra_embed=extra, mode="prefill",
                  cache=init_cache(cfg, b, t + cfg.n_patches, torch.float32, device="cpu"))
    steps, cache = [out.logits[:, -1]], out.cache
    for i in range(p, t - 1):
        out = forward(model, cfg, tokens=toks[:, i:i + 1], mode="decode", cache=cache,
                      cache_pos=cfg.n_patches + i)
        steps.append(out.logits[:, -1])
    want = full[:, cfg.n_patches + p - 1:cfg.n_patches + t - 1]
    torch.testing.assert_close(torch.stack(steps, dim=1), want, atol=LOGIT_ATOL, rtol=0)


def _port_leaf(model, path):
    """The port's tensor of the reference's value-tree leaf at ``path``."""
    stacks = {"layers": "layers", "dense_layers": "dense_layers", "enc": "enc_layers",
              "dec": "layers"}
    head, rest = path[0], path[1:]
    if head in stacks:
        return torch.stack([_port_leaf(layer, rest) for layer in getattr(model, stacks[head])])
    if head == "moe" and rest[0] != "shared":
        moe = model.moe
        return moe.router if rest[0] == "router" else getattr(moe, rest[0])
    obj = model
    for name in path:
        obj = obj[name] if isinstance(obj, torch.nn.ModuleDict) else getattr(obj, name)
    return obj


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_copies_every_leaf(arch):
    """Every leaf of the reference's tree lands in one port tensor of the
    same values, and the port has no other parameter: MLA's nine
    parameters, whisper's encoder, decoder, ``ln_x`` / ``xattn`` and
    layernorm biases, qwen2-vl's qkv biases."""
    import jax

    cfg = get_smoke(arch)
    _, _, values = _ref_model(arch)
    model = params_from_reference(values, cfg, "cpu")
    leaves = list(_leaves(values))
    for path, want in leaves:
        np.testing.assert_array_equal(_port_leaf(model, path).numpy(), want,
                                      err_msg=str(path))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree_util.tree_leaves(values))
    names = {path[2] for path, _ in leaves if path[1] in ("attn", "xattn")}
    if arch == "deepseek-v2-236b":
        assert names == {"q_down", "q_norm", "q_up", "kv_down", "kv_norm", "k_pe", "k_up",
                         "v_up", "o"}
    if arch == "whisper-base":
        assert {path[:2] for path, _ in leaves} >= {("enc", "attn"), ("enc_norm", "scale"),
                                                  ("enc_norm", "bias"), ("dec", "ln_x"),
                                                  ("dec", "xattn")}
    if arch == "qwen2-vl-7b":
        assert model.layers[0].attn.k.b is not None


@pytest.mark.parametrize("module", ["Attention", "MLA"])
def test_attention_modules_raise_without_cuda(module):
    """No device and no CUDA: the weights are not quietly made on the CPU,
    which a caller asks for by name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    build = {"Attention": lambda: PA.Attention(32, 4, 2, 8),
             "MLA": lambda: PA.MLA(32, 4, kv_lora=16, q_lora=24, qk_nope=8, qk_rope=4,
                                   v_dim=6)}[module]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def test_whisper_without_frames_fails_as_the_reference():
    """The reference's prefill reads ``frames.astype``: without frames it
    raises AttributeError, and so does the port."""
    import jax.numpy as jnp

    from repro.models.model import forward as ref_forward

    cfg_ref, jvals, values = _ref_model("whisper-base")
    cfg = get_smoke("whisper-base")
    toks = np.ones((1, 4), np.int32)
    with pytest.raises(AttributeError):
        ref_forward(jvals, cfg_ref, tokens=jnp.asarray(toks), mode="prefill")
    with pytest.raises(AttributeError, match="frame embeddings"):
        forward(params_from_reference(values, cfg, "cpu"), cfg, tokens=torch.from_numpy(toks),
                mode="prefill")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _requests(cls, vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(3, vocab, int(rng.integers(4, 12))).astype(np.int32),
                max_new=int(np.clip(rng.zipf(1.5) * 4, 4, 12))) for i in range(n)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_token_streams_equal_reference(arch):
    """Each family served by both engines (deepseek-v2 at one expert slot,
    the reference's ``mesh=None``), whisper and qwen2-vl with
    ``extra_embed``: requests, lanes and token streams equal."""
    from repro.serve.engine import Engine as RefEngine, EngineConfig as RefConfig
    from repro.serve.engine import Request as RefRequest

    cfg_ref, jvals, values = _ref_model(arch)
    cfg = get_smoke(arch)
    ecfg = dict(lanes=3, max_len=40, eos=-1)
    extra = _extra(cfg, ecfg["lanes"], np.random.default_rng(7))
    want = RefEngine(cfg_ref, jvals, RefConfig(**ecfg)).run(
        _requests(RefRequest, cfg.vocab), extra_embed=_jnp(extra))
    eng = Engine(cfg, params_from_reference(values, cfg, "cpu"), EngineConfig(**ecfg),
                 device="cpu")
    got = eng.run(_requests(Request, cfg.vocab), extra_embed=extra)
    assert [(r.rid, r.lane, r.output) for r in got] == \
        [(r.rid, r.lane, r.output) for r in want]


_REFERENCE_M4_ENGINE = textwrap.dedent('''
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.configs import get_smoke
    from repro.models.model import init_model
    from repro.nn import layers as RL
    from repro.serve.engine import Engine, EngineConfig, Request

    out = sys.argv[1]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    cfg = get_smoke("deepseek-v2-236b")
    vals, _ = RL.split(init_model(jax.random.PRNGKey(0), cfg, mesh))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, int(rng.integers(4, 12)))
                    .astype(np.int32), max_new=int(np.clip(rng.zipf(1.5) * 4, 4, 12)))
            for i in range(5)]
    done = Engine(cfg, vals, EngineConfig(lanes=3, max_len=40, eos=-1), mesh=mesh).run(reqs)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a, np.float32)
            for path, a in jax.tree_util.tree_flatten_with_path(vals)[0]}
    np.savez(out + ".npz", **flat)
    with open(out + ".json", "w") as f:
        json.dump([(r.rid, r.lane, r.output) for r in done], f)
''')


def _unflatten(flat):
    tree = {}
    for key, a in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = a
    return tree


def test_deepseek_engine_at_four_slots_equals_reference_mesh(tmp_path):
    """deepseek-v2's smoke twin over four stacked expert slots against the
    reference engine on a (1, 4) mesh (four forced host devices, in a
    subprocess): the same values, requests, lanes and token streams."""
    import json

    out = tmp_path / "ref"
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_M4_ENGINE, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(str(out) + ".npz") as data:
        values = _unflatten({k: data[k] for k in data.files})
    want = [tuple(r) for r in json.loads((tmp_path / "ref.json").read_text())]
    cfg = get_smoke("deepseek-v2-236b")
    model = params_from_reference(values, cfg, "cpu", ep_slots=4)
    assert model.ep_slots == 4
    got = Engine(cfg, model, EngineConfig(lanes=3, max_len=40, eos=-1), device="cpu").run(
        _requests(Request, cfg.vocab))
    assert [(r.rid, r.lane, r.output) for r in got] == [(r, lane, o) for r, lane, o in want]


def test_vlm_engine_decodes_at_the_prompt_length_as_the_reference(monkeypatch):
    """The reference engine sets a lane's position to the prompt's length p
    after a prefill whose stream holds ``n_patches + p`` tokens, so its
    first decode step writes K/V at p, inside the patch block, and M-RoPE
    reads p as a patch id. The port keeps that: the first decode step of a
    lane runs at ``cache_pos == p`` (recorded here), and its token is that
    of a decode at p, not at ``n_patches + p``."""
    from repro_torch.serve import engine as engine_mod

    cfg = get_smoke("qwen2-vl-7b")
    model = init_model(cfg, seed=0, device="cpu")
    extra = _extra(cfg, 1, np.random.default_rng(3))
    prompt = np.arange(3, 10, dtype=np.int32)
    seen = []
    real = engine_mod.forward

    def spy(*args, **kwargs):
        if kwargs.get("mode") == "decode":
            seen.append(int(torch.as_tensor(kwargs["cache_pos"])[0]))
        return real(*args, **kwargs)

    monkeypatch.setattr(engine_mod, "forward", spy)
    done = Engine(cfg, model, EngineConfig(lanes=1, max_len=32, eos=-1), device="cpu").run(
        [Request(rid=0, prompt=prompt, max_new=3)], extra_embed=extra)
    assert seen == [len(prompt), len(prompt) + 1]
    monkeypatch.setattr(engine_mod, "forward", real)

    toks = torch.from_numpy(prompt[None])
    pre = forward(model, cfg, tokens=toks, extra_embed=extra, mode="prefill",
                  cache=init_cache(cfg, 1, 32, torch.float32, device="cpu"))
    first = int(pre.logits[0, -1].argmax())
    step = torch.tensor([[first]])
    at_p = forward(model, cfg, tokens=step, mode="decode", cache=_clone_tree(pre.cache),
                   cache_pos=torch.tensor([len(prompt)]))
    after = forward(model, cfg, tokens=step, mode="decode", cache=_clone_tree(pre.cache),
                    cache_pos=torch.tensor([cfg.n_patches + len(prompt)]))
    assert done[0].output[:2] == [first, int(at_p.logits[0, -1].argmax())]
    assert not torch.allclose(at_p.logits, after.logits), "p and n_patches + p differ"


def test_merge_lane_splices_tuples_on_batch_axis_1():
    """Whisper's cache holds the cross keys and values as a tuple."""
    cache = {"dec": {"self": {"k": torch.zeros(2, 3, 4)}},
             "cross": (torch.zeros(2, 3, 5), torch.zeros(2, 3, 5))}
    new = {"dec": {"self": {"k": torch.ones(2, 3, 4)}},
           "cross": (torch.full((2, 3, 5), 2.0), torch.full((2, 3, 5), 3.0))}
    out = Engine._merge_lane(cache, new, 2)
    assert out is cache
    assert torch.equal(cache["cross"][0][:, 2], torch.full((2, 5), 2.0))
    assert torch.equal(cache["cross"][1][:, 2], torch.full((2, 5), 3.0))
    assert torch.all(cache["cross"][0][:, :2] == 0) and torch.all(cache["dec"]["self"]["k"][:, :2] == 0)


def _launch(arch, module):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    args = [sys.executable, "-m", module, "--arch", arch]
    if module.startswith("repro_torch"):
        args += ["--device", "cpu"]
    return subprocess.run(args, env=env, capture_output=True, text=True, timeout=400)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_serves_the_family_archs_as_the_reference(arch):
    """``--arch`` on the three archs: deepseek-v2 and qwen2-vl serve their
    smoke twins without patches (the reference's launcher builds none) and
    print the reference launcher's plan (24 requests, balance and finish
    ratios 1.010; the token count depends on the weights, which each
    launcher draws itself, and so on where a stream meets eos); whisper-base
    fails with the reference's exception class (its prefill needs frames
    that neither launcher builds)."""
    proc = _launch(arch, "repro_torch.launch.serve")
    if arch == "whisper-base":
        ref = _launch(arch, "repro.launch.serve")
        assert ref.returncode != 0 and "AttributeError" in ref.stderr
        assert proc.returncode != 0 and "AttributeError" in proc.stderr, proc.stderr[-2000:]
        return
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "scheduler=os4m: 24 requests" in proc.stdout
    assert "lane balance ratio 1.010, finish ratio 1.010" in proc.stdout


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _design(cfg, dtype):
    if cfg.mla is not None:
        return fa_ops.design(dtype, cfg.mla.qk_nope + cfg.mla.qk_rope)
    return fa_ops.design(dtype, cfg.resolved_head_dim())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_forward_matches_cpu(arch):
    """Prefill and a per-lane decode step on the card against the CPU, with
    the flash kernel's instance counted in every attention of the prefill
    (whisper: encoder, decoder and cross-attention)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="pallas")
    model = init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 11)))
    extra = _extra(cfg, 2, rng)
    outs = {}
    for dev in ("cpu", "cuda"):
        mdl = model.to(dev)
        before = dict(fa_ops.launches_by_design)
        pre = forward(mdl, cfg, tokens=toks.to(dev), extra_embed=extra, mode="prefill",
                      cache=init_cache(cfg, 2, 32, torch.float32, device=dev))
        dec = forward(mdl, cfg, tokens=toks[:, :1].to(dev), mode="decode", cache=pre.cache,
                      cache_pos=torch.tensor([11 + cfg.n_patches, 5], device=dev))
        rose = {k: fa_ops.launches_by_design[k] - before[k] for k in before}
        outs[dev] = (pre.logits.cpu(), dec.logits.cpu(), rose)
    assert outs["cpu"][2] == {"wgmma": 0, "simt": 0}
    # One launch an attention of the prefill: whisper's encoder layers, and
    # its decoder layers twice (self and cross); the decode step launches none.
    want = cfg.n_enc_layers + 2 * cfg.n_layers if cfg.enc_dec else cfg.n_layers
    assert outs["cuda"][2] == {"wgmma": 0, "simt": 0, _design(cfg, torch.float32): want}
    for i in (0, 1):
        torch.testing.assert_close(outs["cuda"][i], outs["cpu"][i], atol=LOGIT_ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_engine_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="pallas")
    extra = _extra(cfg, 3, np.random.default_rng(7))
    streams = []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, init_model(cfg, seed=0, device="cpu").to(dev),
                     EngineConfig(lanes=3, max_len=48, eos=-1), device=dev)
        before = fa_ops.launches
        streams.append([(r.rid, r.output) for r in eng.run(_requests(Request, cfg.vocab),
                                                           extra_embed=extra)])
        if dev == "cuda":
            assert fa_ops.launches > before
    assert streams[0] == streams[1]
