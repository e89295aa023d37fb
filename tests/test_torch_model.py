"""The port's configurations and decoder against the reference's.

Configurations: each of the ten architectures, full and smoke, equal to the
reference's field by field. Model: the reference's random parameters
(``init_model`` with a JAX key, as numpy float32) loaded into the port by
``params_from_reference``, then the same numpy tokens through both
``forward``s: prefill logits, and per-lane decode logits against the
prefilled cache, for each ``attn_impl``, in float32 (the dense configs;
``test_torch_moe.py`` and ``test_torch_families.py`` hold the others).

Tolerance 1e-4 absolute on logits of magnitude ~5 (float32 through two
layers; the two frameworks sum in other orders, observed ~3e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from repro_torch.models import config as port_config
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import forward, init_cache, init_model

LOGIT_ATOL = 1e-4
DENSE = ["llama3-8b", "smollm-360m", "starcoder2-3b", "qwen1.5-32b"]


def _ref_values(cfg_ref, seed=0):
    import jax

    from repro.models.model import init_model as ref_init
    from repro.nn import layers as RL

    values, _ = RL.split(ref_init(jax.random.PRNGKey(seed), cfg_ref))
    as_np = jax.tree.map(lambda a: np.asarray(a, np.float32), values)
    return values, as_np


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", port_configs.ARCH_IDS)
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_equals_reference(arch, which):
    from repro import configs as ref_configs

    get_ref = ref_configs.get_config if which == "config" else ref_configs.get_smoke
    get_port = port_configs.get_config if which == "config" else port_configs.get_smoke
    ref, port = get_ref(arch), get_port(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.resolved_head_dim() == ref.resolved_head_dim()
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def test_aliases_shapes_and_args_equal_reference():
    from repro import configs as ref_configs
    from repro.models import config as ref_config
    from repro.nn import moe, ssm, xlstm

    from repro_torch.nn import moe as pmoe, ssm as pssm, xlstm as pxlstm

    assert port_configs.ALIASES == ref_configs.ALIASES
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in port_config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_config.SHAPES.items()}
    for ref_cls, port_cls in ((moe.MoEArgs, pmoe.MoEArgs), (ssm.SSMArgs, pssm.SSMArgs),
                              (xlstm.XLSTMArgs, pxlstm.XLSTMArgs),
                              (ref_config.MLAArgs, port_config.MLAArgs)):
        assert [(f.name, f.default) for f in dataclasses.fields(port_cls)] == \
            [(f.name, f.default) for f in dataclasses.fields(ref_cls)]
    for arch in port_configs.ARCH_IDS:
        for shape in port_config.SHAPES.values():
            ref_shape = ref_config.SHAPES[shape.name]
            assert port_config.shape_applicable(port_configs.get_config(arch), shape) == \
                ref_config.shape_applicable(ref_configs.get_config(arch), ref_shape)
    with pytest.raises(ValueError, match="unknown arch"):
        port_configs.get_config("gpt-5")


# ---------------------------------------------------------------------------
# Conversion and forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_reference_copies_every_leaf(arch):
    import jax

    cfg = port_configs.get_smoke(arch)
    _, values = _ref_values(cfg)
    model = params_from_reference(values, cfg, "cpu")
    leaves = jax.tree_util.tree_leaves(values)
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for a in leaves)
    np.testing.assert_array_equal(model.embed.w.numpy(), values["embed"]["w"])
    np.testing.assert_array_equal(model.lm_head.w.numpy(), values["lm_head"]["w"])
    last = model.layers[-1]
    np.testing.assert_array_equal(last.attn.q.w.numpy(), values["layers"]["attn"]["q"]["w"][-1])
    np.testing.assert_array_equal(last.mlp.down.w.numpy(), values["layers"]["mlp"]["down"]["w"][-1])
    if cfg.qkv_bias:
        np.testing.assert_array_equal(last.attn.k.b.numpy(),
                                      values["layers"]["attn"]["k"]["b"][-1])
    if cfg.norm == "layernorm":
        np.testing.assert_array_equal(last.ln2.bias.numpy(), values["layers"]["ln2"]["bias"][-1])
    assert (last.mlp.gate is None) == (not cfg.gated_mlp)


def test_params_from_reference_takes_only_numpy():
    import jax.numpy as jnp

    cfg = port_configs.get_smoke("llama3-8b")
    _, values = _ref_values(cfg)
    values["embed"]["w"] = jnp.asarray(values["embed"]["w"])
    with pytest.raises(TypeError, match="numpy"):
        params_from_reference(values, cfg, "cpu")


@pytest.mark.parametrize("impl", ["blocked", "pallas", "naive"])
@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("per_lane", [True, False], ids=["per-lane", "scalar"])
def test_prefill_and_decode_logits_match_reference(arch, impl, per_lane):
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models.model import forward as ref_forward, init_cache as ref_cache

    cfg_ref = dataclasses.replace(ref_configs.get_smoke(arch), attn_impl=impl,
                                  attn_block_q=4, attn_block_k=4)
    cfg = dataclasses.replace(port_configs.get_smoke(arch), attn_impl=impl,
                              attn_block_q=4, attn_block_k=4)
    jvals, values = _ref_values(cfg_ref)
    model = params_from_reference(values, cfg, "cpu")
    rng = np.random.default_rng(len(arch))
    b, t, max_len = 3, 9, 16
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    r_pre = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(toks), mode="prefill",
                        cache=ref_cache(cfg_ref, b, max_len, jnp.float32),
                        cache_pos=jnp.int32(0))
    cache = init_cache(cfg, b, max_len, torch.float32, device="cpu")
    p_pre = forward(model, cfg, tokens=torch.from_numpy(toks), mode="prefill", cache=cache)
    np.testing.assert_allclose(p_pre.logits.numpy(), np.asarray(r_pre.logits),
                               atol=LOGIT_ATOL)
    assert torch.all(cache["layers"]["self"]["k"] == 0), "prefill left the cache as it was"
    np.testing.assert_allclose(p_pre.cache["layers"]["self"]["k"].numpy(),
                               np.asarray(r_pre.cache["layers"]["self"]["k"]), atol=1e-5)

    nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    # Per-lane write positions (continuous batching) or one for all lanes.
    pos = np.array([t, t - 4, t + 2], np.int32) if per_lane else np.int32(t)
    r_dec = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(nxt), mode="decode",
                        cache=r_pre.cache, cache_pos=jnp.asarray(pos))
    p_dec = forward(model, cfg, tokens=torch.from_numpy(nxt), mode="decode",
                    cache=p_pre.cache, cache_pos=torch.as_tensor(pos))
    np.testing.assert_allclose(p_dec.logits.numpy(), np.asarray(r_dec.logits),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(p_dec.cache["layers"]["self"]["v"].numpy(),
                               np.asarray(r_dec.cache["layers"]["self"]["v"]), atol=1e-5)


def test_train_mode_matches_reference_without_cache():
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models.model import forward as ref_forward

    cfg = port_configs.get_smoke("starcoder2-3b")
    jvals, values = _ref_values(ref_configs.get_smoke("starcoder2-3b"), seed=3)
    model = params_from_reference(values, cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want = ref_forward(jvals, ref_configs.get_smoke("starcoder2-3b"),
                       tokens=jnp.asarray(toks)).logits
    got = forward(model, cfg, tokens=torch.from_numpy(toks))
    assert got.cache is None
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# Random init, cache layout, what is not ported
# ---------------------------------------------------------------------------


def test_init_model_uses_the_reference_scales():
    cfg = dataclasses.replace(port_configs.get_smoke("llama3-8b"), d_model=256, d_ff=512,
                              n_heads=8, n_kv=4, vocab=1024)
    model = init_model(cfg, seed=0, device="cpu")
    again = init_model(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    layer = model.layers[0]
    for w, d_in in ((layer.attn.q.w, 256), (layer.mlp.down.w, 512), (model.lm_head.w, 256),
                    (model.embed.w, 256)):
        assert abs(float(w.std()) / d_in ** -0.5 - 1) < 0.05
        assert abs(float(w.mean())) < 0.1 * d_in ** -0.5
    assert torch.all(layer.ln1.scale == 1) and torch.all(model.final_norm.scale == 1)
    bf = init_model(dataclasses.replace(cfg, param_dtype="bfloat16"), seed=0, device="cpu")
    assert bf.embed.w.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", DENSE + ["deepseek-v2-236b", "whisper-base", "qwen2-vl-7b",
                                  "zamba2-2.7b", "xlstm-1.3b"])
def test_cache_layout_equals_reference(arch):
    """Every leaf of the cache (MLA's compressed ``c_kv`` / ``k_pe``,
    whisper's ``dec`` part and ``cross`` tuple, zamba2's Mamba2 states and
    shared-block keys and values, xLSTM's mLSTM and sLSTM states) has the
    reference's path, shape, type and values: zeros of the asked type
    (float32 and bfloat16) for keys and values, float32 states, every
    stabiliser ``m`` at -1e30."""
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models.model import init_cache as ref_cache

    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = ref_cache(ref_configs.get_smoke(arch), 3, 20, jdtype)
        port = init_cache(port_configs.get_smoke(arch), 3, 20, dtype, device="cpu")
        want = jax.tree_util.tree_flatten_with_path(ref)[0]
        got = jax.tree_util.tree_flatten_with_path(
            port, is_leaf=lambda a: isinstance(a, torch.Tensor))[0]
        assert [(jax.tree_util.keystr(p), tuple(a.shape)) for p, a in got] == \
            [(jax.tree_util.keystr(p), a.shape) for p, a in want]
        for (path, a), (_, b) in zip(got, want):
            assert str(a.dtype) == f"torch.{b.dtype}", jax.tree_util.keystr(path)
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        state_based = arch in ("zamba2-2.7b", "xlstm-1.3b")
        assert state_based or all(a.dtype == dtype and not torch.any(a) for _, a in got)


@pytest.mark.parametrize("arch,item", [
    ("grok-1-314b", 11), ("deepseek-v2-236b", 12), ("zamba2-2.7b", 12),
    ("xlstm-1.3b", 12), ("whisper-base", 12), ("qwen2-vl-7b", 12)])
def test_unported_families_name_their_item(arch, item):
    """The test keeps its name and its six cases from when the port refused
    these families, each naming its ROADMAP item. All are ported now: the
    MoE family (item 11, grok-1), the attention families of item 12
    (deepseek-v2's MLA, whisper's encoder-decoder, qwen2-vl's M-RoPE and
    patches) and its state-based families (zamba2's Mamba2 with the shared
    attention block, xLSTM's mLSTM and sLSTM). Each case holds the prefill
    logits (and grok-1's and deepseek-v2's expert counts, and zamba2's and
    xlstm's returned states) equal to the reference's."""
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models.model import forward as ref_forward

    cfg_ref = ref_configs.get_smoke(arch)
    jvals, values = _ref_values(cfg_ref)
    cfg = port_configs.get_smoke(arch)
    model = params_from_reference(values, cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    extra = None
    if cfg.n_patches or cfg.enc_dec:
        rows = cfg.n_patches or cfg.enc_len
        extra = rng.standard_normal((2, rows, cfg.d_model)).astype(np.float32)
    want = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(toks), mode="prefill",
                       extra_embed=None if extra is None else jnp.asarray(extra))
    got = forward(model, cfg, tokens=torch.from_numpy(toks), mode="prefill",
                  extra_embed=extra)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=LOGIT_ATOL, rtol=0)
    if cfg.moe is not None:
        np.testing.assert_array_equal(got.stats["expert_counts"].numpy(),
                                      np.asarray(want.stats["expert_counts"]))
    if cfg.ssm is not None or cfg.xlstm is not None:
        import jax

        want_states = jax.tree_util.tree_leaves(want.cache)
        got_states = jax.tree_util.tree_leaves(
            got.cache, is_leaf=lambda a: isinstance(a, torch.Tensor))
        assert len(got_states) == len(want_states) > 0
        for a, b in zip(got_states, want_states):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("builder", ["init_model", "init_cache", "params_from_reference"])
def test_model_builders_raise_without_cuda(builder):
    """No device and no CUDA: the model and its cache are not quietly built
    on the CPU, which a caller asks for by name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg = port_configs.get_smoke("llama3-8b")
    build = {
        "init_model": lambda: init_model(cfg, seed=0),
        "init_cache": lambda: init_cache(cfg, 2, 8, torch.float32),
        "params_from_reference": lambda: params_from_reference({}, cfg),
    }[builder]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


@pytest.mark.gpu
def test_forward_on_gpu_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(port_configs.get_smoke("llama3-8b"), attn_impl="pallas")
    model = init_model(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 11)))
    want = forward(model, cfg, tokens=toks, mode="prefill").logits
    gpu = model.to("cuda")
    got = forward(gpu, cfg, tokens=toks.cuda(), mode="prefill").logits
    torch.testing.assert_close(got.cpu(), want, atol=LOGIT_ATOL, rtol=0)
