"""The port's Mamba2 (SSD) layer and the zamba2 hybrid against the reference.

Layer: ``ssd_chunked`` and ``ssd_recurrent_ref`` against the reference's
chunked and recurrent forms (outputs and final states), with and without
an initial state, at lengths on and off a multiple of the chunk, with one
and two B/C groups; ``causal_conv`` with and without a state (a segment
shorter than the kernel too); ``softplus`` exact above 20; the ``Mamba2``
block's forward (with its returned state) and its decode steps against
the reference's ``mamba2`` and ``mamba2_decode``, and decode continuing
the forward.

Model: zamba2's smoke twin (2 groups of 2 Mamba2 layers, the shared
attention block after each) from the reference's random parameters
(``params_from_reference``): train, prefill and decode logits and caches
for each ``attn_impl``, at scalar or per-lane positions; decode continuing
the full forward within the reference's 5e-2 (``tests/test_models.py``);
every parameter's gradient of the train loss against
``jax.value_and_grad``; remat on and off equal; the ``Trainer`` against
the reference's; ``launch/train.py --arch zamba2-2.7b`` on the CPU; and
``launch/serve.py --arch zamba2-2.7b`` refused at ``Engine``, as the
reference's launcher is. On the card (``gpu``): the twin's logits, decode
and training steps against the CPU, kernel 9 in every shared-block
prefill.

Tolerances (float32): layer outputs and states ``atol=1e-5``; logits
``LOGIT_ATOL = 1e-4`` absolute (``tests/test_torch_model.py``); gradients
``atol=1e-5, rtol=1e-4`` and the Trainer's losses, grad norms and lr
``rtol=1e-5`` (``tests/test_torch_train_grad.py``,
``test_torch_trainer.py``); the Trainer's parameters after 4 steps
``atol=1e-4, rtol=1e-4``: a tenth of one AdamW step at lr 1e-3, whose size
for an element with a gradient near AdamW's eps follows that gradient's
float rounding (one element of ``in_proj`` differs by 8.6e-5).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import model as PMDL
from repro_torch.models.config import Shape
from repro_torch.models.convert import params_from_reference
from repro_torch.nn import ssm as PS
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optim import OptConfig

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCH = "zamba2-2.7b"
ATOL = 1e-5
LOGIT_ATOL = 1e-4
G_ATOL, G_RTOL = 1e-5, 1e-4
P_ATOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=8)


def _ref_model(seed=0, **over):
    """The reference's smoke config (with ``over``), values and numpy values."""
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.models.model import init_model as ref_init
    from repro.nn import layers as RL

    cfg_ref = dataclasses.replace(ref_smoke(ARCH), **over)
    vals, _ = RL.split(ref_init(jax.random.PRNGKey(seed), cfg_ref))
    return cfg_ref, vals, jax.tree.map(lambda a: np.asarray(a, np.float32), vals)


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
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), atol=atol,
                                   rtol=0, err_msg=str(path))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# The SSD scan, the conv, softplus
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, b, l, h, p, g, n):
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (rng.random((b, l, h)) * 0.5).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, bm, cm


@pytest.mark.parametrize("l", [32, 21, 5], ids=["on-chunk", "off-chunk", "short"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state"])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_matches_reference(l, with_state, groups):
    """Chunked (chunk 8) and recurrent forms: outputs and final states
    against the reference's both forms."""
    import jax.numpy as jnp

    from repro.nn import ssm as RS

    rng = np.random.default_rng(l * 10 + groups)
    b, h, p, n = 2, 4, 6, 5
    ins = _ssd_inputs(rng, b, l, h, p, groups, n)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else None
    jx = [jnp.asarray(a) for a in ins]
    js0 = None if s0 is None else jnp.asarray(s0)
    ty = [_t(a) for a in ins]
    ts0 = None if s0 is None else _t(s0)
    want_c = RS.ssd_chunked(*jx, 8, init_state=js0)
    want_r = RS.ssd_recurrent_ref(*jx, init_state=js0)
    got_c = PS.ssd_chunked(*ty, 8, init_state=ts0)
    got_r = PS.ssd_recurrent_ref(*ty, init_state=ts0)
    for got in (got_c, got_r):
        for want in (want_c, want_r):
            for g_, w_ in zip(got, want):
                np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=ATOL, rtol=0)


def test_ssd_padding_leaves_the_state_and_grads_finite():
    """A length off the chunk gives the state of the recurrence (the padded
    rows have dt = 0); gradients through the masked decay are finite
    (the exponent is masked, not the exponential)."""
    rng = np.random.default_rng(3)
    x, dt, A, bm, cm = (_t(a).requires_grad_(True)
                        for a in _ssd_inputs(rng, 2, 13, 4, 6, 1, 5))
    dt = (dt * 20).detach().requires_grad_(True)     # steep decays: exp(+) overflows
    y, s = PS.ssd_chunked(x, dt, A, bm, cm, 8)
    _, s_ref = PS.ssd_recurrent_ref(x, dt, A, bm, cm)
    torch.testing.assert_close(s, s_ref, atol=ATOL, rtol=1e-5)
    grads = torch.autograd.grad((y.square().sum() + s.sum()), (x, dt, A, bm, cm))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("l,with_state", [(7, False), (7, True), (2, False), (1, True)])
def test_causal_conv_matches_reference(l, with_state):
    """Outputs and the returned last K-1 inputs (zeros in front of a
    segment shorter than the kernel)."""
    import jax.numpy as jnp

    from repro.nn import ssm as RS

    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state else None
    want = RS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                           state=None if st is None else jnp.asarray(st))
    got = PS.causal_conv(_t(x), _t(w), _t(bias), state=None if st is None else _t(st))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-6, rtol=0)


def test_softplus_matches_reference_across_the_torch_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port's too, within two
    float32 ulps, around ``F.softplus``'s threshold of 20 and far past it."""
    import jax

    x = np.concatenate([np.linspace(-40, 40, 801), [19.99, 20.0, 20.01, 88.0]]).astype(
        np.float32)
    np.testing.assert_allclose(PS.softplus(_t(x)).numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=2.5e-7, atol=0)


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------


def _load_by_name(module, vals):
    """Copy the reference's value tree into ``module``: a parameter named
    ``a.b`` holds the leaf ``vals["a"]["b"]``."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = vals
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(_t(leaf))
    return module


def _block(seed=0):
    """The smoke config's Mamba2 args, the reference's block values and the
    port's block holding them."""
    import jax

    from repro.nn import layers as RL
    from repro.nn import ssm as RS

    a = get_smoke(ARCH).ssm
    vals, _ = RL.split(RS.init_mamba2(jax.random.PRNGKey(seed), a))
    return a, vals, _load_by_name(PS.Mamba2(a, device="cpu"), vals)


@pytest.mark.parametrize("l", [21])
def test_mamba2_block_and_decode_match_reference(l):
    """Forward with its returned state (from a given state too), then three
    decode steps from it, against the reference's ``mamba2`` and
    ``mamba2_decode``; the decode steps equal the forward over the longer
    sequence."""
    import jax.numpy as jnp

    from repro.nn import ssm as RS

    a, vals, block = _block()
    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l + 3, a.d_model)).astype(np.float32)
    want, wstate = RS.mamba2(vals, jnp.asarray(x[:, :l]), a, return_state=True)
    got, gstate = PS.mamba2(block, _t(x[:, :l]), return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    _assert_trees_close(gstate, wstate, ATOL)
    full = PS.mamba2(block, _t(x))
    for i in range(3):
        step = jnp.asarray(x[:, l + i:l + i + 1])
        want, wstate = RS.mamba2_decode(vals, step, a, wstate)
        got, gstate = PS.mamba2_decode(block, _t(x[:, l + i:l + i + 1]), gstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        _assert_trees_close(gstate, wstate, ATOL)
        torch.testing.assert_close(got, full[:, l + i:l + i + 1], atol=ATOL, rtol=0)
    # A second segment from the state equals the reference's.
    want2 = RS.mamba2(vals, jnp.asarray(x), a, init_state=wstate["ssm"],
                      conv_state=wstate["conv"])
    got2 = PS.mamba2(block, _t(x), init_state=gstate["ssm"], conv_state=gstate["conv"])
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


@pytest.mark.parametrize("impl,per_lane", [("blocked", True), ("pallas", False),
                                           ("naive", True)],
                         ids=["blocked-per-lane", "pallas-scalar", "naive-per-lane"])
def test_zamba_logits_and_states_match_reference(impl, per_lane):
    """Train logits (no cache); prefill logits and the returned cache (the
    Mamba2 states from zero, the shared block's per-group keys and values;
    the caller's cache untouched), also without a cache; then a decode step
    at scalar or per-lane positions, logits and cache (written in place)."""
    import jax.numpy as jnp

    from repro.models.model import forward as ref_forward, init_cache as ref_cache

    over = dict(attn_impl=impl, attn_block_q=4, attn_block_k=4)
    cfg_ref, jvals, values = _ref_model(**over)
    cfg = dataclasses.replace(get_smoke(ARCH), **over)
    model = params_from_reference(values, cfg, "cpu")
    rng = np.random.default_rng(7)
    b, t, max_len = 3, 19, 24
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)

    want = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(toks))
    got = PMDL.forward(model, cfg, tokens=torch.from_numpy(toks))
    assert got.cache is None and want.cache is None
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=LOGIT_ATOL,
                               rtol=0)

    bare = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(toks), mode="prefill")
    got = PMDL.forward(model, cfg, tokens=torch.from_numpy(toks), mode="prefill")
    _assert_trees_close(got.cache, bare.cache, ATOL)
    assert got.cache["attn"] == {}

    r_pre = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(toks), mode="prefill",
                        cache=ref_cache(cfg_ref, b, max_len, jnp.float32),
                        cache_pos=jnp.int32(0))
    cache = PMDL.init_cache(cfg, b, max_len, torch.float32, device="cpu")
    p_pre = PMDL.forward(model, cfg, tokens=torch.from_numpy(toks), mode="prefill", cache=cache)
    np.testing.assert_allclose(p_pre.logits.numpy(), np.asarray(r_pre.logits),
                               atol=LOGIT_ATOL, rtol=0)
    assert all(torch.all(a == 0) for _, a in _leaves(cache)), "prefill left the cache as it was"
    _assert_trees_close(p_pre.cache, r_pre.cache, ATOL)

    nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    pos = np.array([t, t - 4, t + 2], np.int32) if per_lane else np.int32(t)
    r_dec = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(nxt), mode="decode",
                        cache=r_pre.cache, cache_pos=jnp.asarray(pos))
    given = _clone_tree(p_pre.cache)
    p_dec = PMDL.forward(model, cfg, tokens=torch.from_numpy(nxt), mode="decode", cache=given,
                         cache_pos=torch.as_tensor(pos))
    np.testing.assert_allclose(p_dec.logits.numpy(), np.asarray(r_dec.logits),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_trees_close(p_dec.cache, r_dec.cache, ATOL)
    _assert_trees_close(given, r_dec.cache, ATOL)          # written in place


def test_zamba_decode_continues_the_full_forward():
    """The reference's decode parity (``tests/test_models.py``): prefill 8
    tokens, decode 4, against the train-mode forward of the 12, within its
    5e-2; and within LOGIT_ATOL, as float32 gives."""
    cfg = get_smoke(ARCH)
    model = PMDL.init_model(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)))
    full = PMDL.forward(model, cfg, tokens=toks).logits
    out = PMDL.forward(model, cfg, tokens=toks[:, :8], mode="prefill",
                       cache=PMDL.init_cache(cfg, 2, 12, torch.float32, device="cpu"),
                       cache_pos=0)
    logits, cache = [out.logits], out.cache
    for t in range(8, 12):
        out = PMDL.forward(model, cfg, tokens=toks[:, t:t + 1], mode="decode", cache=cache,
                           cache_pos=t)
        logits.append(out.logits)
    err = float((torch.cat(logits, dim=1) - full).abs().max())
    assert err < 5e-2 and err < LOGIT_ATOL, err


def test_params_from_reference_copies_every_leaf():
    """Every leaf of the reference's tree (``mamba`` (groups, k, ...), the
    unstacked ``shared_attn``) lands in the port's tensor of the same
    values, and the port has no other parameter."""
    import jax

    cfg = get_smoke(ARCH)
    _, _, values = _ref_model()
    model = params_from_reference(values, cfg, "cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree_util.tree_leaves(values))
    mixer = values["mamba"]["mixer"]
    for g, group in enumerate(model.mamba):
        for i, layer in enumerate(group):
            np.testing.assert_array_equal(layer.mixer.A_log.numpy(), mixer["A_log"][g, i])
            np.testing.assert_array_equal(layer.mixer.in_proj.w.numpy(),
                                          mixer["in_proj"]["w"][g, i])
            np.testing.assert_array_equal(layer.ln.scale.numpy(),
                                          values["mamba"]["ln"]["scale"][g, i])
    np.testing.assert_array_equal(model.shared_attn.attn.q.w.numpy(),
                                  values["shared_attn"]["attn"]["q"]["w"])
    np.testing.assert_array_equal(model.shared_attn.mlp.gate.w.numpy(),
                                  values["shared_attn"]["mlp"]["gate"]["w"])
    bad = jax.tree.map(lambda a: a, values)
    bad["mamba"]["mixer"]["conv_w"] = bad["mamba"]["mixer"]["conv_w"][:, :, :2]
    with pytest.raises(ValueError, match="conv_w: shape"):
        params_from_reference(bad, cfg, "cpu")


def test_init_model_scales_and_dtypes():
    """bf16 weights but float32 ``A_log``, ``D`` and ``dt_bias``, as the
    reference's init; ``A_log = log(linspace(1, 16, heads))``."""
    cfg = dataclasses.replace(get_smoke(ARCH), param_dtype="bfloat16")
    model = PMDL.init_model(cfg, seed=0, device="cpu")
    mixer = model.mamba[1][0].mixer
    assert mixer.in_proj.w.dtype == torch.bfloat16 and mixer.A_log.dtype == torch.float32
    torch.testing.assert_close(mixer.A_log, torch.log(torch.linspace(1, 16, cfg.ssm.n_heads)))
    assert torch.all(mixer.D == 1) and torch.all(mixer.dt_bias == 0)
    assert abs(float(mixer.conv_w.float().std()) / 0.2 - 1) < 0.1


def _ref_loss_and_grads(cfg_ref, vals, toks):
    import jax
    import jax.numpy as jnp

    from repro.models import model as RMDL

    def loss_for(p):
        out = RMDL.forward(p, cfg_ref, tokens=jnp.asarray(toks), mode="train")
        return RMDL.lm_loss(out.logits[:, :-1], jnp.asarray(toks)[:, 1:])

    total, grads = jax.jit(jax.value_and_grad(loss_for))(vals)
    return float(total), jax.tree.map(lambda a: np.asarray(a, np.float32), grads)


def _port_loss_and_grads(model, cfg, toks):
    tokens = torch.from_numpy(toks)
    out = PMDL.forward(model, cfg, tokens=tokens, mode="train")
    total = PMDL.lm_loss(out.logits[:, :-1], tokens[:, 1:])
    names, params = zip(*model.named_parameters())
    return float(total.detach()), dict(zip(names, torch.autograd.grad(total, params)))


def test_zamba_loss_and_grads_match_reference():
    """The loss and every parameter's gradient against the reference's
    ``jax.value_and_grad`` (a length of 37: the chunk loop pads)."""
    cfg_ref, jvals, values = _ref_model()
    cfg = get_smoke(ARCH)
    toks = np.random.default_rng(0).integers(3, cfg.vocab, (2, 37)).astype(np.int32)
    want_total, want_grads = _ref_loss_and_grads(cfg_ref, jvals, toks)
    model = params_from_reference(values, cfg, "cpu").requires_grad_(True)
    got_total, got_grads = _port_loss_and_grads(model, cfg, toks)
    np.testing.assert_allclose(got_total, want_total, rtol=1e-5)
    ref_grads = dict(params_from_reference(want_grads, cfg, "cpu").named_parameters())
    assert set(ref_grads) == set(got_grads)
    for name, g in got_grads.items():
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), ref_grads[name].detach().numpy(), atol=G_ATOL,
                                   rtol=G_RTOL, err_msg=f"d/d {name}")


def test_remat_on_and_off_give_equal_grads():
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(get_smoke(ARCH), remat=remat)
        model = PMDL.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
        toks = np.random.default_rng(1).integers(3, cfg.vocab, (2, 20)).astype(np.int32)
        out.append(_port_loss_and_grads(model, cfg, toks))
    (t0, g0), (t1, g1) = out
    assert t0 == t1
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_trainer_matches_reference(tmp_path):
    """Four steps of the smoke twin from the reference Trainer's initial
    weights on the same packed batches: every step's loss, grad norm and
    lr, and the final parameters."""
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.data.synthetic import CorpusConfig, token_batches
    from repro.launch.mesh import single_device_mesh
    from repro.models.config import Shape as RShape
    from repro.train import loop as RL
    from repro.train.optim import OptConfig as ROpt

    cfg = get_smoke(ARCH)
    tk = dict(ckpt_every=1000, log_every=100)
    ref = RL.Trainer(ref_smoke(ARCH), RShape("t", "train", 32, 2), single_device_mesh(),
                     opt_cfg=ROpt(**OPT), tcfg=RL.TrainerConfig(ckpt_dir=str(tmp_path / "r"),
                                                                **tk))
    np_tree = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    port = Trainer(cfg, Shape("t", "train", 32, 2),
                   model=params_from_reference(np_tree(ref.params), cfg, device="cpu"),
                   opt_cfg=OptConfig(**OPT),
                   tcfg=TrainerConfig(ckpt_dir=str(tmp_path / "p"), **tk))
    it = token_batches(CorpusConfig(vocab=cfg.vocab), seed=0, batch=2, seq_len=32)
    batches = [next(it) for _ in range(4)]
    ref.run(iter(batches), 4)
    port.run(iter(batches), 4)
    assert [s for s, _ in port.history] == [s for s, _ in ref.history] == [1, 2, 3, 4]
    for (step, g), (_, w) in zip(port.history, ref.history):
        for key in ("loss", "grad_norm", "lr", "total_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=f"{key} @ {step}")
    want = dict(params_from_reference(np_tree(ref.params), cfg, device="cpu").named_parameters())
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   atol=P_ATOL, rtol=G_RTOL, err_msg=name)


def _run(module, *args, timeout=300):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_launcher_trains_zamba_on_the_cpu(tmp_path):
    proc = _run("repro_torch.launch.train", "--arch", ARCH, "--device", "cpu", "--steps", "10",
                "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("step    10  loss ") and "nan" not in lines[0]
    assert lines[-1] == f"done at step 10; checkpoints in {tmp_path}"


def test_serve_launcher_refuses_zamba_at_the_engine_as_the_reference():
    """Both launchers build the smoke twin and fail at ``Engine``: state-based
    archs decode from their state, not through the KV-lane engine."""
    from repro_torch.serve.engine import Engine, EngineConfig

    with pytest.raises(ValueError, match="state-based archs use the decode step directly"):
        Engine(get_smoke(ARCH), PMDL.init_model(get_smoke(ARCH), device="cpu"),
               EngineConfig(lanes=2), device="cpu")
    port = _run("repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu")
    ref = _run("repro.launch.serve", "--arch", ARCH)
    for proc in (port, ref):
        assert proc.returncode != 0
        assert "state-based archs use the decode step directly" in proc.stderr, \
            proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_zamba_matches_cpu(tmp_path):
    """The smoke twin on the card against the CPU: prefill logits and
    states, a per-lane decode step, kernel 9 launched once a group in the
    prefill (the shared block, simt at head dim 16); two training steps'
    losses within 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_smoke(ARCH), attn_impl="pallas")
    model = PMDL.init_model(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 21)))
    outs = {}
    for dev in ("cpu", "cuda"):
        mdl = model.to(dev)
        before = fa_ops.launches
        pre = PMDL.forward(mdl, cfg, tokens=toks.to(dev), mode="prefill",
                           cache=PMDL.init_cache(cfg, 2, 32, torch.float32, device=dev))
        launched = fa_ops.launches - before
        dec = PMDL.forward(mdl, cfg, tokens=toks[:, :1].to(dev), mode="decode",
                           cache=pre.cache, cache_pos=torch.tensor([21, 5], device=dev))
        outs[dev] = (pre.logits.cpu(), dec.logits.cpu(), dec.cache["mamba"]["ssm"].cpu(),
                     launched)
    assert outs["cpu"][3] == 0 and outs["cuda"][3] == cfg.n_layers // cfg.attn_every
    for i in (0, 1, 2):
        torch.testing.assert_close(outs["cuda"][i], outs["cpu"][i], atol=LOGIT_ATOL, rtol=0)
    cfg = get_smoke(ARCH)
    batch = np.random.default_rng(1).integers(3, cfg.vocab, (2, 32)).astype(np.int32)
    hist = {}
    for dev in ("cpu", "cuda"):
        t = Trainer(cfg, Shape("t", "train", 32, 2),
                    model=PMDL.init_model(cfg, seed=0, device="cpu").to(dev),
                    opt_cfg=OptConfig(**OPT),
                    tcfg=TrainerConfig(ckpt_dir=str(tmp_path / dev), ckpt_every=1000))
        t.run(iter([batch, batch]), 2)
        hist[dev] = [m["loss"] for _, m in t.history]
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-4)
