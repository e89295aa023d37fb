"""The port's xLSTM layers (mLSTM, sLSTM) and the xlstm model against the
reference.

Layers: ``mlstm_cell_chunked`` and ``mlstm_cell_recurrent_ref`` against the
reference's chunked and recurrent forms (outputs and the ``(C, n, m)``
state), with and without an initial state, at lengths on and off a
multiple of the chunk (the padded ``log_i`` of -1e30 leaves the state as
it was); the sLSTM on both of its scan branches (64-step chunks, each
recomputed in the backward, when 64 divides a length above 64; one loop
otherwise), with and without a state, outputs, states and gradients; the
mLSTM block's forward and decode steps against the reference's ``mlstm``
and ``mlstm_decode``, and decode continuing the forward, for both blocks.

Model: xlstm's smoke twin (2 groups of 1 mLSTM + 1 sLSTM) from the
reference's random parameters (``params_from_reference``): train,
prefill and decode logits and caches (the sLSTM's prefill from the cache
it is given, as the reference); decode continuing the full forward within
the reference's 5e-2 (``tests/test_models.py``); every parameter's
gradient against ``jax.value_and_grad``; remat on and off equal; the
``Trainer`` against the reference's; ``launch/train.py --arch xlstm-1.3b``
on the CPU; each package's bf16 logits against its own float32 from the
same weights, the port's gap within ``BF16_GAP_RATIO`` (1.25) of the
reference's. On the card (``gpu``): the twin's logits, decode and training
steps against the CPU.

Tolerances (float32): layer outputs and states ``atol=1e-5, rtol=1e-5``
(the cells' outputs and normalisers grow with the exponential input
gates: up to ~45 in the cell cases, whose two orders of summation differ
by up to 9e-6 relative); logits ``LOGIT_ATOL = 1e-4`` absolute
(``tests/test_torch_model.py``); gradients ``atol=1e-5, rtol=1e-4``; the
Trainer's losses and lr ``rtol=1e-5``, its grad norms ``rtol=1e-4`` (step
4's differs by 5.5e-5 relative, after three AdamW steps whose size for
an element with a gradient near eps follows that gradient's float
rounding) and its parameters after 4 steps ``atol=1e-4, rtol=1e-4``
(``tests/test_torch_ssm.py``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import model as PMDL
from repro_torch.models.config import Shape
from repro_torch.models.convert import params_from_reference
from repro_torch.nn import xlstm as PX
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optim import OptConfig

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCH = "xlstm-1.3b"
ATOL = 1e-5
S_RTOL = 1e-5
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


def _assert_trees_close(port, ref, atol, rtol=S_RTOL):
    got, want = list(_leaves(port)), list(_leaves(ref))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), atol=atol,
                                   rtol=rtol, err_msg=str(path))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# The mLSTM cell
# ---------------------------------------------------------------------------


def _cell_inputs(rng, b, l, h, d):
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    log_i = rng.standard_normal((b, l, h)).astype(np.float32) * 2
    log_f = np.log(1 / (1 + np.exp(-(rng.standard_normal((b, l, h)) + 2)))).astype(np.float32)
    return q, k, v, log_i, log_f


def _cell_state(rng, b, h, d):
    return (rng.standard_normal((b, h, d, d)).astype(np.float32),
            rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32))


def _assert_cell_close(got, want, rtol=S_RTOL):
    h_got, (c_got, n_got, m_got) = got
    h_want, (c_want, n_want, m_want) = want
    for g, w in ((h_got, h_want), (c_got, c_want), (n_got, n_want), (m_got, m_want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=rtol)


@pytest.mark.parametrize("l", [32, 21, 5], ids=["on-chunk", "off-chunk", "short"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state"])
def test_mlstm_cell_matches_reference(l, with_state):
    """Chunked (chunk 8) and recurrent forms, outputs and states, each
    against the reference's same form; the chunked against the recurrent
    within ``rtol=1e-4`` (the two forms sum in other orders: the
    reference's own two differ by up to 1.4e-5 relative here)."""
    import jax.numpy as jnp

    from repro.nn import xlstm as RX

    rng = np.random.default_rng(l)
    b, h, d = 2, 3, 6
    ins = _cell_inputs(rng, b, l, h, d)
    st = _cell_state(rng, b, h, d) if with_state else None
    jx = [jnp.asarray(a) for a in ins]
    jst = None if st is None else tuple(jnp.asarray(a) for a in st)
    tx = [_t(a) for a in ins]
    tst = None if st is None else tuple(_t(a) for a in st)
    want_c = RX.mlstm_cell_chunked(*jx, 8, state=jst)
    want_r = RX.mlstm_cell_recurrent_ref(*jx, state=jst)
    got_c = PX.mlstm_cell_chunked(*tx, 8, state=tst)
    got_r = PX.mlstm_cell_recurrent_ref(*tx, state=tst)
    _assert_cell_close(got_c, want_c)
    _assert_cell_close(got_r, want_r)
    _assert_cell_close(got_c, got_r, rtol=1e-4)


def test_mlstm_padding_keeps_the_state_and_grads_finite():
    """Off the chunk, the chunked state equals the recurrence's (the padded
    input gates are -1e30), and gradients through the -1e30 masks and the
    running max are finite."""
    rng = np.random.default_rng(4)
    ins = [_t(a).requires_grad_(True) for a in _cell_inputs(rng, 2, 13, 2, 4)]
    h, (c, n, m) = PX.mlstm_cell_chunked(*ins, 8)
    _, (c_r, n_r, m_r) = PX.mlstm_cell_recurrent_ref(*ins)
    for a, b in ((c, c_r), (n, n_r), (m, m_r)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=1e-5)
    grads = torch.autograd.grad(h.square().sum() + c.sum() + n.sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# The sLSTM and the blocks
# ---------------------------------------------------------------------------


def _blocks(seed=0):
    """The smoke config's xLSTM args, the reference's mLSTM and sLSTM values
    and the port's blocks holding them."""
    import jax

    from repro.nn import layers as RL
    from repro.nn import xlstm as RX

    a = get_smoke(ARCH).xlstm
    mv, _ = RL.split(RX.init_mlstm(jax.random.PRNGKey(seed), a))
    sv, _ = RL.split(RX.init_slstm(jax.random.PRNGKey(seed + 1), a))
    return (a, mv, sv, _load_by_name(PX.MLSTM(a, device="cpu"), mv),
            _load_by_name(PX.SLSTM(a, device="cpu"), sv))


@pytest.mark.parametrize("l", [128, 100, 64], ids=["two-level", "single-off", "single-64"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state"])
def test_slstm_both_scan_branches_match_reference(l, with_state):
    """Output, final state and the input's gradient against the
    reference's ``slstm`` (jitted; its two-level scan at l = 128)."""
    import jax
    import jax.numpy as jnp

    from repro.nn import xlstm as RX

    a, _, sv, _, block = _blocks()
    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l, a.d_model)).astype(np.float32)
    shape = (2, a.n_heads, a.s_head_dim)
    st = None
    if with_state:
        st = tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3)) + (
            rng.standard_normal(shape).astype(np.float32),)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def ref(x_):
        y, s = RX.slstm(sv, x_, a, state=None if st is None else tuple(map(jnp.asarray, st)),
                        return_state=True)
        return jnp.sum(y * ct), (y, s)

    (_, (want_y, want_s)), want_gx = jax.jit(jax.value_and_grad(ref, has_aux=True))(
        jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    got_y, got_s = PX.slstm(block, tx, state=None if st is None else tuple(map(_t, st)),
                            return_state=True)
    (got_gx,) = torch.autograd.grad(torch.sum(got_y * _t(ct)), tx)
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y), atol=ATOL, rtol=0)
    _assert_trees_close(tuple(s.detach() for s in got_s), want_s, ATOL)
    np.testing.assert_allclose(got_gx.numpy(), np.asarray(want_gx), atol=G_ATOL, rtol=G_RTOL)


def test_blocks_decode_match_reference_and_continue_the_forward():
    """The mLSTM block's forward with its state, then three decode steps,
    against the reference's ``mlstm`` and ``mlstm_decode``; the sLSTM's
    decode steps against ``slstm_decode``; each block's steps equal its
    forward over the longer sequence."""
    import jax.numpy as jnp

    from repro.nn import xlstm as RX

    a, mv, sv, mblock, sblock = _blocks()
    rng = np.random.default_rng(9)
    l = 21
    x = rng.standard_normal((2, l + 3, a.d_model)).astype(np.float32)
    want, wm = RX.mlstm(mv, jnp.asarray(x[:, :l]), a, return_state=True)
    got, gm = PX.mlstm(mblock, _t(x[:, :l]), return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    _assert_trees_close(gm, wm, ATOL)
    _, ws = RX.slstm(sv, jnp.asarray(x[:, :l]), a, return_state=True)
    _, gs = PX.slstm(sblock, _t(x[:, :l]), return_state=True)
    full_m, full_s = PX.mlstm(mblock, _t(x)), PX.slstm(sblock, _t(x))
    for i in range(3):
        step = x[:, l + i:l + i + 1]
        want, wm = RX.mlstm_decode(mv, jnp.asarray(step), a, wm)
        got, gm = PX.mlstm_decode(mblock, _t(step), gm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        _assert_trees_close(gm, wm, ATOL)
        torch.testing.assert_close(got, full_m[:, l + i:l + i + 1], atol=ATOL, rtol=0)
        want, ws = RX.slstm_decode(sv, jnp.asarray(step), a, ws)
        got, gs = PX.slstm_decode(sblock, _t(step), gs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        _assert_trees_close(gs, ws, ATOL)
        torch.testing.assert_close(got, full_s[:, l + i:l + i + 1], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The model
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



def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


def test_xlstm_logits_and_states_match_reference():
    """Train logits (no cache); prefill logits and the returned states (the
    mLSTMs' from zero), without a cache, with a fresh one (left untouched)
    and with one holding states (the sLSTMs start from them, as the
    reference's); then a decode step, logits and states (written in
    place)."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import forward as ref_forward, init_cache as ref_cache

    cfg_ref, jvals, values = _ref_model()
    cfg = get_smoke(ARCH)
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

    r_pre = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(toks), mode="prefill",
                        cache=ref_cache(cfg_ref, b, max_len, jnp.float32))
    cache = PMDL.init_cache(cfg, b, max_len, torch.float32, device="cpu")
    fresh = _clone_tree(cache)
    p_pre = PMDL.forward(model, cfg, tokens=torch.from_numpy(toks), mode="prefill", cache=cache)
    np.testing.assert_allclose(p_pre.logits.numpy(), np.asarray(r_pre.logits),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_trees_close(cache, jax.tree.map(lambda a: a.numpy(), fresh), 0, 0)
    _assert_trees_close(p_pre.cache, r_pre.cache, ATOL)

    # A second prefill given the first's states: the sLSTMs continue them.
    again = PMDL.forward(model, cfg, tokens=torch.from_numpy(toks[:, :5]), mode="prefill",
                         cache=_clone_tree(p_pre.cache))
    r_again = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(toks[:, :5]), mode="prefill",
                          cache=r_pre.cache)
    np.testing.assert_allclose(again.logits.numpy(), np.asarray(r_again.logits),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_trees_close(again.cache, r_again.cache, ATOL)

    nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    r_dec = ref_forward(jvals, cfg_ref, tokens=jnp.asarray(nxt), mode="decode",
                        cache=r_pre.cache, cache_pos=jnp.int32(t))
    given = _clone_tree(p_pre.cache)
    p_dec = PMDL.forward(model, cfg, tokens=torch.from_numpy(nxt), mode="decode", cache=given,
                         cache_pos=t)
    np.testing.assert_allclose(p_dec.logits.numpy(), np.asarray(r_dec.logits),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_trees_close(p_dec.cache, r_dec.cache, ATOL)
    _assert_trees_close(given, r_dec.cache, ATOL)          # written in place


# The port's bf16 gap to its own float32 may exceed the reference's by at
# most this factor: both packages round the same weights to bf16 and compute
# in bf16, in different op orders, so the gaps differ a little (0.0383
# against 0.0360 on these inputs), never by a fault's margin.
BF16_GAP_RATIO = 1.25


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_gap_to_float32_is_the_references():
    """Both packages in bf16 and in float32 (``param_dtype`` and
    ``compute_dtype`` set in the config) from the same weights: the
    reference's own bf16 init, exact in float32. The port's bf16-vs-float32
    logit gap is at most ``BF16_GAP_RATIO`` times the reference's: the
    gap belongs to the model, not to the port."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import forward as ref_forward

    over16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg_ref16, jvals16, values = _ref_model(**over16)
    cfg_ref32 = dataclasses.replace(cfg_ref16, param_dtype="float32", compute_dtype="float32")
    jvals32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jvals16)
    toks = np.random.default_rng(11).integers(0, cfg_ref16.vocab, (3, 64)).astype(np.int32)

    def ref_logits(cfg, vals):
        return np.asarray(ref_forward(vals, cfg, tokens=jnp.asarray(toks)).logits, np.float32)

    def port_logits(cfg):
        model = params_from_reference(values, cfg, "cpu")
        return PMDL.forward(model, cfg, tokens=torch.from_numpy(toks)).logits.float().numpy()

    cfg16 = dataclasses.replace(get_smoke(ARCH), **over16)
    cfg32 = get_smoke(ARCH)
    ref32, ref16 = ref_logits(cfg_ref32, jvals32), ref_logits(cfg_ref16, jvals16)
    port32, port16 = port_logits(cfg32), port_logits(cfg16)
    np.testing.assert_allclose(port32, ref32, atol=LOGIT_ATOL, rtol=0)
    ref_gap, port_gap = _rel_l2(ref16, ref32), _rel_l2(port16, port32)
    assert 0 < port_gap <= BF16_GAP_RATIO * ref_gap, (port_gap, ref_gap)


def test_xlstm_decode_continues_the_full_forward():
    """The reference's decode parity (``tests/test_models.py``): prefill 8
    tokens, decode 4, against the train-mode forward of the 12, within its
    5e-2; and within LOGIT_ATOL, as float32 gives."""
    cfg = get_smoke(ARCH)
    model = PMDL.init_model(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)))
    full = PMDL.forward(model, cfg, tokens=toks).logits
    out = PMDL.forward(model, cfg, tokens=toks[:, :8], mode="prefill",
                       cache=PMDL.init_cache(cfg, 2, 12, torch.float32, device="cpu"))
    logits, cache = [out.logits], out.cache
    for t in range(8, 12):
        out = PMDL.forward(model, cfg, tokens=toks[:, t:t + 1], mode="decode", cache=cache,
                           cache_pos=t)
        logits.append(out.logits)
    err = float((torch.cat(logits, dim=1) - full).abs().max())
    assert err < 5e-2 and err < LOGIT_ATOL, err


def test_params_from_reference_copies_every_leaf():
    """Every leaf of the reference's tree (``mlstm`` (groups, per - 1, ...),
    ``slstm`` (groups, ...)) lands in the port's tensor of the same values,
    and the port has no other parameter; a leaf of another shape raises."""
    import jax

    cfg = get_smoke(ARCH)
    _, _, values = _ref_model()
    model = params_from_reference(values, cfg, "cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree_util.tree_leaves(values))
    m, s = values["mlstm"], values["slstm"]
    for g, (group, s_layer) in enumerate(zip(model.mlstm, model.slstm)):
        for i, layer in enumerate(group):
            np.testing.assert_array_equal(layer.mixer.q.numpy(), m["mixer"]["q"][g, i])
            np.testing.assert_array_equal(layer.mixer.gate_f.b.numpy(),
                                          m["mixer"]["gate_f"]["b"][g, i])
            np.testing.assert_array_equal(layer.ln.scale.numpy(), m["ln"]["scale"][g, i])
        np.testing.assert_array_equal(s_layer.mixer.r_gates.numpy(), s["mixer"]["r_gates"][g])
        np.testing.assert_array_equal(s_layer.mixer.w_gates.b.numpy(),
                                      s["mixer"]["w_gates"]["b"][g])
    bad = jax.tree.map(lambda a: a, values)
    bad["slstm"]["mixer"]["r_gates"] = bad["slstm"]["mixer"]["r_gates"][:, :, :3]
    with pytest.raises(ValueError, match="r_gates: shape"):
        params_from_reference(bad, cfg, "cpu")


def test_init_model_scales():
    """The reference's init scales: q, k, v ``hd^-0.5``, ``r_gates``
    ``shd^-0.5``, ``conv_w`` 0.2, zero gate biases."""
    cfg = dataclasses.replace(get_smoke(ARCH), d_model=256, n_heads=2)
    cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, d_model=256,
                                                             n_heads=2))
    model = PMDL.init_model(cfg, seed=0, device="cpu")
    mixer, smixer = model.mlstm[0][0].mixer, model.slstm[1].mixer
    a = cfg.xlstm
    for w, scale in ((mixer.q, a.head_dim ** -0.5), (mixer.conv_w, 0.2),
                     (smixer.r_gates, a.s_head_dim ** -0.5)):
        assert abs(float(w.std()) / scale - 1) < 0.1
    assert torch.all(mixer.gate_i.b == 0) and torch.all(smixer.w_gates.b == 0)


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


def test_xlstm_loss_and_grads_match_reference():
    """The loss and every parameter's gradient against the reference's
    ``jax.value_and_grad`` (a length of 37: the mLSTM's chunk loop pads)."""
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
        for key in ("loss", "lr", "total_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=f"{key} @ {step}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                                   err_msg=f"grad_norm @ {step}")
    want = dict(params_from_reference(np_tree(ref.params), cfg, device="cpu").named_parameters())
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   atol=P_ATOL, rtol=G_RTOL, err_msg=name)


def _run(module, *args, timeout=300):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_launcher_trains_xlstm_on_the_cpu(tmp_path):
    proc = _run("repro_torch.launch.train", "--arch", ARCH, "--device", "cpu", "--steps", "10",
                "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("step    10  loss ") and "nan" not in lines[0]
    assert lines[-1] == f"done at step 10; checkpoints in {tmp_path}"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_xlstm_matches_cpu(tmp_path):
    """The smoke twin on the card against the CPU: prefill logits and
    states, a decode step; two training steps' losses within 1e-4
    relative. No kernel of the port runs on this family."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_smoke(ARCH)
    model = PMDL.init_model(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 21)))
    outs = {}
    for dev in ("cpu", "cuda"):
        mdl = model.to(dev)
        pre = PMDL.forward(mdl, cfg, tokens=toks.to(dev), mode="prefill",
                           cache=PMDL.init_cache(cfg, 2, 32, torch.float32, device=dev))
        dec = PMDL.forward(mdl, cfg, tokens=toks[:, :1].to(dev), mode="decode",
                           cache=pre.cache, cache_pos=21)
        outs[dev] = (pre.logits.cpu(), dec.logits.cpu(), dec.cache["slstm"][1].cpu())
    for i in (0, 1, 2):
        torch.testing.assert_close(outs["cuda"][i], outs["cpu"][i], atol=LOGIT_ATOL, rtol=0)
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
