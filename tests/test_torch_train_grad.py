"""The port's gradients against the reference's.

* Blocked attention: dq, dk and dv of the port's ``blocked_attention``
  (an autograd Function with the reference's flash-style backward)
  against ``jax.vjp`` of the reference's, causal and not, GQA groups 1
  and 7, head dims 64 and 192, ``s % block_k != 0``, suffix and explicit
  ``q_pos``; float32, allclose at ``atol=1e-5, rtol=1e-4``.
* ``lm_loss`` against the reference's, with and without a mask
  (``rtol=1e-6``).
* Each family the port trains (the smoke twins of llama3-8b, smollm-360m,
  grok-1-314b, deepseek-v2-236b, whisper-base and qwen2-vl-7b, float32):
  the train step's loss and every parameter's gradient against
  ``jax.value_and_grad`` of the reference's ``loss_for`` (the closure of
  ``repro.launch.steps.build_train_step``) from the same converted
  weights; loss at ``rtol=1e-5``, gradients at ``atol=1e-5, rtol=1e-4``.
* ``remat`` on and off: equal gradients and expert counts (the
  recomputation does not count the routing twice).
* ``attn_impl="pallas"`` under grad raises, naming the reason.
* The MoE layer at four expert slots: output and gradients of the
  parameters and the input against the reference on a ``(1, 4)`` mesh, in
  a subprocess with four forced host devices.
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
from repro_torch.models import model as PMDL
from repro_torch.models.convert import params_from_reference
from repro_torch.nn import attention as PA
from repro_torch.nn import moe as PM

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ATOL, RTOL = 1e-5, 1e-4
FAMILIES = ["llama3-8b", "smollm-360m", "grok-1-314b", "deepseek-v2-236b", "whisper-base",
            "qwen2-vl-7b"]


# ---------------------------------------------------------------------------
# Blocked attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group,d,t,s,block_k,qpos", [
    (1, 64, 13, 13, 5, None),          # s % block_k != 0, suffix alignment
    (7, 192, 13, 13, 5, None),
    (1, 192, 6, 17, 8, None),          # a suffix of 6 queries over 17 keys
    (7, 64, 6, 17, 8, None),
    (7, 64, 9, 21, 4, "explicit"),     # explicit (shuffled) q positions
    (1, 192, 9, 21, 4, "explicit"),
], ids=["self-g1-d64", "self-g7-d192", "suffix-g1-d192", "suffix-g7-d64",
        "qpos-g7-d64", "qpos-g1-d192"])
def test_blocked_attention_grads_match_reference(causal, group, d, t, s, block_k, qpos):
    import jax
    import jax.numpy as jnp

    from repro.nn import attention as RA

    rng = np.random.default_rng(group * 100 + d + t)
    hkv, b = 2, 2
    q = rng.standard_normal((b, hkv * group, t, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    pos = None if qpos is None else rng.permutation(s)[:t].astype(np.int32)

    def ref(q_, k_, v_):
        return RA.blocked_attention(q_, k_, v_, causal=causal, block_k=block_k,
                                    q_pos=None if pos is None else jnp.asarray(pos))

    out_ref, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = PA.blocked_attention(qt, kt, vt, causal=causal, block_k=block_k,
                               q_pos=None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=ATOL, rtol=RTOL)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


def test_blocked_attention_saves_no_block_probabilities():
    """Only q, k, v, the output and the logsumexp (and the q positions)
    are kept for the backward, whatever the number of kv blocks."""
    q, k, v = (torch.randn(1, 2, 32, 16, requires_grad=True) for _ in range(3))
    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: sizes.append(tuple(x.shape)) or x, lambda x: x):
        PA.blocked_attention(q, k, v, causal=True, block_k=4)
    assert sorted(sizes) == sorted([(1, 2, 32, 16)] * 4 + [(1, 2, 1, 32), (32,)])


@pytest.mark.parametrize("impl", ["pallas"])
def test_pallas_attention_refuses_to_train(impl, tmp_path):
    cfg = dataclasses.replace(get_smoke("smollm-360m"), attn_impl=impl)
    model = PMDL.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
    toks = torch.randint(3, cfg.vocab, (2, 8))
    with pytest.raises(RuntimeError, match="forward only.*blocked"):
        PMDL.forward(model, cfg, tokens=toks, mode="train")
    with torch.no_grad():                        # serving: the kernel path runs
        assert PMDL.forward(model, cfg, tokens=toks, mode="train").logits.shape[1] == 8
    from repro_torch.models.config import Shape
    from repro_torch.train.loop import Trainer, TrainerConfig

    trainer = Trainer(cfg, Shape("t", "train", 8, 2), model=model,
                      tcfg=TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1000))
    with pytest.raises(RuntimeError, match="kernel 9.*forward only"):
        trainer.run(iter([toks.numpy().astype(np.int32)]), 1)


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    import jax.numpy as jnp

    from repro.models.model import lm_loss as ref_loss

    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    want = ref_loss(jnp.asarray(logits), jnp.asarray(labels),
                    None if mask is None else jnp.asarray(mask))
    got = PMDL.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                       None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zero = PMDL.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.zeros(3, 7))
    assert float(zero) == 0.0                    # an empty mask divides by 1


# ---------------------------------------------------------------------------
# Every family's loss and gradients against the reference's loss_for
# ---------------------------------------------------------------------------


def _inputs(cfg, b=2, t=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab, (b, t)).astype(np.int32)
    extra = None
    if cfg.n_patches:
        extra = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    elif cfg.enc_dec:
        extra = rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return toks, extra


def _ref_values(arch, seed=0):
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.models.model import init_model as ref_init
    from repro.nn import layers as RL

    cfg_ref = ref_smoke(arch)
    vals, _ = RL.split(ref_init(jax.random.PRNGKey(seed), cfg_ref))
    return cfg_ref, vals


def _ref_loss_and_grads(cfg_ref, vals, toks, extra, capacity):
    """``jax.value_and_grad`` of the reference's ``loss_for``."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as RMDL

    def loss_for(p):
        out = RMDL.forward(p, cfg_ref, tokens=jnp.asarray(toks),
                           extra_embed=None if extra is None else jnp.asarray(extra),
                           mode="train", moe_capacity=capacity)
        npch = cfg_ref.n_patches or 0
        loss = RMDL.lm_loss(out.logits[:, npch:-1], jnp.asarray(toks)[:, 1:])
        aux = (out.stats or {}).get("aux_loss", 0.0)
        return loss + aux, out.stats

    (total, stats), grads = jax.jit(jax.value_and_grad(loss_for, has_aux=True))(vals)
    return float(total), stats, jax.tree.map(lambda a: np.asarray(a, np.float32), grads)


def _port_loss_and_grads(model, cfg, toks, extra, capacity):
    tokens = torch.from_numpy(toks)
    out = PMDL.forward(model, cfg, tokens=tokens,
                       extra_embed=None if extra is None else torch.from_numpy(extra),
                       mode="train", moe_capacity=capacity)
    npch = cfg.n_patches or 0
    total = PMDL.lm_loss(out.logits[:, npch:-1], tokens[:, 1:])
    if out.stats:
        total = total + out.stats["aux_loss"]
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params)
    return float(total.detach()), out.stats, dict(zip(names, grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grads_match_reference(arch):
    import jax

    cfg = get_smoke(arch)
    cfg_ref, vals = _ref_values(arch)
    toks, extra = _inputs(cfg)
    t = toks.shape[1] + (cfg.n_patches or 0)
    capacity = PMDL.moe_capacity_for_shape(cfg, toks.shape[0], t, 1)
    want_total, want_stats, want_grads = _ref_loss_and_grads(cfg_ref, vals, toks, extra,
                                                             capacity)
    values = jax.tree.map(lambda a: np.asarray(a, np.float32), vals)
    model = params_from_reference(values, cfg, device="cpu").requires_grad_(True)
    got_total, got_stats, got_grads = _port_loss_and_grads(model, cfg, toks, extra, capacity)
    np.testing.assert_allclose(got_total, want_total, rtol=1e-5)
    if cfg.moe is not None:
        np.testing.assert_array_equal(got_stats["expert_counts"].numpy(),
                                      np.asarray(want_stats["expert_counts"]))
    # The reference's gradient tree in the port's layout, by parameter name.
    ref_grads = dict(params_from_reference(want_grads, cfg, device="cpu").named_parameters())
    assert set(ref_grads) == set(got_grads)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].detach().numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{arch}: d/d {name}")


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_remat_on_and_off_give_equal_grads(arch):
    """Each layer recomputed in the backward (``torch.utils.checkpoint``)
    gives the same gradients, loss and expert counts as keeping every
    activation: the recomputed routing is not counted a second time."""
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(get_smoke(arch), remat=remat)
        model = PMDL.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
        toks, extra = _inputs(cfg, seed=1)
        out.append(_port_loss_and_grads(model, cfg, toks, extra, None))
    (t0, s0, g0), (t1, s1, g1) = out
    assert t0 == t1
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    if s0 and "expert_counts" in s0:
        assert torch.equal(s0["expert_counts"], s1["expert_counts"])
        assert float(s0["expert_counts"].sum()) == 2 * 12 * get_smoke(arch).moe.top_k * (
            get_smoke(arch).n_layers - get_smoke(arch).first_k_dense)


# ---------------------------------------------------------------------------
# The MoE layer's gradients at four expert slots, against a (1, 4) mesh
# ---------------------------------------------------------------------------


_CASES4 = {
    "a2a": dict(num_experts=8, strategy="a2a", t=8, capacity=None),
    "a2a-chunked": dict(num_experts=8, strategy="a2a", pipeline_chunks=2, t=8, capacity=None),
    "a2a-drops": dict(num_experts=8, strategy="a2a", pipeline_chunks=2, t=8, capacity=2),
    "broadcast": dict(num_experts=8, strategy="broadcast", t=8, capacity=None),
    "decode": dict(num_experts=8, strategy="a2a", t=1, capacity=None),
    "tp-regime": dict(num_experts=6, strategy="a2a", t=8, capacity=None),
    "shared": dict(num_experts=8, strategy="a2a", t=8, capacity=None, shared_experts=1),
}

_REFERENCE_GRAD_M4 = textwrap.dedent('''
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.nn import layers as RL
    from repro.nn.moe import MoEArgs, init_moe, moe

    cases, out = eval(sys.argv[1]), sys.argv[2]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    saved = {}
    for name, case in cases.items():
        case = dict(case)
        t, cap = case.pop("t"), case.pop("capacity")
        args = MoEArgs(top_k=2, d_model=16, d_ff=32, capacity_factor=2.0, **case)
        vals, _ = RL.split(init_moe(jax.random.PRNGKey(0), args, mesh))
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, t, 16)).astype(np.float32)
        ct = rng.standard_normal((2, t, 16)).astype(np.float32)

        def loss(p, x_):
            y, st = moe(p, x_, args=args, mesh=mesh, capacity=cap)
            return jnp.sum(y * ct) + st["aux_loss"], (y, st)

        (total, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(vals, jnp.asarray(x))
        saved[name + "/total"] = np.asarray(total)
        saved[name + "/y"] = np.asarray(y)
        saved[name + "/overflow"] = np.asarray(st["overflow"])
        saved[name + "/gx"] = np.asarray(gx)
        for key in ("router", "up", "down", "gate"):
            saved[name + "/w/" + key] = np.asarray(vals[key]["w"])
            saved[name + "/g/" + key] = np.asarray(gp[key]["w"])
        if "shared" in vals:
            for key in ("up", "gate", "down"):
                saved[name + "/w/shared/" + key] = np.asarray(vals["shared"][key]["w"])
                saved[name + "/g/shared/" + key] = np.asarray(gp["shared"][key]["w"])
    np.savez(out, **saved)
''')


@pytest.fixture(scope="module")
def reference_grad_m4(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_grad_m4") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_GRAD_M4, repr(_CASES4), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as data:
        return {key: data[key] for key in data.files}


@pytest.mark.parametrize("name", list(_CASES4))
def test_four_slot_moe_grads_match_reference_mesh(reference_grad_m4, name):
    ref = reference_grad_m4
    case = dict(_CASES4[name])
    t, capacity = case.pop("t"), case.pop("capacity")
    args = PM.MoEArgs(top_k=2, d_model=16, d_ff=32, capacity_factor=2.0, **case)
    module = PM.MoE(args, 4, device="cpu")
    with torch.no_grad():
        for key in ("router", "up", "down", "gate"):
            getattr(module, key).copy_(torch.from_numpy(ref[f"{name}/w/{key}"]))
        if module.shared is not None:
            for key in ("up", "gate", "down"):
                module.shared[key].w.copy_(torch.from_numpy(ref[f"{name}/w/shared/{key}"]))
    module.requires_grad_(True)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, t, 16)).astype(np.float32)).requires_grad_()
    ct = torch.from_numpy(rng.standard_normal((2, t, 16)).astype(np.float32))
    y, st = PM.moe(module, x, capacity=capacity)
    total = torch.sum(y * ct) + st["aux_loss"]
    assert not st["counts"].requires_grad and not st["overflow"].is_floating_point()
    np.testing.assert_allclose(y.detach().numpy(), ref[f"{name}/y"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(total.detach()), float(ref[f"{name}/total"]), rtol=1e-5)
    assert int(st["overflow"]) == int(ref[f"{name}/overflow"])
    names = ["router", "up", "down", "gate"]
    tensors = [module.router, module.up, module.down, module.gate]
    if module.shared is not None:
        names += [f"shared/{k}" for k in ("up", "gate", "down")]
        tensors += [module.shared[k].w for k in ("up", "gate", "down")]
    grads = torch.autograd.grad(total, tensors + [x])
    for key, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[f"{name}/g/{key}"], atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name}: d/d {key}")
    np.testing.assert_allclose(grads[-1].numpy(), ref[f"{name}/gx"], atol=ATOL, rtol=RTOL,
                               err_msg=f"{name}: d/dx")
    if name.endswith("drops"):
        assert int(st["overflow"]) > 0
