"""The port's MoE layer, expert balancer, MoE decoder and serving against the
reference's.

Balancer (``core/balancer.py``, a numpy copy): the cases of the reference's
``tests/test_moe_balancer.py``, each run through both packages on the same
inputs, with assignments, placements, permutations and reports equal.

Layer (``nn/moe.py``): the reference's parameters (``init_moe`` with a JAX
key, as numpy float32) in the port's ``MoE`` module, the same numpy
activations through both ``moe``s. One expert slot against the reference's
``moe(mesh=None)`` here; four stacked slots against the reference's
``(1, 4)`` mesh in ``tests/test_torch_moe_mesh.py``. Outputs allclose at
float32 ``atol=rtol=1e-5``; expert counts and overflow equal; the
auxiliary loss allclose.

Model and engine: the grok-1 smoke config's prefill and decode with a cache
against the reference's ``forward`` (expert counts equal, logits within
``1e-4``, as ``test_torch_model.py``), and its token streams through
``Engine`` equal to the reference ``Engine``'s.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import balancer as pb
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import (default_placements, forward, init_cache, init_model,
                                      moe_capacity_for_shape)
from repro_torch.nn import moe as PM
from repro_torch.serve.engine import Engine, EngineConfig, Request

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ATOL = RTOL = 1e-5
LOGIT_ATOL = 1e-4


# ---------------------------------------------------------------------------
# Balancer
# ---------------------------------------------------------------------------


def _rb():
    from repro.core import balancer as rb

    return rb


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("slots,per", [(4, 8), (8, 8), (4, 2)])
def test_schedule_balanced_cardinality_equals_reference(seed, slots, per):
    rb = _rb()
    rng = np.random.default_rng(seed)
    loads = rng.zipf(1.5, slots * per).astype(float)
    speeds = rng.uniform(0.3, 1.5, size=slots)
    for sp in (None, np.ones(slots), speeds):
        a = pb.schedule_balanced_cardinality(loads, slots, per, speeds=sp)
        np.testing.assert_array_equal(a, rb.schedule_balanced_cardinality(
            loads, slots, per, speeds=sp))
        assert (np.bincount(a, minlength=slots) == per).all()
        placement, perm = pb.placement_from_assignment(a, slots)
        want_p, want_perm = rb.placement_from_assignment(a, slots)
        np.testing.assert_array_equal(placement, want_p)
        np.testing.assert_array_equal(perm, want_perm)
        for g, e in enumerate(perm):
            assert placement[0, e] * per + placement[1, e] == g


def test_dead_slot_gets_the_coldest_experts_as_in_the_reference():
    rb = _rb()
    loads = np.array([60, 50, 40, 30, 20, 10, 5, 5], float)
    a = pb.schedule_balanced_cardinality(loads, 4, 2, speeds=[1.0, 0.0, 1.0, 1.0])
    np.testing.assert_array_equal(a, rb.schedule_balanced_cardinality(
        loads, 4, 2, speeds=[1.0, 0.0, 1.0, 1.0]))
    per_dev = np.bincount(a, weights=loads, minlength=4)
    assert per_dev[1] == pytest.approx(per_dev.min())


@pytest.mark.parametrize("speeds", [np.ones(3), [1.0, -0.5, 1.0, 1.0], np.zeros(4)],
                         ids=["wrong-shape", "negative", "all-dead"])
def test_speed_validation_raises_as_in_the_reference(speeds):
    rb = _rb()
    loads = np.arange(8, dtype=float)
    for mod in (pb, rb):
        with pytest.raises(ValueError):
            mod.schedule_balanced_cardinality(loads, 4, 2, speeds=speeds)


def _reports(reports):
    return [dataclasses.astuple(r) for r in reports]


def _replan_both(make, steps):
    """The same observe / replan / set_speeds sequence on both balancers:
    every replan's placements, perms and reports, and the counters, equal."""
    rb = _rb()
    port, ref = make(pb.ExpertBalancer), make(rb.ExpertBalancer)
    for step in steps:
        if step[0] == "observe":
            port.observe(step[1])
            ref.observe(step[1])
            assert port.should_replan() == ref.should_replan()
        elif step[0] == "speeds":
            port.set_speeds(step[1])
            ref.set_speeds(step[1])
        else:
            got, want = port.replan(), ref.replan()
            np.testing.assert_array_equal(got[0], want[0])
            for a, b in zip(got[1], want[1]):
                np.testing.assert_array_equal(a, b)
            assert _reports(got[2]) == _reports(want[2])
            assert (port.layers_reused, port.layers_replanned) == \
                (ref.layers_reused, ref.layers_replanned)
    return port


HOT = np.array([[100, 1, 1, 1, 100, 1, 1, 1]], float)


@pytest.mark.parametrize("case", ["hot-experts", "speeds", "dead-slot", "drift-gate",
                                  "speeds-invalidate-drift", "two-layers-ema"])
def test_expert_balancer_replan_equals_reference(case):
    rng = np.random.default_rng(7)
    zipf = rng.zipf(1.3, (2, 16)).astype(float)
    skew = np.array([[60, 50, 40, 30, 20, 10, 5, 5]], float)
    make, steps = {
        "hot-experts": (lambda cls: cls(8, 4, 1, interval=1),
                        [("observe", HOT), ("replan",)]),
        "speeds": (lambda cls: cls(8, 4, 1, interval=1, ema=0.0,
                                   speeds=[1.0, 1.0, 0.5, 1.0]),
                   [("observe", skew), ("replan",), ("replan",)]),
        "dead-slot": (lambda cls: cls(8, 4, 1, interval=1, ema=0.0,
                                      speeds=[1.0, 0.0, 1.0, 1.0]),
                      [("observe", skew), ("replan",)]),
        "drift-gate": (lambda cls: cls(8, 4, 1, interval=1, ema=0.0, max_drift=0.1),
                       [("observe", HOT), ("replan",), ("observe", HOT * 3.0), ("replan",),
                        ("observe", HOT[:, ::-1].copy()), ("replan",)]),
        "speeds-invalidate-drift": (
            lambda cls: cls(8, 4, 1, interval=1, ema=0.0, max_drift=0.1),
            [("observe", HOT), ("replan",), ("observe", HOT), ("replan",),
             ("speeds", [1.0, 0.25, 1.0, 1.0]), ("observe", HOT), ("replan",)]),
        "two-layers-ema": (lambda cls: cls(16, 4, 2, interval=2, ema=0.8),
                           [("observe", zipf), ("observe", zipf[::-1].copy()), ("replan",),
                            ("observe", zipf), ("replan",)]),
    }[case]
    port = _replan_both(make, steps)
    if case == "drift-gate":
        assert port.layers_reused == 1 and port.layers_replanned == 2
    if case == "speeds-invalidate-drift":
        assert port.layers_replanned == 2
        with pytest.raises(ValueError):
            port.set_speeds([1.0, -1.0, 1.0, 1.0])


def test_balance_report_fields_equal_reference():
    rb = _rb()
    port, ref = (cls(8, 4, 1, interval=1, ema=0.0, speeds=[1.0, 1.0, 0.5, 1.0])
                 for cls in (pb.ExpertBalancer, rb.ExpertBalancer))
    skew = np.array([[60, 50, 40, 30, 20, 10, 5, 5]], float)
    port.observe(skew)
    ref.observe(skew)
    (r,), (w,) = port.replan()[2], ref.replan()[2]
    assert [f.name for f in dataclasses.fields(pb.BalanceReport)] == \
        [f.name for f in dataclasses.fields(rb.BalanceReport)]
    assert dataclasses.asdict(r) == dataclasses.asdict(w)
    assert r.finish_ratio >= 1.0 and r.balance_ratio <= r.baseline_ratio + 1e-9


# ---------------------------------------------------------------------------
# The layer at one slot
# ---------------------------------------------------------------------------


def _ref_moe(args_kw, ep_slots=1, seed=0):
    """The reference's MoE parameters (as jnp) and the port's module holding them."""
    import jax

    from repro.nn import layers as RL
    from repro.nn.moe import MoEArgs as RArgs, init_moe as rinit

    rargs = RArgs(**args_kw)
    vals, _ = RL.split(rinit(jax.random.PRNGKey(seed), rargs, None))
    module = PM.MoE(PM.MoEArgs(**args_kw), ep_slots, device="cpu")
    with torch.no_grad():
        module.router.copy_(torch.tensor(np.asarray(vals["router"]["w"])))
        for name in ("up", "down", "gate"):
            if name in vals:
                getattr(module, name).copy_(torch.tensor(np.asarray(vals[name]["w"])))
        if module.shared is not None:
            for name in ("up", "gate", "down"):
                module.shared[name].w.copy_(torch.tensor(np.asarray(vals["shared"][name]["w"])))
    return rargs, vals, module


def _assert_moe_equal(got, want):
    y, st = got
    y_ref, st_ref = want
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(st["counts"].numpy(), np.asarray(st_ref["counts"]))
    assert int(st["overflow"]) == int(st_ref["overflow"])
    np.testing.assert_allclose(float(st["aux_loss"]), float(st_ref["aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("strategy", ["a2a", "broadcast"])
@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("capacity", [None, 8], ids=["cap-default", "cap-drops"])
def test_one_slot_moe_equals_reference(strategy, chunks, shared, capacity):
    import jax.numpy as jnp

    from repro.nn.moe import moe as rmoe

    kw = dict(num_experts=4, top_k=2, d_model=16, d_ff=32, capacity_factor=2.0,
              strategy=strategy, pipeline_chunks=chunks, shared_experts=shared)
    rargs, vals, module = _ref_moe(kw)
    x = np.random.default_rng(1).standard_normal((2, 8, 16)).astype(np.float32)
    want = rmoe(vals, jnp.asarray(x), args=rargs, mesh=None, capacity=capacity)
    got = PM.moe(module, torch.from_numpy(x), capacity=capacity)
    _assert_moe_equal(got, want)
    if capacity is not None:
        assert int(got[1]["overflow"]) > 0       # the bucket drops tokens


def test_one_slot_decode_step_equals_reference():
    import jax.numpy as jnp

    from repro.nn.moe import moe as rmoe

    kw = dict(num_experts=4, top_k=2, d_model=16, d_ff=32, capacity_factor=2.0)
    rargs, vals, module = _ref_moe(kw)
    x = np.random.default_rng(2).standard_normal((3, 1, 16)).astype(np.float32)
    _assert_moe_equal(PM.moe(module, torch.from_numpy(x)),
                      rmoe(vals, jnp.asarray(x), args=rargs, mesh=None))


def test_moe_respects_balanced_placement():
    """A replanned placement with its permuted weights gives the default
    placement's outputs (a pure relabeling), at one and at four slots."""
    kw = dict(num_experts=8, top_k=2, d_model=16, d_ff=32, capacity_factor=8.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 16, 16))
                         .astype(np.float32))
    for ep in (1, 4):
        _, _, module = _ref_moe(kw, ep_slots=ep)
        y0, st0 = PM.moe(module, x)
        counts = np.asarray([60, 50, 40, 30, 20, 10, 5, 5], float)
        placement, perm = PM.balanced_placement(module.args, ep, counts)
        per = module.args.experts_per_shard(ep)
        for g, e in enumerate(perm):
            assert int(placement[0, e]) * per + int(placement[1, e]) == g
        pb.permute_expert_weights(module, perm)
        y1, st1 = PM.moe(module, x, placement=placement)
        np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=ATOL, rtol=RTOL)
        assert torch.equal(st1["counts"], st0["counts"])
        # Back to the identity order from the permuted one.
        pb.permute_expert_weights(module, np.arange(8), prev_perm=perm)
        torch.testing.assert_close(PM.moe(module, x)[0], y0, atol=0, rtol=0)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("strategy", ["a2a", "broadcast"])
@pytest.mark.parametrize("ep_slots", [1, 4])
def test_top6_combine_is_bit_stable(device, strategy, ep_slots):
    """At top-6 (deepseek-v2's routing) a token's six expert outputs are
    summed in a fixed order: two runs on the same tokens give the same bits,
    and so does the balancer's placement with its permuted weights (a
    relabeling). An add whose order follows the bucket rows (the placement)
    or the atomics' timing would differ in the last bits."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = PM.MoEArgs(num_experts=16, top_k=6, d_model=64, d_ff=48, shared_experts=1,
                      capacity_factor=16.0, strategy=strategy)
    module = PM.init_moe(args, ep_slots, seed=0, device="cpu").to(device)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 32, 64))
                         .astype(np.float32)).to(device)
    dropless = 4 * 32 * args.top_k
    y0, st0 = PM.moe(module, x, capacity=dropless)
    y1, _ = PM.moe(module, x, capacity=dropless)
    assert int(st0["overflow"]) == 0
    assert torch.equal(y1, y0)
    placement, perm = PM.balanced_placement(args, ep_slots, st0["counts"].cpu().numpy())
    pb.permute_expert_weights(module, perm)
    y2, st2 = PM.moe(module, x, placement=placement, capacity=dropless)
    assert int(st2["overflow"]) == 0
    assert torch.equal(st2["counts"], st0["counts"])
    assert torch.equal(y2, y0)


def test_capacity_and_placement_helpers():
    args = PM.MoEArgs(num_experts=8, top_k=2, d_model=16, d_ff=32)
    assert PM.capacity_for(args, 64, 4) == 48                  # 32 · 1.25 + 1, to 8
    assert PM.capacity_for(args, 64, 3) == 128                # TP regime: dropless
    assert PM.default_placement(args, 4).tolist() == [[0, 0, 1, 1, 2, 2, 3, 3],
                                                      [0, 1, 0, 1, 0, 1, 0, 1]]
    assert PM.default_placement(args, 3).tolist() == [[0] * 8, list(range(8))]
    cfg = get_smoke("grok-1-314b")
    assert tuple(default_placements(cfg, 2).shape) == (2, 2, 4)
    assert moe_capacity_for_shape(cfg, 8, 512, 4) == min(
        PM.capacity_for(cfg.moe, 8 * 128, 4), 8 * 128 * 2)
    assert moe_capacity_for_shape(cfg, 8, 1, 4) == min(PM.capacity_for(cfg.moe, 8, 4), 8 * 2)
    with pytest.raises(ValueError, match="TP regime"):
        PM.MoE(dataclasses.replace(args, d_ff=31), 3, device="cpu")


# ---------------------------------------------------------------------------
# The MoE decoder and its serving
# ---------------------------------------------------------------------------


def _ref_grok(seed=0):
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.models.model import init_model as rinit
    from repro.nn import layers as RL

    cfg_ref = ref_smoke("grok-1-314b")
    vals, _ = RL.split(rinit(jax.random.PRNGKey(seed), cfg_ref))
    return cfg_ref, vals, jax.tree.map(lambda a: np.asarray(a, np.float32), vals)


@pytest.mark.parametrize("ep_slots", [1, 2])
def test_grok_smoke_prefill_and_decode_equal_reference(ep_slots):
    """Prefill with a cache, then a per-lane decode step: logits within
    1e-4 and expert counts equal to the reference's (whose ``mesh=None``
    is one slot; two slots are a relabeling of the same experts)."""
    import jax.numpy as jnp

    from repro.models.model import forward as rfwd, init_cache as rcache

    cfg_ref, vals, values = _ref_grok()
    cfg = get_smoke("grok-1-314b")
    model = params_from_reference(values, cfg, device="cpu", ep_slots=ep_slots)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want = rfwd(vals, cfg_ref, tokens=jnp.asarray(toks), mode="prefill",
                cache=rcache(cfg_ref, 2, 16, jnp.float32))
    got = forward(model, cfg, tokens=torch.from_numpy(toks), mode="prefill",
                  cache=init_cache(cfg, 2, 16, torch.float32, device="cpu"))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got.stats["expert_counts"].numpy(),
                                  np.asarray(want.stats["expert_counts"]))
    assert got.stats["expert_counts"].shape == (cfg.n_layers, cfg.moe.num_experts)
    assert int(got.stats["overflow"]) == int(want.stats["overflow"]) == 0
    step = np.array([[5], [7]], np.int32)
    want2 = rfwd(vals, cfg_ref, tokens=jnp.asarray(step), mode="decode", cache=want.cache,
                 cache_pos=jnp.asarray([12, 9]))
    got2 = forward(model, cfg, tokens=torch.from_numpy(step), mode="decode", cache=got.cache,
                   cache_pos=torch.tensor([12, 9]))
    np.testing.assert_allclose(got2.logits.numpy(), np.asarray(want2.logits),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(got2.stats["expert_counts"].numpy(),
                                  np.asarray(want2.stats["expert_counts"]))


def test_grok_smoke_balanced_placements_keep_the_logits():
    """The balancer's placements with the permuted weights, through the
    whole model: the logits of the default placement."""
    cfg = get_smoke("grok-1-314b")
    model = init_model(cfg, seed=0, device="cpu", ep_slots=2)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)))
    base = forward(model, cfg, tokens=toks, mode="prefill")
    bal = pb.ExpertBalancer(cfg.moe.num_experts, 2, cfg.n_layers, interval=1, ema=0.0)
    bal.observe(base.stats["expert_counts"].numpy())
    placements, perms, _ = bal.replan()
    for layer, perm in zip(model.layers, perms):
        pb.permute_expert_weights(layer.moe, perm)
    moved = forward(model, cfg, tokens=toks, mode="prefill",
                    placements=torch.as_tensor(placements))
    np.testing.assert_allclose(moved.logits.numpy(), base.logits.numpy(), atol=ATOL, rtol=RTOL)
    assert torch.equal(moved.stats["expert_counts"], base.stats["expert_counts"])


def test_grok_smoke_engine_token_streams_equal_reference():
    from repro.serve.engine import Engine as RefEngine, EngineConfig as RefConfig
    from repro.serve.engine import Request as RefRequest

    cfg_ref, vals, values = _ref_grok()
    cfg = get_smoke("grok-1-314b")
    ecfg = dict(lanes=3, max_len=40, eos=-1)

    def requests(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, prompt=rng.integers(3, cfg.vocab, int(rng.integers(4, 12)))
                    .astype(np.int32), max_new=int(np.clip(rng.zipf(1.5) * 4, 4, 16)))
                for i in range(6)]

    want = RefEngine(cfg_ref, vals, RefConfig(**ecfg)).run(requests(RefRequest))
    eng = Engine(cfg, params_from_reference(values, cfg, "cpu"), EngineConfig(**ecfg),
                 device="cpu")
    got = eng.run(requests(Request))
    assert [(r.rid, r.lane, r.output) for r in got] == \
        [(r.rid, r.lane, r.output) for r in want]


def test_init_moe_draws_the_reference_scales():
    args = PM.MoEArgs(num_experts=4, top_k=2, d_model=64, d_ff=128, shared_experts=1)
    module = PM.init_moe(args, 2, seed=0, device="cpu")
    for w, fan_in in ((module.router, 64), (module.up, 64), (module.gate, 64),
                      (module.down, 128)):
        assert abs(float(w.float().std()) - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    assert module.shared["down"].w.shape == (128, 64)
    again = PM.init_moe(args, 2, seed=0, device="cpu")
    assert torch.equal(again.up, module.up)


@pytest.mark.gpu
@pytest.mark.parametrize("ep_slots", [1, 4])
def test_cuda_moe_layer_matches_cpu(ep_slots):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = PM.MoEArgs(num_experts=8, top_k=2, d_model=64, d_ff=128, capacity_factor=2.0,
                      pipeline_chunks=2)
    module = PM.init_moe(args, ep_slots, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 16, 64))
                         .astype(np.float32))
    for t in (16, 1):
        y, st = PM.moe(module, x[:, :t])
        y_gpu, st_gpu = PM.moe(module.to("cuda"), x[:, :t].cuda())
        module.to("cpu")
        torch.testing.assert_close(y_gpu.cpu(), y, atol=1e-4, rtol=1e-4)
        assert torch.equal(st_gpu["counts"].cpu(), st["counts"])
        assert int(st_gpu["overflow"]) == int(st["overflow"])


@pytest.mark.gpu
def test_cuda_grok_smoke_engine_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_smoke("grok-1-314b"), attn_impl="pallas")
    streams = []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, init_model(cfg, seed=0, device="cpu", ep_slots=2).to(dev),
                     EngineConfig(lanes=3, max_len=48, eos=-1), device=dev)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, 10).astype(np.int32),
                        max_new=8) for i in range(5)]
        streams.append([(r.rid, r.output) for r in eng.run(reqs)])
    assert streams[0] == streams[1]


def test_launcher_serves_the_grok_smoke_config_on_cpu():
    """``--arch grok-1-314b`` serves the smoke twin, as the reference's
    launcher does; the request plan's line is the one the reference's
    launcher prints for this arch (24 requests, 750 tokens, balance 1.010)."""
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "grok-1-314b", "--device", "cpu"], env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "24 requests, 750 tokens" in proc.stdout
    assert "lane balance ratio 1.010, finish ratio 1.010" in proc.stdout
