"""The serving cell: its entries and files, its traffic and weights, the
work counts, and whole runs at the SMOKE widths on the CPU, with the
faults the comparison has to catch."""

import json
import re
import time

import numpy as np
import pytest
import torch

from os4m_bench import dsv2_weights as W, run as runner, serve_harness, serve_traffic, \
    serve_work, spec
from os4m_bench.tests import dsv2_small
from os4m_bench.trace import Trace

BENCH = json.loads(spec.BENCHMARK_JSON.read_text())
SERVE = [w["name"] for w in BENCH["workloads"]
         if spec.load_cell(w["name"]).config.get("kind") == "serve"]
# Keys the contract counts as widths: never cut.
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"num_attention_heads|num_key_value_heads|experts_per_tok|expan)")


def test_serving_entries():
    assert SERVE == ["dsv2-conv-batch"]
    entry = next(c for c in BENCH["configs"] if c["name"] == "deepseek-v2-ep8")
    config = spec.load_cell("dsv2-conv-batch").config
    assert entry["reduced"] == ["num_hidden_layers", "backend"] == list(config["reduced"])
    assert not any(WIDTH.search(k) for k in entry["reduced"])
    assert config["num_hidden_layers"] == 5 and config["first_k_dense_replace"] == 1
    assert {"deployment", "assumed", "departures", "port", "engine"} <= set(config)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["tokens_per_s"]["workloads"] == ["dsv2-conv-batch"]
    assert e2e["tokens_per_s"]["source"] == "host_clock"
    cell = spec.load_cell("dsv2-conv-batch")
    assert {m.name for m in cell.end_to_end} == {"tokens_per_s", "setup_s"}
    assert {m.name for m in cell.per_layer} == {
        f"{name}.conv-batch" for name in ("prefill_ms", "decode_step_ms", "device_idle",
                                          "attn_roofline", "serve_mfu", "tpot_ms_p50",
                                          "tpot_ms_p95")}


def test_every_seed_serves_the_same_lengths():
    config, mix = spec.load_cell("dsv2-conv-batch").config, spec.load_cell("dsv2-conv-batch").traffic
    seed = 2 ** 31 + 12345
    a = serve_traffic.draw_pool(config, mix, seed)
    b = serve_traffic.draw_pool(config, mix, seed)
    c = serve_traffic.draw_pool(config, mix, seed + 1)
    assert len(a) == mix["pool"] and all(len(x) == mix["requests_per_batch"] for x in a)
    for x, y, z in zip(a, b, c):
        for p, q, r, first in zip(x, y, z, a[0]):
            assert np.array_equal(p.tokens, q.tokens) and p.max_new == q.max_new == r.max_new
            assert p.tokens.shape == r.tokens.shape and p.tokens.dtype == np.int32
            assert p.tokens.shape == first.tokens.shape and p.max_new == first.max_new
    assert any(not np.array_equal(p.tokens, r.tokens) for p, r in zip(a[0], c[0]))
    assert any(not np.array_equal(p.tokens, r.tokens) for p, r in zip(a[0], a[1]))
    prompts = np.array([p.tokens.shape[0] for x in a for p in x])
    answers = np.array([p.max_new for x in a for p in x])
    assert prompts.min() >= 128 and prompts.max() <= 2048 and answers.min() >= 32
    assert answers.max() <= 512 and np.median(prompts) > 2 * np.median(answers)
    assert 900 < np.median(prompts) < 1150 and 110 < np.median(answers) < 150
    tokens = np.concatenate([p.tokens for x in a for p in x])
    assert tokens.min() >= 0 and tokens.max() < config["vocab_size"]
    assert 0.06 < np.mean(tokens == 0) < 0.11    # Zipf(1): rank 1 holds 1 / H(102400) = 8.3%


def test_warmup_takes_the_longest_prompts():
    pool = serve_traffic.draw_pool(dsv2_small.config(), dsv2_small.cell().traffic, 5)
    warm = serve_traffic.warmup(pool, 3, 2)
    longest = sorted((p.tokens.shape[0] for b in pool for p in b), reverse=True)[:3]
    assert [p.tokens.shape[0] for p in warm] == longest and all(p.max_new == 2 for p in warm)


def test_weights_do_not_depend_on_the_order_drawn():
    specs = W.layer_specs(dsv2_small.config(), 1)
    names = list(specs)
    forward = {n: W.draw(n, specs[n], 9, "cpu") for n in names}
    backward = {n: W.draw(n, specs[n], 9, "cpu") for n in reversed(names)}
    other = W.draw(names[0], specs[names[0]], 10, "cpu")
    assert all(torch.equal(forward[n], backward[n]) for n in names)
    assert not torch.equal(forward[names[0]], other)
    assert specs[names[0]].dtype == torch.float32
    assert W.layer_specs(dsv2_small.config("bfloat16"), 1)[names[1]].dtype == torch.bfloat16


def test_the_program_gets_the_drawn_weights():
    config = dsv2_small.config()
    _, _, DecoderModel, _ = serve_harness.program()
    model = DecoderModel(serve_harness.port_config(config), device="cpu", ep_slots=4)
    assert W.fill_program(model, config, 3) == sum(p.numel() for p in model.parameters())
    ref = W.reference_tensors(W.layer_specs(config, 1), 3, "cpu")
    kv_b = ref["model.layers.1.self_attn.kv_b_proj.weight"].view(16, 4, 16)
    assert torch.equal(model.layers[0].attn.v_up.w, kv_b[..., 8:].reshape(16, 32))
    assert torch.equal(model.layers[0].moe.up, ref["model.layers.1.mlp.experts.up_proj.weight"])


def test_fp8_rounding_keeps_each_matrix_within_its_step():
    w = torch.randn(3, 64, 32) * torch.tensor([1e-3, 1.0, 50.0])[:, None, None]
    r = W.fp8_round(w)
    assert not torch.equal(r, w)
    rel = (r - w).abs().amax(dim=(1, 2)) / w.abs().amax(dim=(1, 2))
    assert torch.all(rel < 2 ** -4) and torch.all(rel > 2 ** -12)


def test_work_counts_at_full_width():
    config = spec.load_cell("dsv2-conv-batch").config
    p = serve_work.matmul_params(config)
    active = 5 * p["attn"] + p["dense"] + 4 * p["moe"] + p["head"]
    assert 2.2e9 < active < 2.25e9          # about 2.2 B weights a token
    assert serve_work.attention_ops(config, 2) == 2 * 128 * 320 * 3
    assert serve_work.attention_ops(config, 1, first=4) == 2 * 128 * 320 * 5
    assert serve_work.request_ops(config, 4, 1) == pytest.approx(
        2 * 4 * (active - p["head"]) + 2 * p["head"] + 5 * serve_work.attention_ops(config, 4))
    work = serve_work.prefill_attention_work(config, 8, 512)
    assert work.nbytes == 8 * 128 * 512 * (192 * 2 + 128 * 2) * 2
    assert serve_work.bound_s(work) == pytest.approx(work.nbytes / 3.35e12)


def run_small(cell=None):
    return serve_harness.run_cell(cell or dsv2_small.cell(), dsv2_small.SEED, 0.3, False,
                                  "cpu", time.perf_counter())


def test_result_line_shape():
    out = run_small()
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= dsv2_small.MIX["requests_per_batch"]
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == set(serve_harness.LIMITS)
    assert out["checks"]["token_gap_mean"]["value"] < 1e-5      # float32 on both sides
    json.dumps(out)


def test_every_served_token_is_stamped():
    seen = []
    real = serve_harness.serve

    def serve(*args):
        reqs = real(*args)
        seen.extend(reqs)
        return reqs
    serve_harness.serve = serve
    try:
        run_small()
    finally:
        serve_harness.serve = real
    for r in seen:
        assert len(r.output) == r.max_new == len(r.output.stamps)
        assert r.admitted <= r.output.stamps[0] and r.output.stamps == sorted(r.output.stamps)


@pytest.mark.parametrize("add", ["append", "extend", "iadd", "insert", "slice"])
def test_tokens_are_stamped_however_they_enter(add):
    out = serve_harness._StampedList()
    for token in range(3):
        if add == "append":
            out.append(token)
        elif add == "extend":
            out.extend(iter([token]))
        elif add == "iadd":
            out += [token]
        elif add == "insert":
            out.insert(len(out), token)
        else:
            out[len(out):] = [token]
    assert out == [0, 1, 2] and len(out.stamps) == 3 and out.stamps == sorted(out.stamps)
    out[1:2] = [7, 8]
    out[0] = 5
    assert out == [5, 7, 8, 2] and len(out.stamps) == 4


def test_a_token_without_its_stamp_is_a_fault():
    def served(stamps):
        return serve_harness.Served(0, np.zeros(8, np.int32), 3, [1, 2, 3], 0.0, stamps)
    assert serve_harness.served_faults([served([0.1, 0.2, 0.3])]) == 0
    assert serve_harness.served_faults([served([0.1, 0.2])]) == 1
    checks = serve_harness.checks_of([served([0.1, 0.2])], 0, [torch.zeros(3)])
    assert checks["served_faults"] == 1 and not serve_harness.correct(checks)


def altered_token(monkeypatch):
    """A decode step's tokens altered where they are produced."""
    _, _, _, engine = serve_harness.program()
    real = engine.Engine._decode

    def decode(self, *args):
        cache, nxt = real(self, *args)
        return cache, (nxt + 1) % self.cfg.vocab
    monkeypatch.setattr(engine.Engine, "_decode", decode)


def cache_unchanged(monkeypatch):
    """A decode step that leaves the cache (the engine's state) as it was."""
    from repro_torch.nn import attention
    monkeypatch.setattr(attention, "_write_step", lambda *args, **kwargs: None)


def half_the_batch(monkeypatch):
    """The engine serves half of each batch and drops the rest."""
    _, _, _, engine = serve_harness.program()
    real = engine.Engine.run
    monkeypatch.setattr(engine.Engine, "run",
                        lambda self, reqs, *a: real(self, reqs[:len(reqs) // 2], *a))


def tokens_dropped(monkeypatch):
    """The MoE run at a capacity that drops tokens."""
    real = serve_harness.port_config

    def port_config(config):
        return real(dict(config, port=dict(config["port"], capacity_factor=0.3)))
    monkeypatch.setattr(serve_harness, "port_config", port_config)


@pytest.mark.parametrize("fault", [altered_token, cache_unchanged, half_the_batch,
                                   tokens_dropped])
def test_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run_small()
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_host_spans_and_the_readers():
    def served(admit, stamps):
        return serve_harness.Served(0, np.zeros(8, np.int32), len(stamps), [1] * len(stamps),
                                    admit, stamps)
    run = serve_harness.Run(dsv2_small.config(), dsv2_small.MIX,
                            [served(0.1, [0.2, 0.3, 0.5]), served(0.6, [0.7, 0.8])],
                            [(0.0, 1.0)], [0.1, 0.3, 0.2], [0.01, 0.03], 2.0, 5.0)
    assert serve_work.tokens_per_s(run) == 2.5
    assert serve_work.tpot_ms(run) == pytest.approx([150.0, 100.0])
    assert serve_work.median_ms(run.prefill_seconds) == pytest.approx(200.0)
    assert serve_work.attention_roofline(run, "flash_fwd") is None
    spans = serve_harness.host_spans(run)
    assert spans[0] == ("prefill", 0.1, 0.2) and ("plan and cache", 0.0, 0.1) in spans
    run.trace = Trace([("flash_fwd_wgmma<...>", 0.15, 0.01), ("gemm", 0.4, 0.1)], 2.0)
    assert 0 < serve_work.attention_roofline(run, "flash_fwd") < 100
    assert 0 < serve_work.serve_mfu(run) < 100


def test_runner_without_a_card_prints_nothing_and_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = runner.main(["--workload", "dsv2-conv-batch", "--seed", str(dsv2_small.SEED), "--seconds",
                      "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the reading is at the cell's own size")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3000001111, 3000001112, 3000001113])
def test_the_fp8_control_at_the_cells_size_is_not_correct(seed):
    """The control on the card at the cell's own size and load (one batch):
    the float32 reference with its weights rounded through fp8, put in the
    program's place, goes through the run's own checks and comes out not
    correct, where the program's tokens come out correct."""
    device = on_the_card()
    cell = spec.load_cell("dsv2-conv-batch")
    run, _, dropped = serve_harness.measure(cell, seed, 1.0, False, device, time.perf_counter())
    checked = serve_harness.sample(run.requests, seed, int(cell.traffic["check_requests"]))
    full = serve_harness.reference_logits(cell.config, seed, device, checked)
    served = [torch.as_tensor(np.asarray(r.output, np.int64)) for r in checked]
    control = [lg.argmax(dim=1) for lg in serve_harness.reference_logits(
        cell.config, seed, device, checked, fp8=True)]
    sound = serve_harness.checks_of(run.requests, dropped,
                                    serve_harness.position_gaps(full, served))
    lower = serve_harness.checks_of(run.requests, dropped,
                                    serve_harness.position_gaps(full, control))
    print(json.dumps({"seed": seed, "sound": sound, "fp8": lower}))
    assert serve_harness.correct(sound) and not serve_harness.correct(lower)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3000001121, 3000001122, 3000001123])
def test_a_cache_left_unchanged_at_the_cells_size_is_not_correct(seed, monkeypatch):
    """The engine's state left as it was by each decode step, on the card at
    the cell's own size and load (one batch), comes out not correct."""
    device = on_the_card()
    cache_unchanged(monkeypatch)
    out = serve_harness.run_cell(spec.load_cell("dsv2-conv-batch"), seed, 1.0, False, device,
                                 time.perf_counter())
    print(json.dumps({"seed": seed, "cache_unchanged": out["checks"]}))
    assert out["correct"] is False
