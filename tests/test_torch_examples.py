"""The port's five examples (``repro_torch.examples``) against the reference.

Each example's sections are functions; these tests call them on the CPU
beside the reference's API on the same numpy inputs:

* ``inverted_index``, ``quickstart`` §1-§2c and ``moe_balance``'s offline
  placement and reuse loop: plans, strategies, MapReduce values and counts
  bitwise, network bytes, reuse flags, reasons and drifts equal.
* ``serve_lm`` from the reference's weights (``params_from_reference``):
  the os4m run's token streams equal the reference ``Engine``'s on the
  example's first 8 requests, and both schedulers' lane plans of all 24
  have equal balance ratios.
* ``quickstart`` §3, ``train_lm`` and ``moe_balance``'s trainer, cut to 2
  steps at their configs (``train_lm`` at batch 2 x 32 tokens), from the
  reference ``Trainer``'s initial weights: every loss within 1e-4 of the
  reference's.
* The command lines: ``python -m repro_torch.examples.inverted_index
  --device cpu`` in a subprocess, and every example's ``main`` with
  ``--device cpu`` (``train_lm`` at 2 steps of 2 x 32, then resumed).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import inverted_index, moe_balance, quickstart, serve_lm, train_lm
from repro_torch.models.convert import params_from_reference

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
CPU = torch.device("cpu")
LOSS_ATOL = 1e-4
STREAMED = 8
TRAIN_STEPS = 2


def _identity(batch):
    return batch


def _ref_job(**cfg):
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    return MapReduceJob(_identity, MapReduceConfig(**cfg), backend="vmap")


def _jnp(batch):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in batch)


def _assert_same_result(got, want, what):
    assert got.strategy == want.strategy, what
    np.testing.assert_array_equal(got.schedule.assignment, want.schedule.assignment,
                                  err_msg=what)
    assert got.schedule.balance_ratio == want.schedule.balance_ratio, what
    np.testing.assert_array_equal(got.values, np.asarray(want.values), err_msg=what)
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts), err_msg=what)
    assert got.network_cost.total == want.network_cost.total, what
    assert (got.reused, got.plan_reason, got.drift) == \
        (want.reused, want.plan_reason, want.drift), what


# ---------------------------------------------------------------------------
# MapReduce and scheduling sections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["hash", "os4m"])
def test_inverted_index_equals_reference(sched):
    from repro.core.clustering import recommended_num_clusters

    keys, vals, valid, n_pairs = inverted_index.inputs()
    assert n_pairs == 30248 and keys.shape == (8, 3781)
    n = recommended_num_clusters(inverted_index.SLOTS)
    got = inverted_index.run_index(sched, (keys, vals, valid), CPU, n)
    want = _ref_job(num_slots=8, num_clusters=n, scheduler=sched,
                    pipeline_chunks=4).run(_jnp((keys, vals, valid)))
    _assert_same_result(got, want, sched)


def test_quickstart_schedulers_equal_reference():
    from repro.core import scheduler as RS

    _, loads, hash_s, bss_s = quickstart.schedulers()
    rng = np.random.default_rng(0)
    want_loads = rng.zipf(1.3, 480).clip(1, 20_000).astype(float)
    np.testing.assert_array_equal(loads, want_loads)
    for got, want in ((hash_s, RS.schedule_hash(want_loads, 30, keys=np.arange(480))),
                      (bss_s, RS.schedule_bss(want_loads, 30))):
        np.testing.assert_array_equal(got.assignment, want.assignment)
        assert got.balance_ratio == want.balance_ratio


def _quickstart_batch():
    rng, *_ = quickstart.schedulers()
    return quickstart.wordcount_batch(rng)


@pytest.mark.parametrize("sched", ["hash", "os4m", "auto"])
def test_quickstart_wordcount_equals_reference(sched):
    batch = _quickstart_batch()
    got = quickstart.wordcount(sched, batch, CPU)
    want = _ref_job(num_slots=4, num_clusters=24, scheduler=sched).run(_jnp(batch))
    _assert_same_result(got, want, sched)
    assert got.values.sum() == 1024
    if sched == "auto":
        assert got.strategy == "lpt"


def test_quickstart_pipelined_equals_sequential_and_reference():
    batch = _quickstart_batch()
    runs = quickstart.pipelined_vs_sequential(batch, CPU)
    want = _ref_job(num_slots=4, num_clusters=24, scheduler="os4m", pipeline_chunks=4
                    ).run(_jnp(batch))
    for res in runs.values():
        np.testing.assert_array_equal(res.values, np.asarray(want.values))
        np.testing.assert_array_equal(res.counts, np.asarray(want.counts))


def test_quickstart_reuse_loop_equals_reference():
    from repro.core.schedule_cache import ReusePolicy as RefPolicy

    results, job = quickstart.reuse_loop(CPU)
    ref = _ref_job(num_slots=4, num_clusters=24, scheduler="auto",
                   reuse=RefPolicy(max_drift=0.25, max_age=64))
    vals = np.ones((4, 256, 1), np.float32)
    valid = np.ones((4, 256), bool)
    for i, (got, keys) in enumerate(zip(results, quickstart.reuse_batches())):
        _assert_same_result(got, ref.run(_jnp((keys, vals, valid))), f"batch {i}")
    assert [r.plan_reason for r in results] == ["cold"] + ["ok"] * 5 + ["drift"]
    stats = job.schedule_cache.stats()
    assert stats == ref.schedule_cache.stats() and stats["replans"] == 2


def test_moe_placement_equals_reference():
    from repro.core.balancer import schedule_balanced_cardinality as ref_balanced

    p = moe_balance.placement()
    rng = np.random.default_rng(0)
    loads = np.arange(1, 161, dtype=float) ** -0.6
    rng.shuffle(loads)
    np.testing.assert_array_equal(p["assignment"], ref_balanced(loads, 16, 10))
    assert np.bincount(p["assignment"], minlength=16).tolist() == [10] * 16
    assert p["os4m"] < p["contiguous"]


def test_moe_reuse_loop_equals_reference():
    from repro.core.schedule_cache import ReusePolicy as RefPolicy

    results, job = moe_balance.reuse_loop(CPU)
    ref = _ref_job(num_slots=4, num_clusters=32, scheduler="auto",
                   reuse=RefPolicy(max_drift=0.2))
    ones = np.ones((4, 2048, 1), np.float32)
    valid = np.ones((4, 2048), bool)
    for i, (got, experts) in enumerate(zip(results, moe_balance.routing_batches())):
        _assert_same_result(got, ref.run(_jnp((experts, ones, valid))), f"batch {i}")
    assert [r.reused for r in results] == [False] + [True] * 5 + [False, True]
    assert job.schedule_cache.stats() == ref.schedule_cache.stats()


# ---------------------------------------------------------------------------
# serve_lm from the reference's weights
# ---------------------------------------------------------------------------


def test_serve_lm_streams_and_balance_equal_reference():
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.models.model import init_model as ref_init
    from repro.nn import layers as RL
    from repro.serve.engine import Engine as RefEngine, EngineConfig as RefConfig
    from repro.serve.engine import Request as RefRequest

    from repro_torch.configs import get_smoke
    from repro_torch.serve.engine import Engine, EngineConfig

    ratios = {}
    cfg_ref, cfg = ref_smoke("llama3-8b"), get_smoke("llama3-8b")
    jvals, _ = RL.split(ref_init(jax.random.PRNGKey(0), cfg_ref))
    model = params_from_reference(jax.tree.map(lambda a: np.asarray(a, np.float32), jvals),
                                  cfg, CPU)
    reqs = serve_lm.make_requests(cfg.vocab)
    assert sum(r.max_new for r in reqs) == 366
    # Streams of the example's first STREAMED requests (the reference engine
    # compiles a prefill for every prompt length, so all 24 take ~20 s).
    done, _, eng = serve_lm.serve(cfg, model, reqs[:STREAMED], "os4m", CPU)
    ref = RefEngine(cfg_ref, jvals, RefConfig(scheduler="os4m", **serve_lm.ENGINE))
    want = ref.run(serve_lm.make_requests(cfg.vocab, RefRequest)[:STREAMED])
    assert [(r.rid, r.lane, r.output) for r in done] == \
        [(r.rid, r.lane, r.output) for r in want]
    assert all(len(r.output) == r.max_new for r in done)      # eos=-1: every budget
    assert eng.last_balance_ratio == ref.last_balance_ratio
    # Both schedulers' lane plans of all 24 (the streams take one decode path).
    for sched in ("os4m", "hash"):
        ref_plan = RefEngine(cfg_ref, None, RefConfig(scheduler=sched, **serve_lm.ENGINE))
        ref_plan.plan(serve_lm.make_requests(cfg.vocab, RefRequest))
        port_plan = Engine(cfg, model, EngineConfig(scheduler=sched, **serve_lm.ENGINE),
                           device=CPU)
        port_plan.plan(serve_lm.make_requests(cfg.vocab))
        assert port_plan.last_balance_ratio == ref_plan.last_balance_ratio
        ratios[sched] = port_plan.last_balance_ratio
    assert ratios["os4m"] < ratios["hash"]



# ---------------------------------------------------------------------------
# The trainers, TRAIN_STEPS steps from the reference's weights
# ---------------------------------------------------------------------------


def _np_tree(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _ref_trainer(cfg_ref, shape, opt, tcfg):
    from repro.launch.mesh import single_device_mesh
    from repro.models.config import Shape as RShape
    from repro.train import loop as RL
    from repro.train.optim import OptConfig as ROpt

    return RL.Trainer(cfg_ref, RShape(*shape), single_device_mesh(), opt_cfg=ROpt(**opt),
                      tcfg=RL.TrainerConfig(**tcfg))


def _assert_losses_close(port_hist, ref_hist):
    assert [s for s, _ in port_hist] == [s for s, _ in ref_hist]
    got = [m["loss"] for _, m in port_hist]
    want = [m["loss"] for _, m in ref_hist]
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)


def test_quickstart_tiny_lm_losses_equal_reference(tmp_path):
    from repro.configs import get_smoke as ref_smoke
    from repro.data.synthetic import CorpusConfig as RCorpus, token_batches as ref_batches

    from repro_torch.configs import get_smoke

    cfg_ref = ref_smoke("smollm-360m")
    ref = _ref_trainer(cfg_ref, ("quick", "train", 64, 4),
                       dict(lr=3e-3, warmup_steps=2, decay_steps=20),
                       dict(ckpt_dir=str(tmp_path / "ref"), ckpt_every=100))
    port = quickstart.tiny_lm(CPU, steps=TRAIN_STEPS, ckpt_dir=str(tmp_path / "port"),
                              model=params_from_reference(_np_tree(ref.params),
                                                          get_smoke("smollm-360m"), CPU))
    ref.run(ref_batches(RCorpus(vocab=cfg_ref.vocab), seed=0, batch=4, seq_len=64),
            TRAIN_STEPS)
    _assert_losses_close(port.history, ref.history)


def test_train_lm_losses_equal_reference(tmp_path):
    from repro.configs import get_config as ref_config

    cfg = train_lm.smollm_100m()
    cfg_ref = dataclasses.replace(
        ref_config("smollm-360m"), name="smollm-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv=4, d_ff=1536, param_dtype="float32", compute_dtype="float32",
        logit_dtype="float32")
    assert cfg.param_count() == cfg_ref.param_count()
    ref = _ref_trainer(cfg_ref, ("e2e", "train", 32, 2),
                       dict(lr=6e-4, warmup_steps=20, decay_steps=TRAIN_STEPS),
                       dict(ckpt_dir=str(tmp_path / "ref"), ckpt_every=100, log_every=10))
    port = train_lm.make_trainer(cfg, TRAIN_STEPS, 2, 32, str(tmp_path / "port"), CPU,
                                 model=params_from_reference(_np_tree(ref.params), cfg, CPU))
    batches = train_lm.batches(cfg, 2, 32)
    tokens = [next(batches) for _ in range(TRAIN_STEPS)]
    port.run(iter(tokens), TRAIN_STEPS)
    ref.run(iter(tokens), TRAIN_STEPS)
    _assert_losses_close(port.history, ref.history)


def test_moe_trainer_losses_equal_reference(tmp_path):
    from repro.configs import get_smoke as ref_smoke
    from repro.data.synthetic import CorpusConfig as RCorpus, token_batches as ref_batches

    from repro_torch.configs import get_smoke

    cfg_ref = ref_smoke("deepseek-v2-236b")
    ref = _ref_trainer(cfg_ref, ("moe", "train", 64, 4),
                       dict(lr=2e-3, warmup_steps=5, decay_steps=60),
                       dict(ckpt_dir=str(tmp_path / "ref"), ckpt_every=1000,
                            replan_interval=10, balancer_max_drift=0.1, log_every=10))
    port = moe_balance.trainer(CPU, steps=TRAIN_STEPS, ckpt_dir=str(tmp_path / "port"),
                               model=params_from_reference(_np_tree(ref.params),
                                                           get_smoke("deepseek-v2-236b"), CPU))
    ref.run(ref_batches(RCorpus(vocab=cfg_ref.vocab, zipf_alpha=1.3), seed=0, batch=4,
                        seq_len=64), TRAIN_STEPS)
    _assert_losses_close(port.history, ref.history)


# ---------------------------------------------------------------------------
# The command lines on the CPU
# ---------------------------------------------------------------------------


def test_inverted_index_command_line(tmp_path):
    report = tmp_path / "ii.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.inverted_index", "--device", "cpu",
         "--report", str(report)],
        capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == ("inverted index: 30248 (word, doc) pairs, 8 slots, "
                        "88 operation clusters")
    assert lines[1].startswith("  hash : balance=1.526") and \
        lines[2].startswith("  os4m : balance=1.000")
    got = json.loads(report.read_text())
    assert got["runs"]["os4m"]["balance_ratio"] <= got["runs"]["hash"]["balance_ratio"]
    # The CPU runs the kernels' plain versions: no launch.
    assert all(v == 0 for v in got["launches"].values())


def test_quickstart_and_moe_mains_on_cpu(capsys):
    qs = quickstart.main(["--device", "cpu", "--sections",
                          "schedulers,wordcount,pipelined,reuse"])
    assert qs["pipelined"]["bit_identical"] and qs["reuse"]["stats"]["replans"] == 2
    assert qs["wordcount"]["auto"]["strategy"] == "lpt"
    mb = moe_balance.main(["--device", "cpu", "--sections", "placement,reuse"])
    assert mb["reuse"]["stats"] == {**mb["reuse"]["stats"], "batches": 8, "reuses": 6}
    out = capsys.readouterr().out
    assert "jit_misses" not in out and "executables traced" not in out
    assert "steady state: 5/7 batches reused one plan (replan rate 0.29)" in out
    assert "  one plan served 6/8 batches (replan rate 0.25)" in out
    with pytest.raises(SystemExit):
        quickstart.main(["--device", "cpu", "--sections", "nonsense"])


def test_serve_lm_main_on_cpu(tmp_path):
    got = serve_lm.main(["--device", "cpu", "--report", str(tmp_path / "s.json")])
    assert got["total_budget"] == 366
    for run in got["runs"].values():
        assert run["tokens"] == 366
        assert run["generated"] == {str(i): b for i, b in enumerate(got["budgets"])}
    assert got["runs"]["os4m"]["balance_ratio"] <= got["runs"]["hash"]["balance_ratio"]
    assert json.loads((tmp_path / "s.json").read_text()) == got


def test_train_lm_main_and_resume_on_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    first = train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                           "--ckpt-dir", ckpt])
    assert len(first["losses"]) == 2 and np.isfinite(first["losses"]).all()
    again = train_lm.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
                           "--ckpt-dir", ckpt])
    assert again["start_step"] == 2 and len(again["losses"]) == 1
    out = capsys.readouterr().out
    assert "model: smollm-100m  params ~88M" in out and "resumed from step 2" in out
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]


def test_examples_refuse_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inverted_index.main([])


# ---------------------------------------------------------------------------
# The pinned zipf sampler the examples and the corpus draw through
# ---------------------------------------------------------------------------


def test_zipf_draws_are_pinned_to_numpy_2_0():
    """``synthetic.zipf`` is numpy 2.0's ``Generator.zipf`` on any numpy:
    fixed draws, and where numpy's own sampler is 2.0's, equal to it
    (values and the generator's state after)."""
    from repro_torch.data.synthetic import zipf

    assert zipf(np.random.default_rng(0), 1.3, 12).tolist() == \
        [29, 1, 281, 660, 78, 757, 3, 1, 24, 48, 1, 11]
    r = np.random.default_rng(0)
    assert zipf(r, 1.5) == 7 and r.random() == 0.04097352393619469
    if tuple(int(v) for v in np.__version__.split(".")[:2]) >= (2, 1):
        return                              # numpy's own sampler changed in 2.1
    for a in (1.1, 1.15, 1.3, 1.5, 1.6, 2.2):
        for size in (None, 7, (4, 256), (8, 2048)):
            r1, r2 = np.random.default_rng(int(a * 10)), np.random.default_rng(int(a * 10))
            np.testing.assert_array_equal(zipf(r1, a, size), r2.zipf(a, size))
            assert r1.random() == r2.random()
