"""Schedule reuse and ``scheduler="auto"`` in the port against the reference.

The same numpy batches go through the reference ``MapReduceJob(...,
backend="vmap")`` and through the port on the CPU (``device="cpu"``).
Reuse decisions must come in the same sequence, plans must be equal and
integer-valued outputs bit-equal. The numpy modules the port copied
(``simulator``, ``slot_speeds``) must give equal results, and the torch
drift metric must agree with the jnp one to float32 rounding. The
reference is imported inside the tests only, so the ``gpu`` case also runs
where JAX is absent (``--noconftest -m gpu``).
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import mapreduce as tmr
from repro_torch.core import schedule_cache as tsc


def _identity(batch):
    return batch


def _batch(seed, m=4, k=2048, v=2, key_mod=997, alpha=1.25):
    """Integer-valued f32 pairs (bit-exact in any order), the reference tests' stream."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(alpha, size=(m, k)) % key_mod).astype(np.int32)
    vals = rng.integers(0, 8, size=(m, k, v)).astype(np.float32)
    valid = np.ones((m, k), bool)
    return keys, vals, valid


def _counts_batch(counts, m=2, k=64):
    """Pairs per cluster, identical on every slot (the overflow sequences)."""
    keys = np.concatenate([np.full(c, cl, np.int32) for cl, c in enumerate(counts)])
    return (np.stack([keys] * m), np.ones((m, k, 1), np.float32),
            np.ones((m, k), bool))


def _spy(job):
    """Record every plan ``job._plan`` returns (either package)."""
    plans = []
    plan = job._plan

    def spy(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    job._plan = spy
    return plans


def _jobs(policy_kwargs, m=4, n=32, scheduler="bss", **cfg):
    """A reference job and a port job with equal configurations."""
    from repro.core import schedule_cache as rsc
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    ref_policy = rsc.ReusePolicy(**policy_kwargs) if policy_kwargs is not None else None
    port_policy = tsc.ReusePolicy(**policy_kwargs) if policy_kwargs is not None else None
    ref = MapReduceJob(_identity, MapReduceConfig(
        num_slots=m, num_clusters=n, scheduler=scheduler, reuse=ref_policy,
        use_kernels=True, **cfg), backend="vmap")
    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=m, num_clusters=n, scheduler=scheduler, reuse=port_policy, **cfg),
        device="cpu")
    return ref, port


def _counters(job):
    """The schedule cache's decision counters (the drift value aside)."""
    stats = job.schedule_cache.stats()
    stats.pop("last_drift")
    return stats


def _run_both(ref, port, batch):
    import jax.numpy as jnp

    r = ref.run(tuple(jnp.asarray(a) for a in batch))
    p = port.run(tuple(torch.from_numpy(a) for a in batch))
    np.testing.assert_array_equal(p.values, np.asarray(r.values))
    np.testing.assert_array_equal(p.counts, np.asarray(r.counts))
    np.testing.assert_array_equal(p.key_distribution, np.asarray(r.key_distribution))
    np.testing.assert_array_equal(p.schedule.assignment, r.schedule.assignment)
    assert (p.reused, p.plan_reason, p.overflow) == (r.reused, r.plan_reason, r.overflow)
    assert (p.drift is None) == (r.drift is None)
    if r.drift is not None:
        assert p.drift == pytest.approx(r.drift, abs=1e-6)
    assert p.speed_drift == r.speed_drift
    assert p.strategy == r.strategy
    assert p.strategy_costs == r.strategy_costs
    return r, p


# ---------------------------------------------------------------------------
# Numpy-copied modules and the drift metric.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["l1", "chi2"])
@pytest.mark.parametrize("shape", [(12,), (4, 12)])
def test_drift_metric_matches_reference(kind, shape):
    from repro.core.schedule_cache import drift_metric

    rng = np.random.default_rng(len(shape))
    for _ in range(5):
        p = rng.integers(0, 50, size=shape).astype(np.float32)
        q = rng.integers(0, 50, size=shape).astype(np.float32)
        want = float(drift_metric(p, q, kind))
        got = tsc.drift_metric(torch.from_numpy(p), torch.from_numpy(q), kind)
        assert got.dim() == 0 and got.dtype == torch.float32
        assert float(got) == pytest.approx(want, abs=1e-6)
        assert float(tsc.drift_metric(p, q, kind)) == pytest.approx(want, abs=1e-6)
    with pytest.raises(ValueError):
        tsc.drift_metric(p, q, "kl")


def test_speed_drift_matches_reference():
    from repro.core import slot_speeds as rss

    from repro_torch.core import slot_speeds as tss

    rng = np.random.default_rng(0)
    cases = [(None, None), (np.ones(4), None), (None, rng.uniform(0.5, 2, 4)),
             (rng.uniform(0.5, 2, 4), rng.uniform(0.5, 2, 4)),
             (np.array([1.0, 0.0, 1.0, 2.0]), np.array([1.0, 0.0, 1.5, 2.0]))]
    for ref_speeds, fresh in cases:
        assert tss.speed_drift(ref_speeds, fresh) == rss.speed_drift(ref_speeds, fresh)


@pytest.mark.parametrize("pipelined", [True, False])
def test_estimate_reduce_time_matches_reference(pipelined):
    from repro.core import scheduler as rsched
    from repro.core import simulator as rsim

    from repro_torch.core import scheduler as tsched
    from repro_torch.core import simulator as tsim

    m = 6
    rng = np.random.default_rng(7)
    loads = rng.zipf(1.2, 80).clip(1, 9000).astype(float)
    local = rng.integers(0, 30, size=(m, 80)).astype(np.float32)
    for kw in ({}, {"local_hist": local, "bytes_per_pair": 40.0},
               {"speeds": rng.uniform(0.5, 1.5, m), "pipeline_order": "decreasing"}):
        want = rsim.estimate_reduce_time(loads, rsched.schedule_lpt(loads, m),
                                         pipelined=pipelined, **kw)
        got = tsim.estimate_reduce_time(loads, tsched.schedule_lpt(loads, m),
                                        pipelined=pipelined, **kw)
        assert got == want
    ref_cluster = rsim.PAPER_CLUSTER
    assert (tsim.PAPER_CLUSTER.reduce_slots_per_node, tsim.PAPER_CLUSTER.net_bw,
            tsim.PAPER_CLUSTER.disk_read_bw) == (
        ref_cluster.reduce_slots_per_node, ref_cluster.net_bw, ref_cluster.disk_read_bw)


@pytest.mark.parametrize("m", [4, 8])
def test_pick_strategy_and_replan_benefit_match_reference(m):
    from repro.core import scheduler as rsched
    from repro.core import simulator as rsim

    from repro_torch.core import scheduler as tsched
    from repro_torch.core import simulator as tsim

    rng = np.random.default_rng(m)
    loads = rng.zipf(1.3, 64).clip(1, 5000).astype(float)
    local = rng.integers(0, 40, size=(m, 64)).astype(np.float32)
    for kw in ({}, {"pipelined": False, "bytes_per_pair": 48.0, "local_hist": local},
               {"speeds": rng.uniform(0.5, 1.5, m)}):
        want = rsim.pick_strategy(loads, m, **kw)
        got = tsim.pick_strategy(loads, m, **kw)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1].assignment, want[1].assignment)
        drifted = np.roll(loads, 17) * rng.uniform(0.2, 5.0, 64)
        assert tsim.estimate_replan_benefit(
            drifted, tsched.schedule_bss(loads, m), **kw) == rsim.estimate_replan_benefit(
            drifted, rsched.schedule_bss(loads, m), **kw)
    for name in ("hash", "lpt", "multifit", "bss", "os4m", "brute"):
        assert tsim.scheduling_overhead(name, 352, 32) == rsim.scheduling_overhead(name, 352, 32)


# ---------------------------------------------------------------------------
# Reuse sequences (those of tests/test_schedule_reuse.py), both engines.
# ---------------------------------------------------------------------------


def test_stationary_batches_plan_once():
    ref, port = _jobs({"max_drift": 0.2})
    ref_plans, port_plans = _spy(ref), _spy(port)
    for seed in range(5):
        _run_both(ref, port, _batch(seed))
    assert len(port_plans) == len(ref_plans) == 1
    assert _counters(port) == _counters(ref)
    assert port.schedule_cache.stats()["reuses"] == 4


def test_reused_batch_uploads_no_baseline_again():
    ref, port = _jobs({"max_drift": 0.2})
    _run_both(ref, port, _batch(0))
    _run_both(ref, port, _batch(1))
    baseline = port.schedule_cache.snapshot._hist_dev
    assert baseline is not None
    for seed in (2, 3):
        res = _run_both(ref, port, _batch(seed))[1]
        assert res.reused and port.schedule_cache.snapshot._hist_dev is baseline


def test_shifted_distribution_replans():
    ref, port = _jobs({"max_drift": 0.15})
    for seed in range(3):
        _run_both(ref, port, _batch(seed, alpha=1.25))
    r, p = _run_both(ref, port, _batch(99, alpha=2.2))
    assert p.plan_reason == "drift" and p.drift > 0.15
    assert _run_both(ref, port, _batch(100, alpha=2.2))[1].reused


def test_max_age_sequence():
    ref, port = _jobs({"max_drift": 1.0, "max_age": 2})
    reasons = [_run_both(ref, port, _batch(0))[1].plan_reason for _ in range(7)]
    assert reasons == ["cold", "ok", "ok", "max_age", "ok", "ok", "max_age"]


def test_revalidate_every_sequence():
    ref, port = _jobs({"max_drift": 0.5, "revalidate_every": 3})
    for seed in range(7):
        _run_both(ref, port, _batch(seed))
    assert _counters(port) == _counters(ref)
    assert port.schedule_cache.stats()["drift_checks"] == 2


@pytest.mark.parametrize("slack,reason", [(0.0, "overflow"), (2.0, "ok")])
def test_overflow_forced_replan(slack, reason):
    ref, port = _jobs({"max_drift": 0.5, "capacity_slack": slack},
                      m=2, n=4, pipelined=False)
    ref_plans, port_plans = _spy(ref), _spy(port)
    _run_both(ref, port, _counts_batch([16, 16, 16, 16]))
    _, p = _run_both(ref, port, _counts_batch([40, 8, 8, 8]))
    assert p.plan_reason == reason and p.overflow == 0
    assert port.schedule_cache.capacity_fallbacks == ref.schedule_cache.capacity_fallbacks
    assert port.schedule_cache.capacity_fallbacks == (reason == "overflow")
    assert len(port_plans) == len(ref_plans)
    assert port.last_plan.capacity == ref_plans[-1].capacity
    assert port.last_plan.chunk_caps == ref_plans[-1].chunk_caps


def test_cost_gate_sequence():
    """auto + cost_gate: the gate's verdicts and the refreshed baselines agree."""
    ref, port = _jobs({"max_drift": 0.01, "cost_gate": True}, scheduler="auto")
    for seed in (0, 1, 1, 2):
        r, p = _run_both(ref, port, _batch(seed))
        assert (p.replan_benefit is None) == (r.replan_benefit is None)
        if r.replan_benefit is not None:
            assert p.replan_benefit == r.replan_benefit
    np.testing.assert_array_equal(port.schedule_cache.snapshot.local_hist,
                                  np.asarray(ref.schedule_cache.snapshot.local_hist))


def test_auto_picks_the_reference_strategy():
    """Equal strategy and strategy_costs, also once a measured wire rate exists."""
    ref, port = _jobs(None, m=8, n=96, scheduler="auto", pipeline_chunks=3)
    for seed, alpha in ((0, 1.25), (1, 1.6), (2, 3.0)):
        r, p = _run_both(ref, port, _batch(seed, m=8, k=1024, alpha=alpha))
        assert p.strategy in ("hash", "lpt", "multifit", "bss")
        assert set(p.strategy_costs) == {"hash", "lpt", "multifit", "bss"}
        assert port._wire_rate() == ref._wire_rate()


# ---------------------------------------------------------------------------
# Snapshots across the two packages.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("stats", ["exact", "sketch"])
def test_snapshot_replays_in_the_other_package(writer, stats):
    """A snapshot written by one package loads into the other and replays."""
    import jax.numpy as jnp

    cfg = dict(stats=stats, sketch_width=64) if stats == "sketch" else {}
    ref, port = _jobs({"max_drift": 0.5}, **cfg)
    _run_both(ref, port, _batch(0))
    source = ref if writer == "reference" else port
    snapshot = json.loads(json.dumps(source.schedule_cache.snapshot.to_json()))
    assert tsc.CachedSchedule.from_json(snapshot).to_json() == snapshot

    fresh_ref, fresh_port = _jobs({"max_drift": 0.5}, **cfg)
    fresh_ref.load_snapshot(snapshot)
    fresh_port.load_snapshot(snapshot)
    port_plans = _spy(fresh_port)
    batch = _batch(1)
    r = fresh_ref.run(tuple(jnp.asarray(a) for a in batch))
    p = fresh_port.run(tuple(torch.from_numpy(a) for a in batch))
    assert p.reused and r.reused and port_plans == []
    np.testing.assert_array_equal(p.values, np.asarray(r.values))
    np.testing.assert_array_equal(p.counts, np.asarray(r.counts))
    # ... and the replay equals the original job's own run of the batch.
    _, p_orig = _run_both(ref, port, batch)
    np.testing.assert_array_equal(p.values, p_orig.values)


def test_load_snapshot_rejects_mismatched_plans():
    _, port = _jobs({"max_drift": 0.5})
    port.run(tuple(torch.from_numpy(a) for a in _batch(0)))
    snap = port.schedule_cache.snapshot.to_json()
    _, other = _jobs({"max_drift": 0.5}, n=16)
    with pytest.raises(ValueError, match="clusters"):
        other.load_snapshot(snap)
    no_reuse = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=4, num_clusters=32),
                                device="cpu")
    with pytest.raises(ValueError, match="reuse"):
        no_reuse.load_snapshot(snap)


def test_attach_schedule_cache_adopts_policy_and_snapshot():
    _, donor = _jobs({"max_drift": 0.5})
    donor.run(tuple(torch.from_numpy(a) for a in _batch(0)))
    job = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=4, num_clusters=32,
                                                          scheduler="bss"), device="cpu")
    job.attach_schedule_cache(donor.schedule_cache)
    assert job.cfg.reuse is donor.schedule_cache.policy
    res = job.run(tuple(torch.from_numpy(a) for a in _batch(1)))
    assert res.reused and donor.schedule_cache.stats()["reuses"] == 1


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_reuse_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.histogram import ops as hist_ops

    jobs = {dev: tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=4, num_clusters=32, scheduler="bss",
        reuse=tsc.ReusePolicy(max_drift=0.15)), device=dev) for dev in ("cpu", "cuda")}
    plans = _spy(jobs["cuda"])
    h0 = hist_ops.launches
    for seed, alpha in ((0, 1.25), (1, 1.25), (2, 2.2), (3, 2.2)):
        batch = _batch(seed, alpha=alpha)
        res = {dev: job.run(tuple(torch.from_numpy(a).to(dev) for a in batch))
               for dev, job in jobs.items()}
        assert res["cuda"].plan_reason == res["cpu"].plan_reason
        assert res["cuda"].drift == pytest.approx(res["cpu"].drift, abs=1e-6) \
            if res["cpu"].drift is not None else res["cuda"].drift is None
        np.testing.assert_array_equal(res["cuda"].values, res["cpu"].values)
    assert res["cuda"].reused   # the last batch replayed the drift replan's plan
    assert hist_ops.launches == h0 + 4
    assert len(plans) == jobs["cuda"].schedule_cache.stats()["replans"] == 2
    assert jobs["cuda"].schedule_cache.snapshot._hist_dev.device.type == "cuda"
