"""The elastic mesh in the port against the reference.

Dead slots, wave-checkpointed replay after a mid-batch kill and warm
resizes. The same numpy inputs, drawn from a seed, go through the
reference (``backend="vmap"``) and through the port on the CPU, over the
cases of ``tests/test_elastic_mesh.py``:

* ``rebin_hist`` equals the reference's (exactly: the same float64 sums in
  the same order) and conserves per-cluster mass; an 8 -> 6 -> 8
  ``reproject`` of a live job's snapshot gives the reference's plans;
* dead-slot assignments of lpt, multifit, bss, brute and hash equal the
  reference's; the estimator's mask-out and rejoin; reason ``slot_dead``;
* an uninterrupted checkpointed run equals the fused run and the
  reference's checkpointed run, and a kill at wave 2 or 0 gives the
  reference's values, counts, checkpoint cursor, replayed waves, replay
  plan and mesh events. Values are integer-valued float32, so every
  comparison of outputs is bitwise; plans are compared exactly;
* the configuration errors;
* the sharded backend (``devices=["cpu"] * m``): a kill equals the stacked
  run, and ``resize(..., devices=...)`` re-places the slots;
* a reused plan of the escalated shape (every cap at the safe bound)
  walked checkpointed at the batch's cut caps.

The ``gpu`` cases (skipped without a card) hold the checkpointed walk and
a killed replay on CUDA against the fused run. The reference is imported
inside the CPU tests only, so they also run where JAX is absent
(``--noconftest -m gpu``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mapreduce as tmr
from repro_torch.core import pipeline as tpipe
from repro_torch.core import schedule_cache as tsc
from repro_torch.core import scheduler as tsched
from repro_torch.core import slot_speeds as tss


def _identity(batch):
    return batch


def _batch(seed=0, m=8, k=1024, v=4, key_mod=337, alpha=1.25, invalid=0.03):
    """Skewed keys, a few invalid pairs, integer-valued f32 values."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(alpha, size=(m, k)) % key_mod).astype(np.int32)
    keys[:, ::5] *= -1
    vals = rng.integers(-3, 6, size=(m, k, v)).astype(np.float32)
    valid = rng.random((m, k)) >= invalid
    return keys, vals, valid


def _torch(batch, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def _jnp(batch):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in batch)


def _port(m=8, n=48, device="cpu", **cfg):
    cfg.setdefault("scheduler", "bss")
    return tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=m, num_clusters=n, **cfg),
                            device=device)


def _sharded(m=8, n=48, **cfg):
    cfg.setdefault("scheduler", "bss")
    return tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=m, num_clusters=n, **cfg),
                            backend="sharded", devices=["cpu"] * m)


def _ref(m=8, n=48, **cfg):
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    cfg.setdefault("scheduler", "bss")
    return MapReduceJob(_identity, MapReduceConfig(num_slots=m, num_clusters=n,
                                                   use_kernels=True, **cfg), backend="vmap")


def _assert_same_outputs(a, b):
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))
    np.testing.assert_array_equal(np.asarray(a.counts), np.asarray(b.counts))
    assert a.overflow == b.overflow


def _assert_same_plan(port, ref):
    np.testing.assert_array_equal(port.schedule.assignment, ref.schedule.assignment)
    np.testing.assert_array_equal(port.waves.rank_of_cluster, ref.waves.rank_of_cluster)
    np.testing.assert_array_equal(port.waves.chunk_of_cluster, ref.waves.chunk_of_cluster)
    assert port.capacity == ref.capacity and tuple(port.chunk_caps) == tuple(ref.chunk_caps)
    assert port.k_per_shard == ref.k_per_shard
    np.testing.assert_array_equal(port.local_hist, np.asarray(ref.local_hist))


def _assert_same_stats(port, ref):
    """Cache counters equal; the drift, a float32 reduction in each
    package's own order, within 1e-6."""
    drift = ("last_drift", "last_speed_drift")
    assert {k: v for k, v in port.items() if k not in drift} == {
        k: v for k, v in ref.items() if k not in drift}
    for key in drift:
        if ref[key] is None:
            assert port[key] is None
        else:
            assert port[key] == pytest.approx(ref[key], rel=1e-6, abs=1e-9)


# ---------------------------------------------------------------------------
# Re-projection.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("new_m", [1, 3, 6, 8, 11])
def test_rebin_hist_matches_reference_and_conserves_mass(new_m):
    from repro.core import schedule_cache as rsc

    h = np.random.default_rng(7).integers(0, 50, size=(8, 17)).astype(np.float64)
    out = tsc.rebin_hist(h, new_m)
    np.testing.assert_array_equal(out, rsc.rebin_hist(h, new_m))
    assert out.shape == (new_m, 17)
    np.testing.assert_allclose(out.sum(axis=0), h.sum(axis=0), rtol=0, atol=1e-9)
    assert (out >= -1e-12).all()


def test_rebin_hist_same_m_is_a_copy_and_round_trips():
    h = np.random.default_rng(3).random((4, 5))
    out = tsc.rebin_hist(h, 4)
    np.testing.assert_array_equal(out, h)
    assert out is not h
    g = np.random.default_rng(4).integers(0, 100, size=(8, 23)).astype(np.float64)
    back = tsc.rebin_hist(tsc.rebin_hist(g, 6), 8)
    np.testing.assert_allclose(back.sum(axis=0), g.sum(axis=0), rtol=0, atol=1e-9)


@pytest.mark.parametrize("args", [(np.ones(5), 2), (np.ones((2, 5)), 0)],
                         ids=["1-d", "zero-slots"])
def test_rebin_hist_validation_as_reference(args):
    from repro.core import schedule_cache as rsc

    for mod in (tsc, rsc):
        with pytest.raises(ValueError):
            mod.rebin_hist(*args)


def test_reproject_8_to_6_to_8_matches_reference():
    """A warm resize re-projects the live snapshot: the port's plans equal
    the reference's at 6 and back at 8, per-cluster mass survives, and the
    next batch is not cold."""
    from repro.core import schedule_cache as rsc

    ref = _ref(n=24, reuse=rsc.ReusePolicy(max_drift=0.5, revalidate_every=1))
    port = _port(n=24, reuse=tsc.ReusePolicy(max_drift=0.5, revalidate_every=1))

    def both(m, seed):
        batch = _batch(seed, m=m, k=512, key_mod=24 * 7 + 1)
        r, p = ref.run(_jnp(batch)), port.run(_torch(batch))
        _assert_same_outputs(p, r)
        assert p.plan_reason == r.plan_reason and p.reused == r.reused
        return p

    both(8, 0)
    key_dist8 = port.schedule_cache.snapshot.key_dist.copy()
    for step, m in enumerate((6, 8)):
        ref.resize(m)
        port.resize(m)
        snap = port.schedule_cache.snapshot
        _assert_same_plan(snap, ref.schedule_cache.snapshot)
        assert snap.schedule.num_slots == m and snap.local_hist.shape[0] == m
        np.testing.assert_allclose(snap.key_dist, key_dist8, atol=1e-6)
        assert port.schedule_cache.reprojections == step + 1
        assert both(m, step + 1).plan_reason != "cold"
    _assert_same_stats(port.schedule_cache.stats(), ref.schedule_cache.stats())
    assert port.mesh_events == ref.mesh_events


def test_reproject_rescales_k_per_shard():
    sched = tsched.schedule_lpt(np.ones(10), 8)
    hist = np.tile(np.ones(10) / 8.0, (8, 1)) * 8
    waves = tpipe.plan_waves(hist.sum(axis=0), sched.assignment, sched.num_slots, num_chunks=1)
    snap = tsc.CachedSchedule(
        schedule=sched, strategy="lpt", strategy_costs=None, waves=waves, capacity=4,
        chunk_caps=(4,), local_hist=hist, key_dist=hist.sum(axis=0), k_per_shard=12)
    seen = {}

    def planner(local_hist, key_dist, k_per_shard, prev):
        seen.update(k=k_per_shard, m=local_hist.shape[0], prev=prev)
        s2 = tsched.schedule_lpt(key_dist, local_hist.shape[0])
        return tsc.CachedSchedule(
            schedule=s2, strategy="lpt", strategy_costs=None,
            waves=tpipe.plan_waves(key_dist, s2.assignment, s2.num_slots, num_chunks=1),
            capacity=4, chunk_caps=(4,), local_hist=local_hist, key_dist=key_dist)

    out = snap.reproject(6, planner)
    # ceil(12 * 8 / 6) = 16: total plan-time pairs conserved.
    assert seen == {"k": 16, "m": 6, "prev": None}
    assert out.k_per_shard == 16
    assert snap.reproject(8, planner) is snap


# ---------------------------------------------------------------------------
# Dead slots in the assigners, the estimator and the cache.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lpt", "multifit", "bss"])
def test_dead_slot_assignments_match_reference(name):
    from repro.core import scheduler as rs

    speeds = np.array([1.0, 0.0, 0.7, 1.3, 0.0, 1.0])
    for seed in range(5):
        loads = np.random.default_rng(seed).integers(1, 40, size=12).astype(float)
        got = tsched.get_scheduler(name)(loads, 6, speeds=speeds)
        want = rs.get_scheduler(name)(loads, 6, speeds=speeds)
        np.testing.assert_array_equal(got.assignment, want.assignment)
        assert got.slot_loads[1] == got.slot_loads[4] == 0.0
        assert got.slot_finish[1] == 0.0
        np.testing.assert_allclose(got.slot_loads.sum(), loads.sum())


def test_dead_slots_brute_and_hash_match_reference():
    from repro.core import scheduler as rs

    loads = np.random.default_rng(3).integers(1, 30, size=9).astype(float)
    speeds = np.array([1.0, 0.0, 0.5, 1.5])
    full = tsched.schedule_brute(loads, 4, speeds=speeds)
    alive = tsched.schedule_brute(loads, 3, speeds=np.array([1.0, 0.5, 1.5]))
    np.testing.assert_array_equal(full.assignment,
                                  rs.schedule_brute(loads, 4, speeds=speeds).assignment)
    assert full.makespan == pytest.approx(alive.makespan) and full.slot_loads[1] == 0.0
    hash_speeds = np.array([1.0, 1.0, 0.0, 1.0])
    keyed = np.arange(1, 33, dtype=float)
    got = tsched.schedule_hash(keyed, 4, speeds=hash_speeds)
    np.testing.assert_array_equal(
        got.assignment, rs.schedule_hash(keyed, 4, speeds=hash_speeds).assignment)
    assert got.slot_loads[2] == 0.0


def test_estimator_mask_out_and_rejoin_match_reference():
    from repro.core import slot_speeds as rss

    ests = [mod.SlotSpeedEstimator(num_slots=4, ewma=0.5) for mod in (tss, rss)]
    loads = np.full(4, 100.0)
    for seconds, action in ((np.array([1.0, 1.0, 2.0, 1.0]), ("fail", 2)),
                            (np.array([1.0, 1.0, 0.5, 1.0]), ("join", 2)),
                            (np.array([1.0, 2.0, 1.0, 1.0]), None),
                            (np.ones(4), ("resize", 2)), (np.ones(2), ("resize", 5))):
        for est in ests:
            est.update(loads[:est.num_slots], seconds)
            got = est.speeds()
            if action is None:
                continue
            kind, arg = action
            if kind == "fail":
                est.set_slot_failure(arg)
                assert est.speeds()[arg] == 0.0
                est.update(loads, np.array([1.0, 1.0, 0.5, 1.0]))
                assert est.speeds()[arg] == 0.0     # observations of the dead are dropped
            elif kind == "join":
                est.set_slot_failure(arg, dead=False)
            else:
                est.resize(arg)
                assert est.dead_mask.shape == (arg,) and not est.dead_mask.any()
        np.testing.assert_array_equal(ests[0].speeds(), ests[1].speeds())
        assert got is not None
    assert tss.speed_drift(np.array([1.0, 1.0]), np.array([1.0, 0.0])) == np.inf


def _snapshot(mod_sc, mod_sched, mod_pipe, speeds):
    key_dist = np.ones(8) * 10
    sched = mod_sched.Schedule.from_assignment(np.arange(8, dtype=np.int32) % 4, key_dist, 4,
                                               speeds=speeds)
    return mod_sc.CachedSchedule(
        schedule=sched, strategy="lpt", strategy_costs=None,
        waves=mod_pipe.plan_waves(key_dist, sched.assignment, sched.num_slots, num_chunks=1),
        capacity=8, chunk_caps=(8,), local_hist=np.tile(key_dist / 4.0, (4, 1)),
        key_dist=key_dist)


@pytest.mark.parametrize("planned,fresh,action,reason", [
    ([1, 1, 1, 1], [1, 1, 0, 1], "replan", "slot_dead"),
    ([1, 1, 0, 1], [1, 1, 1, 1], "replan", "slot_dead"),
    ([1, 1, 0, 1], [1, 1, 0, 1], "reuse", None),
], ids=["death", "rejoin", "same-dead-set"])
def test_slot_dead_reason_matches_reference(planned, fresh, action, reason):
    from repro.core import pipeline as rpipe
    from repro.core import schedule_cache as rsc
    from repro.core import scheduler as rs

    decisions, stats = [], []
    for mod_sc, mod_sched, mod_pipe in ((tsc, tsched, tpipe), (rsc, rs, rpipe)):
        cache = mod_sc.ScheduleCache(mod_sc.ReusePolicy(max_drift=0.5, revalidate_every=1))
        cache.store(_snapshot(mod_sc, mod_sched, mod_pipe, np.asarray(planned, float)))
        d = cache.decide(cache.snapshot.local_hist, fresh_speeds=np.asarray(fresh, float))
        decisions.append((d.action, d.reason))
        stats.append(cache.dead_replans)
    assert decisions[0] == decisions[1] and stats[0] == stats[1]
    assert decisions[0][0] == action
    if reason is not None:
        assert decisions[0][1] == reason and stats[0] == 1


# ---------------------------------------------------------------------------
# Wave-checkpointed replay.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce_op,pipelined", [
    ("sum", True), ("max", True), ("count", True), ("sum", False)])
def test_uninterrupted_checkpointed_run_equals_fused_and_reference(reduce_op, pipelined):
    batch = _batch(0)
    cfg = dict(pipeline_chunks=4, reduce_op=reduce_op, pipelined=pipelined)
    fused = _port(**cfg).run(_torch(batch))
    job = _port(checkpoint_waves=True, **cfg)
    got = job.run(_torch(batch))
    ref = _ref(checkpoint_waves=True, **cfg)
    want = ref.run(_jnp(batch))
    _assert_same_outputs(got, want)
    np.testing.assert_array_equal(got.schedule.assignment, want.schedule.assignment)
    if reduce_op != "count":
        # count: the fused walk broadcasts its (m, n, 1) chunks over V, the
        # checkpointed merge keeps the reference's (n, 1).
        _assert_same_outputs(got, fused)
    else:
        np.testing.assert_array_equal(got.values[:, 0], fused.values[:, 0])
    assert job.last_checkpoint_wave == ref.last_checkpoint_wave
    assert job.last_checkpoint.num_chunks == ref.last_checkpoint.num_chunks
    assert job.last_replayed_waves == ref.last_replayed_waves == 0
    assert job.last_replay_plan is None and job.mesh_events == []
    assert got.shuffle_bytes is None


@pytest.mark.parametrize("slot,wave,seed", [(3, 2, 0), (0, 0, 2), (5, 1, 1), (6, 9, 3)],
                         ids=["wave-2", "wave-0", "wave-1", "past-the-last"])
def test_kill_replays_the_residue_as_the_reference(slot, wave, seed):
    batch = _batch(seed)
    base = _port(pipeline_chunks=4).run(_torch(batch))
    job = _port(pipeline_chunks=4, checkpoint_waves=True)
    ref = _ref(pipeline_chunks=4, checkpoint_waves=True)
    for j in (job, ref):
        j.set_slot_failure(slot, at_wave=wave)
    got, want = job.run(_torch(batch)), ref.run(_jnp(batch))
    _assert_same_outputs(got, want)
    _assert_same_outputs(got, base)
    assert job.last_checkpoint_wave == ref.last_checkpoint_wave == min(wave, 4)
    assert job.last_replayed_waves == ref.last_replayed_waves
    assert job.last_replayed_waves <= job.last_checkpoint.num_chunks - job.last_checkpoint_wave
    np.testing.assert_array_equal(job.last_checkpoint.completed_clusters,
                                  ref.last_checkpoint.completed_clusters)
    if wave < 4:
        _assert_same_plan(job.last_replay_plan, ref.last_replay_plan)
        assert job.last_replay_plan.schedule.slot_loads[slot] == 0.0
    else:
        assert job.last_replay_plan is ref.last_replay_plan is None
    assert bool(job.dead_slots[slot]) and job.mesh_events == ref.mesh_events
    assert [e["event"] for e in job.mesh_events] == ["slot_dead"]


def test_next_batch_plans_around_the_corpse_as_the_reference():
    from repro.core import schedule_cache as rsc

    job = _port(pipeline_chunks=4, checkpoint_waves=True, reuse=tsc.ReusePolicy())
    ref = _ref(pipeline_chunks=4, checkpoint_waves=True, reuse=rsc.ReusePolicy())
    for j in (job, ref):
        j.set_slot_failure(5, at_wave=1)
    events = []
    job.on_mesh_change = events.append
    for seed in range(3):
        got, want = job.run(_torch(_batch(seed))), ref.run(_jnp(_batch(seed)))
        _assert_same_outputs(got, want)
        assert (got.plan_reason, got.reused) == (want.plan_reason, want.reused)
        np.testing.assert_array_equal(got.schedule.assignment, want.schedule.assignment)
    assert job.schedule_cache.stats()["dead_replans"] == 1
    assert got.schedule.slot_loads[5] == 0.0 and job.current_speeds()[5] == 0.0
    np.testing.assert_array_equal(job.current_speeds(), ref.current_speeds())
    assert events == job.mesh_events == ref.mesh_events


def test_dead_slot_and_rejoin_match_reference():
    """``set_slot_slowdown(i, 0)`` marks the slot dead; the next plans route
    around it, and a revived slot is planned again, as in the reference."""
    job, ref = _port(estimate_speeds=True), _ref(estimate_speeds=True)
    for step, action in enumerate(("slow", "dead", None, "join", None)):
        for j in (job, ref):
            if action == "slow":
                j.set_slot_slowdown(1, 2.0)
            elif action == "dead":
                j.set_slot_slowdown(2, 0)
            elif action == "join":
                j.set_slot_failure(2, dead=False)
        batch = _batch(step)
        got, want = job.run(_torch(batch)), ref.run(_jnp(batch))
        _assert_same_outputs(got, want)
        np.testing.assert_array_equal(got.schedule.assignment, want.schedule.assignment)
        np.testing.assert_array_equal(job.dead_slots, ref.dead_slots)
        np.testing.assert_allclose(job.current_speeds(), ref.current_speeds(), rtol=1e-12)
        if action == "dead":
            assert got.schedule.slot_loads[2] == 0.0
    assert job.mesh_events == ref.mesh_events
    assert [e["event"] for e in job.mesh_events] == ["slot_dead", "slot_join"]


def test_resize_mesh_events_and_state_match_reference():
    job, ref = _port(speeds=(1.0, 2.0, 1.0, 1.0, 0.5, 1.0, 1.0, 1.0),
                     checkpoint_waves=True), _ref(speeds=(1.0, 2.0, 1.0, 1.0, 0.5, 1.0, 1.0, 1.0),
                                                  checkpoint_waves=True)
    for j in (job, ref):
        j.set_slot_failure(1)
        j.set_slot_failure(6, at_wave=1)
        j.set_slot_slowdown(3, 3.0)
        j.resize(5)
        j.resize(9)
    assert job.mesh_events == ref.mesh_events
    np.testing.assert_array_equal(job.dead_slots, ref.dead_slots)
    np.testing.assert_array_equal(job._slot_slowdown, ref._slot_slowdown)
    assert job._kill_at_wave == ref._kill_at_wave == {}
    assert job.cfg.speeds == ref.cfg.speeds and job.cfg.num_slots == 9
    np.testing.assert_array_equal(job.current_speeds(), ref.current_speeds())
    batch = _batch(4, m=9)
    _assert_same_outputs(job.run(_torch(batch)), ref.run(_jnp(batch)))
    with pytest.raises(ValueError, match="devices"):
        job.resize(4, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        job.resize(0)


def _measured_sharded():
    return tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=2, num_clusters=4, checkpoint_waves=True, estimate_speeds=True),
        backend="sharded", devices=["cpu"] * 2)


@pytest.mark.parametrize("settings,match", [
    (dict(checkpoint_waves=True, measure_timings=True), "measure_timings"),
    (dict(checkpoint_waves=True, shuffle_replication=2), "checkpoint_waves"),
    (dict(checkpoint_waves=True, quantize_shuffle="int8"), "checkpoint_waves"),
    (dict(checkpoint_waves=True, stats="sketch"), "checkpoint_waves"),
], ids=["measured", "coded", "quantized", "sketch"])
def test_configuration_errors_as_reference(settings, match):
    from repro.core import mapreduce as rmr

    for mr, kwargs in ((rmr, {"backend": "vmap"}), (tmr, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            mr.MapReduceJob(_identity, mr.MapReduceConfig(num_slots=2, num_clusters=4,
                                                          **settings), **kwargs)


def test_kill_and_measured_sharded_errors():
    """A kill needs wave checkpoints, as in the reference; on the sharded
    backend estimated speeds resolve to measured timings, which exclude
    checkpoints unless ``measure_timings=False``."""
    for job in (_port(), _ref()):
        with pytest.raises(ValueError, match="checkpoint_waves"):
            job.set_slot_failure(1, at_wave=1)
        with pytest.raises(ValueError):
            job.set_slot_failure(1, dead=False, at_wave=1)
    with pytest.raises(ValueError, match="measured timings"):
        _measured_sharded()
    job = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=2, num_clusters=4, checkpoint_waves=True, estimate_speeds=True,
        measure_timings=False), backend="sharded", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="at_wave"):
        job.set_slot_failure(0, at_wave=-1)


# ---------------------------------------------------------------------------
# The sharded backend.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wave,cut", [(None, {}), (2, {}), (2, dict(capacity_send=24))],
                         ids=["clean", "kill-at-2", "kill-at-2-overflow"])
def test_sharded_checkpointed_run_equals_stacked(wave, cut):
    """The stacked walk (its kept pairs as indices) equals the sharded one
    (padded bucket files); ``-overflow`` cuts every cap below the hottest
    group, in the walk and in the replay."""
    batch = _batch(1)
    stacked = _port(pipeline_chunks=4, checkpoint_waves=True, **cut)
    sharded = _sharded(pipeline_chunks=4, checkpoint_waves=True, **cut)
    if wave is not None:
        for j in (stacked, sharded):
            j.set_slot_failure(4, at_wave=wave)
    want, got = stacked.run(_torch(batch)), sharded.run(_torch(batch))
    _assert_same_outputs(got, want)
    if cut:
        # The replay plans the residue anew, so its drops are its own.
        assert got.overflow > 0 and sharded.last_replayed_waves > 0
        return
    np.testing.assert_array_equal(got.schedule.assignment, want.schedule.assignment)
    assert sharded.last_checkpoint_wave == stacked.last_checkpoint_wave
    assert sharded.last_replayed_waves == stacked.last_replayed_waves
    if wave is not None:
        _assert_same_plan(sharded.last_replay_plan, stacked.last_replay_plan)
    assert sharded.mesh_events == stacked.mesh_events
    _assert_same_outputs(got, _port(pipeline_chunks=4).run(_torch(batch)))


def test_sharded_resize_places_the_new_slots():
    """``resize(6, devices=...)`` re-places the sharded job's slots and
    re-projects its snapshot; the next batches equal the stacked job's and
    the reference's."""
    from repro.core import schedule_cache as rsc

    jobs = {"sharded": _sharded(n=24, reuse=tsc.ReusePolicy(), checkpoint_waves=True),
            "stacked": _port(n=24, reuse=tsc.ReusePolicy(), checkpoint_waves=True)}
    ref = _ref(n=24, reuse=rsc.ReusePolicy(), checkpoint_waves=True)
    for step, m in enumerate((8, 6, 6)):
        if step == 1:
            jobs["sharded"].resize(6, devices=["cpu"] * 6)
            jobs["stacked"].resize(6)
            ref.resize(6)
            assert len(jobs["sharded"].devices) == 6 == len(jobs["sharded"].streams)
            _assert_same_plan(jobs["sharded"].schedule_cache.snapshot,
                              ref.schedule_cache.snapshot)
        batch = _batch(step, m=m, k=512)
        want = ref.run(_jnp(batch))
        for job in jobs.values():
            got = job.run(_torch(batch))
            _assert_same_outputs(got, want)
            assert (got.plan_reason, got.reused) == (want.plan_reason, want.reused)
    assert jobs["sharded"].schedule_cache.reprojections == 1
    with pytest.raises(ValueError, match="devices"):
        jobs["sharded"].resize(4, devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# A reused escalated plan, walked checkpointed.
# ---------------------------------------------------------------------------


def _uniform_batch(seed, m=4, k=2048, n=16):
    """Keys spread evenly over ``n`` clusters: every wave's per-(slot,
    destination) groups are about equally full."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n, size=(m, k)).astype(np.int32)
    values = rng.integers(0, 5, size=(m, k, 2)).astype(np.float32)
    return keys, values, np.ones((m, k), bool)


def test_reused_escalated_plan_walks_checkpointed_at_cut_caps():
    """A plan whose every cap sits at the safe bound (here
    ``capacity_send``, which every wave's statistics bound exceeds) is the
    escalated plan's shape: a reused batch walks it at caps cut to the
    batch (:meth:`_needed_caps`), with the reference's outputs, which walks
    at the plan's caps."""
    from repro.core import schedule_cache as rsc

    # Two waves whose statistics bounds (384 pairs a group) exceed
    # ``send``, which exceeds every group this data fills (at most 302).
    m, k, n, send = 4, 2048, 16, 320
    cfg = dict(m=m, n=n, scheduler="lpt", pipeline_chunks=3, capacity_send=send)
    port = _port(reuse=tsc.ReusePolicy(), checkpoint_waves=True, **cfg)
    ref = _ref(reuse=rsc.ReusePolicy(), checkpoint_waves=True, **cfg)
    fused = _port(**cfg)
    walks = []
    walk = port._execute_checkpointed

    def spy(inter, plan, local_k, k_per_shard, caps=None):
        walks.append((plan, caps))
        return walk(inter, plan, local_k, k_per_shard, caps)

    port._execute_checkpointed = spy
    for b in range(3):
        batch = _uniform_batch(b, m=m, k=k, n=n)
        walks.clear()
        got, want = port.run(_torch(batch)), ref.run(_jnp(batch))
        _assert_same_outputs(got, want)
        _assert_same_outputs(got, fused.run(_torch(batch)))
        assert got.overflow == 0 and got.reused == want.reused == (b > 0)
        (plan, caps), = walks
        assert plan.waves.num_chunks > 1 and port._escalated(plan)
        assert plan.chunk_caps == (send,) * plan.waves.num_chunks
        if b == 0:
            assert caps is None
        else:
            assert all(c <= p for c, p in zip(caps[1], plan.chunk_caps))
            assert sum(caps[1]) < sum(plan.chunk_caps)


@pytest.mark.parametrize("cap", [1, 3])
def test_stacked_chunk_copy_is_contiguous(cap):
    """A residue wave whose groups hold at most one pair has ``cap == 1``.
    At every cap the stacked copy hands the fused kernel contiguous int32
    ids: each chunk's segment row, non-decreasing, holding every pair its
    caps keep once, over contiguous values and gather order."""
    m, k, n, v = 4, 24, 8, 3
    rng = np.random.default_rng(cap)
    keys = torch.from_numpy(rng.integers(0, n, (m, k)).astype(np.int32))
    vals = torch.arange(m * k * v, dtype=torch.float32).view(m, k, v)
    valid = torch.ones((m, k), dtype=torch.bool)
    rank = torch.from_numpy(rng.permutation(n).astype(np.int32))
    plan = (torch.arange(n, dtype=torch.int32) % m, rank, rank // (n // 2))
    static = (m, n, cap, (cap, cap), "sum", True, 2, None)
    send, overflow, _ = tmr._spill((keys, vals, valid), *plan, static, torch.arange(m), vals,
                                   vals)
    assert send.values.is_contiguous() and send.order.is_contiguous()
    assert send.order.dtype == torch.int32
    kept = 0
    for c in range(2):
        seg = tmr._copy_chunk(send, c)
        assert seg.is_contiguous() and seg.dtype == torch.int32 and seg.shape == (1, m * k)
        assert bool((seg[0, 1:] >= seg[0, :-1]).all())
        inside = (seg >= 0) & (seg < n)
        kept += int(inside.sum())
        assert int(inside.sum()) <= m * m * cap
    assert kept + int(overflow) == m * k
# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("wave", [None, 2, 0], ids=["clean", "kill-at-2", "kill-at-0"])
def test_cuda_checkpointed_walk_equals_fused(wave):
    from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops

    dev = _cuda()
    batch = _batch(5, k=8192)
    fused = _port(device=dev, pipeline_chunks=4).run(_torch(batch, dev))
    job = _port(device=dev, pipeline_chunks=4, checkpoint_waves=True)
    cpu = _port(pipeline_chunks=4, checkpoint_waves=True)
    if wave is not None:
        for j in (job, cpu):
            j.set_slot_failure(2, at_wave=wave)
    f0 = fused_ops.launches
    got = job.run(_torch(batch, dev))
    waves = job.last_plan.waves.num_chunks
    replayed = job.last_replayed_waves
    assert fused_ops.launches - f0 == (job.last_checkpoint_wave + replayed if wave is not None
                                       else waves)
    _assert_same_outputs(got, fused)
    _assert_same_outputs(got, cpu.run(_torch(batch)))
    if wave is not None:
        assert job.last_replay_plan.schedule.slot_loads[2] == 0.0


@pytest.mark.gpu
def test_cuda_sharded_kill_equals_stacked():
    dev = _cuda()
    batch = _batch(6, k=8192)
    stacked = _port(device=dev, pipeline_chunks=4, checkpoint_waves=True)
    sharded = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=8, num_clusters=48, scheduler="bss", pipeline_chunks=4,
        checkpoint_waves=True), backend="sharded")
    for j in (stacked, sharded):
        j.set_slot_failure(3, at_wave=1)
    _assert_same_outputs(sharded.run(_torch(batch, dev)), stacked.run(_torch(batch, dev)))
    sharded.resize(6, devices=[dev] * 6)
    small = _batch(7, m=6, k=4096)
    _assert_same_outputs(sharded.run(_torch(small, dev)), _port(m=6).run(_torch(small)))
