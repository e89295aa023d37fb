"""The multi-job coordinator in the port against the reference.

The coordinator cases of ``tests/test_multi_job.py``: add-job validation,
the R-matrix and its dead column, WSPT admission, tenant caches that never
collide, ``run_queue``'s measured weighted completion, and interleaved runs
bit-identical to solo runs (stacked, under a mid-batch kill, across a
resize, and on the sharded backend), each also against the reference's
``vmap`` job on the same numpy inputs. Values are integer-valued float32,
so outputs are compared bitwise; admission orders and planned ``Σ wᵢCᵢ``
exactly. ``weighted_completion_time`` and ``MultiTenantScheduleCache``
equal the reference's. (The R||C_max schedulers are held by the port's
scheduler tests.)
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mapreduce as tmr
from repro_torch.core import multi_job as tmj
from repro_torch.core import pipeline as tpipe
from repro_torch.core import schedule_cache as tsc
from repro_torch.core import simulator as tsim


def _identity(batch):
    return batch


def _batch(seed=0, m=8, k=256, v=4, n_keys=337):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.25, size=(m, k)) % n_keys).astype(np.int32)
    vals = rng.integers(-4, 9, size=(m, k, v)).astype(np.float32)
    return keys, vals, np.ones((m, k), bool)


def _torch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _jnp(batch):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in batch)


def _port(m=8, n=48, chunks=0, checkpoint=False, reuse=None, backend="stacked"):
    cfg = tmr.MapReduceConfig(num_slots=m, num_clusters=n, scheduler="bss",
                              pipeline_chunks=chunks, checkpoint_waves=checkpoint, reuse=reuse)
    if backend == "sharded":
        return tmr.MapReduceJob(_identity, cfg, backend="sharded", devices=["cpu"] * m)
    return tmr.MapReduceJob(_identity, cfg, device="cpu")


def _ref(m=8, n=48, chunks=0, checkpoint=False, reuse=None):
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    return MapReduceJob(_identity, MapReduceConfig(
        num_slots=m, num_clusters=n, scheduler="bss", pipeline_chunks=chunks,
        checkpoint_waves=checkpoint, reuse=reuse, use_kernels=True), backend="vmap")


def _assert_same_outputs(a, b):
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))
    np.testing.assert_array_equal(np.asarray(a.counts), np.asarray(b.counts))


def _both():
    from repro.core import multi_job as rmj

    return ((tmj, _port, _torch), (rmj, _ref, _jnp))


def test_add_job_validates_as_reference():
    for mj, make, _ in _both():
        co = mj.MultiJobCoordinator(num_slots=8)
        co.add_job("a", make())
        with pytest.raises(ValueError, match="already admitted"):
            co.add_job("a", make())
        with pytest.raises(ValueError, match="weight"):
            co.add_job("b", make(), weight=0.0)
        with pytest.raises(ValueError, match="slots"):
            co.add_job("c", make(m=4))
        assert len(co) == 1 and [h.name for h in co.jobs()] == ["a"]


def test_r_matrix_and_dead_column_match_reference():
    mats = []
    for mj, make, _ in _both():
        co = mj.MultiJobCoordinator(num_slots=8)
        co.add_job("a", make())
        co.add_job("b", make())
        co["b"].job.set_slot_failure(5)
        co["a"].observe_batch_seconds(2.0)
        co["a"].observe_batch_seconds(3.0)
        mats.append((co.r_matrix(loads=[1.0, 1.0]), co.r_matrix(), co.estimated_times()))
        with pytest.raises(ValueError, match="loads"):
            co.r_matrix(loads=[1.0])
    for got, want in zip(*mats):
        np.testing.assert_array_equal(got, want)
    R = mats[0][0]
    assert R.shape == (2, 8) and np.isfinite(R[0]).all()
    assert np.isinf(R[1, 5]) and np.isfinite(np.delete(R[1], 5)).all()


def test_wspt_admission_matches_reference():
    out = []
    for mj, make, conv in _both():
        co = mj.MultiJobCoordinator(num_slots=8)
        co.add_job("long", make(), weight=1.0)
        co.add_job("short", make(), weight=4.0)
        co.add_job("mid", make(), weight=2.0)
        for name, secs in (("long", 4.0), ("short", 1.0), ("mid", 1.5)):
            co[name].observe_batch_seconds(secs)
        co.submit("long", conv(_batch(0)))
        co.submit("short", conv(_batch(1)))
        for order in ("wspt", "fifo"):
            out.append((co.plan_admission(order), co.planned_weighted_completion(order)))
        with pytest.raises(ValueError, match="admission order"):
            co.plan_admission("lifo")
    assert out[:2] == out[2:]
    (wspt, w_wspt), (fifo, w_fifo) = out[:2]
    assert wspt == ["short", "mid", "long"] and fifo == ["long", "short", "mid"]
    assert w_wspt <= w_fifo + 1e-9


@pytest.mark.parametrize("order", [None, [2, 0, 1], [1, 2, 0]])
def test_weighted_completion_time_matches_reference(order):
    from repro.core import simulator as rsim

    times, weights = np.array([3.0, 1.0, 2.5]), np.array([1.0, 4.0, 2.0])
    for w in (None, weights):
        assert (tsim.weighted_completion_time(times, w, order=order)
                == rsim.weighted_completion_time(times, w, order=order))


def test_multi_tenant_cache_matches_reference():
    """Keys, adopt/tenant collisions, the collision count and ``stats``."""
    from repro.core import schedule_cache as rsc

    stats = []
    for mod in (tsc, rsc):
        policy = mod.ReusePolicy(max_age=3)
        tenants = mod.MultiTenantScheduleCache(policy)
        a = tenants.tenant("a")
        assert tenants.tenant("a") is a and tenants.tenant("a", policy=policy) is a
        with pytest.raises(ValueError, match="collision"):
            tenants.tenant("a", policy=mod.ReusePolicy())
        own = mod.ScheduleCache(policy)
        assert tenants.adopt("b", own) is own and tenants.adopt("b", own) is own
        with pytest.raises(ValueError, match="collision"):
            tenants.adopt("b", mod.ScheduleCache(policy))
        with pytest.raises(ValueError, match="no policy"):
            mod.MultiTenantScheduleCache().tenant("x")
        assert tenants.keys() == ["a", "b"] and tenants.collisions() == 0
        snap = _tiny_snapshot(mod)
        a.store(snap)
        own.store(snap)                     # one snapshot object in two tenants
        a.record(a.decide(snap.local_hist))
        stats.append((tenants.collisions(), tenants.stats()))
    assert stats[0][0] == stats[1][0] == 1
    assert stats[0][1] == stats[1][1]


def _tiny_snapshot(mod_sc):
    from repro_torch.core import scheduler as tsched

    key_dist = np.arange(1.0, 9.0)
    sched = tsched.Schedule.from_assignment(np.arange(8, dtype=np.int32) % 2, key_dist, 2)
    return mod_sc.CachedSchedule(
        schedule=sched, strategy="lpt", strategy_costs=None,
        waves=tpipe.plan_waves(key_dist, sched.assignment, 2, num_chunks=1),
        capacity=8, chunk_caps=(8,), local_hist=np.tile(key_dist / 2.0, (2, 1)),
        key_dist=key_dist)


def test_tenant_caches_never_collide():
    from repro.core import schedule_cache as rsc

    outs = []
    for (mj, make, conv), mod in zip(_both(), (tsc, rsc)):
        policy = mod.ReusePolicy(max_age=8)
        co = mj.MultiJobCoordinator(num_slots=8, policy=policy)
        for name, seed in (("a", 0), ("b", 1), ("c", 2)):
            co.add_job(name, make(reuse=policy) if name != "c" else make())
            co.submit(name, conv(_batch(seed)))
            co.submit(name, conv(_batch(seed + 10)))
        outs.append(co.run_queue(order="fifo"))
        for name in ("a", "b", "c"):
            assert co[name].job.schedule_cache is co.tenants.tenant(name)
    got, want = outs
    assert got["order"] == want["order"] == ["a", "b", "c"]
    stats = got["cache"]
    assert stats["tenants"] == 3 and stats["collisions"] == 0
    for name in ("a", "b", "c"):
        assert stats["per_tenant"][name]["batches"] == 2
        for key in ("batches", "replans", "reuses"):
            assert stats["per_tenant"][name][key] == want["cache"]["per_tenant"][name][key]
    assert got["coschedule_overlap"] == want["coschedule_overlap"]


def test_run_queue_measures_weighted_completion():
    co = tmj.MultiJobCoordinator(num_slots=8)
    co.add_job("x", _port(), weight=2.0)
    co.add_job("y", _port(), weight=1.0)
    co.submit("x", _torch(_batch(3)))
    co.submit("y", _torch(_batch(4)))
    out = co.run_queue()
    assert set(out["completions"]) == {"x", "y"}
    assert all(c is not None and c > 0 for c in out["completions"].values())
    assert out["weighted_completion"] == pytest.approx(
        sum(co[n].weight * out["completions"][n] for n in ("x", "y")))
    assert out["cache"]["collisions"] == 0
    assert all(co[n].pending == [] and len(co[n].results) == 1 for n in ("x", "y"))
    assert all(co[n].batch_seconds > 0 for n in ("x", "y"))
    want = {n: _ref().run(_jnp(_batch(s))) for n, s in (("x", 3), ("y", 4))}
    for name in ("x", "y"):
        _assert_same_outputs(co[name].results[0], want[name])


def test_coschedule_plan_matches_reference():
    from repro.core import schedule_cache as rsc

    plans = []
    for (mj, make, conv), mod in zip(_both(), (tsc, rsc)):
        co = mj.MultiJobCoordinator(num_slots=8)
        for name, seed in (("a", 0), ("b", 1), ("cold", 2)):
            co.add_job(name, make(chunks=4, reuse=mod.ReusePolicy()))
            if name != "cold":
                co[name].job.run(conv(_batch(seed)))
        plans.append(co.coschedule_plan())
    assert plans[0] == plans[1] and tpipe.coschedule_overlap(plans[0]) >= 0.5


def test_interleaved_bit_identical_to_solo_stacked():
    batches = {"a": [_batch(0), _batch(1)], "b": [_batch(2), _batch(3)]}
    solo = {name: [_port().run(_torch(b)) for b in bs] for name, bs in batches.items()}
    ref = {name: [_ref().run(_jnp(b)) for b in bs] for name, bs in batches.items()}
    co = tmj.MultiJobCoordinator(num_slots=8)
    for name, bs in batches.items():
        co.add_job(name, _port())
        for b in bs:
            co.submit(name, _torch(b))
    out = co.run_interleaved()
    assert [name for name, _ in out] == ["a", "b", "a", "b"]
    for name in batches:
        for r_solo, r_ref, r_co in zip(solo[name], ref[name], co[name].results):
            _assert_same_outputs(r_solo, r_co)
            _assert_same_outputs(r_ref, r_co)
    with pytest.raises(ValueError, match="no pending"):
        co.run_interleaved(sequence=["a"])


def test_interleaved_bit_identical_under_mid_batch_kill():
    """A kill mid-batch in one job never leaks into the other."""
    def fresh(make, kill):
        job = make(chunks=4, checkpoint=True)
        if kill:
            job.set_slot_failure(3, at_wave=1)
        return job

    batches = {"a": _batch(5, k=512), "b": _batch(6, k=512)}
    solo = {"a": fresh(_port, True).run(_torch(batches["a"])),
            "b": fresh(_port, False).run(_torch(batches["b"]))}
    co = tmj.MultiJobCoordinator(num_slots=8)
    co.add_job("a", fresh(_port, True))
    co.add_job("b", fresh(_port, False))
    for name, b in batches.items():
        co.submit(name, _torch(b))
    out = dict(co.run_interleaved(sequence=["a", "b"]))
    ref = {"a": fresh(_ref, True).run(_jnp(batches["a"])),
           "b": fresh(_ref, False).run(_jnp(batches["b"]))}
    for name in batches:
        _assert_same_outputs(solo[name], out[name])
        _assert_same_outputs(ref[name], out[name])
    assert co["a"].job.last_replayed_waves > 0 and co["b"].job.last_replayed_waves == 0
    assert bool(co["a"].job.dead_slots[3]) and not co["b"].job.dead_slots.any()


def test_interleaved_bit_identical_across_resize():
    """8 -> 6 resize between batches: solo vs sharing the coordinator."""
    batches = [_batch(7, m=8), _batch(8, m=6)]
    solo_job = _port()
    solo_job.run(_torch(batches[0]))
    solo_job.resize(6)
    solo = solo_job.run(_torch(batches[1]))
    ref_job = _ref()
    ref_job.run(_jnp(batches[0]))
    ref_job.resize(6)
    ref = ref_job.run(_jnp(batches[1]))
    co = tmj.MultiJobCoordinator(num_slots=8)
    co.add_job("a", _port())
    co.add_job("b", _port())
    co.submit("b", _torch(_batch(9)))
    out0 = dict(co.run_interleaved(sequence=["b"]))
    co["a"].job.run(_torch(batches[0]))
    co["a"].job.resize(6)
    res1 = co["a"].job.run(_torch(batches[1]))
    _assert_same_outputs(solo, res1)
    _assert_same_outputs(ref, res1)
    assert "b" in out0 and co["b"].job.cfg.num_slots == 8


def test_interleaved_bit_identical_to_solo_sharded():
    batches = {"a": [_batch(0)], "b": [_batch(2)]}
    solo = {name: [_port(backend="sharded").run(_torch(b)) for b in bs]
            for name, bs in batches.items()}
    ref = {name: [_ref().run(_jnp(b)) for b in bs] for name, bs in batches.items()}
    co = tmj.MultiJobCoordinator(num_slots=8)
    for name, bs in batches.items():
        co.add_job(name, _port(backend="sharded"))
        for b in bs:
            co.submit(name, _torch(b))
    co.run_interleaved()
    for name in batches:
        for r_solo, r_ref, r_co in zip(solo[name], ref[name], co[name].results):
            _assert_same_outputs(r_solo, r_co)
            _assert_same_outputs(r_ref, r_co)
