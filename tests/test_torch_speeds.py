"""Online slot speeds in the port against the reference.

The numpy modules the port copied — ``SlotSpeedEstimator`` and
``WaveTimings`` — give the reference's results on the same inputs
(seeded random update sequences with zero and non-finite seconds, fixed
tick arrays with a wrapped stamp), and estimator state round-trips as JSON
between the packages. ``shard_ready_seconds`` stamps slots in completion
order. Whole stacked jobs with ``estimate_speeds=True`` follow the
reference's ``vmap`` job (the synthetic timing model) batch for batch:
assignments, slot speeds, speed drift, plan reasons and bitwise outputs.
"""

import json
import time

import numpy as np
import pytest
import torch

from repro_torch.core import mapreduce as tmr
from repro_torch.core import mesh_timing as tmt
from repro_torch.core import schedule_cache as tsc
from repro_torch.core import slot_speeds as tss


def _identity(batch):
    return batch


def _batch(seed, m=4, k=1024, v=2, key_mod=503, alpha=1.25):
    """Integer-valued f32 pairs (bit-exact in any order)."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(alpha, size=(m, k)) % key_mod).astype(np.int32)
    vals = rng.integers(0, 8, size=(m, k, v)).astype(np.float32)
    valid = rng.random((m, k)) > 0.03
    return keys, vals, valid


# ---------------------------------------------------------------------------
# SlotSpeedEstimator.
# ---------------------------------------------------------------------------


def _random_seconds(rng, m):
    """Seconds with zeros, negatives and non-finite entries mixed in."""
    secs = rng.uniform(0.1, 3.0, m)
    kind = rng.integers(0, 8, m)
    secs = np.where(kind == 0, 0.0, secs)
    secs = np.where(kind == 1, np.inf, secs)
    secs = np.where(kind == 2, np.nan, secs)
    return np.where(kind == 3, -1.0, secs)


def _assert_same_speeds(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ewma", [0.4, 1.0, 0.15])
def test_estimator_matches_reference_on_random_sequences(seed, ewma):
    from repro.core import slot_speeds as rss

    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 9))
    mine, theirs = tss.SlotSpeedEstimator(m, ewma=ewma), rss.SlotSpeedEstimator(m, ewma=ewma)
    for step in range(25):
        work = rng.uniform(0.0, 5.0, m) * (rng.random(m) > 0.1)
        secs = _random_seconds(rng, m)
        np.testing.assert_allclose(mine.update(work, secs), theirs.update(work, secs),
                                   rtol=1e-12, atol=0)
        assert mine.observations == theirs.observations
        _assert_same_speeds(mine.speeds(), theirs.speeds())
        if step == 12:
            slot = int(rng.integers(m))
            mine.set_slot_failure(slot)
            theirs.set_slot_failure(slot)
        if step == 18:
            mine.set_slot_failure(slot, dead=False)
            theirs.set_slot_failure(slot, dead=False)
    np.testing.assert_array_equal(mine.dead_mask, theirs.dead_mask)
    assert mine.to_json() == theirs.to_json()


def test_estimator_skips_zero_and_nonfinite_seconds():
    from repro.core import slot_speeds as rss

    for mod in (tss, rss):
        est = mod.SlotSpeedEstimator(4)
        est.update(np.ones(4), np.zeros(4))
        assert est.observations == 0 and est.speeds() is None
        est.update(np.ones(4), [np.inf, np.nan, -1.0, 0.0])
        assert est.observations == 0
        est.update(np.ones(4), [0.0, 0.5, 0.0, np.inf])
        assert est.observations == 1
        sp = est.speeds()
        assert np.isfinite(sp).all() and (sp > 0).all()


def test_estimator_seed_reset_resize_match_reference():
    from repro.core import slot_speeds as rss

    ests = [tss.SlotSpeedEstimator(5, ewma=0.5), rss.SlotSpeedEstimator(5, ewma=0.5)]
    speeds = np.asarray([1.0, 0.5, 0.0, 1.5, 1.0])
    for est in ests:
        est.seed(speeds)
        est.update(np.ones(5), [1.0, 2.0, 1.0, 0.5, 1.0])
    _assert_same_speeds(ests[0].speeds(), ests[1].speeds())
    for size in (7, 3):
        for est in ests:
            est.resize(size)
        _assert_same_speeds(ests[0].speeds(default_ones=True),
                            ests[1].speeds(default_ones=True))
        assert ests[0].to_json() == ests[1].to_json()
    for est in ests:
        est.reset()
    assert ests[0].to_json() == ests[1].to_json()
    for bad in ([1.0, 1.0], [np.nan, 1, 1], [0.0, 0.0, 0.0]):
        for est in ests:
            with pytest.raises(ValueError):
                est.seed(bad)


def test_estimator_json_round_trips_both_ways():
    from repro.core import slot_speeds as rss

    rng = np.random.default_rng(7)
    mine = tss.SlotSpeedEstimator(6, ewma=0.3)
    for _ in range(5):
        mine.update(rng.uniform(1, 2, 6), rng.uniform(0.5, 1.5, 6))
    mine.set_slot_failure(4)
    blob = json.loads(json.dumps(mine.to_json()))
    theirs = rss.SlotSpeedEstimator.from_json(blob)
    _assert_same_speeds(theirs.speeds(), mine.speeds())
    back = tss.SlotSpeedEstimator.from_json(json.loads(json.dumps(theirs.to_json())))
    assert back.to_json() == mine.to_json()
    _assert_same_speeds(back.speeds(), mine.speeds())


# ---------------------------------------------------------------------------
# WaveTimings and shard_ready_seconds.
# ---------------------------------------------------------------------------


_TICKS = [
    np.asarray([[[1_000_000, 1_000_100], [1_000_200, 1_000_500]],
                [[1_000_000, 1_000_400], [1_000_400, 1_000_400]]], np.int64),
    np.asarray([[[100, 40]]], np.int64),                       # wrapped: end < start
    np.asarray([[[5, 5], [5, 9], [9, 2 ** 40]]] * 3, np.int64),
]


@pytest.mark.parametrize("ticks", _TICKS, ids=["two-slots", "wrapped", "wide"])
@pytest.mark.parametrize("spt", [1e-9, 7.5e-10])
def test_wave_timings_from_ticks_match_reference(ticks, spt):
    from repro.core import mesh_timing as rmt

    mine, theirs = tmt.WaveTimings.from_ticks(ticks, spt), rmt.WaveTimings.from_ticks(ticks, spt)
    np.testing.assert_array_equal(mine.seconds, theirs.seconds)
    assert mine.valid == theirs.valid
    assert (mine.seconds >= 0).all()
    slowdown = np.linspace(1.0, 3.0, ticks.shape[0])
    for work in (None, np.full(ticks.shape[0], 6.0)):
        mine.slot_work, theirs.slot_work = work, work
        for sd in (None, slowdown):
            for a, b in zip(mine.observation(sd), theirs.observation(sd)):
                np.testing.assert_array_equal(a, b)


def test_wave_timings_validate_shape_and_accumulate():
    from repro.core import mesh_timing as rmt

    for mod in (tmt, rmt):
        with pytest.raises(ValueError):
            mod.WaveTimings.from_ticks(np.zeros((4, 2)), 1e-9)
        t = mod.WaveTimings.empty(3, 2)
        t.record(0, [0.1, 0.2, 0.3])
        t.record(1, [0.4, 0.1, 0.0])
        np.testing.assert_allclose(t.slot_seconds(), [0.5, 0.3, 0.3])
        assert mod.WaveTimings.empty(2, 0).seconds.shape == (2, 1)


class _FakeEvent:
    """A slot's completion marker that reports done at a wall-clock deadline."""

    def __init__(self, ready_at: float):
        self.ready_at = ready_at

    def query(self) -> bool:
        return time.perf_counter() >= self.ready_at


def test_shard_ready_seconds_stamps_in_completion_order():
    t0 = time.perf_counter()
    straggle = 0.08
    secs = tmt.shard_ready_seconds(
        [_FakeEvent(t0 + straggle), _FakeEvent(t0), _FakeEvent(t0), _FakeEvent(t0)], t0)
    assert secs[0] >= straggle * 0.9
    assert (secs[1:] < straggle * 0.5).all(), secs


def test_shard_ready_seconds_out_of_order_and_cpu_markers():
    t0 = time.perf_counter()
    deadlines = [t0 + 0.06, t0 + 0.04, t0 + 0.02, t0]
    secs = tmt.shard_ready_seconds([_FakeEvent(d) for d in deadlines], t0)
    assert np.all(np.diff(secs) < 0) and secs[0] >= 0.05
    # A CPU slot's marker is the time its call returned.
    mixed = tmt.shard_ready_seconds([t0 + 0.25, _FakeEvent(t0), t0 + 0.5], t0)
    np.testing.assert_allclose(mixed[[0, 2]], [0.25, 0.5])
    assert 0 <= mixed[1] < 0.25


# ---------------------------------------------------------------------------
# Whole stacked jobs: the synthetic timing model.
# ---------------------------------------------------------------------------


def _jobs(m=4, n=24, policy=None, **cfg):
    from repro.core import schedule_cache as rsc
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    ref = MapReduceJob(_identity, MapReduceConfig(
        num_slots=m, num_clusters=n, use_kernels=True,
        reuse=rsc.ReusePolicy(**policy) if policy is not None else None, **cfg),
        backend="vmap")
    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=m, num_clusters=n,
        reuse=tsc.ReusePolicy(**policy) if policy is not None else None, **cfg),
        device="cpu")
    return ref, port


@pytest.mark.parametrize("scheduler", ["bss", "lpt", "os4m"])
@pytest.mark.parametrize("max_speed_drift", [0.25, 1e9])
def test_stacked_estimator_sequence_matches_reference(scheduler, max_speed_drift):
    import jax.numpy as jnp

    ref, port = _jobs(scheduler=scheduler, estimate_speeds=True, pipeline_chunks=3,
                      policy=dict(max_drift=0.8, max_speed_drift=max_speed_drift))
    assert not port._measure_timings
    for b in range(4):
        if b == 1:
            ref.set_slot_slowdown(0, 2.0)
            port.set_slot_slowdown(0, 2.0)
        batch = _batch(b)
        want = ref.run(tuple(jnp.asarray(a) for a in batch))
        got = port.run(tuple(torch.from_numpy(a) for a in batch))
        np.testing.assert_array_equal(got.schedule.assignment, want.schedule.assignment)
        np.testing.assert_allclose(got.slot_speeds, want.slot_speeds, rtol=1e-12)
        assert got.plan_reason == want.plan_reason
        assert (got.speed_drift is None) == (want.speed_drift is None)
        if want.speed_drift is not None:
            assert got.speed_drift == pytest.approx(want.speed_drift, rel=1e-12)
        np.testing.assert_array_equal(got.values, np.asarray(want.values))
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        _assert_same_speeds(port.current_speeds(), ref.current_speeds())
        np.testing.assert_allclose(port.proc_times_row(3.0), ref.proc_times_row(3.0),
                                   rtol=1e-12)
        assert port.last_wave_timings is None and ref.last_wave_timings is None
    assert port.speed_estimator.to_json() == ref.speed_estimator.to_json()
    sp = port.current_speeds()
    assert sp[0] == sp.min() and sp[0] < 1.0


def test_synthetic_two_x_factor_halves_speed():
    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=4, num_clusters=16, scheduler="bss", estimate_speeds=True,
        speed_ewma=1.0), device="cpu")
    port.set_slot_slowdown(1, 2.0)
    port.run(tuple(torch.from_numpy(a) for a in _batch(0, k=256, key_mod=97)))
    sp = port.speed_estimator.speeds()
    assert sp[1] / sp[0] == pytest.approx(0.5)
    assert sp[1] == sp.min()


def test_observe_measured_skips_empty_and_invalid_timings():
    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=4, num_clusters=16, estimate_speeds=True), device="cpu")
    key_dist = np.ones(16)
    planned = port._plan(np.tile(key_dist / 4, (4, 1)), key_dist, 128)
    port._observe_measured(tmt.WaveTimings.empty(4, 0), planned)
    assert not port._external_timings and port.speed_estimator.observations == 0
    t = tmt.WaveTimings.empty(4, 2)
    t.record(0, [0.1, 0.2, 0.3, 0.4])
    t.valid = False
    port._observe_measured(t, planned)
    assert not port._external_timings and port.speed_estimator.observations == 0
    t.valid = True
    port._observe_measured(t, planned)
    assert port._external_timings and port.speed_estimator.observations == 1
    # The synthetic model stays out once a measurement arrived.
    port._observe_wave_timings(planned, key_dist)
    assert port.speed_estimator.observations == 1


def test_observe_slot_times_feeds_the_estimator_like_the_reference():
    ref, port = _jobs(estimate_speeds=True)
    work, secs = np.asarray([4.0, 4.0, 4.0, 4.0]), np.asarray([1.0, 2.0, 1.0, 1.0])
    for job in (ref, port):
        job.observe_slot_times(work, secs)
    _assert_same_speeds(port.current_speeds(), ref.current_speeds())
    assert port._external_timings and ref._external_timings


def test_load_snapshot_seeds_the_estimator():
    _, port = _jobs(estimate_speeds=True, policy={})
    key_dist = np.arange(1, 25, dtype=np.float64)
    hist = np.tile(key_dist / 4, (4, 1))
    speeds = (1.0, 0.5, 1.0, 1.5)
    planner = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=4, num_clusters=24, speeds=speeds), device="cpu")
    snap = planner._plan(hist, key_dist, 256)
    port.load_snapshot(json.loads(json.dumps(snap.to_json())))
    assert port.speed_estimator.observations == 1
    np.testing.assert_allclose(port.current_speeds(), snap.slot_speeds)


@pytest.mark.parametrize("factor,error", [(-1.0, ValueError), (0.0, None)])
def test_set_slot_slowdown_refusals(factor, error):
    """A negative factor is refused; 0 is the elastic mesh's dead slot, as
    in the reference (no error: the slot's speed becomes an exact 0.0)."""
    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=2, num_clusters=4, estimate_speeds=True), device="cpu")
    if error is None:
        port.set_slot_slowdown(0, factor)
        assert port.dead_slots.tolist() == [True, False]
        assert port.current_speeds().tolist() == [0.0, 1.0]
    else:
        with pytest.raises(error, match="factor"):
            port.set_slot_slowdown(0, factor)
    with pytest.raises(ValueError, match="out of range"):
        port.set_slot_slowdown(2, 2.0)
