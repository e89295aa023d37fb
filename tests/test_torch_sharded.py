"""The sharded backend and the measured executor against the reference.

``backend="sharded"`` runs one program per slot (``devices=["cpu"] * m``
here; one CUDA stream a slot on the card). Its outputs must equal the
stacked backend's and the reference ``vmap`` job's bit for bit on
integer-valued f32, with equal plans, over the reduce ops, both phase-B
shapes, the int8 wire and both statistics providers. The sharded drift
reduction equals ``drift_metric`` and uploads its baseline once. The
reference's ``shard_map`` job runs in-process on a 1-device mesh and, at
m = 4, in a subprocess with four forced host devices (the test run does
not set ``XLA_FLAGS``); the port's sharded jobs equal them. The measured
path: outputs equal the unmeasured run's, timings are ``(m, waves)`` and
valid, a fixed ticks buffer moves the estimator as in the reference, a
slowed slot loses load, the fenced fallback agrees, and the reference's
configuration errors fire alike. The reference is imported inside the CPU
tests only, so the ``gpu`` cases also run where JAX is absent
(``--noconftest -m gpu``).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import mapreduce as tmr
from repro_torch.core import mesh_timing as tmt
from repro_torch.core import schedule_cache as tsc
from repro_torch.kernels.wave_timer import ops as wt

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _identity(batch):
    return batch


def _batch(seed, m=4, k=512, v=2, key_mod=503, alpha=1.25, invalid=0.03, peak=False):
    """Integer-valued f32 pairs (bit-exact in any order), as numpy.

    ``peak`` puts one value of 127 on the last slot, so that the int8
    wire's one global scale (a maximum over slots) is exactly 1 and the
    quantized pairs stay integers.
    """
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(alpha, size=(m, k)) % key_mod).astype(np.int32)
    vals = rng.integers(-4, 8, size=(m, k, v)).astype(np.float32)
    valid = rng.random((m, k)) >= invalid
    if peak:
        vals[-1, 0, 0], valid[-1, 0] = 127.0, True
    return keys, vals, valid


def _torch(batch, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def _sharded(m, n=24, devices=None, **cfg):
    return tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=m, num_clusters=n, **cfg),
                            backend="sharded", devices=devices or ["cpu"] * m)


def _stacked(m, n=24, device="cpu", **cfg):
    return tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=m, num_clusters=n, **cfg),
                            device=device)


def _assert_same_result(a, b, plans=True):
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.overflow == b.overflow
    if plans:
        np.testing.assert_array_equal(a.schedule.assignment, b.schedule.assignment)
        assert a.shuffle_bytes == b.shuffle_bytes and a.shuffle_pairs == b.shuffle_pairs
        assert a.shuffle_rows == b.shuffle_rows


def _assert_same_plan(a, b):
    np.testing.assert_array_equal(a.schedule.assignment, b.schedule.assignment)
    np.testing.assert_array_equal(a.waves.rank_of_cluster, b.waves.rank_of_cluster)
    np.testing.assert_array_equal(a.waves.chunk_of_cluster, b.waves.chunk_of_cluster)
    assert a.capacity == b.capacity and tuple(a.chunk_caps) == tuple(b.chunk_caps)


# ---------------------------------------------------------------------------
# Sharded ≡ stacked ≡ reference vmap. The stacked backend carries the kept
# pairs as indices into the Map output, the sharded one padded bucket
# files; the ``-overflow`` cases cut every cap below the hottest group, so
# both drop the newest pairs of the same groups.
# ---------------------------------------------------------------------------

_CUT = dict(capacity_send=40)

_CONFIGS = {
    "sum": dict(),
    "sum-sequential": dict(pipelined=False),
    "max": dict(reduce_op="max"),
    "max-sequential": dict(reduce_op="max", pipelined=False),
    "count": dict(reduce_op="count"),
    "count-sequential": dict(reduce_op="count", pipelined=False),
    "int8": dict(quantize_shuffle="int8"),
    "int8-sequential": dict(quantize_shuffle="int8", pipelined=False),
    "fp8": dict(quantize_shuffle="fp8"),
    "sketch": dict(stats="sketch", sketch_width=64),
    "sketch-prefix": dict(stats="sketch", sketch_width=64, stream_prefix=0.25),
    "lpt-5-chunks": dict(scheduler="lpt", pipeline_chunks=5),
    "coded": dict(shuffle_replication=2),
    "coded-sequential": dict(shuffle_replication=2, pipelined=False),
    "coded-max": dict(shuffle_replication=2, reduce_op="max"),
    "coded-int8": dict(shuffle_replication=2, quantize_shuffle="int8"),
    "coded-fp8": dict(shuffle_replication=2, quantize_shuffle="fp8"),
    "sum-overflow": dict(**_CUT),
    "sum-sequential-overflow": dict(pipelined=False, **_CUT),
    "max-overflow": dict(reduce_op="max", **_CUT),
    "count-overflow": dict(reduce_op="count", **_CUT),
    "int8-overflow": dict(quantize_shuffle="int8", **_CUT),
    "fp8-overflow": dict(quantize_shuffle="fp8", **_CUT),
}


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_sharded_equals_stacked_and_reference_vmap(name):
    import jax.numpy as jnp

    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    m, n, cfg = 4, 24, _CONFIGS[name]
    ref = MapReduceJob(_identity, MapReduceConfig(num_slots=m, num_clusters=n, use_kernels=True,
                                                  **cfg), backend="vmap")
    stacked, sharded = _stacked(m, n, **cfg), _sharded(m, n, **cfg)
    ref_plans = []
    plan = ref._plan

    def spy(*args, **kwargs):
        ref_plans.append(plan(*args, **kwargs))
        return ref_plans[-1]

    ref._plan = spy
    for seed in range(3):
        batch = _batch(seed, m, peak="int8" in name)
        want = ref.run(tuple(jnp.asarray(a) for a in batch))
        a, b = stacked.run(_torch(batch)), sharded.run(_torch(batch))
        _assert_same_result(a, b)
        np.testing.assert_array_equal(b.values, np.asarray(want.values))
        np.testing.assert_array_equal(b.counts, np.asarray(want.counts))
        assert b.overflow == want.overflow
        assert b.shuffle_bytes == want.shuffle_bytes
        assert b.replication_bytes == want.replication_bytes
        assert b.quantize_exact == want.quantize_exact
        assert b.shuffle_rows == want.shuffle_rows and b.shuffle_pairs == want.shuffle_pairs
        if "overflow" in name:
            assert b.overflow > 0
        _assert_same_plan(sharded.last_plan, ref_plans[-1])
        _assert_same_plan(sharded.last_plan, stacked.last_plan)


@pytest.mark.parametrize("m", [1, 2, 5])
def test_sharded_equals_stacked_at_other_slot_counts(m):
    for seed in range(2):
        batch = _batch(seed, m, k=300)
        a = _stacked(m, 17).run(_torch(batch))
        b = _sharded(m, 17).run(_torch(batch))
        _assert_same_result(a, b)


@pytest.mark.parametrize("pipelined", [True, False])
def test_bucket_rows_count_the_layout_from_shapes(pipelined):
    """``JobResult.bucket_rows``: every pair once on the stacked backend (m ·
    K), each slot's padded bucket file on the sharded one (m · m · the
    caps), summed over a run's executions; a coded plan reports none."""
    m, k = 4, 512
    batch = _torch(_batch(0, m, k=k))
    stacked, sharded = _stacked(m, pipelined=pipelined), _sharded(m, pipelined=pipelined)
    assert stacked.run(batch).bucket_rows == m * k
    got = sharded.run(batch)
    plan = sharded.last_plan
    caps = plan.chunk_caps if pipelined and plan.waves.num_chunks > 1 else (plan.capacity,)
    assert got.bucket_rows == m * m * sum(caps) > m * k
    assert _stacked(m, pipelined=pipelined, shuffle_replication=2).run(batch).bucket_rows is None
    # A reused plan that overflows runs phase B again: both count.
    job = _stacked(m, reuse=tsc.ReusePolicy(max_drift=10.0))
    job.run(_torch(_batch(0, m, k=k)))
    hot = _batch(1, m, k=k, key_mod=2)
    again = job.run(_torch(hot))
    assert again.plan_reason == "overflow" and again.bucket_rows == 2 * m * k


def test_sharded_map_fn_runs_per_slot_on_its_slice():
    """map_fn sees (1, ...) slices of every tensor in a nested input."""
    m = 3
    keys, vals, valid = _batch(4, m)
    seen = []

    def map_fn(inputs):
        seen.append(inputs["keys"].shape[0])
        return inputs["keys"], inputs["pairs"][0], inputs["pairs"][1]

    inputs = {"keys": torch.from_numpy(keys), "pairs": [torch.from_numpy(vals),
                                                        torch.from_numpy(valid)]}
    res = tmr.MapReduceJob(map_fn, tmr.MapReduceConfig(num_slots=m, num_clusters=24),
                           backend="sharded", devices=["cpu"] * m).run(inputs)
    assert seen == [1] * m
    want = _stacked(m).run(_torch((keys, vals, valid)))
    _assert_same_result(res, want)


# ---------------------------------------------------------------------------
# Reuse and the sharded drift.
# ---------------------------------------------------------------------------


def test_sharded_drift_matches_drift_metric_and_uploads_once():
    m = 4
    policy = dict(max_drift=0.5, max_speed_drift=1e9, capacity_slack=1.0)
    sharded = _sharded(m, reuse=tsc.ReusePolicy(**policy))
    stacked = _stacked(m, reuse=tsc.ReusePolicy(**policy))
    assert sharded.schedule_cache.drift_fn is not None
    assert stacked.schedule_cache.drift_fn is None
    sharded.run(_torch(_batch(0, m)))
    stacked.run(_torch(_batch(0, m)))
    snap = sharded.schedule_cache.snapshot
    assert snap._hist_dev is None
    baseline = None
    for seed in (1, 2, 3):
        batch = _batch(seed, m)
        a, b = stacked.run(_torch(batch)), sharded.run(_torch(batch))
        assert b.reused and a.reused
        assert b.drift == a.drift
        fresh = np.stack([np.bincount(np.abs(batch[0][i][batch[2][i]]) % 24, minlength=24)
                          for i in range(m)]).astype(np.float32)
        want = float(tsc.drift_metric(snap.local_hist.astype(np.float32), fresh, "l1"))
        assert b.drift == pytest.approx(want, abs=1e-6)
        _assert_same_result(a, b)
        if baseline is None:
            baseline = snap._hist_dev
            assert isinstance(baseline, list) and len(baseline) == m
            assert all(row.shape == (1, 24) for row in baseline)
        assert sharded.schedule_cache.snapshot._hist_dev is baseline


def test_sharded_reuse_sequence_matches_stacked_through_overflow_replans():
    m = 4
    policy = dict(max_drift=0.9, capacity_slack=0.0)
    sharded, stacked = _sharded(m, reuse=tsc.ReusePolicy(**policy)), _stacked(
        m, reuse=tsc.ReusePolicy(**policy))
    reasons = []
    for seed in range(6):
        batch = _batch(seed, m, alpha=1.1 + 0.1 * seed)
        a, b = stacked.run(_torch(batch)), sharded.run(_torch(batch))
        _assert_same_result(a, b)
        assert a.plan_reason == b.plan_reason
        reasons.append(b.plan_reason)
    assert stacked.schedule_cache.stats() == sharded.schedule_cache.stats()
    assert "overflow" in reasons or "drift" in reasons


def test_attach_schedule_cache_inherits_the_sharded_drift():
    m = 3
    cache = tsc.ScheduleCache(tsc.ReusePolicy())
    job = _sharded(m)
    job.attach_schedule_cache(cache)
    assert cache.drift_fn is not None
    job.run(_torch(_batch(0, m)))
    res = job.run(_torch(_batch(1, m)))
    assert res.plan_reason in ("ok", "drift") and res.drift is not None


# ---------------------------------------------------------------------------
# The reference's shard_map backend.
# ---------------------------------------------------------------------------


def _mesh1():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:1]), ("mr_slots",))


@pytest.mark.parametrize("measured", [False, True])
@pytest.mark.parametrize("pipelined", [True, False])
def test_one_slot_sharded_equals_reference_shard_map(measured, pipelined):
    import jax.numpy as jnp

    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    cfg = dict(num_slots=1, num_clusters=16, pipelined=pipelined, estimate_speeds=measured)
    ref = MapReduceJob(_identity, MapReduceConfig(use_kernels=True, **cfg),
                       backend="shard_map", mesh=_mesh1())
    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**cfg), backend="sharded",
                            devices=["cpu"])
    assert port._measure_timings == ref._measure_timings == measured
    for seed in range(2):
        batch = _batch(seed, 1, key_mod=97)
        want = ref.run(tuple(jnp.asarray(a) for a in batch))
        got = port.run(_torch(batch))
        np.testing.assert_array_equal(got.values, np.asarray(want.values))
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        np.testing.assert_array_equal(got.schedule.assignment, want.schedule.assignment)
        assert got.shuffle_bytes == want.shuffle_bytes
        if measured:
            mine, theirs = port.last_wave_timings, ref.last_wave_timings
            assert mine.seconds.shape == theirs.seconds.shape
            assert mine.valid and theirs.valid
            assert port.speed_estimator.observations == ref.speed_estimator.observations
        else:
            assert port.last_wave_timings is None and ref.last_wave_timings is None


_REFERENCE_M4 = textwrap.dedent('''
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    m, n, k, out = 4, 24, 512, sys.argv[1]
    assert len(jax.devices()) >= m, jax.devices()
    mesh = Mesh(np.asarray(jax.devices()[:m]), ("mr_slots",))

    def batch(seed, peak=False):
        rng = np.random.default_rng(seed)
        keys = (rng.zipf(1.25, size=(m, k)) % 503).astype(np.int32)
        vals = rng.integers(-4, 8, size=(m, k, 2)).astype(np.float32)
        valid = rng.random((m, k)) >= 0.03
        if peak:    # an int8 scale of exactly 1: the quantized pairs stay integers
            vals[-1, 0, 0], valid[-1, 0] = 127.0, True
        return tuple(jnp.asarray(a) for a in (keys, vals, valid))

    saved = {}
    for label, extra in (("plain", {}), ("measured", dict(estimate_speeds=True,
                                                          measure_timings=True))):
        job = MapReduceJob(lambda s: s, MapReduceConfig(
            num_slots=m, num_clusters=n, scheduler="bss", pipeline_chunks=3,
            use_kernels=True, **extra), backend="shard_map", mesh=mesh)
        for seed in range(3):
            res = job.run(batch(seed))
            saved[f"{label}_values_{seed}"] = np.asarray(res.values)
            saved[f"{label}_counts_{seed}"] = np.asarray(res.counts)
            saved[f"{label}_assignment_{seed}"] = np.asarray(res.schedule.assignment)
            if job.last_wave_timings is not None:
                saved[f"{label}_timings_{seed}"] = job.last_wave_timings.seconds
                saved[f"{label}_valid_{seed}"] = np.asarray(job.last_wave_timings.valid)
    for label, extra in (("coded", dict(shuffle_replication=2)),
                         ("coded-int8-sequential", dict(shuffle_replication=2,
                                                        quantize_shuffle="int8",
                                                        pipelined=False))):
        job = MapReduceJob(lambda s: s, MapReduceConfig(
            num_slots=m, num_clusters=n, scheduler="bss", pipeline_chunks=3,
            use_kernels=True, **extra), backend="shard_map", mesh=mesh)
        for seed in range(2):
            res = job.run(batch(seed, peak="int8" in label))
            saved[f"{label}_values_{seed}"] = np.asarray(res.values)
            saved[f"{label}_counts_{seed}"] = np.asarray(res.counts)
            saved[f"{label}_assignment_{seed}"] = np.asarray(res.schedule.assignment)
            saved[f"{label}_bytes_{seed}"] = np.asarray(
                [res.shuffle_bytes, res.replication_bytes, res.shuffle_pairs, res.overflow])
    errors = {}
    for label, extra in (("coded", dict(shuffle_replication=2, estimate_speeds=True)),
                         ("no-estimator", dict(measure_timings=True)),
                         ("checkpoint", dict(checkpoint_waves=True, estimate_speeds=True))):
        try:
            MapReduceJob(lambda s: s, MapReduceConfig(num_slots=m, num_clusters=n, **extra),
                         backend="shard_map", mesh=mesh)
            errors[label] = ""
        except ValueError as exc:
            errors[label] = str(exc)
    saved["errors"] = np.asarray(repr(errors))
    np.savez(out, **saved)
''')


@pytest.fixture(scope="module")
def reference_m4(tmp_path_factory):
    """The reference's shard_map jobs at m = 4, in a subprocess with four
    forced host devices; their results as a dict of numpy arrays."""
    out = tmp_path_factory.mktemp("shard_map") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_M4, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as data:
        return {key: data[key] for key in data.files}


def _m4_batch(seed, peak=False):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.25, size=(4, 512)) % 503).astype(np.int32)
    vals = rng.integers(-4, 8, size=(4, 512, 2)).astype(np.float32)
    valid = rng.random((4, 512)) >= 0.03
    if peak:
        vals[-1, 0, 0], valid[-1, 0] = 127.0, True
    return keys, vals, valid


@pytest.mark.parametrize("label", ["plain", "measured"])
def test_four_slot_sharded_equals_reference_shard_map(reference_m4, label):
    extra = dict(estimate_speeds=True, measure_timings=True) if label == "measured" else {}
    port = _sharded(4, 24, scheduler="bss", pipeline_chunks=3, **extra)
    for seed in range(3):
        res = port.run(_torch(_m4_batch(seed)))
        np.testing.assert_array_equal(res.values, reference_m4[f"{label}_values_{seed}"])
        np.testing.assert_array_equal(res.counts, reference_m4[f"{label}_counts_{seed}"])
        if label == "plain" or seed == 0:
            # Later measured plans follow each package's own clocks.
            np.testing.assert_array_equal(res.schedule.assignment,
                                          reference_m4[f"{label}_assignment_{seed}"])
        if label == "measured":
            # Waves follow the plan, so shapes agree on batch 0's plan only.
            want = reference_m4[f"{label}_timings_{seed}"]
            got = port.last_wave_timings
            assert got.seconds.shape == (4, port.last_plan.waves.num_chunks)
            assert want.shape[0] == 4 and (seed > 0 or got.seconds.shape == want.shape)
            assert got.valid and bool(reference_m4[f"{label}_valid_{seed}"])
            assert (got.seconds >= 0).all()
        else:
            assert port.last_wave_timings is None


@pytest.mark.parametrize("label", ["coded", "coded-int8-sequential"])
def test_four_slot_sharded_coded_equals_reference_shard_map(reference_m4, label):
    """The coded shuffle on the sharded backend against the reference's
    ``_phase_b_shard_coded`` under ``shard_map``, and against the stacked
    coded run: values, counts, plans and wire bytes equal."""
    extra = dict(shuffle_replication=2)
    if label == "coded-int8-sequential":
        extra.update(quantize_shuffle="int8", pipelined=False)
    port = _sharded(4, 24, scheduler="bss", pipeline_chunks=3, **extra)
    stacked = _stacked(4, 24, scheduler="bss", pipeline_chunks=3, **extra)
    for seed in range(2):
        batch = _m4_batch(seed, peak="int8" in label)
        res = port.run(_torch(batch))
        _assert_same_result(res, stacked.run(_torch(batch)))
        np.testing.assert_array_equal(res.values, reference_m4[f"{label}_values_{seed}"])
        np.testing.assert_array_equal(res.counts, reference_m4[f"{label}_counts_{seed}"])
        np.testing.assert_array_equal(res.schedule.assignment,
                                      reference_m4[f"{label}_assignment_{seed}"])
        np.testing.assert_array_equal(
            [res.shuffle_bytes, res.replication_bytes, res.shuffle_pairs, res.overflow],
            reference_m4[f"{label}_bytes_{seed}"])
        assert res.replication_bytes > 0


def test_configuration_errors_fire_as_in_the_reference_at_four_slots(reference_m4):
    errors = eval(str(reference_m4["errors"]))      # a repr of {label: message}
    cases = {"coded": dict(shuffle_replication=2, estimate_speeds=True),
             "no-estimator": dict(measure_timings=True),
             "checkpoint": dict(checkpoint_waves=True, estimate_speeds=True)}
    for label, extra in cases.items():
        assert errors[label], f"the reference accepted {label}"
        with pytest.raises(ValueError) as info:
            _sharded(4, **extra)
        # The reference's reason, in its words (the backend's name aside).
        head = errors[label].split("—")[0].strip()
        assert head in str(info.value), (head, str(info.value))


def test_measure_timings_errors_on_one_device_as_in_the_reference():
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    with pytest.raises(ValueError, match="per-slot clocks"):
        MapReduceJob(_identity, MapReduceConfig(num_slots=2, num_clusters=8, estimate_speeds=True,
                                                measure_timings=True), backend="vmap")
    with pytest.raises(ValueError, match="per-slot clocks"):
        tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
            num_slots=2, num_clusters=8, estimate_speeds=True, measure_timings=True),
            device="cpu")
    for make in (lambda cfg: MapReduceJob(_identity, MapReduceConfig(**cfg),
                                          backend="shard_map", mesh=_mesh1()),
                 lambda cfg: tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**cfg),
                                              backend="sharded", devices=["cpu"])):
        with pytest.raises(ValueError, match="nothing consumes"):
            make(dict(num_slots=1, num_clusters=8, measure_timings=True))
        with pytest.raises(ValueError, match="checkpoint_waves=True is incompatible"):
            make(dict(num_slots=1, num_clusters=8, checkpoint_waves=True,
                      estimate_speeds=True))


def test_timing_source_resolves_as_in_the_reference():
    assert not _stacked(2, estimate_speeds=True)._measure_timings
    assert _sharded(2, estimate_speeds=True)._measure_timings
    assert not _sharded(2, estimate_speeds=True, measure_timings=False)._measure_timings
    assert not _sharded(2)._measure_timings


# ---------------------------------------------------------------------------
# The measured path.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sum", "sum-sequential", "max", "count-sequential",
                                  "int8", "sketch-prefix"])
def test_measured_equals_unmeasured_bit_for_bit(name):
    m, cfg = 4, _CONFIGS[name]
    measured = _sharded(m, estimate_speeds=True, **cfg)
    plain = _sharded(m, **cfg)
    assert measured._measure_timings
    for seed in range(3):
        batch = _batch(seed, m)
        got, want = measured.run(_torch(batch)), plain.run(_torch(batch))
        _assert_same_result(got, want, plans=seed == 0)
        t = measured.last_wave_timings
        waves = (measured.last_plan.waves.num_chunks
                 if cfg.get("pipelined", True) else 1)
        assert t.seconds.shape == (m, waves)
        assert t.valid and (t.seconds >= 0).all() and (t.slot_seconds() > 0).all()
    assert measured.speed_estimator.observations == 3
    assert measured._external_timings


def test_fixed_ticks_drive_the_estimator_as_in_the_reference():
    """The same ticks buffer through _observe_measured of both packages."""
    from repro.core import mesh_timing as rmt
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    m, n = 4, 24
    ref = MapReduceJob(_identity, MapReduceConfig(num_slots=m, num_clusters=n,
                                                  estimate_speeds=True), backend="vmap")
    port = _sharded(m, n, estimate_speeds=True)
    key_dist = np.arange(1, n + 1, dtype=np.float64)
    hist = np.tile(key_dist / m, (m, 1))
    plan_r, plan_p = ref._plan(hist, key_dist, 256), port._plan(hist, key_dist, 256)
    _assert_same_plan(plan_p, plan_r)
    rng = np.random.default_rng(3)
    for step in range(4):
        if step == 2:
            ref.set_slot_slowdown(3, 2.5)
            port.set_slot_slowdown(3, 2.5)
        starts = rng.integers(10 ** 9, 2 * 10 ** 9, size=(m, 3))
        ticks = np.stack([starts, starts + rng.integers(10 ** 5, 10 ** 6, size=(m, 3))], -1)
        words = tmr.wt_ops.combine_ticks(np.stack([ticks & 0xFFFFFFFF, ticks >> 32], -1)
                                         .astype(np.uint32))
        np.testing.assert_array_equal(words, ticks)
        ref._observe_measured(rmt.WaveTimings.from_ticks(ticks, 1e-9), plan_r)
        port._observe_measured(tmt.WaveTimings.from_ticks(ticks, 1e-9), plan_p)
        assert port.speed_estimator.to_json() == ref.speed_estimator.to_json()
    np.testing.assert_allclose(port.current_speeds(), ref.current_speeds(), rtol=1e-12)


def test_measured_slowdown_moves_load_off_the_slow_slot():
    """As the reference's test_measured_timings_drive_estimator_and_replan:
    a 4x slowed slot trips a speed_drift replan and loses load, while the
    outputs stay those of the unperturbed stacked job."""
    m = 4
    job = _sharded(m, scheduler="bss", pipeline_chunks=3, estimate_speeds=True,
                   reuse=tsc.ReusePolicy(max_drift=0.8, max_speed_drift=0.25))
    ref = _stacked(m, scheduler="bss", pipeline_chunks=3)
    observe = job._observe_measured

    def steady(timings, planned):
        # The CPU's host stamps swing with the machine's load. Every wave
        # is billed one fixed time instead, so the injected slowdown alone
        # tells the slots apart; the stamps and their shape stay real.
        assert timings.valid and (timings.seconds >= 0).all()
        timings.seconds = np.full_like(timings.seconds, 1e-3)
        observe(timings, planned)

    job._observe_measured = steady
    loads, reasons = [], []
    for seed in range(7):
        if seed == 3:
            job.set_slot_slowdown(1, 4.0)
        batch = _batch(seed, m)
        res, want = job.run(_torch(batch)), ref.run(_torch(batch))
        _assert_same_result(res, want, plans=False)
        reasons.append(res.plan_reason)
        loads.append(np.bincount(res.schedule.assignment, weights=res.key_distribution,
                                 minlength=m))
    assert "speed_drift" in reasons[3:]
    sp = job.speed_estimator.speeds()
    assert sp[1] == sp.min() and sp[1] < 0.85
    share = [load[1] / load.sum() for load in loads]
    assert share[-1] < share[2]


def test_fenced_fallback_gives_the_same_outputs():
    m = 4
    for cfg in (dict(), dict(pipelined=False), dict(reduce_op="max")):
        with wt.force_backend("none"):
            fenced = _sharded(m, estimate_speeds=True, **cfg)
            for seed in range(2):
                batch = _batch(seed, m)
                got = fenced.run(_torch(batch))
                want = _sharded(m, **cfg).run(_torch(batch))
                _assert_same_result(got, want, plans=seed == 0)
                t = fenced.last_wave_timings
                waves = fenced.last_plan.waves.num_chunks if cfg.get("pipelined", True) else 1
                assert t.seconds.shape == (m, waves) and t.valid
                assert (t.seconds > 0).all()
        assert fenced.speed_estimator.observations == 2


def test_fenced_fallback_refuses_the_quantized_wire():
    with wt.force_backend("none"):
        job = _sharded(2, estimate_speeds=True, quantize_shuffle="int8")
        with pytest.raises(ValueError, match="fenced"):
            job.run(_torch(_batch(0, 2)))


# ---------------------------------------------------------------------------
# What the sharded backend does not take.
# ---------------------------------------------------------------------------


def test_sharded_coded_shuffle_is_not_ported():
    """Once refused (ROADMAP item 14), now ported; the test keeps its name
    from when it checked the refusal. The sharded coded run equals the
    stacked one, and a coded snapshot replayed on the sharded backend runs
    coded and equals the stacked job that planned it."""
    coded = _stacked(4, shuffle_replication=2, reuse=tsc.ReusePolicy())
    first = coded.run(_torch(_batch(0, 4)))
    _assert_same_result(_sharded(4, shuffle_replication=2).run(_torch(_batch(0, 4))), first)
    snap = json.loads(json.dumps(coded.schedule_cache.snapshot.to_json()))
    job = _sharded(4, reuse=tsc.ReusePolicy())
    job.load_snapshot(snap)
    replayed = job.run(_torch(_batch(0, 4)))
    assert replayed.reused and job.last_plan.waves.replication == 2
    _assert_same_result(replayed, first, plans=False)
    assert replayed.replication_bytes == first.replication_bytes > 0
    assert replayed.shuffle_bytes == first.shuffle_bytes


def test_a_coded_snapshot_on_a_measured_job_is_refused():
    """The coded decode carries no stamps, so a coded plan replayed on a
    job that measures its waves raises instead of running unmeasured."""
    coded = _stacked(4, shuffle_replication=2, reuse=tsc.ReusePolicy())
    coded.run(_torch(_batch(0, 4)))
    job = _sharded(4, estimate_speeds=True, reuse=tsc.ReusePolicy())
    assert job._measure_timings
    job.load_snapshot(json.loads(json.dumps(coded.schedule_cache.snapshot.to_json())))
    with pytest.raises(ValueError, match="stamp"):
        job.run(_torch(_batch(0, 4)))


def test_sharded_constructor_refusals():
    cfg = tmr.MapReduceConfig(num_slots=3, num_clusters=8)
    with pytest.raises(ValueError, match="devices has 2 entries"):
        tmr.MapReduceJob(_identity, cfg, backend="sharded", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="devices="):
        tmr.MapReduceJob(_identity, cfg, backend="sharded", device="cpu")
    with pytest.raises(ValueError, match="devices="):
        tmr.MapReduceJob(_identity, cfg, device="cpu", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="unknown backend"):
        tmr.MapReduceJob(_identity, cfg, backend="shard_map", device="cpu")
    # The coded shuffle constructs on the sharded backend, refused only
    # where the reference refuses it (one slot, the checkpointed walk, and
    # measured clocks, which estimate_speeds turns on here).
    job = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=3, num_clusters=8,
                                                          shuffle_replication=2),
                           backend="sharded", devices=["cpu"] * 3)
    assert job.cfg.shuffle_replication == 2 and not job._measure_timings
    for extra, match in ((dict(num_slots=1), "at least 2 slots"),
                         (dict(checkpoint_waves=True), "checkpoint_waves"),
                         (dict(estimate_speeds=True), "measured timings")):
        with pytest.raises(ValueError, match=match):
            _sharded(extra.pop("num_slots", 3), shuffle_replication=2, **extra)
    synthetic = _sharded(3, shuffle_replication=2, estimate_speeds=True, measure_timings=False)
    assert not synthetic._measure_timings


def test_sharded_default_devices_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default devices are valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=2, num_clusters=8),
                         backend="sharded")


def test_sharded_rejects_a_map_fn_on_another_device():
    job = tmr.MapReduceJob(lambda b: tuple(t[:, :4] for t in b) + (torch.zeros(1),),
                           tmr.MapReduceConfig(num_slots=2, num_clusters=8),
                           backend="sharded", devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        job.run(_torch(_batch(0, 2)))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sum", "sum-sequential", "max", "int8", "sketch-prefix",
                                  "coded", "coded-sequential", "coded-int8"])
def test_cuda_sharded_equals_cuda_stacked(name):
    dev = _cuda()
    m, cfg = 6, _CONFIGS[name]
    sharded = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=m, num_clusters=24,
                                                              **cfg), backend="sharded")
    assert len(sharded.streams) == m and len({id(s) for s in sharded.streams}) == m
    assert all(d == dev for d in sharded.devices)
    stacked = _stacked(m, device="cuda", **cfg)
    for seed in range(2):
        batch = _torch(_batch(seed, m, k=4096), device=dev)
        _assert_same_result(stacked.run(batch), sharded.run(batch))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sum-overflow", "sum-sequential"])
def test_cuda_stacked_equals_sharded_on_float_pairs(name):
    """On normals, kernel 2's sums over the stacked kept pairs (gathered
    from the Map output) equal its sums over the sharded bucket files bit
    for bit: each cluster's pairs arrive in the same order."""
    dev = _cuda()
    m, cfg = 6, _CONFIGS[name]
    sharded = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=m, num_clusters=24,
                                                              **cfg), backend="sharded")
    stacked = _stacked(m, device="cuda", **cfg)
    for seed in range(2):
        keys, _, valid = _batch(seed, m, k=8192)
        vals = np.random.default_rng(seed).standard_normal((m, 8192, 3)).astype(np.float32)
        batch = _torch((keys, vals, valid), device=dev)
        got, want = stacked.run(batch), sharded.run(batch)
        _assert_same_result(got, want)
        assert (got.overflow > 0) == ("overflow" in name)


@pytest.mark.gpu
@pytest.mark.parametrize("pipelined", [True, False])
def test_cuda_measured_path_stamps_every_wave_boundary(pipelined):
    dev = _cuda()
    m = 6
    measured = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=m, num_clusters=24, estimate_speeds=True, pipelined=pipelined),
        backend="sharded")
    plain = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=m, num_clusters=24, pipelined=pipelined), backend="sharded")
    wt.tick_calibration(dev)
    for seed in range(3):
        batch = _torch(_batch(seed, m, k=4096), device=dev)
        s0 = wt.stamp_through_launches
        got = measured.run(batch)
        waves = measured.last_plan.waves.num_chunks if pipelined else 1
        assert wt.stamp_through_launches - s0 == m * (waves + 1)
        s0 = wt.stamp_through_launches
        want = plain.run(batch)
        assert wt.stamp_through_launches == s0
        _assert_same_result(got, want, plans=seed == 0)
        t = measured.last_wave_timings
        assert t.seconds.shape == (m, waves) and t.valid and (t.seconds > 0).all()


@pytest.mark.gpu
def test_cuda_fenced_fallback_gives_the_same_outputs():
    dev = _cuda()
    m = 4
    with wt.force_backend("none"):
        fenced = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
            num_slots=m, num_clusters=24, estimate_speeds=True), backend="sharded")
        for seed in range(2):
            batch = _torch(_batch(seed, m, k=4096), device=dev)
            got = fenced.run(batch)
            want = _stacked(m, device="cuda").run(batch)
            _assert_same_result(got, want, plans=seed == 0)
            assert (fenced.last_wave_timings.seconds > 0).all()
