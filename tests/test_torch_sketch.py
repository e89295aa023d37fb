"""Count-min statistics and streaming-prefix planning in the port against the reference.

The same numpy inputs go through the reference (``backend="vmap"``,
``use_kernels=True``, so its statistics come from ``sketch_hist_pallas``
in interpret mode) and through the port on the CPU. The provider's numpy
estimators must give equal results, sketch plans must be equal exactly
(assignment, ranks, chunk map, caps, ``caps_estimated``), and outputs
must be bit-equal to the reference's and to the port's exact mode. The
reference is imported inside the tests only, so the ``gpu`` case also runs
where JAX is absent (``--noconftest -m gpu``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mapreduce as tmr
from repro_torch.core import stats_provider as tsp
from repro_torch.kernels.sketch_hist import ops as sk_ops


def _identity(batch):
    return batch


def _batch(m, k, n, seed, zipf=1.3):
    """Skewed keys (negatives included), ~10% invalid, integer-valued values."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(zipf, size=(m, k)) % (4 * n)).astype(np.int32)
    keys[:, ::7] *= -1
    values = rng.integers(-3, 4, size=(m, k, 2)).astype(np.float32)
    valid = rng.random((m, k)) > 0.1
    return keys, values, valid


def _adversarial_batch(seed, m=4, k=1024, n=64):
    """The hot cluster arrives only after the planning prefix (benchmarks/run.py)."""
    rng = np.random.default_rng(seed)
    cut = k // 4
    keys = np.empty((m, k), np.int32)
    choices = np.array([c for c in range(n) if c != 3], np.int32)
    keys[:, :cut] = rng.choice(choices, size=(m, cut))
    keys[:, cut:] = 3
    values = rng.integers(0, 5, size=(m, k, 2)).astype(np.float32)
    return keys, values, np.ones((m, k), bool)


def _spy(job):
    plans = []
    plan = job._plan

    def spy(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    job._plan = spy
    return plans


def _run_ref(batch, **cfg):
    import jax.numpy as jnp

    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    job = MapReduceJob(_identity, MapReduceConfig(use_kernels=True, **cfg), backend="vmap")
    plans = _spy(job)
    res = job.run(tuple(jnp.asarray(a) for a in batch))
    return job, res, plans


def _run_port(batch, device="cpu", **cfg):
    job = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**cfg), device=device)
    plans = _spy(job)
    res = job.run(tuple(torch.from_numpy(a).to(device) for a in batch))
    return job, res, plans


def _assert_plans_equal(ref, port):
    np.testing.assert_array_equal(port.local_hist, np.asarray(ref.local_hist))
    np.testing.assert_array_equal(port.key_dist, np.asarray(ref.key_dist))
    np.testing.assert_array_equal(port.schedule.assignment, ref.schedule.assignment)
    np.testing.assert_array_equal(port.waves.rank_of_cluster, ref.waves.rank_of_cluster)
    np.testing.assert_array_equal(port.waves.chunk_of_cluster, ref.waves.chunk_of_cluster)
    assert port.capacity == ref.capacity
    assert port.chunk_caps == ref.chunk_caps
    assert port.caps_estimated == ref.caps_estimated
    assert port.stats_overestimate == ref.stats_overestimate
    assert (port.strategy, port.stats_provider, port.stats_params) == (
        ref.strategy, ref.stats_provider, ref.stats_params)


def _assert_outputs_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))
    np.testing.assert_array_equal(np.asarray(a.counts), np.asarray(b.counts))


# ---------------------------------------------------------------------------
# The provider's host estimators (numpy copies).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,depth,n", [(8, 1, 5), (64, 4, 200), (256, 3, 40)])
def test_sketch_estimators_match_reference(width, depth, n):
    from repro.core import stats_provider as rsp

    rng = np.random.default_rng(width + depth)
    ref = rsp.SketchStats(n, width=width, depth=depth, seed=3)
    port = tsp.SketchStats(n, width=width, depth=depth, seed=3)
    hist = rng.integers(0, 30, size=(4, n)).astype(np.float64)
    state = port.from_dense(hist)
    np.testing.assert_array_equal(state, ref.from_dense(hist))
    np.testing.assert_array_equal(port.from_dense(hist[0]), ref.from_dense(hist[0]))
    np.testing.assert_array_equal(port.bins(), ref.bins())
    np.testing.assert_array_equal(port.to_dense(state), ref.to_dense(state))
    np.testing.assert_array_equal(port.to_dense(state[1]), ref.to_dense(state[1]))
    np.testing.assert_array_equal(port.key_dist(state), ref.key_dist(state))
    assert (port.to_dense(state) >= hist).all()       # overestimate-only
    dests = rng.integers(0, 4, size=n)
    for members in (np.arange(n), np.arange(0, n, 3), np.array([], np.int64)):
        assert port.send_bound(state, dests[members], members, 4) == \
            ref.send_bound(state, dests[members], members, 4)
    assert port.params() == ref.params() == {"width": width, "depth": depth, "seed": 3}
    assert port.state_size == ref.state_size == depth * width


def test_exact_estimators_match_reference():
    from repro.core import stats_provider as rsp

    hist = np.random.default_rng(0).random((4, 8)).astype(np.float32)
    ref, port = rsp.ExactStats(8), tsp.ExactStats(8)
    for fn in ("to_dense", "from_dense", "key_dist"):
        got, want = getattr(port, fn)(hist), getattr(ref, fn)(hist)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert port.state_size == ref.state_size == 8
    assert port.overestimate_only and tsp.SketchStats.overestimate_only


def test_sketch_collect_matches_reference():
    """Phase A's (m, depth * width) state, one call for all slots."""
    import jax.numpy as jnp

    from repro.core import stats_provider as rsp

    rng = np.random.default_rng(1)
    ids = rng.integers(0, 500, size=(3, 777)).astype(np.int32)
    w = (rng.random((3, 777)) < 0.9).astype(np.float32)
    ref = rsp.SketchStats(500, width=128, depth=4, use_kernel=True)
    port = tsp.SketchStats(500, width=128, depth=4)
    got = port.collect(torch.from_numpy(ids), torch.from_numpy(w)).numpy()
    assert got.shape == (3, 512)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(ref.collect(jnp.asarray(ids[i]), jnp.asarray(w[i]))))


@pytest.mark.parametrize("stats", ["exact", "sketch"])
def test_saturated_counts_plan_like_reference(stats):
    """Counts at 2^24 void the statistics-sized bounds in both packages."""
    m, n, k = 4, 16, 4096
    hist = np.ones((m, n))
    for hot in (float(2 ** 24) + 10.0, 100.0):
        hist[0, 0] = hot
        plans = []
        for job in (_ref_job(m, n, stats), _port_job(m, n, stats)):
            state = job._stats.from_dense(hist) if stats == "sketch" else hist
            plans.append(job._plan(state, None, k))
        _assert_plans_equal(*plans)
        assert (plans[1].capacity == k) == (hot > 2 ** 24)


def _ref_job(m, n, stats):
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    return MapReduceJob(_identity, MapReduceConfig(num_slots=m, num_clusters=n, stats=stats,
                                                   scheduler="lpt"), backend="vmap")


def _port_job(m, n, stats):
    return tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=m, num_clusters=n, stats=stats, scheduler="lpt"), device="cpu")


# ---------------------------------------------------------------------------
# The engine's sketch path, with and without streaming-prefix planning.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", [None, 0.25])
@pytest.mark.parametrize("sched", ["os4m", "lpt", "hash"])
def test_sketch_engine_matches_reference(sched, prefix):
    m, k, n = 8, 256, 96
    batch = _batch(m, k, n, seed=4)
    cfg = dict(num_slots=m, num_clusters=n, scheduler=sched, stats="sketch",
               sketch_width=64, sketch_depth=4, stream_prefix=prefix)
    ref_job, ref, ref_plans = _run_ref(batch, **cfg)
    port_job, port, port_plans = _run_port(batch, **cfg)
    assert len(port_plans) == len(ref_plans) == (2 if prefix else 1)
    for r, p in zip(ref_plans, port_plans):
        _assert_plans_equal(r, p)
    _assert_outputs_equal(ref, port)
    np.testing.assert_array_equal(port.key_distribution, np.asarray(ref.key_distribution))
    assert port.overflow == ref.overflow == 0
    assert port.shuffle_bytes == ref.shuffle_bytes
    assert port_job.capacity_fallbacks == ref_job.capacity_fallbacks
    # The port's sketch path gives its exact path's outputs.
    _, exact, _ = _run_port(batch, num_slots=m, num_clusters=n, scheduler=sched)
    _assert_outputs_equal(exact, port)


def test_adversarial_prefix_trips_the_escape_hatch_in_both():
    """A prefix that never saw the tail-hot cluster under-provisions wave 1:
    both engines take the escape hatch once per batch, outputs stay exact."""
    import jax.numpy as jnp

    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    cfg = dict(num_slots=4, num_clusters=64, scheduler="lpt", stats="sketch",
               sketch_width=128, sketch_depth=4, stream_prefix=0.25)
    ref = MapReduceJob(_identity, MapReduceConfig(use_kernels=True, **cfg), backend="vmap")
    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**cfg), device="cpu")
    exact = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=4, num_clusters=64, scheduler="lpt"), device="cpu")
    for b in range(2):
        batch = _adversarial_batch(10 * b + 1)
        r = ref.run(tuple(jnp.asarray(a) for a in batch))
        p = port.run(tuple(torch.from_numpy(a) for a in batch))
        e = exact.run(tuple(torch.from_numpy(a) for a in batch))
        assert port.capacity_fallbacks == ref.capacity_fallbacks == b + 1
        assert p.overflow == r.overflow == 0
        _assert_outputs_equal(r, p)
        _assert_outputs_equal(e, p)
        assert not port.last_plan.caps_estimated
        assert port.last_plan.chunk_caps == (1024,) * port.last_plan.waves.num_chunks


@pytest.mark.parametrize("pipelined", [True, False])
def test_escape_hatch_buffers_fit_the_batch(pipelined):
    """The hatch re-executes in buffers cut to the batch's largest group,
    with the outputs, overflow and wire rows of the escalated plan's own.
    Only the pipelined walk commits estimated caps, so only it trips."""
    cfg = dict(num_slots=4, num_clusters=64, scheduler="lpt", stats="sketch",
               sketch_width=128, sketch_depth=4, stream_prefix=0.25, pipelined=pipelined)
    job, res, _ = _run_port(_adversarial_batch(1), **cfg)
    assert job.capacity_fallbacks == int(pipelined) and res.overflow == 0
    planned = job._escalate_caps(job.last_plan)
    batch = tuple(torch.from_numpy(a) for a in _adversarial_batch(1))
    capacity, chunk_caps = job._needed_caps(batch, planned)
    if pipelined:
        assert all(c <= p for c, p in zip(chunk_caps, planned.chunk_caps))
        assert sum(chunk_caps) < sum(planned.chunk_caps)
    else:
        assert capacity < planned.capacity
    full = job._execute(batch, planned)
    cut = job._execute(batch, planned, caps=(capacity, chunk_caps))
    for a, b in zip(full, cut):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(res.values, full[0].numpy().sum(axis=0))


def _group_needs(batch, plan, m, n):
    """The most pairs any (slot, destination) group holds in each chunk of
    ``plan``, and in any slot's whole send (numpy, from the batch)."""
    keys, _, valid = batch
    cid = np.abs(keys.astype(np.int64)) % n
    chunk = np.asarray(plan.waves.chunk_of_cluster)[cid]
    dest = np.asarray(plan.schedule.assignment)[cid]
    chunks = plan.waves.num_chunks
    per = np.zeros((keys.shape[0], chunks, m), np.int64)
    for s in range(keys.shape[0]):
        np.add.at(per[s], (chunk[s][valid[s]], dest[s][valid[s]]), 1)
    return int(per.sum(axis=1).max()), tuple(int(c) for c in per.max(axis=(0, 2)))


def test_reused_escalated_plan_replays_at_cut_caps():
    """Batch 0 trips the escape hatch and caches the escalated plan (every
    cap k_per_shard); batches 1-2 reuse it. The reuse replays at caps cut to
    each batch's largest group, with the reference's outputs and overflow."""
    import jax.numpy as jnp

    from repro.core import schedule_cache as rsc
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob
    from repro_torch.core import schedule_cache as tsc

    m, k, n = 4, 1024, 64
    cfg = dict(num_slots=m, num_clusters=n, scheduler="lpt", stats="sketch",
               sketch_width=128, sketch_depth=4, stream_prefix=0.25)
    ref = MapReduceJob(_identity, MapReduceConfig(use_kernels=True, reuse=rsc.ReusePolicy(),
                                                  **cfg), backend="vmap")
    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(reuse=tsc.ReusePolicy(), **cfg),
                            device="cpu")
    runs = []
    execute = port._execute

    def spy(inter, plan, caps=None):
        runs.append((plan, caps))
        return execute(inter, plan, caps)

    port._execute = spy
    for b in range(3):
        batch = _adversarial_batch(10 * b + 1, m=m, k=k, n=n)
        runs.clear()
        r = ref.run(tuple(jnp.asarray(a) for a in batch))
        p = port.run(tuple(torch.from_numpy(a) for a in batch))
        _assert_outputs_equal(r, p)
        assert p.overflow == r.overflow == 0
        assert p.reused == (b > 0) and port.capacity_fallbacks == 1
        plan, caps = runs[-1]
        assert plan.chunk_caps == (k,) * plan.waves.num_chunks == (k,) * 4
        assert plan.stats_overestimate and not plan.caps_estimated
        if b == 0:
            continue
        assert len(runs) == 1 and caps is not None
        need_total, need_chunks = _group_needs(batch, plan, m, n)
        capacity, chunk_caps = caps
        assert capacity <= need_total
        assert all(c <= max(1, w) for c, w in zip(chunk_caps, need_chunks))
        assert m * m * sum(chunk_caps) < m * m * k * plan.waves.num_chunks


def test_sketch_snapshot_keeps_its_provider():
    m, n = 4, 16
    hist = np.random.default_rng(2).integers(1, 50, (m, n)).astype(np.float64)
    job = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=m, num_clusters=n, stats="sketch", sketch_width=128), device="cpu")
    planned = job._plan(job._stats.from_dense(hist), None, 512)
    d = planned.to_json()
    back = type(planned).from_json(d)
    assert back.to_json() == d
    assert back.stats_provider == "sketch" and back.stats_params == job._stats.params()
    np.testing.assert_allclose(back.key_dist, job._stats.key_dist(planned.local_hist))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("prefix", [None, 0.25])
def test_cuda_sketch_engine_matches_cpu(prefix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m, k, n = 8, 4096, 2048
    batch = _batch(m, k, n, seed=9)
    cfg = dict(num_slots=m, num_clusters=n, stats="sketch", sketch_width=256,
               stream_prefix=prefix)
    _, cpu, cpu_plans = _run_port(batch, **cfg)
    before = sk_ops.launches
    _, gpu, gpu_plans = _run_port(batch, device="cuda", **cfg)
    assert sk_ops.launches == before + (2 if prefix else 1)
    for c, g in zip(cpu_plans, gpu_plans):
        _assert_plans_equal(c, g)
    _assert_outputs_equal(cpu, gpu)
    assert gpu.overflow == 0


@pytest.mark.gpu
def test_cuda_escape_hatch_matches_cpu():
    """The adversarial prefix trips the hatch on the card once per batch,
    and the card's outputs equal the CPU port's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dict(num_slots=4, num_clusters=64, scheduler="lpt", stats="sketch",
               sketch_width=128, sketch_depth=4, stream_prefix=0.25)
    cpu = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**cfg), device="cpu")
    gpu = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**cfg), device="cuda")
    for b in range(2):
        batch = _adversarial_batch(10 * b + 1)
        c = cpu.run(tuple(torch.from_numpy(a) for a in batch))
        before = sk_ops.launches
        g = gpu.run(tuple(torch.from_numpy(a).cuda() for a in batch))
        assert sk_ops.launches == before + 2
        assert gpu.capacity_fallbacks == cpu.capacity_fallbacks == b + 1
        assert g.overflow == c.overflow == 0
        _assert_outputs_equal(c, g)
        assert gpu.last_plan.chunk_caps == cpu.last_plan.chunk_caps
