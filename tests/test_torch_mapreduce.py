"""The port's main path against the reference engine, end to end.

Each configuration runs the same numpy batch through the reference
``MapReduceJob(..., use_kernels=True, backend="vmap")`` and through the
port on the CPU (``device="cpu"``: the kernels' plain versions). Plans
must be equal, integer-valued outputs bit-equal and float outputs
allclose. Reference results are cached at module scope, so the integer
and the float batch of one configuration compile the reference once. The
reference is imported inside the tests only, so the ``gpu`` cases also
run where JAX is absent (``--noconftest -m gpu``).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import mapreduce as tmr
from repro_torch.core import scheduler as tsched
from repro_torch.core.schedule_cache import CachedSchedule
from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
from repro_torch.kernels.histogram import ops as hist_ops

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_assignments.json"


def _identity(batch):
    return batch


def _batch(m, k, v, kind, seed=0):
    """Skewed int32 key hashes (negatives and INT32_MIN included), ~10% invalid."""
    rng = np.random.default_rng(seed)
    base = (rng.zipf(1.3, size=(m, k)) % 997).astype(np.uint32)
    keys = (base * np.uint32(2654435761)).view(np.int32)
    keys[0, 0] = np.iinfo(np.int32).min
    valid = rng.random((m, k)) > 0.1
    vrng = np.random.default_rng(seed + 1)
    if kind == "int":
        values = vrng.integers(-3, 4, size=(m, k, v)).astype(np.float32)
    else:
        values = vrng.standard_normal((m, k, v)).astype(np.float32)
    return keys, values, valid


def _spy_plans(job):
    """Record every CachedSchedule the reference job's ``_plan`` returns."""
    plans = []
    plan = job._plan

    def spy(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    job._plan = spy
    return plans


_REF_JOBS = {}


def _reference(key, batch, **cfg):
    """Reference run of ``batch`` (one job per configuration ``key``)."""
    import jax.numpy as jnp

    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    if key not in _REF_JOBS:
        job = MapReduceJob(_identity, MapReduceConfig(use_kernels=True, **cfg),
                           backend="vmap")
        _REF_JOBS[key] = (job, _spy_plans(job))
    job, plans = _REF_JOBS[key]
    res = job.run(tuple(jnp.asarray(a) for a in batch))
    return res, plans[-1]


def _port(batch, device="cpu", **cfg):
    job = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**cfg), device=device)
    res = job.run(tuple(torch.from_numpy(a).to(device) for a in batch))
    return res, job.last_plan


def _assert_plans_equal(ref, port):
    np.testing.assert_array_equal(port.local_hist, ref.local_hist)
    assert port.local_hist.dtype == np.float32
    np.testing.assert_array_equal(port.schedule.assignment, ref.schedule.assignment)
    np.testing.assert_array_equal(port.waves.rank_of_cluster, ref.waves.rank_of_cluster)
    np.testing.assert_array_equal(port.waves.chunk_of_cluster, ref.waves.chunk_of_cluster)
    assert port.capacity == ref.capacity
    assert port.chunk_caps == ref.chunk_caps
    assert port.strategy == ref.strategy


def _assert_results_equal(ref, port, kind):
    assert port.values.shape == ref.values.shape
    if kind == "int":
        np.testing.assert_array_equal(port.values, ref.values)
    else:
        np.testing.assert_allclose(port.values, ref.values, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.counts, ref.counts)
    np.testing.assert_array_equal(port.key_distribution, ref.key_distribution)
    assert port.overflow == ref.overflow
    assert port.shuffle_bytes == ref.shuffle_bytes
    assert port.shuffle_rows == ref.shuffle_rows
    assert port.shuffle_pairs == ref.shuffle_pairs
    assert port.strategy == ref.strategy


def _compare(key, kind, m=8, k=256, n=96, v=5, **cfg):
    batch = _batch(m, k, v, kind)
    ref_res, ref_plan = _reference(key, batch, num_slots=m, num_clusters=n, **cfg)
    port_res, port_plan = _port(batch, num_slots=m, num_clusters=n, **cfg)
    _assert_plans_equal(ref_plan, port_plan)
    _assert_results_equal(ref_res, port_res, kind)
    return port_res


@pytest.mark.parametrize("kind", ["int", "normal"])
@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("sched", ["hash", "lpt", "multifit", "bss", "os4m"])
def test_sum_matches_reference(sched, pipelined, kind):
    _compare(("sum", sched, pipelined), kind, scheduler=sched, pipelined=pipelined)


@pytest.mark.parametrize("kind", ["int", "normal"])
@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("op", ["max", "count"])
def test_max_count_match_reference(op, pipelined, kind):
    _compare((op, pipelined), kind, reduce_op=op, pipelined=pipelined)


@pytest.mark.parametrize("kind", ["int", "normal"])
def test_small_mesh_matches_reference(kind):
    _compare(("small",), kind, m=4, n=24, v=1, pipeline_chunks=3)


@pytest.mark.parametrize("kind", ["int", "normal"])
def test_forced_overflow_matches_reference(kind):
    res = _compare(("overflow",), kind, capacity_send=4)
    assert res.overflow > 0


@pytest.mark.parametrize("kind", ["int", "normal"])
def test_port_pipelined_equals_sequential(kind):
    batch = _batch(8, 512, 3, kind, seed=5)
    runs = [_port(batch, num_slots=8, num_clusters=64, pipelined=p)[0]
            for p in (True, False)]
    np.testing.assert_array_equal(runs[0].values, runs[1].values)
    np.testing.assert_array_equal(runs[0].counts, runs[1].counts)


@pytest.mark.parametrize("pipelined", [True, False])
def test_kept_order_is_sender_then_stream_order(pipelined):
    """The stacked spill's sort gives each cluster its kept pairs in sender
    order, then stream order, as a copy to its slot and a stable sort by
    rank do; the pairs kept are each (sender, chunk, slot) group's first
    ``cap``, and the rest count as overflow (drop-newest)."""
    m, k, n, cap = 4, 96, 12, 5
    rng = np.random.default_rng(11)
    keys = rng.integers(-50, 50, (m, k)).astype(np.int32)
    valid = rng.random((m, k)) > 0.1
    assign = rng.integers(0, m, n).astype(np.int32)
    rank = rng.permutation(n).astype(np.int32)
    chunk = (rank // 3).astype(np.int32) if pipelined else np.zeros(n, np.int32)
    chunks = 4 if pipelined else 1
    static = (m, n, cap, (cap,) * chunks, "sum", pipelined, chunks, None)
    vals = torch.zeros((m, k, 1))
    send, overflow, wire_rows = tmr._spill(
        (torch.from_numpy(keys), vals, torch.from_numpy(valid)),
        *(torch.from_numpy(a) for a in (assign, rank, chunk)), static, torch.arange(m),
        vals, vals)
    cid = np.abs(keys.astype(np.int64)) % n
    filled, kept, nonlocal_ = {}, {c: [] for c in range(n)}, 0
    for i in range(m):
        for t in range(k):
            if not valid[i, t]:
                continue
            group = (i, chunk[cid[i, t]], assign[cid[i, t]])
            filled[group] = filled.get(group, 0) + 1
            if filled[group] <= cap:
                kept[cid[i, t]].append(i * k + t)
                nonlocal_ += int(assign[cid[i, t]] != i)
    assert int(overflow) == valid.sum() - sum(map(len, kept.values())) > 0
    assert int(wire_rows) == nonlocal_
    order, keys_sorted = send.order[0].numpy(), send.keys[0].numpy()
    assert (np.diff(keys_sorted.astype(np.int64)) >= 0).all()
    for c in range(n):
        rows = keys_sorted == chunk[c] * (n + 1) + rank[c]
        assert order[rows].tolist() == kept[c]


def test_cluster_ids_keep_int32_semantics():
    import jax.numpy as jnp

    kh = np.array([[np.iinfo(np.int32).min, -1, -97, 0, 96, 2 ** 31 - 1]], np.int32)
    for n in (1, 7, 96, 352):
        want = np.asarray(jnp.abs(jnp.asarray(kh)) % n)
        got = tmr._cluster_ids(torch.from_numpy(kh), n).numpy()
        np.testing.assert_array_equal(got, want)
        assert ((got >= 0) & (got < n)).all()


def test_golden_assignments():
    golden = json.loads(GOLDEN.read_text())
    checked = 0
    for key, case in golden.items():
        if case.get("proc"):   # R||C_max fixtures: the multi-job slice
            continue
        rng = np.random.default_rng(case["seed"])
        loads = rng.zipf(1.3, case["n"]).clip(1, 20_000).astype(float)
        m = case["m"]
        for name, want in case["assignments"].items():
            if name == "lpt_jax":  # the on-device LPT, on the CPU
                got = tsched.lpt_assign_torch(loads, m, device="cpu")[0].numpy()
            elif name == "brute":
                got = tsched.schedule_brute(loads[:12], min(m, 4)).assignment
            elif name == "hash":
                got = tsched.schedule_hash(loads, m, keys=np.arange(case["n"])).assignment
            else:
                got = tsched.get_scheduler(name)(loads, m).assignment
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{key} {name}")
            checked += 1
    assert checked > 0


def test_reference_snapshot_executes_in_port():
    """A plan the reference wrote as JSON runs in the port to equal outputs."""
    import jax
    import jax.numpy as jnp

    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    m, k, n, v = 8, 256, 96, 5
    batch = _batch(m, k, v, "int", seed=3)
    ref = MapReduceJob(_identity, MapReduceConfig(
        num_slots=m, num_clusters=n, scheduler="lpt", use_kernels=True), backend="vmap")
    plans = _spy_plans(ref)
    ref.run(tuple(jnp.asarray(a) for a in batch))
    snapshot = json.loads(json.dumps(plans[-1].to_json()))
    ref_out, ref_cnt, ref_ovf, _ = ref._execute(
        tuple(jnp.asarray(a) for a in batch), plans[-1])

    port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(num_slots=m, num_clusters=n),
                            device="cpu")
    loaded = CachedSchedule.from_json(snapshot)
    assert loaded.to_json() == snapshot
    out, cnt, ovf, _ = port._execute(
        tuple(torch.from_numpy(a) for a in batch), loaded)
    np.testing.assert_array_equal(
        out.numpy().reshape(m, n, -1).sum(0),
        np.asarray(jax.device_get(ref_out)).reshape(m, n, -1).sum(0))
    np.testing.assert_array_equal(
        cnt.numpy().reshape(m, n).sum(0),
        np.asarray(jax.device_get(ref_cnt)).reshape(m, n).sum(0))
    assert int(ovf) == int(np.asarray(ref_ovf).reshape(-1)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("reduce_op", ["sum", "max", "count"])
def test_cuda_engine_matches_cpu(reduce_op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    batch = _batch(8, 4096, 5, "int", seed=7)
    cfg = dict(num_slots=8, num_clusters=96, reduce_op=reduce_op)
    cpu, cpu_plan = _port(batch, **cfg)
    h0, f0 = hist_ops.launches, fused_ops.launches
    gpu, gpu_plan = _port(batch, device="cuda", **cfg)
    seq, _ = _port(batch, device="cuda", pipelined=False, **cfg)
    assert hist_ops.launches == h0 + 2
    if reduce_op == "sum":
        assert fused_ops.launches == (
            f0 + gpu_plan.waves.num_chunks + 1)
    _assert_plans_equal(cpu_plan, gpu_plan)
    _assert_results_equal(cpu, gpu, "int")
    np.testing.assert_array_equal(gpu.counts, seq.counts)
    if reduce_op != "count":   # count: (n, V) pipelined, (n, 1) sequential
        np.testing.assert_array_equal(gpu.values, seq.values)
