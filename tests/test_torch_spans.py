"""The span recorder inside ``MapReduceJob.run`` (``core/spans.py``).

Off (the default), a run records nothing and ``last_phase_ms`` holds its
three phases; on (``trace=True``, or a profiler recording), every span of
the run lands in one tree under the run's id, with a key each in
``last_phase_ms``. Spans change no output and add no host sync: the
recorded programs hold the same ``host_callback`` nodes either way, and on
the card the sync-debug warnings are as many. The card's case is marked
``gpu``; this file imports no JAX.
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.analysis import op_graph as og
from repro_torch.analysis import targets as tgt
from repro_torch.core import mapreduce as tmr
from repro_torch.core import schedule_cache as tsc
from repro_torch.core import spans

PHASES = ("phase_a", "plan", "phase_b")
DEVICE_STAGES = ("phase_a.map_stats", "phase_b.spill", "phase_b.copy", "phase_b.rank_sort",
                 "phase_b.reduce")
HOST_SPANS = ("phase_a.decide", "phase_a.pull", "phase_b.upload", "phase_b.pull")
PHASE_B_STAGES = ("phase_b.spill", "phase_b.copy", "phase_b.rank_sort", "phase_b.reduce")
M, N, K = 4, 32, 1024


def _batch(seed, device="cpu"):
    """Uniform keys over every cluster, integer values (bit-exact sums)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 31 - 1, size=(M, K)).astype(np.int32)
    vals = rng.integers(0, 8, size=(M, K, 2)).astype(np.float32)
    valid = rng.random((M, K)) < 0.95
    return tuple(torch.from_numpy(a).to(device) for a in (keys, vals, valid))


def _job(trace=False, device="cpu", **cfg):
    cfg = tmr.MapReduceConfig(num_slots=M, num_clusters=N, pipeline_chunks=4,
                              reuse=tsc.ReusePolicy(), **cfg)
    if device == "sharded":
        return tmr.MapReduceJob(lambda b: b, cfg, backend="sharded", devices=["cpu"] * M,
                                trace=trace)
    return tmr.MapReduceJob(lambda b: b, cfg, device=device, trace=trace)


def _entries(monkeypatch):
    """Count the stage hooks that got past their ``None`` check."""
    calls = []
    real = spans.Spans._entry

    def counted(self, name, on_device):
        calls.append(name)
        return real(self, name, on_device)

    monkeypatch.setattr(spans.Spans, "_entry", counted)
    return calls


def test_off_records_nothing(monkeypatch):
    calls = _entries(monkeypatch)
    job = _job()
    assert job.trace is False
    for _ in range(2):
        job.run(_batch(0))
        assert set(job.last_phase_ms) == set(PHASES)
        assert job.last_spans == []
    assert calls == []
    on = _job(trace=True)
    on.run(_batch(0))
    assert len(calls) > 0


def test_on_records_one_tree_per_run():
    job = _job(trace=True)
    job.run(_batch(1))
    first = {s.job for s in job.last_spans}
    res = job.run(_batch(1))
    assert res.reused and job.last_plan.waves.num_chunks == 4
    records = {s.name: s for s in job.last_spans}
    assert len(records) == len(job.last_spans)
    assert set(records) == set(PHASES + DEVICE_STAGES + HOST_SPANS)
    assert set(job.last_phase_ms) == set(records)
    (run_id,) = {s.job for s in job.last_spans}
    assert first == {run_id - 1}
    for span in job.last_spans:
        assert job.last_phase_ms[span.name] == span.ms
        if span.name in PHASES:
            assert span.parent is None and span.count == 1 and span.device_ms is None
            continue
        parent = records[span.parent]
        assert parent.host_start <= span.host_start <= span.host_end <= parent.host_end
        phase = parent
        while phase.parent is not None:
            phase = records[phase.parent]
        assert span.name.startswith(phase.name + ".")
        assert (span.device_ms is not None) == (span.name in DEVICE_STAGES)
        assert span.ms >= 0
    # Stacked, the rank sort is one sort of the kept pairs, inside the spill.
    assert records["phase_b.rank_sort"].parent == "phase_b.spill"
    assert records["phase_b.rank_sort"].count == 1
    for name in ("phase_b.copy", "phase_b.reduce"):
        assert records[name].count == 4
    phases = [records[p] for p in PHASES]
    assert all(a.host_end == b.host_start for a, b in zip(phases, phases[1:]))
    assert sum(records[s].ms for s in PHASE_B_STAGES) <= records["phase_b"].ms


def test_a_profiler_turns_spans_on_and_off():
    job = _job()
    job.run(_batch(0))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        job.run(_batch(0))
    assert {s.name for s in job.last_spans} >= set(DEVICE_STAGES)
    assert set(job.last_phase_ms) > set(PHASES)
    job.run(_batch(0))
    assert job.last_spans == [] and set(job.last_phase_ms) == set(PHASES)


@pytest.mark.parametrize("path", ["stacked", "sharded", "checkpointed", "coded"])
def test_outputs_equal_on_and_off(path):
    kwargs = {"checkpointed": {"checkpoint_waves": True},
              "coded": {"shuffle_replication": 2}}.get(path, {})
    device = "sharded" if path == "sharded" else "cpu"
    off, on = _job(False, device, **kwargs), _job(True, device, **kwargs)
    for seed in (0, 0, 1):
        a, b = off.run(_batch(seed)), on.run(_batch(seed))
        for name in ("values", "counts", "key_distribution"):
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        assert np.array_equal(a.schedule.assignment, b.schedule.assignment)
        assert (a.reused, a.plan_reason, a.overflow) == (b.reused, b.plan_reason, b.overflow)
        assert off.last_spans == [] and {s.name for s in on.last_spans} > set(PHASES)
    assert "phase_b.rank_sort" in on.last_phase_ms


def _syncs(graph):
    return [(n.site, n.attrs.get("op")) for n in graph.by_prim("host_callback")]


def test_recorded_programs_hold_the_same_host_syncs():
    off = {t.name: t.graph for t in tgt.phase_b_targets("cpu")}
    recorder = spans.Spans()
    with recorder.run(on=True):
        on = {t.name: t.graph for t in tgt.phase_b_targets("cpu")}
    assert {s.name for s in recorder.records} >= set(PHASE_B_STAGES)
    assert set(on) == set(off)
    for name in off:
        assert _syncs(on[name]) == _syncs(off[name]), name
        assert on[name].prims() == off[name].prims(), name


def test_a_recorded_run_holds_the_same_host_syncs():
    graphs = []
    for trace in (False, True):
        job = _job(trace)
        job.run(_batch(0))
        with og.Recorder() as rec:
            job.run(_batch(0))
        graphs.append(rec.graph)
    assert graphs[0].by_prim("host_callback")
    assert _syncs(graphs[1]) == _syncs(graphs[0])
    assert graphs[1].prims() == graphs[0].prims()


@pytest.mark.gpu
def test_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stages' events and kernels run only there")
    made = []
    real_event = torch.cuda.Event

    class CountedEvent(real_event):
        def __new__(cls, *args, **kwargs):
            made.append(kwargs)
            return super().__new__(cls, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", CountedEvent)
    batches = [_batch(seed, "cuda") for seed in (0, 1)]
    off, on = _job(False, "cuda"), _job(True, "cuda")
    off.run(batches[0])                         # cold plan, kernels built or loaded
    assert made == [] and off.last_spans == [] and set(off.last_phase_ms) == set(PHASES)
    on.run(batches[0])
    pooled = len(made)
    assert 0 < pooled <= 2 * 16                 # a pair an entry of a device stage
    results, warned = {}, {}
    try:
        for job in (off, on, on, off):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = job.run(batches[1])
            torch.cuda.set_sync_debug_mode(0)
            warned.setdefault(job.trace, []).append(
                sum("synchroniz" in str(w.message) for w in caught))
            results.setdefault(job.trace, []).append(res)
            assert len(made) == pooled              # the pool is reused: none made a run
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert warned[False][0] > 0 and warned[True] == warned[False]
    assert off.last_spans == [] and set(off.last_phase_ms) == set(PHASES)
    for res in results[True] + results[False][1:]:
        for name in ("values", "counts", "key_distribution"):
            x, y = np.asarray(getattr(res, name)), np.asarray(getattr(results[False][0], name))
            assert x.tobytes() == y.tobytes(), name
    ms = on.last_phase_ms
    assert all(ms[s] > 0 for s in DEVICE_STAGES)
    assert sum(ms[s] for s in PHASE_B_STAGES) <= ms["phase_b"]


@pytest.mark.gpu
def test_sharded_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: each slot's stream records its stages' events")
    cfg = tmr.MapReduceConfig(num_slots=M, num_clusters=N, pipeline_chunks=4,
                              reuse=tsc.ReusePolicy())
    off, on = (tmr.MapReduceJob(lambda b: b, cfg, backend="sharded", trace=t)
               for t in (False, True))
    batch = _batch(2, "cuda")
    for _ in range(2):
        a, b = off.run(batch), on.run(batch)
        for name in ("values", "counts", "key_distribution"):
            assert np.asarray(getattr(a, name)).tobytes() == \
                np.asarray(getattr(b, name)).tobytes(), name
    records = {s.name: s for s in on.last_spans}
    assert set(DEVICE_STAGES) <= set(records) and off.last_spans == []
    assert records["phase_b.copy"].count == M * 4      # slots × chunks
    assert all(records[s].device_ms > 0 for s in DEVICE_STAGES)
