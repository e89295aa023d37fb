"""A run of each cell, end to end at a small size on the CPU: its result
line, the control and the faults the comparison has to catch, the runner
without a card, and the trace's reduction."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from os4m_bench import control, harness, run as runner, spec
from os4m_bench.trace import Trace

SMALL = {"slots": 4, "pairs_per_slot": 3696, "clusters": 44}     # 3696 = 231 x 16
SEED = 2 ** 31 + 77


def small(cell_name: str):
    cell = spec.load_cell(cell_name)
    return dataclasses.replace(cell, config=dict(cell.config, **SMALL))


def run_small(cell, trace=False, job_factory=harness.make_job):
    return harness.run_cell(cell, SEED, 0.3, trace, "cpu", time.perf_counter(),
                            job_factory=job_factory)


CELLS = [w["name"] for w in spec.load_json(spec.BENCHMARK_JSON)["workloads"]
         if spec.load_cell(w["name"]).config.get("kind") != "serve"]   # MapReduce cells


@pytest.mark.parametrize("cell_name", CELLS)
def test_result_line_shape(cell_name):
    cell = small(cell_name)
    out = run_small(cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 2
    assert set(out["metrics"]) == {m.name for m in cell.end_to_end}
    for metric in out["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(harness.LIMITS)
    for name, check in out["checks"].items():
        assert check["limit"] == harness.LIMITS[name] and 0 <= check["value"] <= check["limit"]
    assert out["checks"]["values_gap"]["limit"] > 0
    json.dumps(out)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_fresh_key_draw_is_checked_under_both_plans(cell_name):
    calls = []

    def recording(config, traffic, device):
        job = harness.make_job(config, traffic, device)

        def run(inputs):
            res = job.run(inputs)
            calls.append((inputs[0], res.plan_reason))
            return res
        return Wrapped(job, run)

    cell = small(cell_name)
    out = run_small(cell, job_factory=recording)
    assert out["correct"] is True
    (keys_a, reason_a), (keys_b, reason_b) = calls[-2:]
    assert keys_a is keys_b and reason_b == "cold" and reason_a != "cold"
    pool = {tuple(torch.sort(k.flatten()).values.tolist()) for k, _ in calls[:-2]}
    assert len(pool) == cell.traffic["pool"]
    assert tuple(torch.sort(keys_a.flatten()).values.tolist()) not in pool


class Wrapped:
    """A job whose ``run`` is replaced; everything else is the real job's."""

    def __init__(self, job, run):
        self._job, self.run = job, run

    def __getattr__(self, name):
        return getattr(self._job, name)


def stale(config, traffic, device):
    """A job that returns its first result for every batch: state unchanged."""
    job = harness.make_job(config, traffic, device)
    first = []

    def run(inputs):
        res = job.run(inputs)
        first.append(res)
        return first[0]
    return Wrapped(job, run)


def half_batch(config, traffic, device):
    """A job that leaves out half of the slots' pairs and scales the rest up."""
    job = harness.make_job(config, traffic, device)

    def run(inputs):
        keys, values, valid = inputs
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        res = job.run((keys, values, valid))
        for name in ("values", "counts", "key_distribution"):
            setattr(res, name, getattr(res, name) * 2)
        return res
    return Wrapped(job, run)


def altered_answer(monkeypatch):
    """Kernel 2's output altered where it is produced: one sum off by one."""
    from repro_torch.kernels.fused_shuffle_reduce import ops
    real = ops.fused_shuffle_reduce

    def kernel(*args, **kwargs):
        out, counts = real(*args, **kwargs)
        out = out.clone()
        out[0, 0, 0] += 1.0
        return out, counts
    monkeypatch.setattr(ops, "fused_shuffle_reduce", kernel)


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", ["fp8 wire", "int8 wire", "state unchanged",
                                   "half the batch", "answer altered"])
def test_control_and_faults_are_not_correct(cell_name, fault, monkeypatch):
    cell, factory = small(cell_name), harness.make_job
    if fault.endswith(" wire"):
        cell = control.control_cell(cell, fault.split()[0])
    elif fault == "state unchanged":
        factory = stale
    elif fault == "half the batch":
        factory = half_batch
    else:
        altered_answer(monkeypatch)
    out = run_small(cell, job_factory=factory)
    assert out["correct"] is False and out["failed"] > 0
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
    if fault.endswith(" wire"):
        assert out["checks"]["values_gap"]["value"] > 3 * out["checks"]["values_gap"]["limit"]


def test_runner_without_a_card_prints_nothing_and_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = runner.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_runner_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(spec.BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "os4m_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = ("import sys; from os4m_bench import harness; harness.program()")
    done = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and "repro_torch" in done.stderr
    done = subprocess.run([sys.executable, "-m", "os4m_bench.run", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""


def test_trace_reduction():
    events = [("histogram_kernel<bool>", 0.010, 0.002), ("copy", 0.011, 0.004),
              ("reduce_tiles<GatherRows>", 0.050, 0.003), ("segment_starts", 0.054, 0.001),
              ("reduce_tiles<ContiguousRows>", 0.060, 0.001)]
    trace = Trace(events, 0.100)
    assert trace.busy_s() == pytest.approx(0.005 + 0.003 + 0.001 + 0.001)
    assert trace.kernel_s("segment_starts", "reduce_tiles&GatherRows") == pytest.approx(0.004)
    assert trace.top_ops(2) == [["copy", 0.004], ["reduce_tiles<GatherRows>", 0.003]]
    spans = [("phase_a", 0.0, 0.02), ("plan", 0.02, 0.05), ("phase_b", 0.05, 0.07)]
    gaps = trace.idle_gaps(spans, count=3)
    assert [g[0] for g in gaps] == ["harness", "plan", "phase_a"]
    assert [g[1] for g in gaps] == pytest.approx([0.039, 0.035, 0.010])


@pytest.mark.gpu
def test_a_traced_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and the device trace run only there")
    cell = small(CELLS[0])
    out = harness.run_cell(cell, SEED, 1.0, True, torch.device("cuda", 0), time.perf_counter())
    assert out["correct"] is True
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name in ("stats_roofline.recurring", "reduce_roofline.recurring"):
        assert 0 < out["metrics"][name]["value"] <= 105
