"""The port's serving engine and launcher against the reference's.

Plans: the same requests through the reference's ``Engine.plan`` and the
port's, lane by lane, for each scheduler, with lane speeds, a dead lane,
several jobs and sketch admission; the lane queues, balance and finish
ratios must be equal exactly. Serving: ``Engine.run`` on the llama3 smoke
twin with the reference's parameters, token streams equal exactly. The
launcher runs in a subprocess with ``--device cpu``; its elastic-mesh
flags print the reference launcher's mesh events and plan decisions, and
the reference README's elastic command gives outputs equal to a numpy
oracle.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import init_model
from repro_torch.serve.engine import Engine, EngineConfig, Request

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _requests(cls, n, seed=0, jobs=1, vocab=512, plen=(4, 24), budget_cap=60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(*plen))
        budget = int(np.clip(rng.zipf(1.5) * 4, 4, budget_cap))
        out.append(cls(rid=i, prompt=rng.integers(3, vocab, p).astype(np.int32),
                       max_new=budget, job=i % jobs))
    return out


def _engines(ecfg_kwargs, cfg_name="llama3-8b"):
    """The reference's engine and the port's on one config (no weights: the
    planner never reads them)."""
    from repro.configs import get_smoke as ref_smoke
    from repro.serve.engine import Engine as RefEngine, EngineConfig as RefConfig

    cfg = get_smoke(cfg_name)
    ref = RefEngine(ref_smoke(cfg_name), None, RefConfig(**ecfg_kwargs))
    port = Engine(cfg, init_model(cfg, device="cpu"), EngineConfig(**ecfg_kwargs),
                  device="cpu")
    return ref, port


def _queues(by_lane):
    return {lane: [r.rid for r in q] for lane, q in by_lane.items()}


PLAN_CASES = {
    "os4m": dict(lanes=4),
    "lpt": dict(lanes=4, scheduler="lpt"),
    "hash": dict(lanes=4, scheduler="hash"),
    "speeds": dict(lanes=4, lane_speeds=[1.0, 0.5, 2.0, 1.0]),
    "dead-lane": dict(lanes=4, lane_speeds=[1.0, 0.0, 1.0, 1.0]),
    "lpt-speeds": dict(lanes=3, scheduler="lpt", lane_speeds=[3.0, 1.0, 2.0]),
    "sketch": dict(lanes=4, stats="sketch", sketch_width=16, sketch_depth=2),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_equals_reference(case):
    from repro.serve.engine import Request as RefRequest

    ref, port = _engines(PLAN_CASES[case])
    want = ref.plan(_requests(RefRequest, 23, seed=1))
    got = port.plan(_requests(Request, 23, seed=1))
    assert _queues(got) == _queues(want)
    assert port.last_balance_ratio == ref.last_balance_ratio
    assert port.last_finish_ratio == ref.last_finish_ratio
    assert port.sketch_admissions == ref.sketch_admissions
    assert port.mesh_events == ref.mesh_events
    assert np.array_equal(port.dead_lanes, ref.dead_lanes)


@pytest.mark.parametrize("jobs,weights,cap", [(2, None, None), (3, {0: 1.0, 1: 4.0, 2: 0.5}, None),
                                              (3, None, 1), (2, {1: 2.0}, 2)])
def test_multi_job_plan_equals_reference(jobs, weights, cap):
    from repro.serve.engine import Request as RefRequest

    kwargs = dict(lanes=4, job_weights=weights, max_concurrent_jobs=cap,
                  lane_speeds=[1.0, 1.0, 0.0, 2.0] if jobs == 3 else None)
    ref, port = _engines(kwargs)
    want = ref.plan(_requests(RefRequest, 17, seed=jobs, jobs=jobs))
    got = port.plan(_requests(Request, 17, seed=jobs, jobs=jobs))
    assert _queues(got) == _queues(want)
    assert port.last_balance_ratio == ref.last_balance_ratio
    assert port.last_finish_ratio == ref.last_finish_ratio
    assert np.array_equal(port.r_matrix(list(range(jobs))), ref.r_matrix(list(range(jobs))))


def test_metered_replan_equals_reference():
    """Per-job meters fed the same (tokens, seconds), a lane failure, then a
    drift replan of the waiting queues: both engines move the same requests."""
    from repro.serve.engine import Request as RefRequest

    kwargs = dict(lanes=4, adaptive=True, replan_on_drift=True, max_speed_drift=0.1)
    ref, port = _engines(kwargs)
    queues = {}
    for eng, cls in ((ref, RefRequest), (port, Request)):
        reqs = _requests(cls, 19, seed=4, jobs=2)
        queues[id(eng)] = eng.plan(reqs)
        eng.observe_job_lane_times(0, [4, 4, 4, 4], [1.0, 1.0, 3.0, 1.0])
        eng.lane_meter.update(np.array([4.0, 4, 4, 4]), np.array([1.0, 2.0, 1.0, 1.0]))
        eng.set_lane_failure(3)
    assert port.mesh_events == ref.mesh_events
    np.testing.assert_array_equal(port.lane_speeds(job=0), ref.lane_speeds(job=0))
    moved = [eng.maybe_replan_waiting(queues[id(eng)]) for eng in (ref, port)]
    assert moved[0] == moved[1]
    assert _queues(queues[id(port)]) == _queues(queues[id(ref)])
    assert port.replans == ref.replans and port.last_replan_drift == ref.last_replan_drift


@pytest.mark.parametrize("impl,ecfg", [
    ("pallas", dict(lanes=3, max_len=48, eos=-1)),
    ("blocked", dict(lanes=2, max_len=40, lane_speeds=[1.0, 0.5])),
    ("naive", dict(lanes=3, max_len=48, eos=-1, lane_speeds=[1.0, 0.0, 1.0])),
], ids=["pallas", "blocked-speeds", "naive-dead-lane"])
def test_run_token_streams_equal_reference(impl, ecfg):
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.models.model import init_model as ref_init
    from repro.nn import layers as RL
    from repro.serve.engine import Engine as RefEngine, EngineConfig as RefConfig
    from repro.serve.engine import Request as RefRequest

    cfg_ref = dataclasses.replace(ref_smoke("llama3-8b"), attn_impl=impl)
    cfg = dataclasses.replace(get_smoke("llama3-8b"), attn_impl=impl)
    jvals, _ = RL.split(ref_init(jax.random.PRNGKey(0), cfg_ref))
    values = jax.tree.map(lambda a: np.asarray(a, np.float32), jvals)
    kw = dict(plen=(4, 12), budget_cap=16)
    want = RefEngine(cfg_ref, jvals, RefConfig(**ecfg)).run(_requests(RefRequest, 6, **kw))
    eng = Engine(cfg, params_from_reference(values, cfg, "cpu"), EngineConfig(**ecfg),
                 device="cpu")
    got = eng.run(_requests(Request, 6, **kw))
    assert [(r.rid, r.lane, r.output) for r in got] == \
        [(r.rid, r.lane, r.output) for r in want]
    assert len(eng.prefill_seconds) == 6 and len(eng.step_seconds) > 0


def test_merge_lane_splices_one_lane():
    cache = {"a": {"k": torch.zeros(2, 3, 4)}}
    new = {"a": {"k": torch.ones(2, 3, 4)}}
    out = Engine._merge_lane(cache, new, 1)
    assert out is cache
    assert torch.equal(cache["a"]["k"][:, 1], torch.ones(2, 4))
    assert torch.all(cache["a"]["k"][:, [0, 2]] == 0)


def test_engine_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg = get_smoke("llama3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, init_model(cfg, device="cpu"), EngineConfig())


def test_engine_refuses_a_model_on_another_device():
    cfg = get_smoke("llama3-8b")
    with pytest.raises(ValueError, match="engine on"):
        Engine(cfg, init_model(cfg, device="cpu"), EngineConfig(), device="meta")


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _launch(*args, timeout=240, module="repro_torch.launch.serve"):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, timeout=timeout, env={**os.environ, "PYTHONPATH": str(SRC)})


def _elastic_lines(stdout):
    """The mesh events and each batch's plan decision (``REPLAN (slot_dead
    )``, ``reuse  (ok ...``), without the wall times, and the checkpoint
    summary line."""
    keep = []
    for line in stdout.splitlines():
        if line.startswith("  mesh event:") or line.startswith("wave checkpoints:"):
            keep.append(line)
        elif line.startswith("  batch"):
            keep.append(line.split(" drift=")[0])
    return keep


def test_launcher_engine_mode_on_cpu():
    out = _launch("--device", "cpu", "--requests", "6", "--lanes", "2", "--max-len", "40",
                  "--jobs", "2", "--slot-slowdown", "1:2")
    assert out.returncode == 0, out.stderr
    assert "scheduler=os4m: 6 requests" in out.stdout
    assert "attn_impl=pallas, flash kernel launches 0" in out.stdout   # plain version
    assert "job 1: 3 requests" in out.stdout


def test_launcher_steady_state_on_cpu():
    out = _launch("--device", "cpu", "--steady-state", "3", "--lanes", "4",
                  "--slot-slowdown", "2:2")
    assert out.returncode == 0, out.stderr
    assert "steady state:" in out.stdout and "estimated slot speeds" in out.stdout


@pytest.mark.parametrize("flags", [["--checkpoint-waves"], ["--slot-slowdown", "1:0"],
                                   ["--checkpoint-waves", "--kill-at-wave", "1:1"]])
def test_launcher_elastic_flags_name_item_7(flags):
    """The elastic flags, which named their ROADMAP item before the port had
    the elastic mesh, now run as the reference launcher's do: exit 0 with
    its mesh events, plan decisions and checkpoint cursor."""
    args = ("--steady-state", "2", "--lanes", "4", *flags)
    out = _launch("--device", "cpu", *args)
    assert out.returncode == 0, out.stderr
    ref = _launch(*args, module="repro.launch.serve")
    assert ref.returncode == 0, ref.stderr
    assert _elastic_lines(out.stdout) == _elastic_lines(ref.stdout)
    assert ("wave checkpoints:" in out.stdout) == ("--checkpoint-waves" in flags)
    if "--kill-at-wave" in flags:
        assert "mesh event: {'event': 'slot_dead', 'slot': 1" in out.stdout
    if "1:0" in flags:      # dead before the observer hook is installed
        assert "estimated slot speeds (synthetic timing model): 1.00 0.00" in out.stdout


def test_launcher_readme_elastic_command_is_exact(monkeypatch, capsys):
    """``--steady-state 8 --slot-slowdown 2:0 --checkpoint-waves --kill-at-wave
    1:1 --device cpu`` (in-process): every batch's values and counts equal a
    numpy oracle bit for bit, slots 1 and 2 end dead, and the mesh events
    and plan decisions are the reference launcher's."""
    from repro_torch.launch import serve

    flags = ["--steady-state", "8", "--slot-slowdown", "2:0", "--checkpoint-waves",
             "--kill-at-wave", "1:1"]
    seen, jobs = [], []
    real = serve.steady_state_loop

    def spy(job, batches, on_batch=None):
        jobs.append(job)

        def tee():
            for batch in batches:
                seen.append([batch])
                yield batch

        def hook(i, res, wall):
            seen[i].append(res)
            on_batch(i, res, wall)

        return real(job, tee(), hook)

    monkeypatch.setattr(serve, "steady_state_loop", spy)
    monkeypatch.setattr(sys, "argv", ["serve", *flags, "--device", "cpu"])
    serve.main()
    stdout = capsys.readouterr().out
    assert len(seen) == 8
    n = jobs[0].cfg.num_clusters
    for (keys, vals, valid), res in seen:
        kh = keys.numpy().astype(np.int64)
        cid = np.abs(kh)[valid.numpy()] % n
        v = vals.numpy()[valid.numpy()].astype(np.float64)
        want = np.stack([np.bincount(cid, weights=v[:, c], minlength=n)
                         for c in range(v.shape[1])], axis=1)
        np.testing.assert_array_equal(res.values, want)
        np.testing.assert_array_equal(res.counts, np.bincount(cid, minlength=n))
        assert res.overflow == 0
    assert jobs[0].dead_slots.tolist() == [False, True, True, False]
    ref = _launch(*flags, module="repro.launch.serve")
    assert ref.returncode == 0, ref.stderr
    assert _elastic_lines(stdout) == _elastic_lines(ref.stdout)


@pytest.mark.gpu
def test_engine_on_gpu_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_smoke("llama3-8b"), attn_impl="pallas")
    streams = []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, init_model(cfg, seed=0, device="cpu").to(dev),
                     EngineConfig(lanes=3, max_len=48, eos=-1), device=dev)
        streams.append([(r.rid, r.output) for r in eng.run(_requests(Request, 6))])
    assert streams[0] == streams[1]
