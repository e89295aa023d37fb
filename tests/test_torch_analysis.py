"""The port's plan checker, convention lint and CLI (``repro_torch.analysis``).

* **Real targets are green** — every snapshot the port's planner makes for
  the reference's eight plan targets validates clean, and the lint finds
  nothing in ``src/repro_torch``.
* **Properties** — the cases of the reference's ``TestPlanProperties`` on
  the port's planner: random histograms, dead slots, coded r=2 plans, the
  pairing at every m.
* **Same rule as the reference** — a snapshot of the port's planner,
  corrupted in its JSON form (a repeated rank, a chunk id out of range, an
  empty wave, a dead slot that still carries load, an undersized cap), is
  loaded into both packages: the port's validator names the same rules as
  the reference's.
* **Lint fixtures** — an unstable ``torch.argsort`` in a wire module is
  flagged C2 (``wire-sort-stability``); a clock or RNG in a function given
  to ``torch.compile`` / ``make_graphed_callables`` or in a
  ``torch.cuda.graph`` body is flagged C1 (``capture-rng-time``).
* ``TestReport`` / ``TestCLI`` as the reference's, with its four checkers'
  bits (1, 2, 4, 8) and the self-test bit 16. The recorded-program
  checkers and the mutation self-tests have their own file,
  ``tests/test_torch_analysis_traced.py``.
"""

import copy
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.analysis import conventions, plan_checks
from repro_torch.analysis import targets as tgt
from repro_torch.analysis.__main__ import run as run_analysis
from repro_torch.analysis.report import CHECKER_BITS, SELF_TEST_BIT, Finding, Report
from repro_torch.core import mapreduce as mr
from repro_torch.core.schedule_cache import CachedSchedule

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def plans():
    return tgt.plan_targets()


def test_plans_clean(plans):
    assert [name for name, _ in plans] == [
        "lpt-uniform", "os4m-pipelined", "lpt-straggler", "lpt-dead-slot", "coded-r2",
        "sketch-os4m", "sketch-lpt", "sketch-prefix"]
    findings = plan_checks.check_plans(plans)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_plans_equal_reference_targets(plans):
    """The port's planner makes the reference's snapshots of the same targets."""
    from repro.analysis import targets as rtgt

    for (name, got), (rname, want) in zip(plans, rtgt.plan_targets()):
        assert name == rname
        assert json.loads(json.dumps(got.to_json())) == json.loads(json.dumps(want.to_json())), name


def test_conventions_clean():
    findings = conventions.lint_tree(conventions.default_root())
    assert findings == [], "\n".join(f.render() for f in findings)
    assert conventions.default_root().name == "repro_torch"


# ---------------------------------------------------------------------------
# Plan-validator properties (real planner across random inputs)
# ---------------------------------------------------------------------------


def _snapshot(m, n, seed, speeds=None, chunks=1, replication=1):
    cfg = mr.MapReduceConfig(
        num_slots=m, num_clusters=n, scheduler="lpt", pipeline_chunks=chunks, speeds=speeds,
        shuffle_replication=replication)
    job = mr.MapReduceJob(lambda s: s, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, 64, size=(m, n)).astype(np.float64)
    k = int(np.ceil(hist.sum(axis=1).max()))
    return job._plan(hist, hist.sum(axis=0), k)


class TestPlanProperties:
    @given(st.integers(2, 6), st.integers(6, 20), st.integers(0, 10_000))
    @settings(max_examples=15, deadline=None)
    def test_random_plans_validate_clean(self, m, n, seed):
        snap = _snapshot(m, n, seed, chunks=min(3, n))
        assert plan_checks.validate_snapshot(snap, "prop") == []

    @given(st.integers(3, 6), st.integers(8, 20), st.integers(0, 10_000))
    @settings(max_examples=10, deadline=None)
    def test_dead_slot_plans_validate_clean(self, m, n, seed):
        speeds = [1.0] * m
        speeds[seed % m] = 0.0
        snap = _snapshot(m, n, seed, speeds=tuple(speeds))
        assert plan_checks.validate_snapshot(snap, "prop-dead") == []
        assert not np.any(np.asarray(snap.schedule.assignment) == seed % m)

    @pytest.mark.parametrize("m", [2, 3, 5, 7])
    def test_pairing_valid_when_r_does_not_divide_m(self, m):
        assert plan_checks.validate_pairing(m, 2, f"m={m}") == []

    def test_pairing_rejects_single_slot(self):
        findings = plan_checks.validate_pairing(1, 2, "m=1")
        assert [f.rule for f in findings] == ["invalid-pairing"]

    @given(st.integers(3, 6), st.integers(8, 20), st.integers(0, 10_000))
    @settings(max_examples=10, deadline=None)
    def test_coded_plans_validate_clean(self, m, n, seed):
        snap = _snapshot(m, n, seed, replication=2)
        assert snap.waves.replication == 2
        assert plan_checks.validate_snapshot(snap, "prop-coded") == []


# ---------------------------------------------------------------------------
# Corrupted plans: the same rule as the reference
# ---------------------------------------------------------------------------


def _repeat_rank(d):
    d["waves"]["rank_of_cluster"][1] = d["waves"]["rank_of_cluster"][0]


def _chunk_out_of_range(d):
    d["waves"]["chunk_of_cluster"][0] = d["waves"]["num_chunks"]


def _empty_wave(d):
    d["waves"]["num_chunks"] += 1
    d["chunk_caps"].append(d["chunk_caps"][-1])


def _dead_slot_loaded(d):
    d["slot_speeds"] = [1.0] * d["num_slots"]
    d["slot_speeds"][d["assignment"][0]] = 0.0


def _undersized_cap(d):
    d["chunk_caps"][0] = 1


CORRUPTIONS = {
    "rank-not-permutation": _repeat_rank,
    "chunk-id-out-of-range": _chunk_out_of_range,
    "chunk-id-not-dense": _empty_wave,
    "dead-slot-loaded": _dead_slot_loaded,
    "chunk-cap-undersized": _undersized_cap,
}


@pytest.mark.parametrize("rule", list(CORRUPTIONS))
def test_corrupted_plan_flagged_by_the_reference_rule(rule):
    from repro.analysis import plan_checks as rpc
    from repro.core.schedule_cache import CachedSchedule as RefCached

    blob = json.loads(json.dumps(_snapshot(4, 12, seed=3, chunks=3).to_json()))
    CORRUPTIONS[rule](blob)
    got = plan_checks.validate_snapshot(CachedSchedule.from_json(copy.deepcopy(blob)), "bad")
    want = rpc.validate_snapshot(RefCached.from_json(copy.deepcopy(blob)), "bad")
    assert rule in [f.rule for f in got]
    assert sorted(f.rule for f in got) == sorted(f.rule for f in want)
    assert all(f.checker == "plan" and f.evidence for f in got)


def test_dead_loaded_schedule_and_wave_plan_checks():
    """``validate_schedule`` / ``validate_wave_plan`` on their own, as the
    card's elastic re-plan is checked."""
    snap = _snapshot(4, 12, seed=5, speeds=(1.0, 0.0, 1.0, 1.0), chunks=3)
    assert plan_checks.validate_schedule(snap.schedule, "ok") == []
    assert plan_checks.validate_wave_plan(snap.waves, 12, "ok") == []
    blob = snap.to_json()
    blob["slot_speeds"] = [0.0, 0.0, 1.0, 1.0]
    bad = CachedSchedule.from_json(blob)
    rules = [f.rule for f in plan_checks.validate_schedule(bad.schedule, "bad")]
    assert rules == ["dead-slot-loaded"]


# ---------------------------------------------------------------------------
# Lint fixtures
# ---------------------------------------------------------------------------


def _lint(tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return conventions.lint_paths([path])


def test_unstable_wire_sort_flagged_c2(tmp_path):
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def f(x, y):\n"
        "    a = torch.argsort(x, dim=1)\n"
        "    b = torch.argsort(x, dim=1, stable=True)\n"
        "    c = x.argsort()\n"
        "    d = np.argsort(y)\n"
        "    e = np.argsort(y, kind='stable')\n"
        "    f = torch.sort(x)\n"
        "    g = sorted([3, 1])\n"
        "    return a, b, c, d, e, f, g\n")
    findings = _lint(tmp_path, "core/mapreduce.py", src)
    assert [f.rule for f in findings] == ["wire-sort-stability"] * 4
    assert sorted(int(f.evidence[0].split(":")[1]) for f in findings) == [4, 6, 7, 9]
    # Outside the wire modules the rule does not apply.
    assert _lint(tmp_path, "core/planner.py", src) == []


def test_clock_or_rng_in_a_captured_body_flagged_c1(tmp_path):
    src = (
        "import random\n"
        "import time\n"
        "import numpy as np\n"
        "import torch\n"
        "from time import perf_counter\n"
        "def helper(x):\n"
        "    return x * np.random.rand()\n"
        "def step(x):\n"
        "    return helper(x) + time.time()\n"
        "def other(x):\n"
        "    return x + perf_counter()\n"
        "def host(x):\n"
        "    return x + time.time()\n"
        "@torch.compile\n"
        "def decorated(x):\n"
        "    return x * random.random()\n"
        "compiled = torch.compile(step)\n"
        "graphed = torch.cuda.make_graphed_callables((other,), ((1,),))\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = x * random.random()\n"
        "    return y\n")
    findings = _lint(tmp_path, "serve/step.py", src)
    assert {f.rule for f in findings} == {"capture-rng-time"}
    lines = sorted(int(f.evidence[0].split(":")[1]) for f in findings)
    assert lines == [7, 9, 11, 16, 21]          # helper, step, other, decorated, the graph body


def test_lint_tree_skips_the_analysis_package(tmp_path):
    (tmp_path / "analysis").mkdir()
    (tmp_path / "analysis" / "fixture.py").write_text(
        "import torch, time\n@torch.compile\ndef f(x):\n    return time.time()\n")
    assert conventions.lint_tree(tmp_path) == []


# ---------------------------------------------------------------------------
# Report and CLI contract
# ---------------------------------------------------------------------------


class TestReport:
    def test_exit_code_is_bitmask(self):
        r = Report()
        r.extend("plan", [Finding("plan", "r", "t", "s", ["e"])])
        r.extend("conventions", [Finding("conventions", "r", "t", "s", ["e"])])
        assert r.exit_code() == CHECKER_BITS["plan"] | CHECKER_BITS["conventions"] == 12
        assert not r.ok

    def test_bits_are_the_reference_bits(self):
        from repro.analysis.report import CHECKER_BITS as REF_BITS

        from repro.analysis.report import SELF_TEST_BIT as REF_SELF_TEST

        assert CHECKER_BITS == REF_BITS
        assert SELF_TEST_BIT == REF_SELF_TEST == 16

    @pytest.mark.parametrize("checker", ["typo", "self-test"])
    def test_unknown_checker_rejected(self, checker):
        with pytest.raises(ValueError):
            Finding(checker, "r", "t", "s")

    def test_render_names_failures(self):
        r = Report()
        r.extend("conventions", [])
        r.extend("plan", [Finding("plan", "dead-slot-loaded", "t", "s", ["e"])])
        text = r.render()
        assert "conventions" in text and "ok" in text
        assert "[plan:dead-slot-loaded]" in text


class TestCLI:
    @pytest.mark.parametrize("check", ["plan", "conventions", "all"])
    def test_run_exits_zero(self, check):
        out = io.StringIO()
        assert run_analysis(check=check, out=out) == 0
        text = out.getvalue()
        assert "ok" in text and "FAIL" not in text

    def test_run_rejects_unknown_checker(self):
        with pytest.raises(ValueError):
            run_analysis(check="self-test")

    def test_main_exits_with_bitmask_zero(self):
        from repro_torch.analysis.__main__ import main

        with pytest.raises(SystemExit) as ei:
            main(["--check", "plan"])
        assert ei.value.code == 0

    def test_module_entry_point(self):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                              capture_output=True, text=True, timeout=120,
                              env={**os.environ, "PYTHONPATH": SRC})
        assert proc.returncode == 0, proc.stderr
        assert "plan         ok" in proc.stdout and "conventions  ok" in proc.stdout
