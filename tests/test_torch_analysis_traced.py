"""The port's recorded-program checkers: overlap, determinism, the mutation
self-tests (``repro_torch.analysis``), against the reference's catalog.

* **Real targets are clean** — every recorded phase-B variant (the
  reference's target names and flags) gives no overlap and no determinism
  finding, carries the nodes its rules read (``all_to_all``, ``spill``,
  stamps, opaque kernels, ``pmax``), and the recorded run's outputs equal
  the engine's unrecorded run bit for bit.
* **Mutants are caught** — each of the 17 cases is caught by its intended
  checker and rule with non-empty evidence; the catalog's names, checkers
  and rules are the reference's, read from its source with ``ast`` (the
  reference's analyzer itself cannot be imported under this jax: it calls
  ``jax.core.extend_axis_env_nd``, which jax 0.9 removed). The one rule
  that differs is C1's (``jit-rng-time`` → ``capture-rng-time``).
* **The recorder** — in-place writes make new values that later readers
  depend on; views share their base's producer; a kernel wrapper is one
  opaque node whose inside is not recorded; a stamp has two output slots;
  host syncs (``.item()``, ``.cpu()``, ``.tolist()``, ``int()``) resolve to
  the function that made them.
* **The port's own rule** — a float ``index_add_`` that feeds the outputs
  is ``unordered-float-accumulate``; the same op in a function declared
  exact (``_segment_sum``) is not; D3 holds at both slab-length pairs.
* **C3 lint fixtures** and the CLI's exit bits (1, 2, 16).
"""

import ast
import io
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import allowlist, conventions, determinism, mutations, overlap
from repro_torch.analysis import op_graph as og
from repro_torch.analysis import targets as tgt
from repro_torch.analysis.__main__ import run as run_analysis
from repro_torch.core import mapreduce as mr
from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
from repro_torch.kernels.wave_timer import ops as wt_ops

REF_MUTATIONS = pathlib.Path(__file__).resolve().parents[1] / "src/repro/analysis/mutations.py"
NAMES = ["sequential", "pipelined", "pipelined-kernels", "pipelined-int8", "coded-r2",
         "coded-r2-int8", "timed-sequential", "timed-pipelined", "checkpointed-wave-copy",
         "checkpointed-wave-run", "sharded-pipelined", "phase-a-sketch"]
CASE_NAMES = [c[0] for c in mutations._CASES]


@pytest.fixture(scope="module")
def targets():
    return {t.name: t for t in tgt.phase_b_targets()}


# ---------------------------------------------------------------------------
# Real targets
# ---------------------------------------------------------------------------


def test_target_names_and_flags(targets):
    assert list(targets) == NAMES
    assert {n for n, t in targets.items() if t.timed} == {"timed-sequential", "timed-pipelined"}
    assert {n for n, t in targets.items() if t.coded} == {"coded-r2", "coded-r2-int8"}
    assert not targets["sequential"].pipelined and targets["sharded-pipelined"].pipelined


@pytest.mark.parametrize("name", NAMES)
def test_real_target_is_clean(targets, name):
    t = targets[name]
    assert overlap.check_overlap([t]) == []
    findings = determinism.check_determinism([t])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_slab_invariance_holds_for_the_launch_geometry():
    assert determinism.check_slab_invariance() == []
    from repro_torch.kernels.fused_shuffle_reduce.fused_shuffle_reduce import (
        TILE_ROWS, launch_geometry,
    )
    for n in (96, 160, 3000, 5000):
        assert launch_geometry(n, 3).tile_rows == TILE_ROWS
        assert launch_geometry(n, 3).tiles == -(-n // TILE_ROWS)


@pytest.mark.parametrize("name,prims", [
    ("sequential", {"spill": 1, "all_to_all": 1, "fused_shuffle_reduce": 1}),
    ("pipelined", {"spill": 1, "all_to_all": 4, "fused_shuffle_reduce": 4}),
    ("pipelined-int8", {"pmax": 1, "all_to_all": 4}),
    # The stacked runner transposes the three replica tensors one by one.
    ("coded-r2", {"all_to_all": 3 + 4, "encode_packets": 4, "xor_words": 4}),
    ("timed-pipelined", {"stamp": 5, "all_to_all": 4}),
    ("timed-sequential", {"stamp": 2, "all_to_all": 1}),
    ("checkpointed-wave-copy", {"spill": 1, "all_to_all": 1}),
    ("checkpointed-wave-run", {"host_callback": 2, "fused_shuffle_reduce": 1}),
    ("sharded-pipelined", {"spill": 1, "all_to_all": 4, "fused_shuffle_reduce": 4}),
    ("phase-a-sketch", {"sketch_hist": 1, "all_to_all": 0, "host_callback": 0, "sort": 0}),
])
def test_targets_carry_the_nodes_their_rules_read(targets, name, prims):
    g = targets[name].graph
    assert {p: len(g.by_prim(p)) for p in prims} == prims
    for n in g.nodes:
        if n.prim in ("fused_shuffle_reduce", "encode_packets", "xor_words", "sketch_hist",
                      "stamp"):
            assert n.attrs.get("kernel") is True


def test_wire_sorts_are_stable_and_stamps_declared(targets):
    for name in ("pipelined", "coded-r2", "sharded-pipelined"):
        sorts = targets[name].graph.by_prim("sort")
        assert sorts and all(n.attrs["is_stable"] for n in sorts)
    for n in targets["timed-pipelined"].graph.by_prim("stamp"):
        assert allowlist.is_allowed(n.attrs["callback"])
    for n in targets["checkpointed-wave-run"].graph.by_prim("host_callback"):
        assert n.attrs["callback"] == "repro_torch.core.mapreduce.MapReduceJob._host_merge"


def _unrecorded(name: str):
    """Target ``name``'s outputs from the engine's own driver, no recorder."""
    pipelined, quantize, coded, timed = {
        "sequential": (False, None, False, False), "pipelined": (True, None, False, False),
        "pipelined-int8": (True, "int8", False, False),
        "coded-r2": (True, None, True, False), "coded-r2-int8": (True, "int8", True, False),
        "timed-pipelined": (True, None, False, True)}[name]
    inter, plan = tgt.shard_inputs("cpu")
    static = tgt.static_of(pipelined, quantize)
    if coded:
        return mr._drive_stacked(mr._phase_b_coded(inter, *plan, static, list(range(tgt.M))))
    return mr._drive_stacked(mr._phase_b_body(inter, *plan, static, torch.arange(tgt.M),
                                              wt_ops.stamp_through if timed else None))


@pytest.mark.parametrize("name", ["sequential", "pipelined", "pipelined-int8", "coded-r2",
                                  "coded-r2-int8", "timed-pipelined"])
def test_recorded_run_equals_unrecorded_bit_for_bit(targets, name):
    got = targets[name].result
    want = _unrecorded(name)
    # The tick words of a timed run are host clock readings: the first four
    # outputs (values, counts, overflow, wire) are the program's.
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_recorded_checkpointed_wave_equals_the_fused_walk(targets):
    """Wave 1's copy and reduce, recorded, give chunk 1's reduce of the
    unrecorded pipeline (each cluster lives in one chunk)."""
    inter, plan = tgt.shard_inputs("cpu")
    static = tgt.static_of(True)
    send, _, _ = mr._spill(inter, *plan, static, torch.arange(tgt.M), inter[1], inter[1])
    seg = mr._copy_chunk(send, 1)
    assert torch.equal(targets["checkpointed-wave-copy"].result, seg)
    out, counts = mr._reduce_received(send, seg, plan, tgt.N_CLUSTERS, "sum")
    got = targets["checkpointed-wave-run"].result
    assert torch.equal(got[0], out) and torch.equal(got[1], counts)
    # Chunk 1's clusters only, as the pipelined walk reduces them.
    acc, cnt = _unrecorded("pipelined")[:2]
    in_chunk = (plan[2] == 1)[None, :]
    assert torch.equal(out, torch.where(in_chunk[..., None], acc, 0))
    assert torch.equal(counts, torch.where(in_chunk, cnt, 0))


# ---------------------------------------------------------------------------
# Mutants and the catalog
# ---------------------------------------------------------------------------


def _reference_catalog():
    tree = ast.parse(REF_MUTATIONS.read_text())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == "_CASES":
            return [tuple(e.value for e in case.elts[:3]) for case in node.value.elts]
    raise AssertionError("no _CASES in the reference's mutations module")


def test_catalog_is_the_reference_catalog():
    ref = _reference_catalog()
    port = [c[:3] for c in mutations._CASES]
    assert len(ref) == len(port) == 17
    assert [c[:2] for c in port] == [c[:2] for c in ref]
    differ = [(p, r) for p, r in zip(port, ref) if p[2] != r[2]]
    assert differ == [(("jitted-time-call", "conventions", "capture-rng-time"),
                       ("jitted-time-call", "conventions", "jit-rng-time"))]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_mutant_caught_by_intended_checker(case):
    (_, checker, rule, fn), = [c for c in mutations._CASES if c[0] == case]
    findings = fn()
    hits = [f for f in findings if f.checker == checker and f.rule == rule]
    assert hits, [f.render() for f in findings]
    assert all(len(f.evidence) > 0 for f in hits)


def test_self_test_roll_up():
    lines = []
    results = mutations.run_self_tests(progress=lines.append)
    assert mutations.self_tests_ok(results) and len(results) == 17
    assert all(line.startswith("caught") for line in lines)
    bad = mutations.run_self_tests(cases=[("never", "overlap", "a2a-depends-on-a2a",
                                           lambda device: [])])
    assert not mutations.self_tests_ok(bad) and "MISSED" in bad[0].render()


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def test_in_place_write_is_a_new_value():
    with og.Recorder() as rec:
        a = torch.zeros(4)
        b = torch.ones(2)
        c = a + 1                       # reads the zeros
        a.index_add_(0, torch.tensor([0, 1]), b)
        d = a * 2                       # reads the written value
        rec.set_outputs((c, d))
    g = rec.graph
    (add_,) = g.by_prim("index_add_")
    (mul,) = g.by_prim("mul")
    (plus,) = g.by_prim("add")
    assert add_.id in g.ancestors_of(mul.id)
    assert add_.id not in g.ancestors_of(plus.id)
    assert add_.attrs["float_accumulate"] is True


def test_views_share_their_base_producer():
    with og.Recorder() as rec:
        x = torch.arange(12.0)
        v = x.view(3, 4).transpose(0, 1)[1:]
        y = v.sum()
        rec.set_outputs((y,))
    g = rec.graph
    assert g.prims() == ["arange", "sum"]
    assert g.ancestors_of(g.by_prim("sum")[0].id) == {g.by_prim("arange")[0].id}


def test_kernel_wrapper_is_one_opaque_node():
    vals = torch.randn(2, 16, 3)
    order = torch.argsort(torch.randint(0, 4, (2, 16)), dim=1, stable=True).to(torch.int32)
    seg = torch.sort(torch.randint(0, 4, (2, 16)), dim=1, stable=True).values.to(torch.int32)
    with og.Recorder() as rec:
        out, counts = fused_ops.fused_shuffle_reduce(vals, order, seg, 4)
        total = out.sum() + counts.sum()
        rec.set_outputs((total,))
    g = rec.graph
    assert g.prims() == ["fused_shuffle_reduce", "sum", "sum", "add"]
    kernel = g.by_prim("fused_shuffle_reduce")[0]
    assert g.consumers_of_output(kernel.id, 0) and g.consumers_of_output(kernel.id, 1)
    # Outside a recording the wrapper is the module's own function again.
    assert fused_ops.fused_shuffle_reduce.__module__.endswith("fused_shuffle_reduce.ops")


def test_stamp_has_pass_through_and_tick_slots():
    with og.Recorder() as rec:
        hook = og.stamp_hook(rec)
        x = torch.arange(5)
        y, ticks = hook(x + 1)
        z = y * 2
        rec.set_outputs((z, ticks))
    g = rec.graph
    (stamp,) = g.by_prim("stamp")
    assert g.consumers_of_output(stamp.id, 0) == {g.by_prim("mul")[0].id}
    assert g.outputs[1] == (stamp.id, 1)
    assert stamp.attrs["callback"].endswith("wave_timer.ref.stamp_through_ref")


def _peek(x):
    return int(x.sum()) + len(x.tolist()) + x.cpu().numpy().size


def test_host_syncs_resolve_to_their_function():
    with og.Recorder() as rec:
        _peek(torch.arange(3))
    syncs = rec.graph.by_prim("host_callback")
    assert [n.attrs["op"] for n in syncs] == ["_local_scalar_dense", "tolist", "cpu"]
    assert {n.attrs["callback"] for n in syncs} == {f"{__name__}._peek"}
    findings = determinism._check_callbacks("t", rec.graph, ())
    assert len(findings) == 3 and findings[0].rule == "undeclared-host-callback"
    assert determinism._check_callbacks("t", rec.graph, (f"{__name__}._peek",)) == []


def _accumulate(vals, seg):
    out = torch.zeros(4, vals.shape[-1])
    out.index_add_(0, seg, vals)
    return out


def test_float_accumulate_on_the_outputs_is_flagged_unless_declared():
    vals, seg = torch.randn(10, 2), torch.randint(0, 4, (10,))
    with og.Recorder() as rec:
        out = _accumulate(vals, seg)
        rec.set_outputs((out, out.sum(1)))
    (f,) = determinism._check_accumulates("t", rec.graph)
    assert f.rule == "unordered-float-accumulate" and f.checker == "determinism"
    assert f.evidence and "_accumulate" in f.evidence[-1]
    with og.Recorder() as rec:
        out = mr._segment_sum(torch.ones(1, 10, 1), seg[None], 4)
        rec.set_outputs((out, out))
    assert rec.graph.by_prim("index_add_") and \
        determinism._check_accumulates("t", rec.graph) == []
    with og.Recorder() as rec:                     # integer accumulates are exact
        out = torch.zeros(4, dtype=torch.int64).index_add_(0, seg, torch.ones(10).long())
        rec.set_outputs((out,))
    assert determinism._check_accumulates("t", rec.graph) == []


# ---------------------------------------------------------------------------
# C3 and the CLI
# ---------------------------------------------------------------------------


def _lint(tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return conventions.lint_paths([path])


def test_callback_marker_c3(tmp_path):
    src = (
        "import torch\n"
        "from repro_torch.analysis import allowlist\n"
        "@allowlist.allow_callback\n"
        "def ok(x):\n"
        "    # analysis: allow-callback\n"
        "    return x.cpu()\n"
        "def undeclared(x):\n"
        "    return x.item()  # analysis: allow-callback\n"
        "@allowlist.allow_callback\n"
        "def unmarked(x):\n"
        "    return x.tolist()\n"
        "def other(x):\n"
        "    torch.cuda.synchronize()\n"
        "    return x.to('cpu'), x.to(torch.float32)\n")
    findings = _lint(tmp_path, "kernels/wave_timer/timers.py", src)
    assert {f.rule for f in findings} == {"callback-marker"}
    assert sorted(int(f.evidence[0].split(":")[1]) for f in findings) == [8, 11, 13, 14]
    assert _lint(tmp_path, "serve/engine.py", src) == []


def test_cli_exit_bits(monkeypatch):
    assert run_analysis(check="overlap", out=io.StringIO()) == 0
    chain = mutations._mutant_target("mutant-a2a-chain", mutations._chain_body)
    rogue = mutations._mutant_target("mutant-rogue", mutations._rogue_body)
    monkeypatch.setattr(tgt, "phase_b_targets", lambda device="cpu": [chain, rogue])
    assert run_analysis(check="overlap", out=io.StringIO()) == 1
    assert run_analysis(check="determinism", out=io.StringIO()) == 2
    monkeypatch.setattr(mutations, "_CASES", (("blind", "plan", "dead-slot-loaded",
                                               lambda device: []),))
    out = io.StringIO()
    assert run_analysis(check="plan", self_test=True, out=out) == 16
    assert "MISSED" in out.getvalue() and "0/1 caught" in out.getvalue()


def test_cli_self_test_catches_all_17():
    out = io.StringIO()
    assert run_analysis(check="all", self_test=True, out=out) == 0
    text = out.getvalue()
    assert "self-test 17/17 caught" in text
    for name in ("overlap", "determinism", "plan", "conventions"):
        assert f"{name:12s} ok" in text


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_recordings_equal_cpu_and_are_clean():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = tgt.phase_b_targets("cpu")
    gpu = tgt.phase_b_targets("cuda")
    for a, b in zip(cpu, gpu):
        assert a.name == b.name and a.graph.prims() == b.graph.prims(), a.name
    assert overlap.check_overlap(gpu) == [] and determinism.check_determinism(gpu) == []
    assert mutations.self_tests_ok(mutations.run_self_tests(device="cuda"))


def test_kernel_sums_bit_equal_across_slab_lengths_cpu():
    assert determinism.runtime_slab_invariance("cpu") == []


@pytest.mark.gpu
def test_cuda_kernel_sums_bit_equal_across_slab_lengths():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert determinism.runtime_slab_invariance("cuda") == []
