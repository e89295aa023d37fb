"""BENCHMARK.json's shape, every cell's files found by name, and the imports."""

import ast
import json
import re

import pytest

from os4m_bench import harness, spec

BENCH = json.loads(spec.BENCHMARK_JSON.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", (cell,))


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["os4m_bench"]
    assert all(not w.startswith("/") and ".." not in w and ONE_LINE.match(w)
               for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(ONE_LINE.match(x["why"]) for x in BENCH["configs"] + BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_metric_entries():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert ONE_LINE.match(m["layer"]) and m["moves"] in E2E
        for cell in m["workloads"]:
            assert cell in CELLS and reports(E2E[m["moves"]], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    if c.config.get("kind") == "serve":
        assert c.traffic["kind"] == "serve"
        assert {"pool", "shape_seed", "requests_per_batch", "prompt_len", "output_len",
                "token_zipf", "warmup_new", "check_requests"} <= set(c.traffic)
    else:
        assert c.config["backend"] == "stacked"
        assert {"pool", "shape_seed", "warmup_jobs", "reuse"} <= set(c.traffic)
    e2e = [m.name for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert all(callable(m.read) for m in c.end_to_end + c.per_layer)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("os4m_bench/configs/")
    config = spec.load_json(spec.ROOT / entry["file"])
    assert config["name"] == entry["name"] and ONE_LINE.match(entry["source"])
    assert sorted(entry["reduced"]) == sorted(config["reduced"])
    assert all(key in config for key in entry["reduced"])
    assert config["source"] == entry["source"]
    assert not set(entry["reduced"]) & {"values_per_pair", "num_keys", "zipf_s", "slots",
                                        "clusters"}
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def imports_of(path) -> set:
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module)
    return found


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert harness.forbidden_modules(imports_of(path)) == [], path
    for name in ("reference.py", "traffic.py", "roofline.py", "reference_dsv2.py",
                 "serve_traffic.py", "dsv2_weights.py", "serve_work.py"):
        tops = {m.split(".")[0] for m in imports_of(spec.BENCH_DIR / name)}
        assert not tops & {"repro_torch", "repro"}, name


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["repro_torch.core.mapreduce", "reproducible", "jax.numpy", "repro", "flax",
             "jaxlib.xla_client", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == ["flax", "jax.numpy", "jaxlib.xla_client",
                                                "repro"]
