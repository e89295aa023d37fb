"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_pulls_in_no_jax_repro_or_triton():
    code = (
        "import sys, repro_torch, repro_torch.core.mapreduce, "
        "repro_torch.kernels.histogram.ops, "
        "repro_torch.kernels.fused_shuffle_reduce.ops\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT)))
def test_no_module_imports_jax_or_repro(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        MapReduceJob(lambda x: x, MapReduceConfig(num_slots=2, num_clusters=4))


@pytest.mark.parametrize("field,value,item", [
    ("scheduler", "auto", 4),
    ("reuse", object(), 4),
    ("stats", "sketch", 5),
    ("stream_prefix", 0.5, 5),
    ("estimate_speeds", True, 6),
    ("measure_timings", True, 6),
    ("checkpoint_waves", True, 7),
    ("shuffle_replication", 2, 8),
    ("quantize_shuffle", "int8", 8),
])
def test_unported_settings_name_their_roadmap_item(field, value, item):
    cfg = MapReduceConfig(num_slots=2, num_clusters=4, **{field: value})
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        MapReduceJob(lambda x: x, cfg, device="cpu")
