"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
from repro_torch.kernels.wave_timer import ops as wt_ops

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_pulls_in_no_jax_repro_or_triton():
    code = (
        "import sys, repro_torch, repro_torch.core.mapreduce, "
        "repro_torch.core.schedule_cache, repro_torch.core.simulator, "
        "repro_torch.core.slot_speeds, repro_torch.core.stats_provider, "
        "repro_torch.core.mesh_timing, repro_torch.core.multi_job, "
        "repro_torch.kernels.wave_timer.ops, repro_torch.kernels.wave_timer.ref, "
        "repro_torch.kernels.wave_timer.calibration, "
        "repro_torch.kernels.wave_timer.wave_timer, "
        "repro_torch.kernels.histogram.ops, "
        "repro_torch.kernels.sketch_hist.ops, "
        "repro_torch.kernels.segment_reduce.ops, "
        "repro_torch.kernels.coded_shuffle.ops, "
        "repro_torch.kernels.fused_shuffle_reduce.ops, "
        "repro_torch.kernels.flash_attention.ops, repro_torch.kernels.moe_dispatch.ops, "
        "repro_torch.nn.layers, repro_torch.nn.attention, repro_torch.nn.moe, "
        "repro_torch.core.balancer, repro_torch.models.model, "
        "repro_torch.models.convert, repro_torch.configs, repro_torch.serve.engine, "
        "repro_torch.launch.serve, repro_torch.launch.steps, repro_torch.launch.train, "
        "repro_torch.train.optim, repro_torch.train.compression, "
        "repro_torch.train.checkpoint, repro_torch.train.loop, repro_torch.data.synthetic, "
        "repro_torch.data.packing, repro_torch.analysis, repro_torch.analysis.__main__, "
        "repro_torch.analysis.conventions, repro_torch.analysis.plan_checks, "
        "repro_torch.analysis.targets, repro_torch.analysis.allowlist, "
        "repro_torch.analysis.op_graph, repro_torch.analysis.overlap, "
        "repro_torch.analysis.determinism, repro_torch.analysis.mutations, "
        "repro_torch.launch.roofline, repro_torch.launch.dryrun, "
        "repro_torch.examples.quickstart, "
        "repro_torch.examples.inverted_index, repro_torch.examples.serve_lm, "
        "repro_torch.examples.moe_balance, repro_torch.examples.train_lm\n"
        "import repro_torch.configs as c\n"
        "[c.get_config(a) for a in c.ARCH_IDS]\n"
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


def test_read_ticks_without_a_device_raises_without_cuda():
    """No device, no anchor and no CUDA: the wave timer raises instead of
    falling back to host stamps, which a caller asks for by name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        wt_ops.read_ticks()
    with pytest.raises(RuntimeError, match="CUDA"):
        wt_ops.backend()
    assert wt_ops.read_ticks(device="cpu").dtype == torch.uint32
    assert wt_ops.backend("cpu") == "host"


@pytest.mark.parametrize("field,value,item,backend", [
    ("shuffle_replication", 2, 14, "sharded"),
])
def test_unported_settings_name_their_roadmap_item(field, value, item, backend):
    """The last MapReduce setting that named its ROADMAP item (the coded
    shuffle on the sharded backend, item 14) is ported; the test keeps its
    name from when it checked the refusal. The engine refuses no setting as
    not ported: every variant of this one constructs on ``backend``, and
    what the reference refuses for it (one slot, checkpointed waves) raises
    the reference's ``ValueError``. Its run against the reference is
    ``test_once_unported_settings_run_as_the_reference``."""
    from repro_torch.core import mapreduce as port_mr

    assert not hasattr(port_mr, "_unported")
    where = ({"device": "cpu"} if backend == "stacked"
             else {"backend": "sharded", "devices": ["cpu"] * 3})
    for extra in ({}, {"pipelined": False}, {"reduce_op": "max"},
                  {"quantize_shuffle": "int8"}, {"quantize_shuffle": "fp8"}):
        job = MapReduceJob(lambda x: x, MapReduceConfig(num_slots=3, num_clusters=8,
                                                        **{field: value}, **extra), **where)
        assert getattr(job.cfg, field) == value
    for extra in ({"num_slots": 1}, {"checkpoint_waves": True}):
        cfg = {"num_slots": 3, "num_clusters": 8, field: value, **extra}
        with pytest.raises(ValueError):
            MapReduceJob(lambda x: x, MapReduceConfig(**cfg), **where)


@pytest.mark.parametrize("field,value,item,backend", [
    ("checkpoint_waves", True, 7, "stacked"),
    ("checkpoint_waves", True, 7, "sharded"),
    ("shuffle_replication", 2, 14, "stacked"),
    ("shuffle_replication", 2, 14, "sharded"),
])
def test_once_unported_settings_run_as_the_reference(field, value, item, backend):
    """Settings that named their ROADMAP item before it was ported now
    construct and run, equal to the reference's ``vmap`` job bit for bit."""
    import jax.numpy as jnp
    import numpy as np

    from repro.core import mapreduce as ref_mr

    rng = np.random.default_rng(item)
    batch = ((rng.zipf(1.3, size=(2, 256)) % 97).astype(np.int32),
             rng.integers(0, 5, size=(2, 256, 3)).astype(np.float32),
             rng.random((2, 256)) > 0.05)
    cfg = dict(num_slots=2, num_clusters=4, **{field: value})
    where = ({"device": "cpu"} if backend == "stacked"
             else {"backend": "sharded", "devices": ["cpu"] * 2})
    got = MapReduceJob(lambda x: x, MapReduceConfig(**cfg), **where).run(
        tuple(torch.from_numpy(a) for a in batch))
    want = ref_mr.MapReduceJob(lambda x: x, ref_mr.MapReduceConfig(**cfg),
                               backend="vmap").run(tuple(jnp.asarray(a) for a in batch))
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))


def _reuse_with_negative_drift(sc_module):
    return {"reuse": sc_module.ReusePolicy(max_drift=-1)}


@pytest.mark.parametrize("settings,match", [
    ({"stats": "exact", "stream_prefix": 0.5}, "stream_prefix"),
    ({"stats": "sketch", "stream_prefix": 1.5}, "stream_prefix"),
    (_reuse_with_negative_drift, "max_drift"),
    ({"stats": "bogus"}, "stats provider"),
], ids=["prefix-exact", "prefix-1.5", "negative-drift", "unknown-stats"])
def test_invalid_settings_raise_the_reference_errors(settings, match):
    """Each setting the reference refuses with ValueError, the port refuses too."""
    from repro.core import mapreduce as ref_mr
    from repro.core import schedule_cache as ref_sc

    from repro_torch.core import mapreduce as port_mr
    from repro_torch.core import schedule_cache as port_sc

    for mr, sc_module, kwargs in ((ref_mr, ref_sc, {"backend": "vmap"}),
                                  (port_mr, port_sc, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            extra = settings(sc_module) if callable(settings) else settings
            mr.MapReduceJob(lambda x: x, mr.MapReduceConfig(
                num_slots=2, num_clusters=4, **extra), **kwargs)
