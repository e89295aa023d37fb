"""The port's one-card dry-run (``repro_torch.launch.dryrun``) and its step
specs (``launch/steps.py``) against the reference.

* **Bytes equal the reference's** — for every arch in ``configs`` at full
  width and depth: the weight bytes of the port's model on ``meta`` equal
  the reference's ``jax.eval_shape`` of ``init_model`` leaf for leaf in
  total, and the cache bytes equal its ``init_cache`` under ``eval_shape``
  (4 sequences of 256 positions, bf16; xLSTM's and zamba2's float32 states
  included). Nothing is allocated on either side.
* **FLOPs** — on the dense smoke configs, ``FlopCounterMode``'s count of a
  forward equals the analytic ``2 · N_matmul · tokens`` (every weight but
  the embedding and the norms) plus the attention's ``4 · B · H · T · S · D``
  within ``FLOP_RTOL`` = 1e-3 (``N_matmul`` read off the model's Linear
  weights; the remainder is the rotary and norm arithmetic the counter does
  not count, which is exactly zero).
* **Per unit, times depth** — the dry-run's extrapolated FLOPs and bytes
  at a smoke config's full depth equal a direct measurement there, and its
  peak is within ``PEAK_RTOL`` = 5% of it.
* **The meter** — a storage freed inside the step leaves the live count,
  a view moves nothing, and ``fits_one_h100`` / ``max_layers_fit`` follow
  the peak's line in the depth.
* **The CLI** — ``python -m repro_torch.launch.dryrun --all`` writes a
  record for every (arch × shape), each ok or skipped by the reference's
  rule, within ``ALL_LIMIT_S`` = 900 s on the CPU.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.models import model as PMDL
from repro_torch.models.config import SHAPES, Shape, shape_applicable

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
FLOP_RTOL = 1e-3
PEAK_RTOL = 0.05
ALL_LIMIT_S = 900


def _ref_cfg(arch):
    from repro.configs import get_config as ref_config

    return ref_config(arch)


def _nbytes(tree) -> int:
    import jax

    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weight_bytes_equal_reference(arch):
    import jax

    from repro.models.model import init_model as ref_init
    from repro.nn import layers as RLay

    shapes = jax.eval_shape(lambda k: RLay.split(ref_init(k, _ref_cfg(arch)))[0],
                            jax.random.PRNGKey(0))
    model = ST.param_specs(get_config(arch))
    assert all(p.device.type == "meta" for p in model.parameters())
    port = sum(p.numel() * p.element_size() for p in model.parameters())
    assert port == _nbytes(shapes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_bytes_equal_reference(arch):
    import jax
    import jax.numpy as jnp

    from repro.models.model import init_cache as ref_cache

    want = _nbytes(jax.eval_shape(lambda: ref_cache(_ref_cfg(arch), 4, 256, jnp.bfloat16)))
    cache = ST.cache_specs(get_config(arch), 4, 256)
    leaves = [t for t in torch.utils._pytree.tree_flatten(cache)[0]
              if isinstance(t, torch.Tensor)]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() * t.element_size() for t in leaves) == want


def _matmul_params(model) -> int:
    return sum(m.w.numel() for m in model.modules()
               if type(m).__name__ == "Linear")


@pytest.mark.parametrize("arch", ["llama3-8b", "smollm-360m", "qwen1.5-32b"])
def test_smoke_forward_flops_match_the_analytic_count(arch):
    cfg = get_smoke(arch)
    b, t = 2, 48
    model = ST.param_specs(cfg)
    tokens = torch.empty((b, t), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        PMDL.forward(model, cfg, tokens=tokens)
    hd = cfg.resolved_head_dim()
    attn = 4 * b * cfg.n_heads * t * t * hd * cfg.n_layers     # blocked: every block pair
    want = 2 * _matmul_params(model) * b * t + attn
    assert _matmul_params(model) < cfg.param_count()
    np.testing.assert_allclose(fc.get_total_flops(), want, rtol=FLOP_RTOL)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_extrapolation_equals_direct_measurement(kind):
    cfg = dataclasses.replace(get_smoke("llama3-8b"), n_layers=5)
    shape = Shape("s", kind, 64, 2)
    counts, c0, c1, depths = D.extrapolated(cfg, shape, cfg.n_layers)
    direct = D.measure(cfg, shape)
    assert depths == (2, 3)
    for key in ("flops", "moved", "base"):
        np.testing.assert_allclose(counts[key], direct[key], rtol=1e-9, err_msg=key)
    # The peak is a line in the depth up to where a few allocator granules
    # move between phases: within PEAK_RTOL.
    np.testing.assert_allclose(counts["step_peak"], direct["step_peak"], rtol=PEAK_RTOL)


def test_zamba_kinds_extrapolate_to_a_direct_measurement():
    """zamba2's two kinds (a Mamba2 layer, an application of the shared
    block), measured apart: FLOPs and bytes at the smoke config's depth
    equal a direct measurement; the peak within PEAK_RTOL."""
    cfg = get_smoke("zamba2-2.7b")
    shape = Shape("s", "train", 32, 2)
    counts, _, _, depths = D.extrapolated(cfg, shape, cfg.n_layers)
    direct = D.measure(cfg, shape)
    assert depths == (cfg.attn_every, 2 * cfg.attn_every)
    for key in ("flops", "moved", "base"):
        np.testing.assert_allclose(counts[key], direct[key], rtol=1e-9, err_msg=key)
    np.testing.assert_allclose(counts["step_peak"], direct["step_peak"], rtol=PEAK_RTOL)


def test_moe_and_state_units():
    assert D.unit_layers(get_config("deepseek-v2-236b")) == (1, 1)
    assert D.unit_layers(get_config("zamba2-2.7b")) == (0, get_config("zamba2-2.7b").attn_every)
    assert D.unit_layers(get_config("xlstm-1.3b")) == (0, get_config("xlstm-1.3b").slstm_every)
    cfg = get_smoke("deepseek-v2-236b")
    rec = D.dry_run(cfg, Shape("s", "prefill", 32, 2))
    assert rec["measured_depths"] == [cfg.first_k_dense + 2, cfg.first_k_dense + 3]
    assert rec["fits_one_h100"] and rec["max_layers_fit"] == cfg.n_layers


def test_meter_counts_frees_and_views():
    with D.MetaMeter() as m:
        a = torch.empty(1000, device="meta")          # 4,000 B -> 4,096
        b = a.view(10, 100)                            # a view: nothing
        c = b * 2
        del c
        d = a + 1
    assert m.peak == 2 * 4096 and m.live == 2 * 4096
    assert m.moved == 4000 * 4                         # mul and add, each in + out;
    #                                                    empty moves nothing
    del a, b, d
    assert m.live == 0
    with D.MetaMeter() as m:
        x = torch.empty((64, 32), device="meta")
        w = torch.empty((32, 16), device="meta")
        x @ w
    assert m.flops == 2 * 64 * 32 * 16


def test_fit_follows_the_peak_line():
    cfg = get_config("grok-1-314b")
    rec = D.dry_run(cfg, Shape("s", "decode", 1024, 1))
    fit = rec["max_layers_fit"]
    assert not rec["fits_one_h100"] and 0 < fit < cfg.n_layers
    def at(depth):
        return D.dry_run(dataclasses.replace(cfg, n_layers=depth), Shape("s", "decode", 1024, 1))

    assert at(fit)["fits_one_h100"]
    assert not at(fit + 1)["fits_one_h100"]
    small = at(4)
    assert small["fits_one_h100"] and small["n_layers"] == 4


def test_conventions_are_the_references():
    big, opt, mb = D.conventions(get_config("grok-1-314b"), SHAPES["train_4k"])
    assert big.logit_dtype == "bfloat16" and opt.moment_dtype == "bfloat16" and mb == 8
    _, opt, mb = D.conventions(get_config("llama3-8b"), SHAPES["train_4k"])
    assert opt.moment_dtype == "float32" and mb == 2
    _, opt, mb = D.conventions(get_config("smollm-360m"), SHAPES["train_4k"])
    assert mb == 1
    _, _, mb = D.conventions(get_config("grok-1-314b"), SHAPES["decode_32k"])
    assert mb == 1


def test_roofline_terms():
    terms = RL.roofline_terms(989.4e12, 3.35e12 * 2)
    assert terms.t_compute == pytest.approx(1.0) and terms.t_memory == pytest.approx(2.0)
    assert terms.dominant == "memory" and terms.step_time == pytest.approx(2.0)
    assert terms.collective_bytes == 0 and terms.as_dict()["chips"] == 1


def test_input_and_step_specs_live_on_meta():
    cfg = get_config("qwen2-vl-7b")
    batch = ST.input_specs(cfg, SHAPES["prefill_32k"])
    assert batch["tokens"].shape == (32, 32_768 - cfg.n_patches)
    assert batch["extra_embed"].shape == (32, cfg.n_patches, cfg.d_model)
    step, (model, cache, batch, pos) = ST.build_step_for_shape(cfg, SHAPES["decode_32k"])
    assert batch["tokens"].shape == (128, 1) and pos.shape == (128,)
    logits, _ = step(model, cache, batch, pos)
    assert logits.device.type == "meta" and logits.shape[:2] == (128, 1)


def test_dryrun_all_runs_within_its_limit(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                           "--out", str(out)], capture_output=True, text=True,
                          timeout=ALL_LIMIT_S, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert time.perf_counter() - t0 < ALL_LIMIT_S
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == len(ARCH_IDS) * len(SHAPES)
    for rec in recs:
        ok, _ = shape_applicable(get_config(rec["arch"]), SHAPES[rec["shape"]])
        assert rec["status"] == ("ok" if ok else "skipped"), rec
        if ok:
            assert {"fits_one_h100", "max_layers_fit", "weights_bytes", "cache_bytes",
                    "moments_bytes", "flops", "model_flops", "roofline"} <= set(rec)
    by = {(r["arch"], r["shape"]): r for r in recs}
    assert by[("xlstm_1_3b", "long_500k")]["fits_one_h100"]
    assert not by[("grok1_314b", "train_4k")]["fits_one_h100"]
