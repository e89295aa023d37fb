"""One-card dry-run: every (arch × shape) step on PyTorch's ``meta`` device.

The reference's dry-run (``repro.launch.dryrun``) lowers and compiles each
cell for a 256- or 512-chip TPU mesh and reads XLA's memory and cost
analyses. The port's runs each step itself, on one card's terms, with
nothing allocated: the weights, optimizer moments, cache and inputs are
``meta`` tensors (:mod:`repro_torch.launch.steps`), and the real step
function runs on them — the forward, the backward and AdamW for a train
step, a prefill or a decode step for serving. One meter,
:class:`MetaMeter`, watches it:

* it counts the FLOPs with ``FlopCounterMode``'s own per-op formulas
  (``torch.utils.flop_counter.flop_registry``: matmuls, convolutions,
  attention), and the flash kernel's, whose wrapper has no ``meta`` path,
  from its shape. The mode itself is not used: its module tracking keeps
  tensors alive longer than the step does, which inflated the peak;
* it sums the bytes every op reads and writes (views move nothing) for
  the roofline;
* it follows every storage the step allocates until it is freed, rounded
  up to the caching allocator's 512-byte granule: the step's peak on top
  of what its arguments hold.

**Per layer kind, times depth.** A cell is measured at two depths — one
and two repeating units (xLSTM's ``slstm_every`` layers), or two and three
layers where the unit is one layer (a lone layer's peak can sit elsewhere
in the step), after an MoE config's leading dense layers — and every count
is extrapolated linearly to the depth asked for (the reference's
``default_trip=cfg.n_layers``). zamba2's two kinds, a Mamba2 layer and an
application of the shared block, are measured apart on one- and
two-layer stacks.
xLSTM's eager sLSTM time loop issues ~20 ops a token and layer, so its
cells are measured at 128 and 192 tokens and extrapolated linearly in the
length (every xLSTM op is linear in it, chunk by chunk). The same line
gives the deepest stack that fits the card's 80 GB.

Per cell the record holds the bytes of the weights, gradients, moments
and cache, the step's peak (``peak_memory_bytes``), its FLOPs and bytes
moved, ``model_flops`` (6·N_active·D for training, 2·N_active·D
otherwise), the roofline terms (:mod:`repro_torch.launch.roofline`),
``fits_one_h100`` and ``max_layers_fit``. The reference's numeric
conventions hold: bf16 logits, bf16 moments above 1e11 parameters, and
8 / 2 / 1 microbatches above 1e11 / 5e9 parameters / else.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.models.config import SHAPES, ModelConfig, Shape, shape_applicable
from repro_torch.train.optim import OptConfig

GRANULE = 512                 # the CUDA caching allocator's rounding
XLSTM_LENGTHS = (128, 192)    # lengths an xLSTM cell is measured at (multiples of 64)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _op_tensors(value, out: list) -> list:
    """The tensors among an aten call's arguments or results (tensors,
    sequences and dicts of them), quicker than a pytree walk."""
    if isinstance(value, torch.Tensor):
        out.append(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _op_tensors(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _op_tensors(v, out)
    return out


def _rounded(nbytes: int) -> int:
    return -(-nbytes // GRANULE) * GRANULE


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages in ``tree`` (modules included; each
    allocator-rounded)."""
    leaves = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.nn.Module):
            leaves.extend(leaf.parameters())
            leaves.extend(leaf.buffers())
        elif isinstance(leaf, torch.Tensor):
            leaves.append(leaf)
    seen: Dict[int, int] = {}
    for t in leaves:
        st = t.untyped_storage()
        seen[st._cdata] = _rounded(st.nbytes())
    return sum(seen.values())


_FACTS: Dict = {}


def _op_facts(func) -> tuple:
    """What the meter needs to know of an aten op, once per op: its FLOP
    formula (or None), whether it has a composite decomposition, whether it
    writes an argument, and whether it is an ``empty`` allocation."""
    facts = _FACTS.get(func)
    if facts is None:
        count = flop_registry.get(func.overloadpacket)
        composite = count is None and torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
        writes = any(a.alias_info is not None and a.alias_info.is_write
                     for a in func._schema.arguments)
        empty = func.overloadpacket.__name__.startswith("empty")
        facts = _FACTS[func] = (count, composite, writes, empty)
    return facts


class MetaMeter(TorchDispatchMode):
    """FLOPs of, bytes moved by, and live storage bytes of, a program on ``meta``.

    ``flops``: ``FlopCounterMode``'s count, op by op from its registry.
    ``moved``: the bytes every op reads and writes (its tensor arguments
    and results; a view, or an ``empty`` allocation, moves nothing).
    ``peak``: the most bytes of storages allocated inside the ``with`` that
    were alive at once, each rounded up to :data:`GRANULE`.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.moved = 0
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        count, composite, writes, empty = _op_facts(func)
        if composite:
            # Under inference mode composite ops (``matmul``) arrive whole:
            # run their decomposition with this meter back on, so that its
            # ops come back through here.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ins = _op_tensors(kwargs, _op_tensors(args, []))
        out = func(*args, **kwargs)
        outs = _op_tensors(out, [])
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        in_st = {t.untyped_storage()._cdata for t in ins}
        if outs and not writes and all(t.untyped_storage()._cdata in in_st for t in outs):
            return out                                   # a view or an alias
        if not empty:                                    # an allocation moves nothing
            self.moved += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in in_st or key in self._alive:
                continue
            n = _rounded(st.nbytes())
            self._alive[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


@contextlib.contextmanager
def _flash_on_meta(extra_flops: list):
    """The flash kernel's wrapper has no ``meta`` path: stand in its output's
    shape, and count its FLOPs (4·B·Hq·T·S·D, half of it when causal)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    real = fa_ops.flash_attention

    def shaped(q, k, v, *, causal=True, **_kw):
        if q.device.type != "meta":
            return real(q, k, v, causal=causal, **_kw)
        b, hq, t, d = q.shape
        extra_flops[0] += 4 * b * hq * t * k.shape[2] * d * (0.5 if causal else 1.0)
        return torch.empty_like(q)

    fa_ops.flash_attention = shaped
    try:
        yield
    finally:
        fa_ops.flash_attention = real


def unit_layers(cfg: ModelConfig) -> tuple:
    """``(first, per)``: the layers before the repeating unit (an MoE
    config's dense ones) and the layers a unit holds."""
    if cfg.xlstm is not None:
        return 0, cfg.slstm_every or cfg.n_layers
    if cfg.ssm is not None:
        return 0, cfg.attn_every or cfg.n_layers
    return (cfg.first_k_dense if cfg.moe is not None else 0), 1


def measure(cfg: ModelConfig, shape: Shape, *, opt_cfg: OptConfig = OptConfig(),
            microbatches: int = 1, max_len: Optional[int] = None,
            cache_dtype=torch.bfloat16) -> dict:
    """One step of ``shape`` at ``cfg``'s depth on ``meta``: FLOPs, bytes
    moved, the bytes its arguments hold and the peak it allocates on top."""
    step, example = ST.build_step_for_shape(cfg, shape, opt_cfg=opt_cfg,
                                            microbatches=microbatches, max_len=max_len,
                                            cache_dtype=cache_dtype)
    base = storage_bytes(example)
    flash = [0.0]
    with _flash_on_meta(flash), MetaMeter() as meter:
        result = step(*example)
    del result
    return {"flops": meter.flops + flash[0], "moved": meter.moved,
            "base": base, "step_peak": meter.peak}


def _at(cfg: ModelConfig, depth: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=depth)


def _line(a: dict, b: dict, xa: float, xb: float, x: float) -> dict:
    """Each count of ``a`` (at ``xa``) and ``b`` (at ``xb``) carried on their line to ``x``."""
    return {k: a[k] + (b[k] - a[k]) * (x - xa) / (xb - xa) for k in a}


def extrapolated(cfg: ModelConfig, shape: Shape, n_layers: int, **kw) -> tuple:
    """``(counts at n_layers, counts at depth d0, counts at d1, (d0, d1))``
    from one- and two-unit stacks (for xLSTM at two lengths; for zamba2
    from its two layer kinds)."""
    first, per = unit_layers(cfg)
    # A lone layer's peak can sit elsewhere in the step than a stack's: a
    # one-layer unit is measured at two and three layers.
    units = 2 if per == 1 else 1
    d0, d1 = first + units * per, first + (units + 1) * per
    if cfg.enc_dec:                      # whisper: small; measured whole
        c = measure(cfg, shape, **kw)
        return c, c, c, (cfg.n_layers, cfg.n_layers)

    def at_depth(depth):
        if cfg.xlstm is None or shape.kind == "decode" or shape.seq_len <= XLSTM_LENGTHS[1]:
            return measure(_at(cfg, depth), shape, **kw)
        la, lb = XLSTM_LENGTHS
        a = measure(_at(cfg, depth), dataclasses.replace(shape, seq_len=la), **kw)
        b = measure(_at(cfg, depth), dataclasses.replace(shape, seq_len=lb), **kw)
        return _line(a, b, la, lb, shape.seq_len)

    if cfg.ssm is not None and cfg.attn_every:
        # zamba2: a Mamba2 layer and an application of the shared block are
        # the two kinds, measured apart (one layer + one application, two
        # layers + one, two + two) and counted at any depth, as the same
        # two units' line.
        one = measure(dataclasses.replace(cfg, n_layers=1, attn_every=1), shape, **kw)
        two = measure(dataclasses.replace(cfg, n_layers=2, attn_every=2), shape, **kw)
        both = measure(dataclasses.replace(cfg, n_layers=2, attn_every=1), shape, **kw)

        def counts(depth):
            apps = depth // per
            return {k: one[k] + (depth - 1) * (two[k] - one[k]) + (apps - 1) * (both[k] - two[k])
                    for k in one}

        return counts(n_layers), counts(d0), counts(d1), (d0, d1)
    c0, c1 = at_depth(d0), at_depth(d1)
    return _line(c0, c1, d0, d1, n_layers), c0, c1, (d0, d1)


def dry_run(cfg: ModelConfig, shape: Shape, *, opt_cfg: OptConfig = OptConfig(),
            microbatches: int = 1, max_len: Optional[int] = None,
            cache_dtype=torch.bfloat16) -> dict:
    """The dry-run record of one step of ``shape`` at ``cfg`` (a prefill's
    cache of ``max_len`` positions, default the shape's, in
    ``cache_dtype``): see the module docstring."""
    t0 = time.perf_counter()
    hw = RL.HW()
    depth = cfg.n_layers
    counts, c0, c1, (d0, d1) = extrapolated(cfg, shape, depth, opt_cfg=opt_cfg,
                                            microbatches=microbatches, max_len=max_len,
                                            cache_dtype=cache_dtype)
    model = ST.param_specs(cfg)
    weights = storage_bytes(list(model.parameters()))
    rec = {"n_layers": depth, "measured_depths": [d0, d1], "microbatches": microbatches,
           "weights_bytes": weights, "grads_bytes": 0, "moments_bytes": 0, "cache_bytes": 0}
    if shape.kind == "train":
        rec["grads_bytes"] = weights
        rec["moments_bytes"] = 2 * storage_bytes(
            [torch.empty(p.shape, dtype=torch.bfloat16 if opt_cfg.moment_dtype == "bfloat16"
                         else torch.float32, device="meta") for p in model.parameters()])
    else:
        rec["cache_bytes"] = storage_bytes(ST.cache_specs(
            cfg, shape.global_batch, (max_len or shape.seq_len) if shape.kind == "prefill"
            else shape.seq_len, cache_dtype))
    peak = counts["base"] + counts["step_peak"]
    # The peak is a line in the depth: the deepest stack (whole units) under
    # the card's memory, 0 when not even one unit fits.
    p0, p1 = (c0["base"] + c0["step_peak"]), (c1["base"] + c1["step_peak"])
    first, per = unit_layers(cfg)
    if d1 == d0 or p1 <= p0:
        fit = depth if peak <= hw.hbm_bytes else 0
    else:
        fit = d0 + int((hw.hbm_bytes - p0) // (p1 - p0)) * per
        fit = 0 if fit < first + per else min(depth, fit)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * cfg.active_param_count() * tokens
    terms = RL.roofline_terms(counts["flops"], counts["moved"])
    rec.update(
        activation_peak_bytes=counts["step_peak"], peak_memory_bytes=peak,
        flops=counts["flops"], hbm_bytes=counts["moved"], model_flops=model_flops,
        useful_flops_ratio=model_flops / counts["flops"] if counts["flops"] else 0.0,
        roofline=terms.as_dict(), fits_one_h100=bool(peak <= hw.hbm_bytes),
        max_layers_fit=fit, model_params=cfg.param_count(),
        model_active_params=cfg.active_param_count(),
        dryrun_s=time.perf_counter() - t0)
    return rec


def conventions(cfg: ModelConfig, shape: Shape) -> tuple:
    """The reference's dry-run conventions: ``(cfg, opt_cfg, microbatches)``."""
    cfg = dataclasses.replace(cfg, logit_dtype="bfloat16")
    n_params = cfg.param_count()
    opt_cfg = OptConfig(moment_dtype="bfloat16" if n_params > 1e11 else "float32")
    microbatches = 1
    if shape.kind == "train":
        microbatches = 8 if n_params > 1e11 else (2 if n_params > 5e9 else 1)
        if cfg.parallelism == "fsdp":
            microbatches = 1
    return cfg, opt_cfg, microbatches


def run_cell(arch: str, shape_name: str, out: Optional[Path] = None) -> dict:
    """Dry-run one (arch × shape) cell and append its record to ``out``."""
    from repro_torch.configs import get_config

    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    head = {"arch": arch, "shape": shape_name, "mesh": "1xH100", "kind": shape.kind,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    if not ok:
        rec = {**head, "status": "skipped", "reason": why}
        print(f"[skip] {arch} × {shape_name}: {why}", flush=True)
    else:
        cfg, opt_cfg, mb = conventions(cfg, shape)
        rec = {**head, "status": "ok",
               **dry_run(cfg, shape, opt_cfg=opt_cfg, microbatches=mb)}
        print(f"[ok] {arch} × {shape_name}: peak {rec['peak_memory_bytes'] / 1e9:.2f} GB "
              f"(weights {rec['weights_bytes'] / 1e9:.2f}, cache "
              f"{rec['cache_bytes'] / 1e9:.2f}), {rec['flops']:.3e} FLOP, fits "
              f"{rec['fits_one_h100']} (deepest {rec['max_layers_fit']} of "
              f"{rec['n_layers']} layers), bound {rec['roofline']['step_time_lower_bound_s']:.4g}"
              f" s ({rec['roofline']['dominant']}) in {rec['dryrun_s']:.1f} s", flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.configs import ALIASES, ARCH_IDS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true", help="every arch × shape")
    ap.add_argument("--out", default="experiments/dryrun.jsonl",
                    help="JSON lines are appended here")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(ALIASES.get(args.arch, args.arch), args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    failures = []
    for arch, shape in cells:
        try:
            run_cell(arch, shape, Path(args.out))
        except Exception as e:  # noqa: BLE001 — one failed cell must not hide the others
            traceback.print_exc()
            failures.append((arch, shape, str(e)[:200]))
            with open(Path(args.out), "a") as f:
                f.write(json.dumps({"arch": arch, "shape": shape, "mesh": "1xH100",
                                    "status": "failed", "error": str(e)[:500]}) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nALL CELLS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
