"""One run of a serving cell: set-up, the measured window, the comparison
with the plain reference, and the result.

A configuration with ``"kind": "serve"`` names the port's model
(``model``, a ``repro_torch.configs`` name) and states its numbers under
the published checkpoint's keys; :func:`port_config` carries them into
the port's ``ModelConfig``. Set-up builds the port's ``DecoderModel`` over
``port.ep_slots`` stacked expert slots, draws its weights on the device
from ``--seed`` straight into it (``dsv2_weights.fill_program``), builds
``repro_torch.serve.engine.Engine``, draws the traffic's pool
(``serve_traffic``) and serves a warm-up batch: the lanes' count of the
pool's longest prompts, a few tokens each.

The window hands ``Engine.run`` one batch at a time in a closed loop,
cycling the pool: it starts no batch once ``seconds`` have passed and
closes when the last batch has returned. Each request's tokens are
stamped on the host clock as the engine adds them to its output
(:func:`timed_request_class`), the engine's own prefill and decode-step
seconds are kept, and the MoE's dropped tokens (``forward``'s
``stats["overflow"]``) are summed on the device. The peak memory is read
when the window closes.

Then the program is freed and a sample of the window's requests, drawn
from the seed with the longest among them, is held against the plain
reference (``reference_dsv2``): its full float32 forward pass over each
prompt and the tokens served, with weights drawn again from the seed.
At each position where a token was served, its gap is the reference's
best logit less the logit of the token served: 0 where the engine served
the reference's greedy token, small where rounding swapped two near
ties. The engine serves greedy tokens only, so every token is judged.
``token_gap_mean`` is the mean gap over the sample's served tokens. The
widest gap is set by a few positions where bfloat16 rounding moved a
token across a router tie and swapped one of its experts: the sound runs'
widest and the fp8 control's overlap, where the mean separates them on
every seed (PERF.md, "Correctness").
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from os4m_bench import dsv2_weights, reference_dsv2, serve_traffic
from os4m_bench.harness import program as _program_path
from os4m_bench.spec import Cell
from os4m_bench.trace import DeviceTracer, Trace

# The limit of each compared number. ``token_gap_mean`` lies between the
# sound runs' readings (at most 9.7e-4 over 14 seeds) and those of the
# reference with its weights in fp8 (at least 5.7e-3; PERF.md,
# "Correctness"); a dropped token and a request served short, not at all
# or with its tokens unstamped are faults, limit 0.
LIMITS = {"token_gap_mean": 2.5e-3, "drops": 0.0, "served_faults": 0.0}


@dataclasses.dataclass
class Served:
    """One request of the window; times on the host clock from the window's start."""

    batch: int
    prompt: np.ndarray
    max_new: int
    output: List[int]
    admit_s: float                 # the engine took it off its lane's queue
    token_s: List[float]           # each served token reached the host


@dataclasses.dataclass
class Run:
    """What the serving readers (``metrics/*.py``) read."""

    config: dict
    traffic: dict
    requests: List[Served]
    batches: List[Tuple[float, float]]     # each batch's start and end
    prefill_seconds: List[float]           # Engine.prefill_seconds of the window
    step_seconds: List[float]              # Engine.step_seconds of the window
    window_s: float
    setup_s: float
    trace: Optional[Trace] = None


def program():
    """The port's serving entry points (``src/`` of the checkout on the path)."""
    _program_path()
    from repro_torch.configs import get_config
    from repro_torch.models.config import MLAArgs
    from repro_torch.models.model import DecoderModel
    from repro_torch.serve import engine
    return get_config, MLAArgs, DecoderModel, engine


def port_config(config: dict):
    """The port's ``ModelConfig`` of ``config``: the port's ``model`` with
    every number the configuration states, and its ``port`` settings."""
    get_config, MLAArgs, _, _ = program()
    base, port = get_config(config["model"]), config["port"]
    if config["hidden_act"] != base.act or config["num_key_value_heads"] != config[
            "num_attention_heads"] or config["moe_layer_freq"] != 1:
        raise ValueError(f"{config['name']}: the port's {base.name} cannot run this configuration")
    mla = MLAArgs(kv_lora=config["kv_lora_rank"], q_lora=config["q_lora_rank"],
                  qk_nope=config["qk_nope_head_dim"], qk_rope=config["qk_rope_head_dim"],
                  v_dim=config["v_head_dim"])
    moe = dataclasses.replace(
        base.moe, num_experts=config["n_routed_experts"], top_k=config["num_experts_per_tok"],
        d_model=config["hidden_size"], d_ff=config["moe_intermediate_size"],
        shared_experts=config["n_shared_experts"], capacity_factor=float(port["capacity_factor"]))
    return dataclasses.replace(
        base, n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"], n_kv=config["num_key_value_heads"],
        d_ff=config["moe_intermediate_size"], vocab=config["vocab_size"],
        first_k_dense=config["first_k_dense_replace"], first_dense_ff=config["intermediate_size"],
        rope_theta=float(config["rope_theta"]), mla=mla, moe=moe, attn_impl=port["attn_impl"],
        param_dtype=port["param_dtype"], compute_dtype=port["compute_dtype"])


class _StampedList(list):
    """A request's output list that stamps the host clock for each token as
    it enters: by ``append``, ``extend``, ``+=``, ``insert`` or assignment.
    A token taken out leaves a stamp without a token, which the run counts
    as a fault (:func:`served_faults`)."""

    def __init__(self, items=()):
        super().__init__(items)
        self.stamps = [time.perf_counter() for _ in self]

    def append(self, item) -> None:
        super().append(item)
        self.stamps.append(time.perf_counter())

    def extend(self, items) -> None:
        items = list(items)
        super().extend(items)
        self.stamps.extend([time.perf_counter()] * len(items))

    def __iadd__(self, items):
        self.extend(items)
        return self

    def insert(self, index, item) -> None:
        super().insert(index, item)
        self.stamps.insert(index, time.perf_counter())

    def __setitem__(self, key, value) -> None:
        if isinstance(key, slice):
            value = list(value)
            super().__setitem__(key, value)
            self.stamps[key] = [time.perf_counter()] * len(value)
        else:
            super().__setitem__(key, value)
            self.stamps[key] = time.perf_counter()


def timed_request_class(request_cls):
    """``request_cls`` (the engine's ``Request``) whose ``output``, which the
    engine sets to ``[]`` when it admits the request and adds each token
    to, stamps the host clock: ``admitted`` and ``output.stamps``."""

    class TimedRequest(request_cls):
        @property
        def output(self):
            return self._output

        @output.setter
        def output(self, value):
            if value is not None:
                self.admitted = time.perf_counter()
                value = _StampedList(value)
            self._output = value

    return TimedRequest


@contextlib.contextmanager
def dropped_tokens(engine_module, device):
    """Sum the MoE's ``stats["overflow"]`` of every forward the engine
    makes inside the block, on the device; yields the running total."""
    total = torch.zeros((), dtype=torch.int64, device=device)
    inner = engine_module.forward

    def forward(*args, **kwargs):
        out = inner(*args, **kwargs)
        if out.stats and "overflow" in out.stats:
            total.add_(out.stats["overflow"])
        return out

    engine_module.forward = forward
    try:
        yield total
    finally:
        engine_module.forward = inner


def build(config: dict, seed: int, device):
    """``(engine, EngineConfig)`` of ``config`` with its weights from ``seed``."""
    _, _, DecoderModel, engine_module = program()
    cfg = port_config(config)
    model = DecoderModel(cfg, device=device, ep_slots=int(config["port"]["ep_slots"]))
    dsv2_weights.fill_program(model, config, seed)
    e = config["engine"]
    ecfg = engine_module.EngineConfig(lanes=int(e["lanes"]), max_len=int(e["max_len"]),
                                      scheduler=e["scheduler"], eos=-1)
    return engine_module.Engine(cfg, model, ecfg, device=device), ecfg


def serve(engine, request_cls, prompts, rid0: int) -> list:
    """Serve ``prompts`` (``serve_traffic.Prompt``) as one ``Engine.run``;
    the requests handed over, served or not."""
    reqs = [request_cls(rid=rid0 + j, prompt=p.tokens, max_new=p.max_new)
            for j, p in enumerate(prompts)]
    engine.run(reqs)
    return reqs


def sample(requests: List[Served], seed: int, count: int) -> List[Served]:
    """``count`` served requests drawn from ``seed``: the one with the
    most positions (prompt and served tokens) and others at random."""
    served = [r for r in requests if r.output]
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: served[i].prompt.shape[0] + len(served[i].output))
    rng = np.random.default_rng((int(seed) % 2 ** 64, 0x5E7))
    rest = [i for i in range(len(served)) if i != longest]
    picked = rng.choice(rest, size=min(count - 1, len(rest)), replace=False).tolist()
    return [served[i] for i in [longest] + sorted(picked)]


def reference_logits(config: dict, seed: int, device, requests: List[Served],
                     fp8: bool = False) -> List[torch.Tensor]:
    """The reference's float32 logits at the positions where each request's
    served tokens were chosen: ``[(served, vocab)]``."""
    reference_dsv2.exact_float32()
    seqs = [torch.as_tensor(np.concatenate([r.prompt, np.asarray(r.output[:-1], np.int32)]))
            for r in requests]
    starts = [r.prompt.shape[0] - 1 for r in requests]
    weights = lambda specs: dsv2_weights.reference_tensors(specs, seed, device, fp8)  # noqa: E731
    return reference_dsv2.logits(config, weights, seqs, starts, device)


def position_gaps(logits: List[torch.Tensor], tokens: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each request's gap at each of its positions: the best logit less
    that of its token (``tokens[i] (served,)``)."""
    return [lg.max(dim=1).values - lg.gather(1, t.to(lg.device).long()[:, None])[:, 0]
            for lg, t in zip(logits, tokens)]


def gap_readings(gaps: List[torch.Tensor]) -> dict:
    """Over every position of every request: the mean, 99th-percentile and
    widest gap, and the share of positions whose token is not the best."""
    every = torch.cat(gaps)
    return {"mean": float(every.mean()), "p99": float(torch.quantile(every, 0.99)),
            "widest": float(every.max()), "mismatch": float((every > 0).float().mean())}


def host_spans(run: Run) -> list:
    """``(label, start_s, end_s)``: each admission's prefill (to its first
    token), the plan before a batch's first admission, and the batch's
    decode loop, in that order of precedence."""
    spans = [("prefill", r.admit_s, r.token_s[0]) for r in run.requests if r.token_s]
    for start, end in run.batches:
        admits = [r.admit_s for r in run.requests if start <= r.admit_s <= end]
        spans.append(("plan and cache", start, min(admits, default=end)))
        spans.append(("decode loop", start, end))
    return spans


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            setup_start: float) -> Tuple[Run, int, int]:
    """Set-up and the window of one run of the serving ``cell``:
    ``(run, memory_peak_bytes, dropped tokens)``, the engine freed.

    ``setup_start`` is the host clock at the process's start."""
    on_cuda = torch.device(device).type == "cuda"
    config, mix = cell.config, cell.traffic
    e = config["engine"]
    if int(e["max_len"]) < mix["prompt_len"]["max"] + mix["output_len"]["max"]:
        raise ValueError(f"{cell.name}: max_len {e['max_len']} holds no longest request")
    if on_cuda:
        # Segments that grow in place: a prefill's buffers differ in size with
        # every prompt length, and in fixed segments they leave gaps that
        # only a process near the card's memory would run into.
        with warnings.catch_warnings():         # renamed, not removed, in newer torch
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    _, _, _, engine_module = program()
    request_cls = timed_request_class(engine_module.Request)
    pool = serve_traffic.draw_pool(config, mix, seed)
    count = sum(len(b) for b in pool)
    with dropped_tokens(engine_module, device) as drops:
        engine, ecfg = build(config, seed, device)
        serve(engine, request_cls,
              serve_traffic.warmup(pool, ecfg.lanes, int(mix["warmup_new"])), 0)
        if on_cuda:
            torch.cuda.synchronize(device)

        requests, batches, prefill_s, step_s = [], [], [], []
        tracer = DeviceTracer(device) if trace else None
        with tracer or contextlib.nullcontext():
            t_start = tracer.start if tracer else time.perf_counter()
            setup_s = t_start - setup_start
            i = 0
            while time.perf_counter() - t_start < seconds:
                b = i % len(pool)
                t0 = time.perf_counter()
                reqs = serve(engine, request_cls, pool[b], count * (i + 1))
                t1 = time.perf_counter()
                batches.append((t0 - t_start, t1 - t_start))
                prefill_s += engine.prefill_seconds
                step_s += engine.step_seconds
                for r, p in zip(reqs, pool[b]):
                    out = r.output if r.output is not None else []
                    stamps = getattr(out, "stamps", [])
                    requests.append(Served(b, p.tokens, p.max_new, list(out),
                                           getattr(r, "admitted", t1) - t_start,
                                           [s - t_start for s in stamps]))
                i += 1
            window_s = time.perf_counter() - t_start
        if tracer:
            window_s = tracer.end - tracer.start
        memory_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
        dropped = int(drops)
    del engine
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    run = Run(config, mix, requests, batches, prefill_s, step_s, window_s, setup_s,
              tracer.trace if tracer else None)
    return run, int(memory_peak), dropped


def served_faults(requests: List[Served]) -> int:
    """Requests served short or not at all, or whose tokens and host
    stamps do not pair up one to one."""
    return sum(len(r.output) != r.max_new or len(r.token_s) != len(r.output)
               for r in requests)


def checks_of(requests: List[Served], dropped: int, gaps: List[torch.Tensor]) -> dict:
    """Each compared number of a run whose sample read ``gaps``
    (:func:`position_gaps`)."""
    return {"token_gap_mean": gap_readings(gaps)["mean"] if gaps else float("inf"),
            "drops": float(dropped), "served_faults": float(served_faults(requests))}


def correct(checks: dict) -> bool:
    """Every compared number within its limit."""
    return all(checks[k] <= LIMITS[k] for k in LIMITS)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             setup_start: float) -> dict:
    """One run of the serving ``cell``; returns the result line's object.

    ``setup_start`` is the host clock at the process's start."""
    on_cuda = torch.device(device).type == "cuda"
    run, memory_peak, dropped = measure(cell, seed, seconds, trace, device, setup_start)
    checked = sample(run.requests, seed, int(cell.traffic["check_requests"]))
    tokens = [torch.as_tensor(np.asarray(r.output, np.int64)) for r in checked]
    full = reference_logits(cell.config, seed, device, checked) if checked else []
    checks = checks_of(run.requests, dropped, position_gaps(full, tokens))
    # A request fails where it is served short, not at all, or unstamped.
    # The gap is judged over the sample, not a request at a time: one router
    # tie swapped in a 32-token answer lifts that answer's mean past the limit.
    failed = served_faults(run.requests)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    out = {"correct": bool(run.requests) and failed == 0 and correct(checks),
           "attempted": len(run.requests), "failed": failed, "metrics": metrics,
           "device": device_info}
    if run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps(host_spans(run))}
    out["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}
    return out
