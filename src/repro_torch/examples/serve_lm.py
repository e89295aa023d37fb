"""Continuous-batching serving with OS4M lane scheduling.

Serves a batch of synthetic requests (zipf-skewed decode budgets — the
operation-load skew of paper Fig 1a) through the engine under the hash
baseline and the OS4M schedule, and reports lane balance + step counts.

Run:  python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.synthetic import zipf
from repro_torch.device import default_device
from repro_torch.examples import _common
from repro_torch.models.model import init_model
from repro_torch.serve.engine import Engine, EngineConfig, Request

NUM_REQUESTS = 24
ENGINE = dict(lanes=4, max_len=96, eos=-1)


def make_requests(vocab: int, request_cls=Request):
    """The 24 requests: prompts of 4-15 tokens, zipf decode budgets 3..48.

    ``request_cls`` builds each one (the reference engine's ``Request``
    class takes the same fields).
    """
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(NUM_REQUESTS):
        plen = int(rng.integers(4, 16))
        budget = int(np.clip(zipf(rng, 1.5) * 3, 3, 48))
        reqs.append(request_cls(
            rid=i, prompt=rng.integers(3, vocab, plen).astype(np.int32),
            max_new=budget))
    return reqs


def serve(cfg, model, reqs, sched: str, device):
    """Fresh copies of ``reqs`` through an engine under ``sched``.

    Returns ``(done, seconds, engine)``.
    """
    eng = Engine(cfg, model, EngineConfig(scheduler=sched, **ENGINE), device=device)
    fresh = [Request(r.rid, r.prompt, r.max_new) for r in reqs]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    done = eng.run(fresh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return done, time.perf_counter() - t0, eng


def main(argv=None) -> dict:
    args = _common.parser(__doc__).parse_args(argv)
    device = default_device(args.device, "examples.serve_lm")
    launches0 = _common.launch_counts()
    cfg = get_smoke("llama3-8b")
    model = init_model(cfg, seed=0, device=device)
    reqs = make_requests(cfg.vocab)
    total_budget = sum(r.max_new for r in reqs)
    print(f"{len(reqs)} requests, decode budgets 3..48 (total {total_budget})")
    report = {"requests": len(reqs), "total_budget": total_budget,
              "budgets": [r.max_new for r in reqs], "runs": {}}
    for sched in ("hash", "os4m"):
        done, dt, eng = serve(cfg, model, reqs, sched, device)
        toks = sum(len(r.output) for r in done)
        print(f"  {sched:5s}: {toks} tokens in {dt:5.1f}s  "
              f"lane balance ratio {eng.last_balance_ratio:.3f}")
        report["runs"][sched] = {
            "tokens": toks, "seconds": dt, "tokens_per_s": toks / max(dt, 1e-9),
            "balance_ratio": eng.last_balance_ratio,
            "generated": {r.rid: len(r.output) for r in done}}
    print("(lower balance ratio = lanes finish together; the OS4M plan is the "
          "paper's global schedule, hash is eq. 3-1)")
    return _common.finish(report, args.report, launches0)


if __name__ == "__main__":
    main()
