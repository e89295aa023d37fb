"""OS4M expert placement on a live MoE model (the technique end-to-end).

Trains a small deepseek-class MoE on skewed synthetic data; the router
develops hot experts, the in-step communication mechanism collects the
per-expert key distribution, and the balancer periodically re-solves
P||C_max, physically re-placing expert weights. The balancer is
**drift-gated** (``balancer_max_drift``): on steady routing it keeps the
live placement instead of re-solving every interval. Prints the balance
ratio of the baseline (contiguous/eq. 3-1 class) vs the OS4M placement,
then runs a steady-state serving loop through ONE persistent
``MapReduceJob`` whose schedule is reused across batches.

Run:  python -m repro_torch.examples.moe_balance [--device cpu]
      [--sections trainer,placement,reuse]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.balancer import schedule_balanced_cardinality
from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
from repro_torch.core.schedule_cache import ReusePolicy
from repro_torch.data.synthetic import zipf
from repro_torch.device import default_device
from repro_torch.examples import _common

SECTIONS = ("trainer", "placement", "reuse")
SLOTS, TOKENS, BATCHES = 4, 2048, 8


def trainer(device, steps: int = 30, model=None, ckpt_dir=None, on_metrics=None):
    """deepseek-v2's smoke twin trained ``steps`` steps with the drift-gated
    balancer; the Trainer. ``model``: start from these weights."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.synthetic import CorpusConfig, token_batches
    from repro_torch.models.config import Shape
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import OptConfig

    cfg = get_smoke("deepseek-v2-236b")
    tr = Trainer(
        cfg, Shape("moe", "train", 64, 4), device=device, model=model,
        opt_cfg=OptConfig(lr=2e-3, warmup_steps=5, decay_steps=60),
        tcfg=TrainerConfig(ckpt_dir=ckpt_dir or _common.tmp_dir("moe_balance_ckpt"),
                           ckpt_every=1000, replan_interval=10,
                           balancer_max_drift=0.1, log_every=10))
    batches = token_batches(CorpusConfig(vocab=cfg.vocab, zipf_alpha=1.3),
                            seed=0, batch=4, seq_len=64)
    tr.run(batches, steps, on_metrics=on_metrics)
    return tr


def placement() -> dict:
    """What the placement is worth at production scale: 160 experts, 16 shards."""
    rng = np.random.default_rng(0)
    loads = (np.arange(1, 161, dtype=float) ** -0.6)
    rng.shuffle(loads)
    ideal = loads.sum() / 16
    base = np.bincount(np.arange(160) // 10, weights=loads, minlength=16).max()
    a = schedule_balanced_cardinality(loads, 16, 10)
    bal = np.bincount(a, weights=loads, minlength=16).max()
    return {"contiguous": base / ideal, "os4m": bal / ideal,
            "saving_pct": 100 * (1 - bal / base), "assignment": a}


def routing_batches():
    """The reuse loop's token → expert batches; the skew shifts at batch 6."""
    r = np.random.default_rng(0)
    out = []
    for i in range(BATCHES):
        alpha = 0.6 if i < 6 else 1.1      # routing skew shifts at batch 6
        out.append((zipf(r, 1 + alpha, size=(SLOTS, TOKENS)) % 160).astype(np.int32))
    return out


def reuse_loop(device):
    """ONE persistent job + reuse policy over the routing stream: ``(results, job)``."""
    serve_job = MapReduceJob(
        lambda s: s,
        MapReduceConfig(num_slots=SLOTS, num_clusters=32, scheduler="auto",
                        reuse=ReusePolicy(max_drift=0.2)),
        device=device)
    ones = torch.ones((SLOTS, TOKENS, 1), dtype=torch.float32, device=device)
    valid = torch.ones((SLOTS, TOKENS), dtype=torch.bool, device=device)
    results = [serve_job.run((torch.as_tensor(e, device=device), ones, valid))
               for e in routing_batches()]
    return results, serve_job


def main(argv=None) -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"which sections to run, of {','.join(SECTIONS)}")
    args = ap.parse_args(argv)
    sections = args.sections.split(",")
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    device = default_device(args.device, "examples.moe_balance")
    launches0 = _common.launch_counts()
    report = {}

    if "trainer" in sections:
        from repro_torch.configs import get_smoke

        cfg = get_smoke("deepseek-v2-236b")
        print(f"arch: {cfg.name} — {cfg.moe.num_experts} experts, "
              f"top-{cfg.moe.top_k}, {cfg.first_k_dense} dense layer(s)")
        tr = trainer(device, on_metrics=lambda s, m: print(
            f"  step {s}: loss {m['loss']:.3f}"
            + (f"  balance {m['balance_ratio']:.3f} (baseline "
               f"{m['baseline_ratio']:.3f})" if "balance_ratio" in m else "")))
        report["trainer"] = {
            "losses": [m["loss"] for _, m in tr.history],
            "replans": [{"step": s, "balance_ratio": m["balance_ratio"],
                         "baseline_ratio": m["baseline_ratio"]}
                        for s, m in tr.history if "balance_ratio" in m]}

    if "placement" in sections:
        print("\nproduction-scale placement (160 experts on 16 shards, "
              "zipf expert loads):")
        p = placement()
        print(f"  contiguous placement capacity: {p['contiguous']:.3f}x ideal")
        print(f"  OS4M placement capacity:       {p['os4m']:.3f}x ideal")
        print(f"  padded-compute saving:         {p['saving_pct']:.1f}%")
        report["placement"] = p

    if "reuse" in sections:
        print("\nsteady-state serving (schedule reuse over the routing stream):")
        results, serve_job = reuse_loop(device)
        for i, res in enumerate(results):
            print(f"  batch {i}: {'reuse ' if res.reused else 'REPLAN'} "
                  f"({res.plan_reason}) balance={res.schedule.balance_ratio:.3f}")
        stats = serve_job.schedule_cache.stats()
        print(f"  one plan served {stats['reuses']}/{stats['batches']} batches "
              f"(replan rate {stats['replan_rate']:.2f})")
        report["reuse"] = {
            "batches": [{"reused": r.reused, "plan_reason": r.plan_reason,
                         "balance_ratio": r.schedule.balance_ratio, "strategy": r.strategy,
                         "assignment": r.schedule.assignment, "counts": r.counts}
                        for r in results],
            "stats": stats}
    return _common.finish(report, args.report, launches0)


if __name__ == "__main__":
    main()
