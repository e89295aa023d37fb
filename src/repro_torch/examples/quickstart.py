"""Quickstart: OS4M in 60 seconds.

1. Schedule skewed Reduce operations (hash vs the paper's BSS scheduler).
2. Run a keyed MapReduce word-count on the engine with both schedules
   (and ``auto``), then through the chunked double-buffered pipeline vs the
   sequential (Hadoop-style) phase B — outputs must be bit-identical — and
   a serving loop that reuses one plan across batches.
3. Train a tiny LM for a few steps with OS4M-packed batches.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
      [--sections schedulers,wordcount,pipelined,reuse,lm]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import scheduler as S
from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
from repro_torch.core.schedule_cache import ReusePolicy
from repro_torch.data.synthetic import zipf
from repro_torch.device import default_device
from repro_torch.examples import _common

SECTIONS = ("schedulers", "wordcount", "pipelined", "reuse", "lm")
M, K, CLUSTERS = 4, 256, 24


def _map_fn(shard):
    return shard


def _on(batch, device):
    return tuple(torch.as_tensor(a, device=device) for a in batch)


def schedulers():
    """§1: the op loads, and the hash and BSS schedules of them on 30 slots.

    Returns ``(rng, loads, hash_schedule, bss_schedule)``; §2 draws its keys
    from the same ``rng``, after the loads.
    """
    rng = np.random.default_rng(0)
    loads = zipf(rng, 1.3, 480).clip(1, 20_000).astype(float)  # skewed op loads
    hash_s = S.schedule_hash(loads, 30, keys=np.arange(480))
    bss_s = S.schedule_bss(loads, 30)                  # the paper's algorithm
    return rng, loads, hash_s, bss_s


def wordcount_batch(rng):
    """§2's word-count batch: ``(keys, vals, valid)`` numpy arrays."""
    keys = (zipf(rng, 1.3, size=(M, K)) % 1000).astype(np.int32)
    vals = np.ones((M, K, 1), np.float32)
    valid = np.ones((M, K), bool)
    return keys, vals, valid


def wordcount(sched: str, batch, device):
    """§2: one word-count job under ``sched``; its JobResult."""
    job = MapReduceJob(_map_fn, MapReduceConfig(
        num_slots=M, num_clusters=CLUSTERS, scheduler=sched), device=device)
    return job.run(_on(batch, device))


def pipelined_vs_sequential(batch, device):
    """§2b: the os4m job with and without the pipelined phase B."""
    out = {}
    for pipelined in (False, True):
        job = MapReduceJob(_map_fn, MapReduceConfig(
            num_slots=M, num_clusters=CLUSTERS, scheduler="os4m",
            pipelined=pipelined, pipeline_chunks=4), device=device)
        out[pipelined] = job.run(_on(batch, device))
    return out


def reuse_batches():
    """§2c's seven batches of keys: six stationary, then a shifted one."""
    keys = []
    for i in range(6):                       # stationary traffic: plan once
        r = np.random.default_rng(100 + i)
        keys.append((zipf(r, 1.3, size=(M, K)) % 1000).astype(np.int32))
    r = np.random.default_rng(999)           # the workload shifts…
    keys.append((zipf(r, 2.2, size=(M, K)) % 1000).astype(np.int32))
    return keys


def reuse_loop(device):
    """§2c: one serving job over :func:`reuse_batches`: ``(results, job)``."""
    vals = np.ones((M, K, 1), np.float32)
    valid = np.ones((M, K), bool)
    serve_job = MapReduceJob(_map_fn, MapReduceConfig(
        num_slots=M, num_clusters=CLUSTERS, scheduler="auto",
        reuse=ReusePolicy(max_drift=0.25, max_age=64)), device=device)
    results = [serve_job.run(_on((k, vals, valid), device)) for k in reuse_batches()]
    return results, serve_job


def tiny_lm(device, steps: int = 10, model=None, ckpt_dir=None, on_metrics=None):
    """§3: smollm-360m's smoke twin trained ``steps`` steps; the Trainer.

    ``model``: start from these weights (e.g. converted from the
    reference's), else from ``init_model`` with seed 0.
    """
    from repro_torch.configs import get_smoke
    from repro_torch.data.synthetic import CorpusConfig, token_batches
    from repro_torch.models.config import Shape
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import OptConfig

    cfg = get_smoke("smollm-360m")
    trainer = Trainer(cfg, Shape("quick", "train", 64, 4), device=device, model=model,
                      opt_cfg=OptConfig(lr=3e-3, warmup_steps=2, decay_steps=20),
                      tcfg=TrainerConfig(
                          ckpt_dir=ckpt_dir or _common.tmp_dir("quickstart_ckpt"),
                          ckpt_every=100))
    batches = token_batches(CorpusConfig(vocab=cfg.vocab), seed=0, batch=4, seq_len=64)
    trainer.run(batches, steps, on_metrics=on_metrics)
    return trainer


def main(argv=None) -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"which sections to run, of {','.join(SECTIONS)}")
    args = ap.parse_args(argv)
    sections = args.sections.split(",")
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    device = default_device(args.device, "examples.quickstart")
    launches0 = _common.launch_counts()
    report = {}

    rng, loads, hash_s, bss_s = schedulers()
    if "schedulers" in sections:
        print("== 1. P||C_max scheduling (paper §3.2/§4.2) ==")
        print(f"hash  max-load/ideal = {hash_s.balance_ratio:.3f}   (eq. 3-1 baseline)")
        print(f"os4m  max-load/ideal = {bss_s.balance_ratio:.3f}   (BSS, eta=0.002)")
        report["schedulers"] = {
            "hash": {"balance_ratio": hash_s.balance_ratio, "assignment": hash_s.assignment},
            "os4m": {"balance_ratio": bss_s.balance_ratio, "assignment": bss_s.assignment}}

    batch = wordcount_batch(rng)
    if "wordcount" in sections:
        print("\n== 2. Keyed MapReduce on the engine ==")
        report["wordcount"] = {}
        for sched in ("hash", "os4m", "auto"):
            res = wordcount(sched, batch, device)
            picked = f" -> {res.strategy}" if sched == "auto" else ""
            print(f"{sched:5s}{picked}: wordcount total={res.values.sum():.0f}  "
                  f"balance={res.schedule.balance_ratio:.3f}  "
                  f"net-overhead={res.network_cost.total / 1e3:.1f} KB")
            report["wordcount"][sched] = {
                "strategy": res.strategy, "total": float(res.values.sum()),
                "balance_ratio": res.schedule.balance_ratio,
                "network_bytes": res.network_cost.total,
                "assignment": res.schedule.assignment, "counts": res.counts}

    if "pipelined" in sections:
        print("\n== 2b. Pipelined vs sequential phase B (§4.4) ==")
        engine_res = pipelined_vs_sequential(batch, device)
        bit_identical = (np.array_equal(engine_res[True].values, engine_res[False].values)
                         and np.array_equal(engine_res[True].counts,
                                            engine_res[False].counts))
        print(f"chunked double-buffered engine == sequential barrier: "
              f"bit_identical={bit_identical}")
        assert bit_identical
        report["pipelined"] = {"bit_identical": bit_identical}

    if "reuse" in sections:
        print("\n== 2c. Serving loop: one plan, many batches (schedule reuse) ==")
        results, serve_job = reuse_loop(device)
        for i, res in enumerate(results[:-1]):
            print(f"batch {i}: {'reuse ' if res.reused else 'REPLAN'} "
                  f"({res.plan_reason}) drift="
                  f"{'-' if res.drift is None else f'{res.drift:.3f}'}")
        res = results[-1]
        print(f"shifted batch: {'reuse' if res.reused else 'REPLAN'} "
              f"({res.plan_reason}) drift={res.drift:.3f}")
        stats = serve_job.schedule_cache.stats()
        print(f"steady state: {stats['reuses']}/{stats['batches']} batches reused "
              f"one plan (replan rate {stats['replan_rate']:.2f})")
        assert stats["replans"] == 2             # cold start + the injected shift
        report["reuse"] = {
            "batches": [{"reused": r.reused, "plan_reason": r.plan_reason, "drift": r.drift,
                         "strategy": r.strategy, "assignment": r.schedule.assignment}
                        for r in results],
            "stats": stats}

    if "lm" in sections:
        print("\n== 3. Tiny LM training with OS4M-packed batches ==")
        trainer = tiny_lm(device, on_metrics=lambda s, m: print(
            f"  step {s}: loss {m['loss']:.3f}"))
        hist = trainer.history
        print(f"loss {hist[0][1]['loss']:.3f} -> {hist[-1][1]['loss']:.3f}")
        report["lm"] = {"losses": [m["loss"] for _, m in hist]}
    return _common.finish(report, args.report, launches0)


if __name__ == "__main__":
    main()
