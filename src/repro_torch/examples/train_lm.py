"""End to end: train a ~100M-param LM for a few hundred steps.

A shrunk SmolLM (d_model 512, 12 layers, 49k vocab ≈ 90M params, float32)
on the synthetic corpus with OS4M packing, AdamW + cosine schedule, atomic
checkpoints, and resume-on-restart: a run continues from the latest
checkpoint in ``--ckpt-dir``. ``--steps 300`` is the full run.

Run:  python -m repro_torch.examples.train_lm --steps 300 [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import default_device
from repro_torch.examples import _common


def smollm_100m():
    """The ~100M-param config of the smollm family, float32 throughout."""
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("smollm-360m"), name="smollm-100m", n_layers=12, d_model=512,
        n_heads=8, n_kv=4, d_ff=1536, param_dtype="float32", compute_dtype="float32",
        logit_dtype="float32")


def make_trainer(cfg, steps: int, batch: int, seq: int, ckpt_dir: str, device, model=None):
    """The Trainer of ``cfg`` at ``(batch, seq)``, its schedule decaying over
    ``steps``. ``model``: start from these weights."""
    from repro_torch.models.config import Shape
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import OptConfig

    return Trainer(
        cfg, Shape("e2e", "train", seq, batch), device=device, model=model,
        opt_cfg=OptConfig(lr=6e-4, warmup_steps=20, decay_steps=steps),
        tcfg=TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=100, log_every=10))


def batches(cfg, batch: int, seq: int):
    """OS4M-packed (batch, seq) token batches of the synthetic corpus."""
    from repro_torch.data import packing
    from repro_torch.data.synthetic import CorpusConfig, token_batches

    return token_batches(
        CorpusConfig(vocab=cfg.vocab, zipf_alpha=1.1), seed=0, batch=batch, seq_len=seq,
        packer=lambda d, b, s: packing.pack_documents(d, b, s, scheduler="os4m"))


def main(argv=None) -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints (default: train_lm_ckpt in the temporary directory)")
    args = ap.parse_args(argv)
    device = default_device(args.device, "examples.train_lm")
    ckpt_dir = args.ckpt_dir or _common.tmp_dir("train_lm_ckpt")
    launches0 = _common.launch_counts()

    cfg = smollm_100m()
    print(f"model: {cfg.name}  params ~{cfg.param_count() / 1e6:.0f}M")
    trainer = make_trainer(cfg, args.steps, args.batch, args.seq, ckpt_dir, device)
    start = 0
    if trainer.try_resume():
        start = trainer.step
        print(f"resumed from step {trainer.step}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    hist = trainer.run(batches(cfg, args.batch, args.seq), args.steps - trainer.step,
                       on_metrics=lambda s, m: print(
                           f"step {s:4d}  loss {m['loss']:.4f}  "
                           f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}"))
    trainer.save()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok = (args.steps - start) * args.batch * args.seq
    losses = [m["loss"] for _, m in hist]
    final = f"final loss {losses[-1]:.4f}" if losses else "no step left to run"
    print(f"\n{final} ({tok / max(dt, 1e-9):.0f} tok/s on {device.type}); "
          f"checkpoints in {ckpt_dir}")
    report = {"params": cfg.param_count(), "start_step": start, "steps": args.steps,
              "batch": args.batch, "seq": args.seq, "seconds": dt,
              "tokens_per_s": tok / max(dt, 1e-9), "losses": losses}
    if device.type == "cuda":
        report["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return _common.finish(report, args.report, launches0)


if __name__ == "__main__":
    main()
