"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference's ``repro.launch.train`` with the same flags, plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU).
Without ``--full`` it trains the smoke twin of the chosen arch on the
synthetic corpus packed by the chosen scheduler; with ``--full`` it
trains the full config on the one device (where the reference uses its
production mesh). Its log lines are the reference's.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="the full config (on the one device)")
    ap.add_argument("--ckpt-dir", default="checkpoints/train_cli")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--scheduler", default="os4m",
                    help="packing scheduler: os4m | lpt | hash")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda; cpu for the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import packing
    from repro_torch.data.synthetic import CorpusConfig, token_batches
    from repro_torch.device import default_device
    from repro_torch.models.config import Shape
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import OptConfig

    device = default_device(None if args.device == "cuda" else args.device,
                            "launch.train")
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    shape = Shape("cli", "train", args.seq, args.batch)

    trainer = Trainer(
        cfg, shape, device=device,
        opt_cfg=OptConfig(lr=args.lr, warmup_steps=10, decay_steps=args.steps),
        tcfg=TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=25,
                           replan_interval=10))
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")

    corpus = CorpusConfig(vocab=cfg.vocab)
    packer = lambda docs, b, s: packing.pack_documents(  # noqa: E731
        docs, b, s, scheduler=args.scheduler)
    batches = token_batches(corpus, seed=0, batch=args.batch,
                            seq_len=args.seq, packer=packer)

    def log(step, m):
        print(f"step {step:5d}  loss {m.get('loss', float('nan')):.4f}  "
              f"gnorm {m.get('grad_norm', 0):.3f}  lr {m.get('lr', 0):.2e}"
              + (f"  balance {m['balance_ratio']:.3f}"
                 if "balance_ratio" in m else ""), flush=True)

    trainer.run(batches, args.steps, on_metrics=log)
    trainer.save()
    print(f"done at step {trainer.step}; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
