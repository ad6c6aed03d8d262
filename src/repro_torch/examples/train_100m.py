"""End-to-end example: train a ~100M-parameter LM with the full production
stack: sharding plan, AdamW, checkpointing, fault-tolerant trainer,
synthetic data pipeline.

Counterpart of ``examples/train_100m.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300      # full run
    PYTHONPATH=src python -m repro_torch.examples.train_100m --preset smoke   # CI-sized

Resume after interruption is automatic (latest committed checkpoint). The
default device is the card (``cuda``); ``--device cpu`` trains on the CPU.
``--preset tiny`` (2 layers, 2 steps of 2 x 16 tokens) only shows that the
example runs.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional, Sequence

from repro_torch.configs.base import ArchConfig

# ~106M params: 10L x d640 x ff2560, 32k vocab
CONFIG_100M = ArchConfig(
    name="repro-100m", family="dense", n_layers=10, d_model=640,
    n_heads=10, n_kv_heads=5, d_ff=2560, vocab=32000, d_head=64,
    rope_theta=10_000.0, dtype="float32",
)

#: preset -> (steps, seq, batch, layers); "full" keeps the flags' values
PRESETS = {"smoke": (20, 64, 4, None), "tiny": (2, 16, 2, 2)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--preset", choices=["full", "smoke", "tiny"], default="full")
    ap.add_argument("--ckpt", default="artifacts/ckpt_100m")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="train on the card (default) or, when asked, the CPU")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train (resuming from the latest committed checkpoint in ``--ckpt``)
    and print the loss trajectory; returns the trainer's result."""
    args = build_parser().parse_args(argv)
    from repro_torch.core.device import resolve_device
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import step as step_mod
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = CONFIG_100M
    if args.preset in PRESETS:
        args.steps, args.seq, args.batch, layers = PRESETS[args.preset]
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)

    print(f"training {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens on {dev}")

    plan = ShardingPlan(rules={}, remat="none", zero1=False, loss_chunk=0)
    opt = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=max(args.steps, 100))
    step = step_mod.make_train_step(cfg, plan, None, opt)

    state, _ = step_mod.init_train_state(cfg, plan, seed=0, device=dev)
    start = ckpt.latest_step(args.ckpt)
    if start is not None:
        state, start, _ = ckpt.restore_checkpoint(args.ckpt, state)
        print(f"resuming from committed checkpoint at step {start}")
    else:
        start = 0

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=0))
    trainer = Trainer(
        cfg, plan, step, state, data,
        TrainerConfig(total_steps=args.steps, ckpt_every=max(args.steps // 5, 10),
                      ckpt_dir=args.ckpt, log_every=5),
        device=dev)
    out = trainer.run(start_step=start)
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"done: step {out['final_step']}, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, median step time "
              f"{sorted(h['dt'] for h in out['history'])[len(losses)//2]*1e3:.0f}ms")
    return out


if __name__ == "__main__":
    main()
