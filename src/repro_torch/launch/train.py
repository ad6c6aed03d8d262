"""Training launcher: trains a config on one device, the card unless the
caller asks for the CPU.

Counterpart of ``repro/launch/train.py``, with the same flags and these
more: ``--device`` (``cuda``, the default, or ``cpu``), ``--resume-step N``
(restart from step N committed in ``--ckpt``, step 0 or a multiple of
``max(steps // 4, 5)``; the steps after it replay bit for bit; the
reference launcher's checkpoints have the same layout) and ``--history PATH`` (each step's loss, device time and host data
time as JSON). ``--reduced`` trains the reduced config;
without it the full config trains on the one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 20 --batch 8 --seq 64 --device cpu
"""
import argparse
import json
import sys
from pathlib import Path

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs import reduced as reduce_cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (without it, the full config)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt", default="artifacts/ckpt_train")
    ap.add_argument("--resume-step", type=int, default=None,
                    help="restart from this step, committed in --ckpt")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="train on the card (default) or, when asked, the CPU")
    ap.add_argument("--history", default=None, help="write the per-step history JSON here")
    return ap


def main(argv=None) -> None:
    """CLI entry: train and print the first and last loss. Loss values
    depend on the synthetic data's seed and the initial weights, and are
    deterministic per invocation."""
    args = build_parser().parse_args(argv)
    from repro_torch.core.device import resolve_device
    from repro_torch.sharding.plan import ShardingPlan, baseline_rules
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import step as step_mod
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    plan = ShardingPlan(rules={} if args.reduced else baseline_rules(),
                        remat=args.remat, microbatches=args.microbatches,
                        grad_compress=args.grad_compress, zero1=not args.reduced)
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M plan={plan.name} device={dev}",
          flush=True)

    state, _ = step_mod.init_train_state(cfg, plan, seed=0, device=dev)
    start = 0
    if args.resume_step is not None:
        state, start, _ = ckpt_mod.restore_checkpoint(args.ckpt, state, step=args.resume_step)
    step = step_mod.make_train_step(
        cfg, plan, None, AdamWConfig(warmup_steps=10, total_steps=args.steps))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    tr = Trainer(cfg, plan, step, state, data,
                 TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                               ckpt_every=max(args.steps // 4, 5)),
                 device=dev)
    out = tr.run(start_step=start)
    h = out["history"]
    if args.history:
        Path(args.history).parent.mkdir(parents=True, exist_ok=True)
        Path(args.history).write_text(json.dumps(h))
    if not h:
        print(f"final: step {out['final_step']}, no step left to run")
        sys.exit(0)
    print(f"final: step {out['final_step']} loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
