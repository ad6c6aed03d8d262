"""Quickstart: train a tiny LM for a few steps, then serve it.

Counterpart of ``examples/quickstart.py``: reduced qwen3-0.6b, 60 AdamW
steps on the synthetic data (the loss must fall), then 8 greedy tokens
from the trained weights through the serve steps.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The default device is the card (``cuda``); without one that is an error.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="train and serve on the card (default) or, when asked, the CPU")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train, check the loss fell, decode; returns the first and last loss
    and the generated tokens."""
    args = build_parser().parse_args(argv)
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve import step as serve_step
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.train import step as step_mod
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig

    dev = resolve_device(args.device)
    cfg = reduced(get_config("qwen3-0.6b"))
    plan = ShardingPlan(rules={}, remat="none", zero1=False)
    state, _ = step_mod.init_train_state(cfg, plan, seed=0, device=dev)
    step = step_mod.make_train_step(
        cfg, plan, None, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0))

    print(f"model: {cfg.name}  params={cfg.n_params()/1e6:.2f}M  device={dev}")
    first = last = None
    for i in range(60):
        state, metrics = step(state, {k: torch.from_numpy(v).to(dev)
                                      for k, v in data.batch(i).items()})
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        last = loss
        if i % 10 == 0:
            print(f"step {i:3d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}")
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    assert last < first, "training should reduce loss on structured synthetic data"

    # decode a few tokens from the trained model
    prefill = serve_step.make_prefill_step(cfg, plan, None)
    decode = serve_step.make_decode_step(cfg, plan, None)
    toks = []
    with torch.inference_mode():
        prompt = torch.from_numpy(data.batch(999)["tokens"][:1, :8]).to(dev)
        cache = M.init_cache(cfg, 1, 64, device=dev)
        logits, cache = prefill(state["params"], {"tokens": prompt}, cache)
        cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        for _ in range(8):
            toks.append(int(cur[0, 0]))
            logits, cache = decode(state["params"], {"tokens": cur}, cache)
            cur = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    print("generated:", toks)
    return {"first_loss": first, "last_loss": last, "generated": toks}


if __name__ == "__main__":
    main()
