"""Serving launcher: batched prefill+decode for a (reduced) architecture.

Counterpart of ``repro/launch/serve.py``, with ``--device`` (``cuda``, the
default, or ``cpu``). The params come from seed 0 on the device, the plan
is ``ShardingPlan(rules={})`` (one device), and the continuous batcher
serves synthetic requests (prompts of 4-31 tokens from a numpy seed).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --requests 8
"""
import argparse
from typing import Dict, Optional, Sequence

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs import reduced as reduce_cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="serve on the card (default) or, when asked, the CPU")
    return ap


def teacher_forced_gap(params, prefill_step, decode_step, init_cache, requests,
                       max_len: int) -> float:
    """How far the batcher's greedy tokens are from greedy, re-run alone.

    Each finished request is replayed at batch 1, teacher-forced: its prompt
    prefilled, then each generated token fed back. At every generated
    position the reading is ``(max logit - logit of the generated token) /
    max |logit|``; the worst reading over all requests is returned (0 when
    every token is the replay's argmax). Batching changes the summation
    order, so in bf16 a near-tied token may flip: a limit of 2e-2 holds the
    batcher to its own batch-1 run without demanding identical tokens."""
    import torch

    dev = next(iter(params.values())).device
    worst = torch.zeros((), dtype=torch.float32, device=dev)
    with torch.inference_mode():
        for r in requests:
            cache = init_cache(1, max_len)
            toks = torch.as_tensor(r.prompt, dtype=torch.int32, device=dev)[None]
            logits, cache = prefill_step(params, {"tokens": toks}, cache)
            out = torch.as_tensor(r.out, dtype=torch.int32, device=dev)
            for j in range(len(r.out)):
                row = logits[0, -1].float()
                worst = torch.maximum(worst, (row.max() - row[out[j]]) / row.abs().max())
                if j + 1 < len(r.out):
                    logits, cache = decode_step(params, {"tokens": out[j:j + 1][None]}, cache)
    return float(worst)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """CLI entry: run the continuous batcher over synthetic requests for a
    reduced text architecture; prints the reference's line and returns the
    batcher's stats. Exits via SystemExit for vlm/audio archs (their
    frontends are dry-run stubs, not servable)."""
    args = build_parser().parse_args(argv)
    import numpy as np

    from repro_torch.core.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve import step as serve_step
    from repro_torch.serve.batcher import Batcher
    from repro_torch.sharding.plan import ShardingPlan

    cfg = reduce_cfg(get_config(args.arch))
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("serve launcher targets text-in architectures; "
                         "vlm/audio frontends are stub inputs (see dryrun)")
    dev = resolve_device(args.device)
    params, _ = M.init_params(cfg, seed=0, device=dev)
    plan = ShardingPlan(rules={})
    batcher = Batcher(
        cfg, params,
        serve_step.make_prefill_step(cfg, plan, None),
        serve_step.make_decode_step(cfg, plan, None),
        init_cache=lambda b, ml: M.init_cache(cfg, b, ml, device=dev),
        max_batch=args.max_batch, max_len=256)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        batcher.submit(rng.integers(0, cfg.vocab, size=int(rng.integers(4, 32))),
                       max_new=args.max_new)
    batcher.run()
    s = batcher.stats
    print(f"{s['requests']} requests, {s['tokens']} tokens, "
          f"{s['tok_per_s']:.1f} tok/s")
    return s


if __name__ == "__main__":
    main()
