"""Serve a small model with batched requests (continuous-batching style).

Counterpart of ``examples/serve_demo.py``: reduced llama3-8b, random
weights from seed 0, ten requests of 4-23 prompt tokens and 12 new tokens
each through the continuous batcher (4 rows, caches of 128 positions).

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]

The default device is the card (``cuda``); without one that is an error.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_demo")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="serve on the card (default) or, when asked, the CPU")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Serve the requests and print throughput, latency and one request's
    tokens; returns the batcher's stats."""
    args = build_parser().parse_args(argv)
    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve import step as serve_step
    from repro_torch.serve.batcher import Batcher
    from repro_torch.sharding.plan import ShardingPlan

    dev = resolve_device(args.device)
    cfg = reduced(get_config("llama3-8b"))
    params, _ = M.init_params(cfg, seed=0, device=dev)
    plan = ShardingPlan(rules={})
    batcher = Batcher(cfg, params, serve_step.make_prefill_step(cfg, plan, None),
                      serve_step.make_decode_step(cfg, plan, None),
                      init_cache=lambda b, ml: M.init_cache(cfg, b, ml, device=dev),
                      max_batch=4, max_len=128)
    rng = np.random.default_rng(0)
    n_requests = 10
    for _ in range(n_requests):
        batcher.submit(rng.integers(0, cfg.vocab, size=int(rng.integers(4, 24))),
                       max_new=12)
    print(f"submitted {n_requests} requests (prompt lens 4-24, 12 new tokens each) "
          f"on {dev}")
    done = batcher.run()
    s = batcher.stats
    print(f"served {s['requests']} requests, {s['tokens']} tokens in "
          f"{s['wall_s']:.2f}s -> {s['tok_per_s']:.1f} tok/s "
          f"({s['decode_steps']} decode steps)")
    lat = [r.t_done - r.t_submit for r in done]
    print(f"latency p50={np.median(lat)*1e3:.0f}ms p100={max(lat)*1e3:.0f}ms")
    sample = done[0]
    print(f"request 0: prompt[:6]={sample.prompt[:6].tolist()} -> out={sample.out}")
    return s


if __name__ == "__main__":
    main()
