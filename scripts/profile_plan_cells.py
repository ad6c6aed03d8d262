"""Where a plan cell's step spends its time on the card.

Builds ``--arch`` 's steps (llama3-8b by default) at full width on the
one-device mesh (the measured tier's inputs: zeros, the global batch cut
to fit one card: llama3-8b's ``prefill_32k`` at 1, ``decode_32k`` at 8,
``train_4k`` at 1 with int8 Adam moments; ``--batch`` and ``--layers``
set another arch's cut), runs one warm call, then one call under ``torch.profiler``
and prints the step's wall time (CUDA events), the device time summed over
its kernels, the idle share and the kernels that take the most device
time. For ``train_4k`` it then times the step (CUDA events, min of 2)
with the stacked layer parameters taken apart by one ``unbind`` (the
model's way, whose backward is one ``stack``) and by indexing each layer
(whose backward gives every layer a full-size zero gradient of the stack,
summed over the layers), and prints both.

    PYTHONPATH=src python3 scripts/profile_plan_cells.py [--top 12] [--shapes train_4k]
    PYTHONPATH=src python3 scripts/profile_plan_cells.py --arch mamba2-780m \
        --shapes prefill_32k --batch 8

Needs one card with 75 GB free; about two minutes.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.launch.campaign import make_campaign_mesh
from repro_torch.launch.measure import cut_config, zero_step

CUTS = {"prefill_32k": 1, "decode_32k": 8, "train_4k": 1}


def _plan(cfg, cell):
    from repro_torch.sharding.plan import baseline_plan

    plan = baseline_plan(cfg, cell)
    return dataclasses.replace(plan, opt_int8=True) if cell.kind == "train" else plan


def _min_ms(call, runs: int = 2) -> float:
    out = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        call()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return min(out)


def _layer_take(mesh, cfg, cell, card: str) -> None:
    """The train step with the layers taken by ``unbind`` and by indexing."""
    from repro_torch.models import transformer

    times = {}
    unbind = transformer.layer_stack
    try:
        for how in ("unbind", "index"):
            if how == "index":
                transformer.layer_stack = lambda params: {
                    k: [v[i] for i in range(v.shape[0])]
                    for k, v in params.items() if k.startswith("blocks.")}
            call, _ = zero_step("llama3-8b", "train_4k", mesh, _plan(cfg, cell), cfg=cfg,
                                cell=cell)
            call()
            times[how] = _min_ms(call)
            del call
            torch.cuda.empty_cache()
    finally:
        transformer.layer_stack = unbind
    print(f"train_4k layer take (batch 1, llama3-8b, {card}): unbind {times['unbind']:.2f} ms, "
          f"index {times['index']:.2f} ms per step, saved {times['index'] - times['unbind']:.2f} "
          f"ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--shapes", default=",".join(CUTS), help="comma-separated cells")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=None, help="the global batch (default: CUTS)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    mesh, name = make_campaign_mesh("tiny", "cuda")
    arch = args.arch
    cfg = get_config(arch) if args.layers is None else cut_config(arch, args.layers)
    for shape in args.shapes.split(","):
        batch = args.batch or CUTS[shape]
        cell = dataclasses.replace(SHAPE_BY_NAME[shape], global_batch=batch)
        call, _ = zero_step(arch, shape, mesh, _plan(cfg, cell), cfg=cfg, cell=cell)
        call()  # warm
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            call()
            end.record()
            end.synchronize()
        wall_ms = start.elapsed_time(end)
        rows = [e for e in prof.key_averages() if e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.device_time_total for e in rows) / 1e3
        launches = sum(e.count for e in rows)
        print(f"{shape} (batch {batch}, {arch}, {cfg.n_layers} layers, {card}): step "
              f"{wall_ms:.2f} ms, device "
              f"busy {dev_ms:.2f} ms over {launches} kernel launches, idle share "
              f"{max(0.0, 1 - dev_ms / wall_ms):.3f} (profiled call)", flush=True)
        for e in sorted(rows, key=lambda e: -e.device_time_total)[:args.top]:
            print(f"  {e.device_time_total / 1e3:10.3f} ms {100 * e.device_time_total / 1e3 / dev_ms:5.1f}% "
                  f"x{e.count:<6d} {e.key[:110]}", flush=True)
        del call, prof
        torch.cuda.empty_cache()
        if shape == "train_4k" and arch == "llama3-8b":
            _layer_take(mesh, cfg, cell, card)


if __name__ == "__main__":
    main()
