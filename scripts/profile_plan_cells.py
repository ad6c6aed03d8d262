"""Where a plan cell's step spends its time on the card.

Builds llama3-8b's serve steps at full width on the one-device mesh (the
measured tier's inputs: zeros, the global batch cut to fit one card:
``prefill_32k`` at 1, ``decode_32k`` at 8), runs one warm call, then one
call under ``torch.profiler`` and prints the step's wall time (CUDA
events), the device time summed over its kernels, the idle share and the
kernels that take the most device time.

    PYTHONPATH=src python3 scripts/profile_plan_cells.py [--top 12]

Needs one card with 60 GB free; about a minute.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.launch.campaign import make_campaign_mesh
from repro_torch.launch.measure import zero_step

CUTS = {"prefill_32k": 1, "decode_32k": 8}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    mesh, name = make_campaign_mesh("tiny", "cuda")
    cfg = get_config("llama3-8b")
    for shape, batch in CUTS.items():
        cell = dataclasses.replace(SHAPE_BY_NAME[shape], global_batch=batch)
        call, _ = zero_step("llama3-8b", shape, mesh, cfg=cfg, cell=cell)
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
        print(f"{shape} (batch {batch}, llama3-8b, {card}): step {wall_ms:.2f} ms, device "
              f"busy {dev_ms:.2f} ms over {launches} kernel launches, idle share "
              f"{max(0.0, 1 - dev_ms / wall_ms):.3f} (profiled call)", flush=True)
        for e in sorted(rows, key=lambda e: -e.device_time_total)[:args.top]:
            print(f"  {e.device_time_total / 1e3:10.3f} ms {100 * e.device_time_total / 1e3 / dev_ms:5.1f}% "
                  f"x{e.count:<6d} {e.key[:110]}", flush=True)
        del call
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
