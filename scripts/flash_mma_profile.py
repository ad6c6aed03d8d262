"""Where flash attention's mma route spends a call at the CI f32 shape.

For ``attn_s128_f32`` (b 2, 128 positions, 4 heads, d 64, f32) at every
tile: the kernel's device time from ``torch.profiler`` (the mean over 20
calls) beside SDPA's kernel on the same inputs, and the host time of one
call of each (the mean over 2000 calls issued back to back, synchronised
once at the end; all taken before the first profile). Then the compiler's registers and local (spill) bytes of
the mma kernel at every instantiated head dim, f32 and bf16.

    PYTHONPATH=src python3 scripts/flash_mma_profile.py

Needs one card; builds the kernels (about 20 s) and runs for a few more.
"""
from __future__ import annotations

import functools
import subprocess
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME, tile_grid
from repro_torch.kernels import _build, conformance
from repro_torch.kernels import flash_attention as fa


def device_us(fn, calls: int = 20) -> float:
    """Mean device time of the CUDA kernels one call of ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / calls


def host_us(fn, calls: int = 2000) -> float:
    """Mean host time of one call of ``fn``, calls issued back to back."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _build.library()
    shape = KERNEL_SHAPE_BY_NAME["attn_s128_f32"]
    q, k, v = conformance.make_inputs(shape, device="cuda")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    calls = {}
    for causal in (True, False):
        calls[f"SDPA causal={causal}"] = functools.partial(
            F.scaled_dot_product_attention, qh, kh, vh, is_causal=causal)
        for dims in tile_grid(shape):
            if dims["causal"] == causal:
                calls[f"mma {dims}"] = functools.partial(
                    fa.flash_attention_cuda, q, k, v, causal=causal,
                    block_q=dims["block_q"], block_k=dims["block_k"])
    # every host time first: the profiler's hooks slow the host after it
    host = {name: host_us(fn) for name, fn in calls.items()}
    for name, fn in calls.items():
        print(f"{name}: device {device_us(fn):.2f} us, host {host[name]:.2f} us [{card}]",
              flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        attrs = {d: fa.mma_attributes(d, dtype) for d in fa.MMA_D}
        print(f"mma kernel {dtype}: (registers, local bytes) by padded head dim {attrs}",
              flush=True)


if __name__ == "__main__":
    main()
