"""What f32 attention scores cost on the card, per prefill q chunk.

Times one q chunk of llama3-8b's ``prefill_32k`` (8 KV heads x 4 q heads
x 512 rows against 32768 keys, d 128, bf16) through the port's
``models.layers._attend_chunk`` (scores stored, masked and softmaxed in
f32, as the reference's) and through the same steps with the scores
stored in bf16 (the design before f32 scores), plus the f32 softmax and
its cast to bf16 alone. A prefill runs 64 chunks in each of 32 layers.

    PYTHONPATH=src python3 scripts/score_precision_cost.py

Needs one card; a few seconds.
"""
from __future__ import annotations

import math
import subprocess

import torch

from repro_torch.models import layers as L


def best_ms(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    b, kh, g, c, d, n = 1, 8, 4, 512, 128, 32768
    gen = torch.Generator(device="cuda").manual_seed(0)
    qc = torch.randn(b, kh, g, c, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    kt = torch.randn(b, kh, d, n, generator=gen, device="cuda", dtype=torch.bfloat16)
    vg = torch.randn(b, kh, n, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    mask = (n - c, 0, True, None)  # the last q chunk: the diagonal band at the end

    def f32_scores():
        return L._attend_chunk(qc, kt, vg, scale, mask)

    def bf16_scores():
        s = qc.new_empty(b * kh, g * c, n)
        s.baddbmm_(qc.reshape(b * kh, g * c, d), kt.reshape(b * kh, d, n), beta=0, alpha=scale)
        L._mask_scores_(s.view(b * kh, g, c, n), *mask)
        return torch.bmm(torch.softmax(s, dim=-1), vg.reshape(b * kh, n, d))

    s32 = torch.randn(b * kh, g * c, n, generator=gen, device="cuda")

    def softmax_and_cast():
        return torch.softmax(s32, dim=-1).to(torch.bfloat16)

    for name, fn in (("f32 scores (the port)", f32_scores), ("bf16 scores", bf16_scores),
                     ("f32 softmax + cast alone", softmax_and_cast)):
        ms = best_ms(fn)
        print(f"{name}: {ms:.3f} ms per q chunk, {ms * 64 * 32 / 1e3:.2f} s over a "
              f"prefill's 64 x 32 chunks [{card}]", flush=True)


if __name__ == "__main__":
    main()
