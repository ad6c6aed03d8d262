"""Flash attention from two builds of the port on the same seeded inputs.

    PYTHONPATH=src python3 scripts/flash_build_compare.py --save artifacts/cmp/new.pt
    PYTHONPATH=<other checkout>/src python3 scripts/flash_build_compare.py --save artifacts/cmp/old.pt
    python3 scripts/flash_build_compare.py --compare artifacts/cmp/old.pt artifacts/cmp/new.pt

``--save`` builds the kernels of the ``repro_torch`` that ``PYTHONPATH``
names, runs ``flash_attention_cuda`` on inputs drawn on the card from a
fixed seed per case, and saves the outputs, the routes and the times (CUDA
events) to a file. The cases: the ``wgmma`` route at llama3-8b's widths
(b 1, 4096 positions, 32 heads, 8 KV heads, d 128, bf16) at its eight
tiles of 64 and 128, causal and not; the ``mma`` route where its two K/V
stages hold whole tiles (f32 at d 16, 64 and 128, bf16 at d 32 and 96; 512
positions; and every tile of the campaign's f32 cell, ``attn_s128_f32``);
and bf16 at head dims that one build may route to ``mma`` and another to
``wgmma``: stablelm-3b's attention widths (b 1, 4096 positions, 32 heads,
32 KV heads, d 80) at (512, 512) and (128, 128) and Gemma 2 9B's (16
heads, 8 KV heads, d 256) at (128, 128). The script of one checkout can
save the other's build: ``PYTHONPATH`` picks the package. ``--compare``
prints each case's routes in both files, its largest absolute difference
and the times side by side, then the largest difference over the cases
both files ran on the same route (which must be 0 where neither build
changed that route's kernel) apart from the cases whose route differs. Run
it as parent, change, change, parent in one call to hold the times to one
card.

Needs one card; each ``--save`` builds its checkout's kernels once (about
20 s, reused by a second run of the same checkout) and runs for about 30 s.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import zlib

import torch

#: (dtype, b, s, h, kh, d, block_q, block_k, causal)
CASES = ([("bfloat16", 1, 4096, 32, 8, 128, bq, bk, causal)
          for bq in (64, 128) for bk in (64, 128) for causal in (True, False)]
         + [(dtype, 1, 512, 4, 2, d, bq, bk, causal)
            for dtype, d, tiles in (("float32", 64, ((64, 64), (64, 128), (128, 64),
                                                     (128, 128))),
                                    ("float32", 128, ((64, 64), (128, 64))),
                                    ("bfloat16", 96, ((64, 64), (128, 128))),
                                    ("float32", 16, ((64, 64), (128, 128))),
                                    ("bfloat16", 32, ((32, 64), (128, 128))))
            for bq, bk in tiles for causal in (True, False)]
         + [("float32", 2, 128, 4, 4, 64, bq, bk, causal)  # attn_s128_f32
            for bq in (64, 128) for bk in (64, 128) for causal in (True, False)]
         + [("bfloat16", 1, 4096, 32, 32, 80, 512, 512, causal)  # stablelm-3b
            for causal in (True, False)]
         + [("bfloat16", 1, 4096, 32, 32, 80, 128, 128, True),
            ("bfloat16", 1, 4096, 16, 8, 256, 128, 128, True)])  # Gemma 2 9B


def case_name(case) -> str:
    dtype, b, s, h, kh, d, bq, bk, causal = case
    return f"{dtype} [{b},{s},{h},{kh},{d}] ({bq},{bk}) causal={causal}"


def time_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds a call from CUDA events, after two warm calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def save(path: str) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _build.library()
    dev = torch.device("cuda")
    rec = {"card": card, "source": fa.__file__, "outputs": {}, "routes": {}, "ms": {}}
    for case in CASES:
        dtype, b, s, h, kh, d, bq, bk, causal = case
        name = case_name(case)
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
        q, k, v = ((0.3 * torch.randn(b, s, hh, d, generator=gen, device=dev))
                   .to(getattr(torch, dtype)) for hh in (h, kh, kh))
        run = lambda: fa.flash_attention_cuda(  # noqa: E731
            q, k, v, causal=causal, block_q=bq, block_k=bk)
        rec["outputs"][name] = run().cpu()
        rec["routes"][name] = fa.route(q.dtype, d, bq, bk)
        rec["ms"][name] = time_ms(run)
        print(f"{name}: {rec['routes'][name]} {rec['ms'][name]:.4f} ms [{card}]", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(rec, path)


def compare(path_a: str, path_b: str) -> None:
    a, b = torch.load(path_a), torch.load(path_b)
    print(f"a: {a['source']} [{a['card']}]\nb: {b['source']} [{b['card']}]")
    worst = {True: 0.0, False: 0.0}
    count = {True: 0, False: 0}
    for name in a["outputs"]:
        if name not in b["outputs"]:
            continue
        oa, ob = a["outputs"][name].float(), b["outputs"][name].float()
        diff = (oa - ob).abs().max().item()
        same = a["routes"][name] == b["routes"][name]
        worst[same] = max(worst[same], diff)
        count[same] += 1
        print(f"{name}: routes {a['routes'][name]} / {b['routes'][name]}, "
              f"max|a - b| {diff:.3g}, {a['ms'][name]:.4f} / {b['ms'][name]:.4f} ms "
              f"(a / b {a['ms'][name] / b['ms'][name]:.3f})")
    print(f"largest difference over the {count[True]} cases on the same route in both: "
          f"{worst[True]:.3g}; over the {count[False]} whose route differs: "
          f"{worst[False]:.3g}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="PATH")
    mode.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.save:
        save(args.save)
    else:
        compare(*args.compare)


if __name__ == "__main__":
    main()
