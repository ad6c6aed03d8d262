"""Flash attention and the SSD scan from two builds of the port on the same
seeded inputs.

    PYTHONPATH=src python3 scripts/flash_build_compare.py --save artifacts/cmp/new.pt
    PYTHONPATH=<other checkout>/src python3 scripts/flash_build_compare.py --save artifacts/cmp/old.pt
    python3 scripts/flash_build_compare.py --compare artifacts/cmp/old.pt artifacts/cmp/new.pt

(``--kernels ssd`` or ``--kernels flash`` with ``--save`` runs one
kernel's cases.)

``--save`` builds the kernels of the ``repro_torch`` that ``PYTHONPATH``
names, runs ``flash_attention_cuda`` and ``ssd_scan_cuda`` on inputs drawn
on the card from a fixed seed per case, and saves the outputs, the routes
and the times (CUDA events) to a file; a call that build refuses is saved
as refused. The flash cases: the ``wgmma`` route at llama3-8b's widths
(b 1, 4096 positions, 32 heads, 8 KV heads, d 128, bf16) at its eight
tiles of 64 and 128, causal and not; the ``mma`` route where its two K/V
stages hold whole tiles (f32 at d 16, 64 and 128, bf16 at d 32 and 96; 512
positions; and every tile of the campaign's f32 cell, ``attn_s128_f32``);
and bf16 at head dims that one build may route to ``mma`` and another to
``wgmma``: stablelm-3b's attention widths (b 1, 4096 positions, 32 heads,
32 KV heads, d 80) at (512, 512) and (128, 128) and Gemma 2 9B's (16
heads, 8 KV heads, d 256) at (128, 128); and head dims above 256 (d 320
and 512 at tiles the FMA kernel took and at (128, 128), in both types).
The SSD cases, at mamba2-780m's widths (b 8, 4096 positions, 48 heads of
64, N 128) unless named: bf16 at chunks 32-256 (the ``mma`` and ``wgmma``
routes), f32 at chunks 32-128 and ``ssd_s256_f32`` at every chunk (the
``mma`` route's whole-chunk kernel), and the sizes that moved from the FMA
kernels to the streamed ``mma`` kernel: f32 at chunk 256 at mamba2-780m's
and zamba2-2.7b's widths (80 heads, N 64), bf16 at N 256, at dh 128 (24
heads) and at chunk 512; the first 1024 rows of batch 0 of y and the
final state of batch 0 are kept. The script of one checkout can save the
other's build: ``PYTHONPATH`` picks the package. ``--compare``
prints each case's routes in both files, its largest absolute difference
and the times side by side, then the largest difference over the cases
both files ran on the same route (which must be 0 where neither build
changed that route's kernel) apart from the cases whose route differs. Run
it as parent, change, change, parent in one call to hold the times to one
card.

Needs one card; each ``--save`` builds its checkout's kernels once (about
20 s, reused by a second run of the same checkout) and runs for about 90 s.
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
            ("bfloat16", 1, 4096, 16, 8, 256, 128, 128, True)]  # Gemma 2 9B
         + [(dtype, 1, 512, 16, 8, d, bq, bk, True)  # above d 256
            for dtype, d, bq, bk in (("bfloat16", 320, 32, 16), ("float32", 320, 16, 32),
                                     ("float32", 512, 16, 16), ("bfloat16", 512, 16, 16),
                                     ("float32", 320, 128, 128), ("bfloat16", 512, 128, 128))])

#: (dtype, b, s, nh, dh, N, chunk) of the SSD scan
_MAMBA = (8, 4096, 48, 64, 128)
SSD_CASES = ([("bfloat16", *_MAMBA, L) for L in (32, 64, 128, 256)]
             + [("float32", *_MAMBA, L) for L in (32, 64, 128)]
             + [("float32", 1, 256, 4, 32, 32, L) for L in (32, 64, 128, 256)]  # ssd_s256_f32
             + [("float32", *_MAMBA, 256), ("float32", 8, 4096, 80, 64, 64, 256),
                ("bfloat16", 8, 4096, 48, 64, 256, 256), ("bfloat16", 8, 4096, 24, 128, 128, 256),
                ("bfloat16", *_MAMBA, 512)])


def case_name(case) -> str:
    dtype, b, s, h, kh, d, bq, bk, causal = case
    return f"{dtype} [{b},{s},{h},{kh},{d}] ({bq},{bk}) causal={causal}"


def ssd_case_name(case) -> str:
    dtype, b, s, nh, dh, N, L = case
    return f"ssd {dtype} [{b},{s},{nh},{dh},{N}] chunk {L}"


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


def _record(rec, name, route, run, keep, card) -> None:
    """Run one case into ``rec``: its route, the part of its output that
    ``keep`` selects and its time, or "refused" where the build raises."""
    try:
        out = run()
    except (RuntimeError, ValueError) as e:
        rec["routes"][name] = f"{route} refused"
        print(f"{name}: {route} refused ({str(e)[:120]}) [{card}]", flush=True)
        return
    rec["outputs"][name] = keep(out)
    rec["routes"][name] = route
    rec["ms"][name] = time_ms(run, reps=20 if name.startswith("ssd") else 50)
    print(f"{name}: {route} {rec['ms'][name]:.4f} ms [{card}]", flush=True)


def save(path: str, kernels=("flash", "ssd")) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _build.library()
    dev = torch.device("cuda")
    rec = {"card": card, "source": fa.__file__, "outputs": {}, "routes": {}, "ms": {}}
    for case in CASES if "flash" in kernels else []:
        dtype, b, s, h, kh, d, bq, bk, causal = case
        name = case_name(case)
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
        q, k, v = ((0.3 * torch.randn(b, s, hh, d, generator=gen, device=dev))
                   .to(getattr(torch, dtype)) for hh in (h, kh, kh))
        run = lambda: fa.flash_attention_cuda(  # noqa: E731
            q, k, v, causal=causal, block_q=bq, block_k=bk)
        _record(rec, name, fa.route(q.dtype, d, bq, bk), run, lambda o: o.cpu(), card)
        del q, k, v
    for case in SSD_CASES if "ssd" in kernels else []:
        dtype, b, s, nh, dh, N, L = case
        name = ssd_case_name(case)
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
        dt_ = getattr(torch, dtype)
        x = (0.3 * torch.randn(b, s, nh, dh, generator=gen, device=dev)).to(dt_)
        dt = (0.1 + 0.2 * torch.rand(b, s, nh, generator=gen, device=dev)).to(dt_)
        A = -(0.5 + torch.rand(nh, generator=gen, device=dev))
        B, C = ((0.3 * torch.randn(b, s, N, generator=gen, device=dev)).to(dt_)
                for _ in range(2))
        route = ssd.route(dt_, L, dh, N)
        if route == "mma" and getattr(ssd, "mma_streams", None) is not None \
                and ssd.mma_streams(L, N, dh, x.element_size()):
            route = "mma (streamed)"
        run = lambda: ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=L)  # noqa: E731
        _record(rec, name, route, run, lambda o: (o[0][:1, :1024].cpu(), o[1][:1].cpu()),
                card)
        del x, dt, B, C
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(rec, path)


def compare(path_a: str, path_b: str) -> None:
    a, b = torch.load(path_a), torch.load(path_b)
    print(f"a: {a['source']} [{a['card']}]\nb: {b['source']} [{b['card']}]")
    worst = {True: 0.0, False: 0.0}
    count = {True: 0, False: 0}
    for name in a["routes"]:
        if name not in b["outputs"] or name not in a["outputs"]:
            print(f"{name}: routes {a['routes'][name]} / {b['routes'].get(name)}")
            continue
        pairs = zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (a["outputs"][name], b["outputs"][name])))
        diff = max((oa.float() - ob.float()).abs().max().item() for oa, ob in pairs)
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
    ap.add_argument("--kernels", nargs="+", choices=("flash", "ssd"), default=("flash", "ssd"),
                    help="the cases --save runs (default: both kernels')")
    args = ap.parse_args()
    if args.save:
        save(args.save, args.kernels)
    else:
        compare(*args.compare)


if __name__ == "__main__":
    main()
