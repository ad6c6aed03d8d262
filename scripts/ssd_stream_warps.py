"""The SSD scan's streamed mma kernel at each warp count it can launch with.

    PYTHONPATH=src python3 scripts/ssd_stream_warps.py

The streamed kernel (``csrc/ssd_scan_stream.cu``) owns a slice of 8 W
columns of dh with W warps (two to each 16 columns); ``ssd_scan.stream_warps``
picks W. This script launches it through ``ssd_scan_mma_launch`` at every
even W whose block fits, at the sizes the mma route streams at realistic
widths (b 8, 4096 positions, chunk 256): f32 at mamba2-780m's (48 heads of
64, N 128) and zamba2-2.7b's (80 heads, N 64) widths, bf16 at N 256. For
each W it checks the output against ``ssd_scan_plain`` (bit-identical
across W: the products and their order do not depend on W), prints the
blocks an SM holds by shared memory, the time per call from CUDA events
and the kernel's time from ``torch.profiler`` (per recorded launch, and
the launches it recorded out of the calls made, for the first calls at a
W and after a warm call). Prints the card's name and power limit
beside every time. Needs one card; runs for about a minute.
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.core.device import H100_SXM
from repro_torch.core.kernel_space import KernelShape
from repro_torch.kernels import _build, conformance
from repro_torch.kernels import ssd_scan as ssd

#: (name, dtype, b, s, nh, dh, N, chunk)
CASES = [("mamba2-780m f32", "float32", 8, 4096, 48, 64, 128, 256),
         ("zamba2-2.7b f32", "float32", 8, 4096, 80, 64, 64, 256),
         ("mamba2-780m N 256 bf16", "bfloat16", 8, 4096, 48, 64, 256, 256)]


def events_ms(fn, reps: int = 20) -> float:
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


def profiled(fn, calls: int, warm: bool):
    """(ms per recorded launch, launches recorded) of the streamed kernel
    over ``calls`` profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if "ssd_stream_kernel" in e.key:
            total += e.device_time_total / 1e3
            count += e.count
    return (total / count if count else float("nan")), count


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    lib = _build.library()
    for dt_name in ("float32", "bfloat16"):
        regs, local = ssd.stream_attributes(getattr(torch, dt_name))
        print(f"streamed kernel {dt_name}: {regs} registers, {local} B local [{card}]",
              flush=True)
    for name, dtype, b, s, nh, dh, N, L in CASES:
        shape = KernelShape("ssd_stream_warps", "ssd_scan",
                            {"b": b, "s": s, "nh": nh, "dh": dh, "N": N}, dtype)
        x, dt, A, B, C = conformance.make_inputs(shape, device=dev)
        item = x.element_size()
        assert ssd.launch_key(x.dtype, L, dh, N) == ssd.STREAM_KEY
        want = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=L)
        cs = torch.empty(b, s, nh, dtype=torch.float32, device=dev)
        first = None
        for w in range(2, ssd.STREAM_MAX_WARPS + 1, 2):
            smem = ssd._stream_bytes(L, N, w, item)
            if smem > H100_SXM.smem_per_block or 8 * (w - 2) >= dh:
                continue
            y, S = torch.empty_like(x), torch.empty(b, nh, dh, N, device=dev)

            def run(w=w, smem=smem, y=y, S=S):
                err = lib.ssd_scan_mma_launch(
                    x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                    None, cs.data_ptr(), y.data_ptr(), S.data_ptr(), b, s, nh, dh, N, L,
                    _build.dtype_code(x), 32 * w, smem, _build.stream_ptr(dev))
                _build.check("ssd_scan_mma_launch", err)

            # the first calls at this W under the profiler, as chip_smoke.py's
            # phase 4 profiles a new shape
            cold_ms, cold_n = profiled(run, 3, warm=False)
            agree = conformance.agree_with_plain((y, S), want)
            if not agree["passed"]:
                raise SystemExit(f"{name} W {w}: kernel vs plain {agree}")
            same = first is None or (torch.equal(y, first[0]) and torch.equal(S, first[1]))
            if first is None:
                first = (y.clone(), S.clone())
            blocks = H100_SXM.smem_per_sm // (smem + H100_SXM.smem_reserved_per_block)
            ms = events_ms(run)
            warm_ms, warm_n = profiled(run, 3, warm=True)
            pick = " (stream_warps' pick)" if w == ssd.stream_warps(L, N, dh, item) else ""
            print(f"{name} chunk {L} W {w}{pick}: {-(-dh // (8 * w))} slices, {smem} B, "
                  f"{blocks} blocks an SM by shared memory; events {ms:.4f} ms; profiler "
                  f"{cold_ms:.4f} ms a launch ({cold_n} of 3 recorded), after a warm call "
                  f"{warm_ms:.4f} ms ({warm_n} of 3); err/limit {agree['ratio']:.3g}, "
                  f"bits equal to the first W: {same} [{card}]", flush=True)
        del x, dt, A, B, C, want


if __name__ == "__main__":
    main()
