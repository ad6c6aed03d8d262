"""Where the SSD scan's mma route spends a call, and what mma.sync can give it.

1. The device time of the route's two kernels (``torch.profiler``, the mean
   over 10 calls) at ``ssd_mamba2_780m_b8_s4096_bf16``, chunk 32 (the
   full-width cell's chunk that the wgmma route has no tile for), and at
   every chunk of ``ssd_s256_f32``; beside them the compiler's registers
   and local (spill) bytes of each instantiation they run.
2. The issue rate of ``mma.sync`` on this card: a microbenchmark (built
   here with ``nvcc``) in which 12 warps an SM each keep eight independent
   m16n8k8 TF32 or m16n8k16 bf16 products in flight; cycles a product per
   SM sub-partition, at the card's maximum SM clock.
3. From the two: the products a chunk of the full-width cell issues per SM
   sub-partition (the kernel's own counts: G's share, C . S_prev^T, P . x
   and (x w)^T . B) at that rate, beside the chunk's measured time.

    PYTHONPATH=src python3 scripts/ssd_mma_profile.py

Needs one card; builds the kernels (about 20 s) and runs for a few more.
"""
from __future__ import annotations

import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME, tile_grid
from repro_torch.kernels import _build, conformance
from repro_torch.kernels import ssd_scan as ssd

MMA_RATE_CU = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
template <int BF16>
__global__ void rate(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 3u * threadIdx.x, a2 = 5u * threadIdx.x,
                 a3 = 7u * threadIdx.x, b0 = 11u * threadIdx.x, b1 = 13u * threadIdx.x;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms, khz;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const int blocks = 3 * sms, iters = 4096;  // 3 blocks of 4 warps an SM
  float* out;
  cudaMalloc(&out, blocks * 128 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int bf16 = 0; bf16 < 2; ++bf16) {
    float ms = 0.f;
    for (int rep = 0; rep < 3; ++rep) {  // the last of three
      cudaEventRecord(e0);
      if (bf16) rate<1><<<blocks, 128>>>(out, iters); else rate<0><<<blocks, 128>>>(out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      cudaEventElapsedTime(&ms, e0, e1);
    }
    const double per_smsp = (double)blocks * 4 * iters * 8 / (4.0 * sms);
    const double flop = (double)blocks * 4 * iters * 8 * (bf16 ? 4096 : 2048);
    printf("%s %.4f %.2f %.3f %d\n", bf16 ? "bf16_m16n8k16" : "tf32_m16n8k8", ms,
           ms * 1e-3 * khz * 1e3 / per_smsp, flop / ms / 1e9, khz);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


KERNELS = ("ssd_cumsum_kernel", "ssd_mma_kernel", "ssd_state_kernel", "ssd_intra_kernel")


def device_ms(fn, calls: int = 10) -> dict:
    """Mean device milliseconds per call of each SSD kernel ``fn`` runs."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in KERNELS:
            if name in e.key:
                out[name] = out.get(name, 0.0) + e.device_time_total / calls / 1e3
    return out


def mma_rates() -> dict:
    """{"tf32_m16n8k8" | "bf16_m16n8k16": (cycles a product per SM
    sub-partition, TFLOP/s, max SM clock in kHz)} from the microbenchmark."""
    build = _build.BUILD_DIR / "mma_rate"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "mma_rate.cu"
    src.write_text(MMA_RATE_CU)
    exe = build / "mma_rate"
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-O3", "-o", str(exe), str(src)],
                   check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    rates = {}
    for line in out.splitlines():
        name, _, cycles, tflops, khz = line.split()
        rates[name] = (float(cycles), float(tflops), int(khz))
    return rates


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _build.library()
    full = KERNEL_SHAPE_BY_NAME["ssd_mamba2_780m_b8_s4096_bf16"]
    p = full.params
    inputs = conformance.make_inputs(full, device="cuda")
    assert ssd.route(torch.bfloat16, 32, p["dh"], p["N"]) == "mma"
    split = device_ms(lambda: ssd.ssd_scan_cuda(*inputs, chunk=32))
    walk_ms = split["ssd_mma_kernel"]
    nc = p["s"] // 32
    print(f"{full.name} chunk=32: device ms by kernel {split}; the walk "
          f"{walk_ms / nc * 1e3:.3f} us a chunk; (registers, local bytes) "
          f"{ssd.mma_attributes(p['dh'], p['N'], torch.bfloat16)} [{card}]", flush=True)
    del inputs
    ci = KERNEL_SHAPE_BY_NAME["ssd_s256_f32"]
    inputs = conformance.make_inputs(ci, device="cuda")
    for dims in tile_grid(ci):
        got = device_ms(lambda: ssd.ssd_scan_cuda(*inputs, chunk=dims["chunk"]))
        print(f"{ci.name} {dims}: device ms by kernel {got} [{card}]", flush=True)
    print(f"{ci.name}: (registers, local bytes) "
          f"{ssd.mma_attributes(ci.params['dh'], ci.params['N'], torch.float32)}", flush=True)

    rates = mma_rates()
    for name, (cycles, tflops, khz) in rates.items():
        print(f"mma.sync {name}: {cycles:.2f} cycles a product per SM sub-partition at "
              f"12 warps an SM, {tflops:.1f} TFLOP/s (max SM clock {khz / 1e3:.0f} MHz) "
              f"[{card}]", flush=True)
    # the full-width chunk's bf16 products per warp (ssd_scan_mma.cu): G's
    # share (6 tiles of 8 steps over 4 warps, at most 2 a warp), C . S_prev^T
    # (8 steps x 2 row tiles of 16 x 2 column tiles x 3 parts), P . x (3
    # steps of 16 over the two row tiles x 2 x 3) and (x w)^T . B (2 steps x
    # 16 column tiles x 3 parts); three warps a sub-partition (3 CTAs an SM)
    per_warp = 2 * 8 + 8 * 2 * 2 * 3 + 3 * 2 * 3 + 2 * 16 * 3
    cycles, _, khz = rates["bf16_m16n8k16"]
    issue_us = 3 * per_warp * cycles / (khz * 1e3) * 1e6
    print(f"{full.name} chunk=32: {per_warp} products a warp a chunk, {3 * per_warp} a "
          f"sub-partition, {issue_us:.3f} us of issue at the measured rate and max clock, "
          f"against {walk_ms / nc * 1e3:.3f} us a chunk measured [{card}]", flush=True)


if __name__ == "__main__":
    main()
