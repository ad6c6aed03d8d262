// Mamba2 SSD chunked scan in bf16 on Hopper's tensor cores: one walk over
// the chunks per (batch, head), every product on `wgmma`, the inputs brought
// in by TMA, the carried state in registers.
//
// Replaces, for bf16 inputs at dh = 64, N = 64 or 128 and a chunk of 64, 128
// or 256 (the sizes SSD_WGMMA_CASE below instantiates; the rule is
// repro_torch/kernels/ssd_scan.py::route, whose WGMMA_DH, WGMMA_N and
// WGMMA_CHUNKS list the same sizes), the Pallas kernels of
// src/repro/kernels/ssd_scan.py: _ssd_chunk_kernel (body at 24, pallas_call
// at 82), _ssd_inter_kernel (body at 55, pallas_call at 121) and the
// lax.scan recurrence between them (106-116). Every other call takes
// csrc/ssd_scan.cu (f32 FMAs). Same function: y = y_intra + y_inter rounded
// once to bf16, the final state in f32, `initial_state` threaded in. Three
// values are rounded to bf16: x * w and S_prev (the carried state itself
// stays f32) as tensor-core operands, and y once; ssd_scan_plain rounds at
// the same points on this route. P = G * exp(cs_l - cs_s) * dt_s enters
// P . x as two bf16 parts (hi + lo, ~2^-16): rounded to one bf16, P flipped
// against the plain version's wherever G's sums differed in the last f32
// bit, and at mamba2-780m widths that moved some of y's rows beyond 2^-7 of
// their largest value on the H100.
//
// What bounds it on the H100: bytes. x, dt, B, C read and y, the final state
// written once (~435 MB at mamba2-780m widths, b=8 s=4096 nh=48 dh=64
// N=128), plus cs written and read (2 x 6.3 MB): 0.134 ms at 3.35 TB/s;
// ~148 GFLOP with G recomputed per head over whole 64 x 64 diagonal tiles
// (~169 with P . x twice for P's two parts), 0.17 ms at the bf16 peak. No
// scratch of y's size: y_inter never leaves the registers.
//
// The design. Two launches on one stream:
//  1. ssd_cumsum_kernel (csrc/ssd_scan.cu, unchanged): cs [b,s,nh] f32 in
//     the order repro_torch/kernels/ssd_scan.py::chunk_cumsum adds.
//  2. ssd_wgmma_kernel: one CTA per (batch, head), head fastest, so the
//     heads that run together share a batch's B and C rows in L2. A CTA has
//     consumer warpgroups (one per 64 columns of the state, each holding its
//     columns in registers; at N = 64 a second one without state where two
//     CTAs would not fit an SM) and, last, a producer warp. For each chunk
//     the producer's lanes copy the chunk's cs and dt (strided by nh,
//     fetched a chunk ahead) into the stage, and its lane 0 brings C and B
//     ([b*s, N] maps, 64 x 64 boxes) and x (a [b*s, nh, dh] map, a box of
//     one head and 64 rows) by TMA with a 128-byte swizzle, each 64-row tile
//     on its own `full` mbarrier, so a chunk's first products start while
//     its later tiles are in flight. The consumers walk the chunks in order.
//     Per chunk:
//       - each warpgroup writes its columns of S_prev to shared memory in
//         bf16, the K-major B operand of C . S_prev^T; then S *= exp(cs_L);
//       - the 64-row tiles of the chunk are shared out among the
//         warpgroups (0 1 1 0 at four tiles: five of G's tiles each). Per
//         tile: acc = C_tile . S_prev^T, rows scaled by exp(cs_l) BEFORE any
//         P . x product accumulates (both terms share acc); then for each
//         64-row tile t at or below the diagonal (each G issued with the
//         product before it, one wait per tile), G = C_tile . B_t^T (f32
//         registers), P = G * exp(cs_l - cs_s) * dt_s, masked to 0 where
//         s > l, split into bf16 hi and lo register A operands, and acc +=
//         P_hi . x_t + P_lo . x_t with x the MN-major B operand (dt is folded
//         into P, so x feeds the product straight from TMA); y goes once, in
//         bf16, through the tile's spent C columns in shared memory, so each
//         warp stores whole 128-byte rows;
//       - the chunk's own state: x is scaled in place by w_l = dt_l *
//         exp(cs_L - cs_l) into bf16 and each warpgroup adds (x w)^T . B for
//         its 64 columns, both operands MN-major (wgmma_ss_tt); the stage is
//         released on `empty`.
//     Last the final state is written in f32.
//
// Traps, and what the code does about them:
//  - the decay is never factored as exp(cs_l) * exp(-cs_s): cs_L reaches
//    about -115 at chunk 256 with the conformance inputs and exp(+115)
//    overflows f32. exp(cs_l - cs_s) is taken per (l, s) pair; where s > l
//    it may be inf, and the mask's select drops it before anything else
//    reads it. exp(cs_L) itself underflows to 0 there.
//  - w goes through expf, as torch.exp does, so x * w rounds to the same
//    bf16 as in the plain version: a flipped rounding there moves the f32
//    final state, which is held to 2^-14 of its row. P and the row scaling
//    reach only y (held to 2^-7) and use the SFU's ex2 on cs in log2 units.
//  - registers: a warpgroup's 64 state columns 32 + acc 32 + G 32 + P 32 +
//    addressing; the compiler's count is ssd_scan_wgmma_attributes (printed
//    by chip_smoke.py). One warpgroup holding all 128 columns at N = 128 was
//    slower: one warpgroup an SM leaves the tensor cores idle while it
//    forms P and stores y.
//
// Shared memory (repro_torch/kernels/ssd_scan.py::smem_bytes_wgmma):
//   1024 (alignment slack) + stages * (L * (2 N + dh) * 2 + ceil1024(8 L))
//   + dh * N * 2 (S_prev in bf16) + 8 * stages * (L/64 + 1) (mbarriers),
//   with 2 stages where they fit 227 KB and 1 otherwise (chunk 256 at
//   N = 128: 183,336 B). Two CTAs share an SM where both fit with one
//   consumer warpgroup each (N = 64, chunk 64 and 128).
#include "hopper.cuh"

// csrc/ssd_scan.cu
extern "C" int ssd_cumsum_launch(const void* dt, const void* A, void* cs, long long n_rows,
                                 int L, int nh, int dtype, void* stream);

namespace {

constexpr int DH = 64;  // the head dim this kernel takes
constexpr int SMEM_LIMIT = 232448, SMEM_PER_SM = 233472, SMEM_RESERVED = 1024;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x, the SFU's approximation (flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr int stage_bytes(int L, int N) {
  return L * (2 * N + DH) * 2 + (8 * L + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int smem_with(int L, int N, int stages) {
  return 1024 + stages * stage_bytes(L, N) + DH * N * 2 + 8 * stages * (L / 64 + 1);
}
__host__ __device__ constexpr int stages_for(int L, int N) {
  return smem_with(L, N, 2) <= SMEM_LIMIT ? 2 : 1;
}
__host__ __device__ constexpr int ssd_smem(int L, int N) {
  return smem_with(L, N, stages_for(L, N));
}
__host__ __device__ constexpr bool two_ctas_fit(int L, int N) {
  return 2 * (ssd_smem(L, N) + SMEM_RESERVED) <= SMEM_PER_SM;
}

// consumer warpgroups: one per 64 columns of the state, which each holds in
// registers; at N = 64 a second one (holding no state, sharing the row tiles)
// where two CTAs of one warpgroup would not fit an SM's shared memory
__host__ __device__ constexpr int consumer_wgs(int L, int N) {
  return N >= 128 ? N / 64 : (two_ctas_fit(L, N) ? 1 : 2);
}
// the consumer warpgroups and the producer warp
__host__ __device__ constexpr int ssd_threads(int L, int N) {
  return 128 * consumer_wgs(L, N) + 32;
}
// the consumer warpgroup that computes row tile i of a chunk: with two, the
// tiles go 0 1 1 0, so each takes an equal share of the (i + 1) tiles of G
// and P . x a row tile walks at chunk 256
__host__ __device__ constexpr int row_owner(int i, int nwg) {
  return nwg == 1 ? 0 : ((i & 1) ^ ((i >> 1) & 1));
}
// two CTAs an SM where both fit shared memory and still leave a thread 168
// registers (one consumer warpgroup, N = 64)
__host__ __device__ constexpr int min_blocks(int L, int N) {
  return two_ctas_fit(L, N) && 65536 / (2 * ssd_threads(L, N)) >= 168 ? 2 : 1;
}

template <int N, int L>
__global__ void __launch_bounds__(ssd_threads(L, N), min_blocks(L, N))
    ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const __nv_bfloat16* __restrict__ dt, const float* __restrict__ cs,
                     const float* __restrict__ s0, __nv_bfloat16* __restrict__ y,
                     float* __restrict__ s_final, int s, int nh) {
  constexpr int STAGES = stages_for(L, N);
  constexpr int NWG = consumer_wgs(L, N);  // warpgroup w holds S columns 64w..64w+63
  constexpr int CONSUMERS = 128 * NWG;
  constexpr int T = L / 64;  // 64-row tiles of a chunk
  constexpr int CB_BYTES = L * N * 2, X_BYTES = L * DH * 2;
  constexpr int TILE_TX = 64 * (2 * N + DH) * 2;  // C, B and x bytes of one row tile
  constexpr int STAGE = stage_bytes(L, N);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // `base` as a generic pointer
  const uint32_t sS = base + STAGES * STAGE;
  // full[st][tt]: row tile tt of stage st has landed; empty[st]: stage st is free
  const uint32_t full0 = sS + DH * N * 2, empty0 = full0 + 8 * STAGES * T;

  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const int nc = s / L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      for (int tt = 0; tt < T; ++tt) mbar_init(full0 + 8 * (st * T + tt), 1);
      mbar_init(empty0 + 8 * st, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp
    // a chunk's cs and dt (strided by nh), L / 32 of each per lane, fetched
    // into registers one chunk ahead so their latency hides behind the wait
    // for a free stage
    float cv[L / 32], dv[L / 32];
    auto fetch = [&](int c) {
      const long long row0 = (long long)bi * s + (long long)c * L;
#pragma unroll
      for (int q = 0; q < L / 32; ++q) {
        const long long idx = (row0 + lane + 32 * q) * nh + h;
        cv[q] = cs[idx];
        dv[q] = __bfloat162float(dt[idx]);
      }
    };
    fetch(0);
    for (int c = 0; c < nc; ++c) {
      const int st = c % STAGES;
      if (c >= STAGES) mbar_wait(empty0 + 8 * st, ((c / STAGES) - 1) & 1);
      float* scs = reinterpret_cast<float*>(gbase + st * STAGE + 2 * CB_BYTES + X_BYTES);
#pragma unroll
      for (int q = 0; q < L / 32; ++q) {
        scs[lane + 32 * q] = cv[q];
        scs[L + lane + 32 * q] = dv[q];
      }
      __syncwarp();  // the lanes' writes before lane 0's release on full[st][0]
      if (lane == 0) {
        const uint32_t sb = base + st * STAGE;
        const int row0 = bi * s + c * L;
        // one barrier per 64-row tile, so row tile 0's products start while
        // the later tiles are still on their way
        for (int tt = 0; tt < T; ++tt) {
          const uint32_t full = full0 + 8 * (st * T + tt);
          const int r0 = row0 + 64 * tt;
          mbar_expect_tx(full, TILE_TX);
#pragma unroll
          for (int cn = 0; cn < N / 64; ++cn) {
            tma_load_2d(sb + cn * L * 128 + tt * 64 * 128, &tc, full, 64 * cn, r0);
            tma_load_2d(sb + CB_BYTES + cn * L * 128 + tt * 64 * 128, &tb, full, 64 * cn, r0);
          }
          tma_load_3d(sb + 2 * CB_BYTES + tt * 64 * 128, &tx, full, 0, h, r0);
        }
      }
      if (c + 1 < nc) fetch(c + 1);
      __syncwarp();
    }
    return;
  }

  // ---- the consumer warpgroups: wg holds state columns 64 wg .. 64 wg + 63
  // (where N has them) and computes the row tiles i with row_owner(i) == wg
  const int wg = warp / 4, ctid = threadIdx.x;  // ctid: 0 .. CONSUMERS - 1
  const int r = 16 * (warp % 4) + lane / 4;  // this thread's rows of a 64-row tile: r and r + 8
  const int cq = 2 * (lane % 4);
  const long long srow = ((long long)bi * nh + h) * DH;  // row p = 0 of this head's state
  // whether this warpgroup holds state columns (known at compile time
  // unless a second warpgroup was added at N = 64)
  const bool holds = NWG * 64 == N || wg * 64 < N;
  float S[32];  // S[p][64 wg + n'], the accumulator layout
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int p = r + 8 * ((i >> 1) & 1), n = 64 * wg + 8 * (i / 4) + cq;
    float2 v = make_float2(0.f, 0.f);
    if (holds && s0 != nullptr) v = *reinterpret_cast<const float2*>(s0 + (srow + p) * N + n);
    S[i] = v.x;
    S[i + 1] = v.y;
  }

  for (int c = 0; c < nc; ++c) {
    const int st = c % STAGES;
    const uint32_t sC = base + st * STAGE, sB = sC + CB_BYTES, sX = sB + CB_BYTES;
    uint8_t* const gX = gbase + st * STAGE + 2 * CB_BYTES;
    const float* scs = reinterpret_cast<const float*>(gX + X_BYTES);
    const float* sdt = scs + L;
    const int parity = (c / STAGES) & 1;

    // S_prev in bf16, rows p and columns n: the K-major B operand of
    // C . S_prev^T; every warpgroup writes its columns. The last chunk's
    // readers of S_prev finished before the barrier ahead of x * w.
    if (holds) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int p = r + 8 * ((i >> 1) & 1), n = 64 * wg + 8 * (i / 4) + cq;
        *reinterpret_cast<uint32_t*>(gbase + (sS - base) + swz128(p, n, 64)) =
            pack_bf16(S[i], S[i + 1]);
      }
    }
    fence_proxy_async();
    named_sync(1, CONSUMERS);
    mbar_wait(full0 + 8 * (st * T), parity);  // row tile 0, and the chunk's cs and dt
    int landed = 1;                           // row tiles this warpgroup has waited for
    const float cs_end = scs[L - 1];
    const float decay = expf(cs_end);
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] *= decay;

#pragma unroll 1
    for (int i = 0; i < T; ++i) {
      if (row_owner(i, NWG) != wg) continue;
      for (; landed <= i; ++landed) mbar_wait(full0 + 8 * (st * T + landed), parity);
      const uint32_t cbase = sC + i * 64 * 128;
      // one group: the inter-chunk term acc = C_tile . S_prev^T and the
      // first G = C_tile . B_0^T, both reading the C tile
      float acc[32], g[32];
      fence_regs(acc);
      fence_regs(g);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t dc = desc128(cbase + (kk / 4) * L * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_ss(acc, dc, desc128(sS + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
        wgmma_ss(g, dc, desc128(sB + (kk / 4) * L * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      }
      wgmma_commit();
      // this thread's rows' cs, in log2 units for ex2
      const float cl2[2] = {scs[64 * i + r] * LOG2E, scs[64 * i + r + 8] * LOG2E};
      const float el[2] = {ex2(cl2[0]), ex2(cl2[1])};
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(g);
      // rows times exp(cs_l) before any P . x product accumulates
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] *= el[(j >> 1) & 1];

      // intra-chunk term over the 64-row tiles t <= i; G(t) is in g
      uint32_t phi[4][4], plo[4][4];
      // P for tile t from g, split into two bf16 parts, hi = bf16(P) and
      // lo = bf16(P - hi), the register A fragments of P . x: together they
      // carry P to ~2^-16, so a rounding of P that flips with the order of
      // G's sum cannot move y (see the header). `diag`: mask s > l.
      auto p_tile = [&](int t, bool diag) {
        // this thread's 16 columns of tile t: cs in log2 units, dt
        float c2[16], dts[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 cv = *reinterpret_cast<const float2*>(scs + 64 * t + 8 * jj + cq);
          const float2 dv = *reinterpret_cast<const float2*>(sdt + 64 * t + 8 * jj + cq);
          c2[2 * jj] = cv.x * LOG2E;
          c2[2 * jj + 1] = cv.y * LOG2E;
          dts[2 * jj] = dv.x;
          dts[2 * jj + 1] = dv.y;
        }
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int hh = (j >> 1) & 1, row = r + 8 * hh, col = 8 * (j / 4) + cq;
          const int k = 2 * (j / 4);  // c2 and dts of columns col and col + 1
          // exp(cs_l - cs_s), never exp(cs_l) * exp(-cs_s); where s > l the
          // argument may be large and its exp inf, and the select drops it
          float p0 = g[j] * dts[k] * ex2(cl2[hh] - c2[k]);
          float p1 = g[j + 1] * dts[k + 1] * ex2(cl2[hh] - c2[k + 1]);
          if (diag && col > row) p0 = 0.f;
          if (diag && col + 1 > row) p1 = 0.f;
          // registers 8k..8k+7 hold columns 16k..16k+15: the A fragment's order
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          phi[j / 8][(j % 8) / 2] = *reinterpret_cast<const uint32_t*>(&hi);
          plo[j / 8][(j % 8) / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }
      };
      // acc += P . x_t
      auto px = [&](int t) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dx = desc128(sX + t * 64 * 128 + kk * 2048, 1024, 1024);
          wgmma_rs(acc, phi[kk], dx);
          wgmma_rs(acc, plo[kk], dx);
        }
      };
#pragma unroll 1
      for (int t = 0; t < i; ++t) {  // below the diagonal: no mask
        p_tile(t, false);
        // one group: acc += P . x_t, and G(t+1) while P's registers are read
        fence_regs(acc);
        fence_regs(g);
        wgmma_fence();
        px(t);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          wgmma_ss(g, desc128(cbase + (kk / 4) * L * 128 + (kk % 4) * 32, 16, 1024),
                   desc128(sB + (kk / 4) * L * 128 + (t + 1) * 64 * 128 + (kk % 4) * 32, 16,
                           1024),
                   kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(g);
      }
      p_tile(i, true);  // the diagonal tile
      fence_regs(acc);
      wgmma_fence();
      px(i);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);

      // y, once, in bf16: through shared memory (the first 64 columns of
      // this row tile's C, which no product reads any more), so each warp
      // stores whole 128-byte rows
      uint8_t* const stage_y = gbase + (cbase - base);
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int row = r + 8 * ((j >> 1) & 1), col = 8 * (j / 4) + cq;
        *reinterpret_cast<uint32_t*>(stage_y + swz128(row, col, 64)) =
            pack_bf16(acc[j], acc[j + 1]);
      }
      named_sync(2 + wg, 128);
      const long long row0 = (long long)bi * s + (long long)c * L + 64 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // 16-byte units: 8 per row, 4 per thread
        const int u = (ctid - 128 * wg) + 128 * k, row = u / 8, q = u % 8;
        *reinterpret_cast<uint4*>(y + ((row0 + row) * nh + h) * DH + 8 * q) =
            *reinterpret_cast<const uint4*>(stage_y + swz128(row, 8 * q, 64));
      }
    }

    // the chunk's own state: x * w in place (w_l = dt_l exp(cs_L - cs_l)),
    // then S += (x w)^T . B, each warpgroup for its 64 columns of B
    for (; landed < T; ++landed) mbar_wait(full0 + 8 * (st * T + landed), parity);
    named_sync(1, CONSUMERS);  // every warpgroup's products have read x and S_prev
    for (int u = ctid; u < L * 8; u += CONSUMERS) {  // 16-byte units, 8 per row
      const int l = u / 8;
      const float w = sdt[l] * expf(cs_end - scs[l]);
      uint4 v = *reinterpret_cast<uint4*>(gX + u * 16);
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(e[q]);
        e[q] = __floats2bfloat162_rn(f.x * w, f.y * w);
      }
      *reinterpret_cast<uint4*>(gX + u * 16) = v;
    }
    fence_proxy_async();  // before wgmma reads x w, and before TMA refills the stage
    named_sync(1, CONSUMERS);
    if (holds) {
      fence_regs(S);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        wgmma_ss_tt(S, desc128(sX + kk * 2048, 1024, 1024),
                    desc128(sB + wg * L * 128 + kk * 2048, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(S);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  if (holds) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int p = r + 8 * ((i >> 1) & 1), n = 64 * wg + 8 * (i / 4) + cq;
      *reinterpret_cast<float2*>(s_final + (srow + p) * N + n) = make_float2(S[i], S[i + 1]);
    }
  }
}

template <int N, int L>
int launch(const void* x, const void* dt, const void* B, const void* C, const void* s0,
           const void* cs, void* y, void* s_final, int b, int s, int nh, int smem,
           cudaStream_t st) {
  if (smem < ssd_smem(L, N)) return (int)cudaErrorInvalidValue;
  auto kern = ssd_wgmma_kernel<N, L>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)e;
  }
  const cuuint64_t rows = (cuuint64_t)b * s;
  const cuuint64_t xdims[3] = {DH, (cuuint64_t)nh, rows};
  const cuuint64_t xstr[2] = {DH * 2, (cuuint64_t)nh * DH * 2};
  const cuuint32_t xbox[3] = {64, 1, 64};
  const cuuint64_t bdims[2] = {N, rows};
  const cuuint64_t bstr[1] = {N * 2};
  const cuuint32_t bbox[2] = {64, 64};
  CUtensorMap tx, tb, tc;
  if (!tma_map_bf16(&tx, x, 3, xdims, xstr, xbox) || !tma_map_bf16(&tb, B, 2, bdims, bstr, bbox) ||
      !tma_map_bf16(&tc, C, 2, bdims, bstr, bbox))
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)(b * nh), ssd_threads(L, N), smem, st>>>(
      tx, tb, tc, (const __nv_bfloat16*)dt, (const float*)cs, (const float*)s0,
      (__nv_bfloat16*)y, (float*)s_final, s, nh);
  return (int)cudaGetLastError();
}

template <int N, int L>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, ssd_wgmma_kernel<N, L>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// calls f.template operator()<N, L>() for an instantiated size, else returns
// cudaErrorInvalidValue
template <typename F>
int dispatch(int dh, int n, int l, F f) {
#define SSD_WGMMA_CASE(DH_, N_, L_)                     \
  static_assert(DH_ == DH, "the kernel takes dh = 64"); \
  if (dh == DH_ && n == N_ && l == L_) return f.template operator()<N_, L_>();
  SSD_WGMMA_CASE(64, 64, 64)
  SSD_WGMMA_CASE(64, 64, 128)
  SSD_WGMMA_CASE(64, 64, 256)
  SSD_WGMMA_CASE(64, 128, 64)
  SSD_WGMMA_CASE(64, 128, 128)
  SSD_WGMMA_CASE(64, 128, 256)
#undef SSD_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

struct Launch {
  const void *x, *dt, *B, *C, *s0, *cs;
  void *y, *s_final;
  int b, s, nh, smem;
  cudaStream_t st;
  template <int N, int L>
  int operator()() const {
    return launch<N, L>(x, dt, B, C, s0, cs, y, s_final, b, s, nh, smem, st);
  }
};

struct Attr {
  int *regs, *local_bytes;
  template <int N, int L>
  int operator()() const {
    return attributes<N, L>(regs, local_bytes);
  }
};

// 0 for an instantiated size, for dispatch
struct Has {
  template <int N, int L>
  int operator()() const {
    return 0;
  }
};

}  // namespace

// x [b,s,nh,dh], dt [b,s,nh], B and C [b,s,N] in bf16, A [nh] f32, s0
// [b,nh,dh,N] f32 or null; cs [b,s,nh] f32 is the cumsum's output; y in
// bf16 and s_final [b,nh,dh,N] f32 are written
extern "C" int ssd_scan_wgmma_launch(const void* x, const void* dt, const void* A,
                                     const void* B, const void* C, const void* s0, void* cs,
                                     void* y, void* s_final, int b, int s, int nh, int dh,
                                     int N, int L, int threads, int smem, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || L <= 0 || s % L != 0 || threads != ssd_threads(L, N) ||
      (long long)b * s > 0x7fffffffLL || (long long)b * nh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Launch f{x, dt, B, C, s0, cs, y, s_final, b, s, nh, smem, (cudaStream_t)stream};
  if (dispatch(dh, N, L, Has{}) != 0) return (int)cudaErrorInvalidValue;
  const int e = ssd_cumsum_launch(dt, A, cs, (long long)b * (s / L), L, nh, DTYPE_BF16, stream);
  if (e != 0) return e;
  return dispatch(dh, N, L, f);
}

// the compiler's registers per thread and local (spill) bytes at one size
extern "C" int ssd_scan_wgmma_attributes(int dh, int N, int L, int* regs, int* local_bytes) {
  return dispatch(dh, N, L, Attr{regs, local_bytes});
}
