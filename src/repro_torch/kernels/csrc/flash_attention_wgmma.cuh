// The wgmma flash kernel (flash_wgmma_kernel) and its host helpers: the
// template, the tensor maps and its launch, shared by two translation units
// so that nvcc builds them in parallel. csrc/flash_attention_wgmma.cu holds
// the design notes, the instantiations at head dims 64 and 128, the
// dispatch and the C entry points; csrc/flash_attention_wgmma_padded.cu
// those at d below 64 and 65-120 (zero-padded to 64 and 128), and
// csrc/flash_attention_wgmma_wide.cu those at DP 256.
#pragma once

#include "hopper.cuh"

namespace flash_wgmma {

constexpr int STAGES = 2;
constexpr int MAX_PASS = 128;  // q rows of a pass, at most
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = -1e30f * LOG2E;  // the -1e30 mask in log2 units

// registers a thread of a consumer and of the producer warpgroup, where the
// producer is a warpgroup (producer_threads): the CTA's 65,536 split with
// setmaxnreg, 2 x 128 x 232 + 128 x 40 = 64,512
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// the producer's threads: one warp, or a whole warpgroup at DP 256 with
// passes of 128 rows, so that it can give its registers to the two consumer
// warpgroups (setmaxnreg acts on warpgroups): 288 threads would leave 168
// registers a thread as the compiler allocates them (in warpgroups), and O
// alone takes 128
__host__ __device__ constexpr int producer_threads(int dp, int qp) {
  return dp > 128 && qp > 64 ? 128 : 32;
}
__host__ __device__ constexpr int wgmma_threads(int dp, int qp) {
  return (qp / 64) * 128 + producer_threads(dp, qp);
}
__host__ __device__ constexpr int wgmma_smem(int dp, int qp, int ks) {
  return 1024 + 2 * dp * (qp + 2 * STAGES * ks) + 8 * (2 + 2 * STAGES);
}
// keys of a K/V sub-tile, at most: 128, or 64 at DP 256, where O takes 128
// registers a thread
__host__ __device__ constexpr int max_sub_keys(int dp) { return dp > 128 ? 64 : 128; }
// the instantiated head dim a call's d is zero-padded to, 0 where none
// takes it (TMA needs row strides of a multiple of 16 bytes: d % 8 == 0)
__host__ __device__ constexpr int padded_d(int d) {
  return d <= 0 || d % 8 != 0 ? 0 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

// steps a pass takes through the K/V ring: its nk sub-tiles, and for every
// pass but the last as many empty steps as bring the count to a multiple of
// 2 * STAGES, so that each pass starts with both stages at phase 0
__device__ __forceinline__ int ring_steps(int nk, int i, int passes) {
  return i + 1 < passes ? (nk + 2 * STAGES - 1) / (2 * STAGES) * (2 * STAGES) : nk;
}

// Accumulator fragment of one m64n64 wgmma, thread t of the warpgroup,
// register i (0..31): row 16 * (warp % 4) + lane / 4 + 8 * ((i >> 1) & 1),
// column 8 * (i / 4) + 2 * (lane % 4) + (i & 1).
// D is the padded head dim: the tensor maps span the call's d columns, so
// TMA fills columns d .. D-1 of q, K and V with zeros. PADDED (d < D) writes
// the first d columns of each output row at a row stride of d; without it
// the epilogue is the one of d == D, with no test a column (a runtime
// stride and a test a column made d 128 up to 7% slower at (128, 128) as
// the compiler scheduled the hot loop; scripts/flash_build_compare.py).
template <int D, int QP, int KS, bool PADDED>
__global__ void __launch_bounds__(wgmma_threads(D, QP), 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int sq, int sk, int h, int kh, int d, int bq, int causal, int q_offset,
                       float scale_log2) {
  constexpr int NWG = QP / 64;  // consumer warpgroups
  constexpr int DC = D / 64;    // 64-column (128-byte) chunks of a row
  constexpr int NB = KS / 64;   // 64-key blocks of a K sub-tile
  constexpr int Q_BYTES = QP * D * 2, KV_BYTES = KS * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + Q_BYTES, sV = sK + STAGES * KV_BYTES;
  const uint32_t q_full = sV + STAGES * KV_BYTES, q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8, empty0 = full0 + 8 * STAGES;

  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int bi = bh / h, head = bh % h, kvh = head / (h / kh);
  const int q0 = qt * bq, passes = bq / QP;
  // sub-tiles pass p walks: all, or with causal and q_offset >= 0 those up
  // to the last one its last row can see
  const bool skip = causal && q_offset >= 0;
  auto walk = [&](int p) {
    const int n = sk / KS;
    return skip ? (int)min((long long)n, ((long long)q_offset + q0 + p * QP + QP - 1) / KS + 1)
                : n;
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * NWG);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  constexpr bool SPLIT_REGS = producer_threads(D, QP) == 128;
  if (SPLIT_REGS ? warp >= 4 * NWG : warp == 4 * NWG) {  // the producer
    if constexpr (SPLIT_REGS) setmaxnreg_dec<PRODUCER_REGS>();
    if (lane == 0 && (!SPLIT_REGS || warp == 4 * NWG)) {  // one lane issues every copy
      for (int i = 0; i < passes; ++i) {
        const int p = passes - 1 - i;  // the last pass walks furthest
        if (i > 0) mbar_wait(q_empty, (i - 1) & 1);
        mbar_expect_tx(q_full, Q_BYTES);
        for (int c = 0; c < DC; ++c)
          tma_load_3d(sQ + c * QP * 128, &tq, q_full, 64 * c, head, bi * sq + q0 + p * QP);
        const int nk = walk(p), steps = ring_steps(nk, i, passes);
        for (int t = 0; t < steps; ++t) {
          const int s = t % STAGES;
          if (i > 0 || t >= STAGES) mbar_wait(empty0 + 8 * s, ((t / STAGES) - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          if (t >= nk) {  // a step that only keeps the ring's phases even
            mbar_arrive(full);
            continue;
          }
          mbar_expect_tx(full, 2 * KV_BYTES);
          for (int c = 0; c < DC; ++c) {
            tma_load_3d(sK + s * KV_BYTES + c * KS * 128, &tk, full, 64 * c, kvh,
                        bi * sk + t * KS);
            tma_load_3d(sV + s * KV_BYTES + c * KS * 128, &tv, full, 64 * c, kvh,
                        bi * sk + t * KS);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup `wg`: rows wg*64 .. wg*64+63 of each pass
  if constexpr (SPLIT_REGS) setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;  // this thread's rows: r and r + 8
  const int cq = 2 * (lane % 4);
  const uint32_t qbase = sQ + wg * 64 * 128;
  for (int i = 0; i < passes; ++i) {
    const int p = passes - 1 - i;
    const int row0 = q0 + p * QP + 64 * wg;  // the warpgroup's row 0 in the sequence
    const int qpos0 = q_offset + row0;       // its query position
    const int nk = walk(p);
    float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
    float oacc[DC][32];
#pragma unroll
    for (int nb = 0; nb < DC; ++nb)
#pragma unroll
      for (int j = 0; j < 32; ++j) oacc[nb][j] = 0.f;

    mbar_wait(q_full, i & 1);
    int t = 0;
    for (; t < nk; ++t) {
      const int s = t % STAGES;
      mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
      const uint32_t kb = sK + s * KV_BYTES, vb = sV + s * KV_BYTES;

      // S = Q K^T: K steps of 16 columns, 4 per 128-byte chunk
      float sacc[NB][32];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(sacc[nb]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = desc128(qbase + (kk / 4) * QP * 128 + (kk % 4) * 32, 16, 1024);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const uint64_t db =
              desc128(kb + (kk / 4) * KS * 128 + nb * 64 * 128 + (kk % 4) * 32, 16, 1024);
          wgmma_ss(sacc[nb], da, db, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(sacc[nb]);

      // online softmax in log2 units, two rows per thread
      const bool diag = causal && (t * KS + KS - 1 > qpos0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int hh = (j >> 1) & 1;
          float v = sacc[nb][j] * scale_log2;
          if (diag && qpos0 + r + 8 * hh < t * KS + nb * 64 + 8 * (j / 4) + cq + (j & 1))
            v = NEG2;
          sacc[nb][j] = v;
          mx[hh] = fmaxf(mx[hh], v);
        }
      float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        corr[hh] = exp2f(m[hh] - mx[hh]);
        m[hh] = mx[hh];
      }
      uint32_t pf[KS / 16][4];  // P in bf16: the A fragments of the P.V wgmma
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int hh = (j >> 1) & 1;
          const float p0 = exp2f(sacc[nb][j] - mx[hh]);
          const float p1 = exp2f(sacc[nb][j + 1] - mx[hh]);
          lsum[hh] += p0 + p1;
          // registers 8k..8k+7 of a 64-key block hold keys 16k..16k+15:
          // (r, c), (r+8, c), (r, c+8), (r+8, c+8) pairs, the A fragment's order
          pf[nb * 4 + j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + lsum[hh];
#pragma unroll
      for (int nb = 0; nb < DC; ++nb)
#pragma unroll
        for (int j = 0; j < 32; ++j) oacc[nb][j] *= corr[(j >> 1) & 1];

      // O += P V: V is keys x d (MN-major), 16 keys (2048 bytes) per step
#pragma unroll
      for (int nb = 0; nb < DC; ++nb) fence_regs(oacc[nb]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
        for (int nb = 0; nb < DC; ++nb)
          wgmma_rs(oacc[nb], pf[kk], desc128(vb + nb * KS * 128 + kk * 2048, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < DC; ++nb) fence_regs(oacc[nb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    if (lane == 0) mbar_arrive(q_empty);  // the pass is done with its q rows
    for (const int steps = ring_steps(nk, i, passes); t < steps; ++t) {
      const int s = t % STAGES;
      mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // l was summed per thread over its own columns: add up the quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      if (l[hh] == 0.f) l[hh] = 1.f;
    }
    // PADDED: the first d columns; d is a multiple of 8, so a thread's
    // column pair 8 * j + cq, + 1 lies wholly below d or wholly at or above
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = (long long)bi * sq + row0 + r + 8 * hh;
      __nv_bfloat16* orow = o + (row * h + head) * (PADDED ? d : D);
#pragma unroll
      for (int nb = 0; nb < DC; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (PADDED && nb * 64 + 8 * j >= d) continue;
          const float v0 = oacc[nb][4 * j + 2 * hh] / l[hh];
          const float v1 = oacc[nb][4 * j + 2 * hh + 1] / l[hh];
          *reinterpret_cast<__nv_bfloat162*>(orow + nb * 64 + 8 * j + cq) =
              __floats2bfloat162_rn(v0, v1);
        }
    }
  }
}

// a [rows, heads, d] bf16 tensor as a 3-D map; box: 64 columns, one head,
// `box_rows` rows, 128-byte swizzle. Columns of a box at d and above lie out
// of bounds and arrive as zeros (a box wholly above d too); the copy still
// completes a box's full bytes on its mbarrier
inline bool make_map(CUtensorMap* map, const void* ptr, long long rows, int heads, int d,
                     int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  return tma_map_bf16(map, ptr, 3, dims, strides, box);
}

template <int D, int QP, int KS, bool PADDED>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h,
           int kh, int d, int bq, int causal, int q_offset, float scale, int threads, int smem,
           cudaStream_t s) {
  constexpr int SMEM = wgmma_smem(D, QP, KS);
  if (threads != wgmma_threads(D, QP) || smem < SMEM || padded_d(d) != D || PADDED != (d < D))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<D, QP, KS, PADDED>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)e;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, (long long)b * sq, h, d, QP) ||
      !make_map(&tk, k, (long long)b * sk, kh, d, KS) ||
      !make_map(&tv, v, (long long)b * sk, kh, d, KS))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * h), (unsigned)(sq / bq));
  kern<<<grid, threads, smem, s>>>(tq, tk, tv, (__nv_bfloat16*)o, sq, sk, h, kh, d, bq, causal,
                                   q_offset, (float)((double)scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

template <int D, int QP, int KS, bool PADDED>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, flash_wgmma_kernel<D, QP, KS, PADDED>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// PREFIX empty: an explicit instantiation; `extern`: its declaration, for
// the unit that dispatches to an instantiation made in another
#define FLASH_WGMMA_INSTANCES(PREFIX, D, QP, KS, PADDED)                                      \
  PREFIX template int launch<D, QP, KS, PADDED>(const void*, const void*, const void*, void*,   \
                                                int, int, int, int, int, int, int, int, int,   \
                                                float, int, int, cudaStream_t);                \
  PREFIX template int attributes<D, QP, KS, PADDED>(int*, int*);

}  // namespace flash_wgmma
