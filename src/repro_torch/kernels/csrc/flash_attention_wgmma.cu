// Blockwise (flash) attention for bf16 on Hopper's tensor cores: both
// products on `wgmma`, K/V tiles brought in by TMA.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention(), lines 24-103) for bf16 inputs at d = 64 and d = 128
// with block_q and block_k of 64 or 128, the tiles FLASH_WGMMA_CASE below
// instantiates; f32 inputs, any other d and any other tile take
// csrc/flash_attention.cu (the rule is
// repro_torch/kernels/flash_attention.py::route, whose WGMMA_D and
// WGMMA_BLOCKS list the same tiles). Same function: q
// [b, sq, h, d], k and v [b, sk, kh, d], GQA (query head `hd` reads KV head
// `hd / (h / kh)`), scores scaled by 1/sqrt(d) in f32, causal keeps
// q_offset + i >= j, masked scores are -1e30 (so a fully masked row
// averages V), m, l and the accumulator in f32, an l == 0 -> 1 guard, output
// in bf16. P is rounded to bf16 for the P.V product, as every Hopper flash
// kernel does; l is summed from the f32 P. The plain version
// (flash_attention_plain) rounds P the same way for bf16 inputs.
//
// What bounds it on the H100: operations. 4 * d FLOP per (query, key) pair
// that the mask keeps, ~1,000 FLOP per byte at llama3-8b widths, far above
// the bf16 ridge of ~295; the least time is FLOP / 989e12 s.
//
// What the design does about it: one CTA per (b*h, q tile of BQ rows), the
// longest causal q tiles launched first. Warps 0 .. 4*BQ/64-1 are consumer
// warpgroups of 64 query rows each; the last warp is the producer. The
// producer's lane 0 loads the q tile once and then the K and V tiles through
// a ring of STAGES = 2 stages with cp.async.bulk.tensor (3-D maps over
// [b*s, heads, d] with a box of one head, 64 columns = 128 bytes per box,
// 128-byte swizzle), each stage's completion on an mbarrier (`full`), its
// release by the consumers on another (`empty`), so the next tile's load
// overlaps this tile's math. Each consumer warpgroup computes S = Q.K^T with
// wgmma.m64n64k16 (both operands K-major in shared memory, S in registers),
// scales S by log2(e)/sqrt(d) in f32, masks only the tiles that cross the
// diagonal, and runs the online softmax row-parallel in registers: each
// thread owns two rows of its fragment, reduces max over its quad with
// shuffles and takes exp2f. P goes to bf16 in registers and is the register
// A operand of the P.V wgmma, V the shared-memory B operand with the
// transpose bit (V is keys x d, MN-major). With causal and q_offset >= 0
// the walk stops after the last K tile the q tile can see (the skipped
// tiles would add exactly 0). No intermediate reaches device memory.
//
// Shared memory (repro_torch/kernels/flash_attention.py::smem_bytes_wgmma):
//   1024 (alignment slack) + 2 * d * (bq + 2 * STAGES * bk) + 8 * (1 + 2 * STAGES)
//   bytes: the q tile, STAGES K and V tiles in bf16, and the mbarriers.
// Threads: 128 * bq / 64 + 32.
// Registers per thread (resource_model.py::flash_wgmma_registers, a model
//   used only for blocks per SM; the compiler's count is
//   flash_attention_wgmma_attributes): bk / 2 (S) + d / 2 (O) + bk / 4 (P in
//   bf16) + 48, rounded up to 8. Larger tiles do not fit: at bk = 256, S, O
//   and P alone take 128 + d / 2 + 64 registers; at bq = 256, 544 threads
//   leave 120 each.
// Resource model (resource_model.py::flash_attention_resources): as for the
//   FMA kernel, but the compute term runs at peak_flops_bf16 and blocks per
//   SM also divide the SM's 65,536 registers. Every tile this route takes is
//   instantiated, so it is feasible when its shared memory fits.
#include "hopper.cuh"

namespace {

constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = -1e30f * LOG2E;  // the -1e30 mask in log2 units

__host__ __device__ constexpr int wgmma_threads(int bq) { return (bq / 64) * 128 + 32; }
__host__ __device__ constexpr int wgmma_smem(int d, int bq, int bk) {
  return 1024 + 2 * d * (bq + 2 * STAGES * bk) + 8 * (1 + 2 * STAGES);
}

// Accumulator fragment of one m64n64 wgmma, thread t of the warpgroup,
// register i (0..31): row 16 * (warp % 4) + lane / 4 + 8 * ((i >> 1) & 1),
// column 8 * (i / 4) + 2 * (lane % 4) + (i & 1).
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(wgmma_threads(BQ), 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int sq, int sk, int h, int kh, int causal, int q_offset,
                       float scale_log2) {
  constexpr int NWG = BQ / 64;  // consumer warpgroups
  constexpr int DC = D / 64;    // 64-column (128-byte) chunks of a row
  constexpr int NB = BK / 64;   // 64-key blocks of a K tile
  constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + Q_BYTES, sV = sK + STAGES * KV_BYTES;
  const uint32_t q_full = sV + STAGES * KV_BYTES;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int bi = bh / h, head = bh % h, kvh = head / (h / kh);
  const int q0 = qt * BQ;
  int nk = sk / BK;
  if (causal && q_offset >= 0)
    nk = (int)min((long long)nk, ((long long)q_offset + q0 + BQ - 1) / BK + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int c = 0; c < DC; ++c)
        tma_load_3d(sQ + c * BQ * 128, &tq, q_full, 64 * c, head, bi * sq + q0);
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty0 + 8 * s, ((t / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * KV_BYTES);
        for (int c = 0; c < DC; ++c) {
          tma_load_3d(sK + s * KV_BYTES + c * BK * 128, &tk, full, 64 * c, kvh, bi * sk + t * BK);
          tma_load_3d(sV + s * KV_BYTES + c * BK * 128, &tv, full, 64 * c, kvh, bi * sk + t * BK);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup `wg`: query rows wg*64 .. wg*64+63 of the tile
  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;  // this thread's rows: r and r + 8
  const int cq = 2 * (lane % 4);
  const int qpos0 = q_offset + q0 + 64 * wg;  // query position of the warpgroup's row 0
  const uint32_t qbase = sQ + wg * 64 * 128;
  float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
  float oacc[DC][32];
#pragma unroll
  for (int nb = 0; nb < DC; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[nb][i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < nk; ++t) {
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
      const uint64_t da = desc128(qbase + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint64_t db =
            desc128(kb + (kk / 4) * BK * 128 + nb * 64 * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_ss(sacc[nb], da, db, kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(sacc[nb]);

    // online softmax in log2 units, two rows per thread
    const bool diag = causal && (t * BK + BK - 1 > qpos0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float v = sacc[nb][i] * scale_log2;
        if (diag && qpos0 + r + 8 * hh < t * BK + nb * 64 + 8 * (i / 4) + cq + (i & 1))
          v = NEG2;
        sacc[nb][i] = v;
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
    uint32_t pf[BK / 16][4];  // P in bf16: the A fragments of the P.V wgmma
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hh = (i >> 1) & 1;
        const float p0 = exp2f(sacc[nb][i] - mx[hh]);
        const float p1 = exp2f(sacc[nb][i + 1] - mx[hh]);
        lsum[hh] += p0 + p1;
        // registers 8k..8k+7 of a 64-key block hold keys 16k..16k+15:
        // (r, c), (r+8, c), (r, c+8), (r+8, c+8) pairs, the A fragment's order
        pf[nb * 4 + i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + lsum[hh];
#pragma unroll
    for (int nb = 0; nb < DC; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[nb][i] *= corr[(i >> 1) & 1];

    // O += P V: V is keys x d (MN-major), 16 keys (2048 bytes) per step
#pragma unroll
    for (int nb = 0; nb < DC; ++nb) fence_regs(oacc[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < DC; ++nb)
        wgmma_rs(oacc[nb], pf[kk], desc128(vb + nb * BK * 128 + kk * 2048, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < DC; ++nb) fence_regs(oacc[nb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // l was summed per thread over its own columns: add up the quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    if (l[hh] == 0.f) l[hh] = 1.f;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long row = (long long)bi * sq + q0 + 64 * wg + r + 8 * hh;
    __nv_bfloat16* orow = o + (row * h + head) * D;
#pragma unroll
    for (int nb = 0; nb < DC; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v0 = oacc[nb][4 * j + 2 * hh] / l[hh];
        const float v1 = oacc[nb][4 * j + 2 * hh + 1] / l[hh];
        *reinterpret_cast<__nv_bfloat162*>(orow + nb * 64 + 8 * j + cq) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}


// a [rows, heads, d] bf16 tensor as a 3-D map; box: 64 columns, one head,
// `box_rows` rows, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, long long rows, int heads, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  return tma_map_bf16(map, ptr, 3, dims, strides, box);
}

template <int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h,
           int kh, int causal, int q_offset, float scale, int threads, int smem,
           cudaStream_t s) {
  constexpr int SMEM = wgmma_smem(D, BQ, BK);
  if (threads != wgmma_threads(BQ) || smem < SMEM) return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<D, BQ, BK>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)e;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, (long long)b * sq, h, D, BQ) ||
      !make_map(&tk, k, (long long)b * sk, kh, D, BK) ||
      !make_map(&tv, v, (long long)b * sk, kh, D, BK))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * h), (unsigned)(sq / BQ));
  kern<<<grid, threads, smem, s>>>(tq, tk, tv, (__nv_bfloat16*)o, sq, sk, h, kh, causal,
                                   q_offset, (float)((double)scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

template <int D, int BQ, int BK>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, flash_wgmma_kernel<D, BQ, BK>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// calls f.template operator()<D, BQ, BK>() for an instantiated tile, else
// returns cudaErrorInvalidValue
template <typename F>
int dispatch(int d, int bq, int bk, F f) {
#define FLASH_WGMMA_CASE(D_, BQ_, BK_) \
  if (d == D_ && bq == BQ_ && bk == BK_) return f.template operator()<D_, BQ_, BK_>();
  FLASH_WGMMA_CASE(64, 64, 64)
  FLASH_WGMMA_CASE(64, 64, 128)
  FLASH_WGMMA_CASE(64, 128, 64)
  FLASH_WGMMA_CASE(64, 128, 128)
  FLASH_WGMMA_CASE(128, 64, 64)
  FLASH_WGMMA_CASE(128, 64, 128)
  FLASH_WGMMA_CASE(128, 128, 64)
  FLASH_WGMMA_CASE(128, 128, 128)
#undef FLASH_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

// the launch of one call, for dispatch
struct Launch {
  const void *q, *k, *v;
  void* o;
  int b, sq, sk, h, kh, causal, q_offset;
  float scale;
  int threads, smem;
  cudaStream_t s;
  template <int D, int BQ, int BK>
  int operator()() const {
    return launch<D, BQ, BK>(q, k, v, o, b, sq, sk, h, kh, causal, q_offset, scale, threads,
                             smem, s);
  }
};

// the compiler's attributes of one tile, for dispatch
struct Attr {
  int *regs, *local_bytes;
  template <int D, int BQ, int BK>
  int operator()() const {
    return attributes<D, BQ, BK>(regs, local_bytes);
  }
};

}  // namespace

extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* o, int b, int sq, int sk, int h, int kh,
                                            int d, int bq, int bk, int causal, int q_offset,
                                            float scale, int threads, int smem, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || kh <= 0 || bq <= 0 || bk <= 0 || h % kh != 0 ||
      sq % bq != 0 ||
      sk % bk != 0 || sq / bq > 65535 || (reinterpret_cast<uintptr_t>(o) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(d, bq, bk,
                  Launch{q, k, v, o, b, sq, sk, h, kh, causal, q_offset, scale, threads, smem, s});
}

// the compiler's registers per thread and local (spill) bytes for one tile
extern "C" int flash_attention_wgmma_attributes(int d, int bq, int bk, int* regs,
                                                int* local_bytes) {
  return dispatch(d, bq, bk, Attr{regs, local_bytes});
}
