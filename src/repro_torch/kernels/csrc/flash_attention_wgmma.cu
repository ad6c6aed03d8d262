// Blockwise (flash) attention for bf16 on Hopper's tensor cores: both
// products on `wgmma`, K/V sub-tiles brought in by TMA.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention(), lines 24-103) for bf16 inputs at d = 64 and d = 128
// with block_q and block_k in {64, 128, 256, 512}; f32 inputs, any other d
// and any other tile take csrc/flash_attention.cu, or above d = 128
// csrc/flash_attention_fma.cu (the rule is
// repro_torch/kernels/flash_attention.py::route, whose WGMMA_D and
// WGMMA_BLOCKS list the same). Same function: q [b, sq, h, d], k and v
// [b, sk, kh, d], GQA (query head `hd` reads KV head `hd / (h / kh)`),
// scores scaled by 1/sqrt(d) in f32, causal keeps q_offset + i >= j, masked
// scores are -1e30 (so a fully masked row averages V), m, l and the
// accumulator in f32, an l == 0 -> 1 guard, output in bf16. P is rounded to
// bf16 for the P.V product, as every Hopper flash kernel does; l is summed
// from the f32 P. The plain version (flash_attention_plain) rounds P the
// same way on this route, and walks each block_k tile in the same
// sub-tiles.
//
// What bounds it on the H100: operations. 4 * d FLOP per (query, key) pair
// that the mask keeps, ~1,000 FLOP per byte at llama3-8b widths, far above
// the bf16 ridge of ~295; the least time is FLOP / 989e12 s.
//
// What the design does about it: one CTA per (b*h, q tile of bq rows), the
// longest causal q tiles launched first. A CTA takes its q tile in passes
// of QP = min(bq, 128) rows and walks K and V in sub-tiles of
// KS = min(bk, 128) keys; QP and KS (and D) are the template parameters,
// bq and bk loop counts, so eight instantiations take every tile of
// {64, 128, 256, 512}^2 and a large tile needs the shared memory and
// registers of (128, 128). Warps 0 .. 4*QP/64-1 are consumer warpgroups of
// 64 query rows each; the last warp is the producer. The producer's lane 0
// loads a pass's q rows and then that pass's K and V sub-tiles through a
// ring of STAGES = 2 stages with cp.async.bulk.tensor (3-D maps over
// [b*s, heads, d] with a box of one head, 64 columns = 128 bytes per box,
// 128-byte swizzle), each stage's completion on an mbarrier (`full`), its
// release by the consumers on another (`empty`), so the next sub-tile's
// load overlaps this one's math. Each pass restarts the ring at stage 0:
// every pass but the last is padded with empty steps (the producer arrives
// on `full` without a copy, the consumers only release the stage) to a
// multiple of 2 * STAGES steps, so each stage's phase is even at a pass's
// start and the walk within a pass is the single-pass walk, as the compiler
// schedules it (a ring position carried across passes made it schedule the
// softmax worse, and slowed the one-pass tiles). A pass's q buffer is
// released (`q_empty`) after its walk, so the next pass's q load overlaps
// the epilogue and the padding. Each pass walks K/V again; they come
// from L2 (one (batch, KV head) holds 2 MB of K and V at 4096 x 128, the 8
// KV heads of llama3-8b 16 MB of the 50 MB). Passes run last first, so with
// causal the longest walks come first within a CTA as across CTAs. Each
// consumer warpgroup computes S = Q.K^T with wgmma.m64n64k16 (both operands
// K-major in shared memory, S in registers), scales S by log2(e)/sqrt(d) in
// f32, masks only the sub-tiles that cross the diagonal, and runs the
// online softmax row-parallel in registers, once a sub-tile: each thread
// owns two rows of its fragment, reduces max over its quad with shuffles
// and takes exp2f. P goes to bf16 in registers and is the register A
// operand of the P.V wgmma, V the shared-memory B operand with the
// transpose bit (V is keys x d, MN-major). With causal and q_offset >= 0 a
// pass stops after the last sub-tile its rows can see: every row has seen
// key 0, so the skipped keys would add exp(-1e30 - m) = 0 and scale by 1.
// At bq <= 128 and bk <= 128 a CTA runs one pass over whole tiles. No
// intermediate reaches device memory.
//
// Shared memory (repro_torch/kernels/flash_attention.py::smem_bytes_wgmma):
//   1024 (alignment slack) + 2 * d * (QP + 2 * STAGES * KS) + 8 * (2 + 2 * STAGES)
//   bytes: a pass's q rows, STAGES K and V sub-tiles in bf16, and the
//   mbarriers (q full and empty, a full and an empty per stage); 164,912 B
//   at d = 128 for every tile from (128, 128) up.
// Threads: 128 * QP / 64 + 32.
// Registers per thread (resource_model.py::flash_wgmma_registers, a model
//   used only for blocks per SM; the compiler's count is
//   flash_attention_wgmma_attributes, which reports the instantiation a tile
//   runs on): KS / 2 (S) + d / 2 (O) + KS / 4 (P in bf16) + 48, rounded up
//   to 8. Sub-tiles of 256 keys would not fit: S, O and P alone would take
//   128 + d / 2 + 64 registers; nor passes of 256 rows: 544 threads leave
//   120 each.
// Resource model (resource_model.py::flash_attention_resources): as for the
//   FMA kernel, with the compute term at peak_flops_bf16, the work of the
//   passes and sub-tiles the kernel walks, and blocks per SM also dividing
//   the SM's 65,536 registers.
#include "hopper.cuh"

namespace {

constexpr int STAGES = 2;
constexpr int MAX_PASS = 128;  // q rows of a pass, K/V keys of a sub-tile, at most
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = -1e30f * LOG2E;  // the -1e30 mask in log2 units

__host__ __device__ constexpr int wgmma_threads(int qp) { return (qp / 64) * 128 + 32; }
__host__ __device__ constexpr int wgmma_smem(int d, int qp, int ks) {
  return 1024 + 2 * d * (qp + 2 * STAGES * ks) + 8 * (2 + 2 * STAGES);
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
template <int D, int QP, int KS>
__global__ void __launch_bounds__(wgmma_threads(QP), 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int sq, int sk, int h, int kh, int bq, int causal, int q_offset,
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

  if (warp == 4 * NWG) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
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
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = (long long)bi * sq + row0 + r + 8 * hh;
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
}


// a [rows, heads, d] bf16 tensor as a 3-D map; box: 64 columns, one head,
// `box_rows` rows, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, long long rows, int heads, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  return tma_map_bf16(map, ptr, 3, dims, strides, box);
}

template <int D, int QP, int KS>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h,
           int kh, int bq, int causal, int q_offset, float scale, int threads, int smem,
           cudaStream_t s) {
  constexpr int SMEM = wgmma_smem(D, QP, KS);
  if (threads != wgmma_threads(QP) || smem < SMEM) return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<D, QP, KS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)e;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, (long long)b * sq, h, D, QP) ||
      !make_map(&tk, k, (long long)b * sk, kh, D, KS) ||
      !make_map(&tv, v, (long long)b * sk, kh, D, KS))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * h), (unsigned)(sq / bq));
  kern<<<grid, threads, smem, s>>>(tq, tk, tv, (__nv_bfloat16*)o, sq, sk, h, kh, bq, causal,
                                   q_offset, (float)((double)scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

template <int D, int QP, int KS>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, flash_wgmma_kernel<D, QP, KS>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// calls f.template operator()<D, QP, KS>() for the instantiation a tile of
// bq x bk runs on (passes of min(bq, 128) rows, sub-tiles of min(bk, 128)
// keys, each dividing its block), else returns cudaErrorInvalidValue
template <typename F>
int dispatch(int d, int bq, int bk, F f) {
  const int qp = bq < MAX_PASS ? bq : MAX_PASS, ks = bk < MAX_PASS ? bk : MAX_PASS;
  if (bq <= 0 || bk <= 0 || bq % qp != 0 || bk % ks != 0) return (int)cudaErrorInvalidValue;
#define FLASH_WGMMA_CASE(D_, QP_, KS_) \
  if (d == D_ && qp == QP_ && ks == KS_) return f.template operator()<D_, QP_, KS_>();
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
  int b, sq, sk, h, kh, bq, causal, q_offset;
  float scale;
  int threads, smem;
  cudaStream_t s;
  template <int D, int QP, int KS>
  int operator()() const {
    return launch<D, QP, KS>(q, k, v, o, b, sq, sk, h, kh, bq, causal, q_offset, scale,
                             threads, smem, s);
  }
};

// the compiler's attributes of one instantiation, for dispatch
struct Attr {
  int *regs, *local_bytes;
  template <int D, int QP, int KS>
  int operator()() const {
    return attributes<D, QP, KS>(regs, local_bytes);
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
                  Launch{q, k, v, o, b, sq, sk, h, kh, bq, causal, q_offset, scale, threads, smem,
                         s});
}

// the compiler's registers per thread and local (spill) bytes for the
// instantiation a tile of bq x bk runs on
extern "C" int flash_attention_wgmma_attributes(int d, int bq, int bk, int* regs,
                                                int* local_bytes) {
  return dispatch(d, bq, bk, Attr{regs, local_bytes});
}
