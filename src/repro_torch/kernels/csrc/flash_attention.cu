// Blockwise (flash) attention with online softmax on Hopper's tensor cores
// at f32 accuracy: both products on mma.sync m16n8k8 TF32, each operand
// split into two TF32 parts.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention(), lines 24-103) for the calls that
// csrc/flash_attention_wgmma.cu does not take (f32 inputs; bf16 at a head
// dim other than 64 or 128, a block outside {64, 128, 256, 512} or a
// sequence shorter than 64), at every tile up to d 128;
// csrc/flash_attention_fma.cu takes d above 128 (the rule is
// repro_torch/kernels/flash_attention.py::route). Same function: q
// [b, sq, h, d], k and v [b, sk, kh, d], GQA (query head `hd` reads KV head
// `hd / (h / kh)`), q scaled by 1/sqrt(d) in f32, causal keeps
// q_offset + i >= j, masked scores are -1e30 (not -inf, so a fully masked
// row averages V), m, l and the accumulator in f32, an l == 0 -> 1 guard,
// the causal walk stopping after the last keys the q tile can see, output
// rounded once to q's type.
//
// What bounds it on the H100: operations at realistic widths (4 * d FLOP per
// (query, key) pair, ~1,000 FLOP per byte at 4096 positions), latency at the
// CI shapes (attn_s128_f32 gives 8 CTAs for 132 SMs). The kernel it replaces
// ran both products as f32 FMAs on the CUDA cores (at most 67 TFLOP/s), each
// FMA paying two shared-memory loads. Plain TF32 on the tensor cores keeps
// 10 mantissa bits and would not hold f32 to its plain version (PLAIN_REL,
// 2^-14 of each row's largest value).
//
// What the design does about it: each f32 operand x is split into
// big = tf32(x) (cvt.rna.tf32.f32) and small = x - big, which the tensor
// core reads truncated to TF32, and a * b is taken as small_a * big_b +
// big_a * small_b + big_a * big_b, small terms first, on
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32: three tensor-core products
// per product (the dropped small * small term and the truncation of small
// are below 2^-21 of the product). A bf16 K or V is exact in TF32, so its
// small part is zero and those terms drop: two products.
//   One CTA per (b*h, q tile of bq rows), the longest causal tiles first.
// Each warp owns 16 query rows; a CTA has ceil(bq / 16) warps, at most 8,
// and a larger q tile runs in passes of 128 rows (16 warps would leave 128
// registers a thread; the kernel takes 170-255 at d 64 and up). The head
// dim is zero-padded inside the kernel to the next of 16, 32, 64, 96 and
// 128 (DP): the zero columns add nothing to Q.K^T, and the padded output
// columns are not written. The pass's q rows and K and V come in the input
// type through 16-byte cp.async (q with the first stage), K and V into a
// ring of two stages of ST keys, so the next stage's copy overlaps this
// one's products. A stage holds a whole tile of bk keys (ST = bk rounded up
// to KC) where two such stages and the q rows fit a block; else ST is the
// largest multiple of KC that fits (64 keys at f32 and DP 128) and a tile
// comes in ceil(bk / ST) stages, each starting at a multiple of ST within
// the tile. The sub-tiles, the softmax and every product are the same
// either way: only the staging differs. Each warp reads its 16 rows of q once a
// pass, scales them and splits them into registers (A fragments: DP
// registers for the two parts; for f32, and above DP 64, where the parts
// would not leave room beside O and the splits of K and V, q is held as one
// f32 value, DP / 2 registers, and split at each use). The warps walk a
// tile in sub-tiles of KC keys (64 up to DP 32, else 32, which sets S's
// registers). With causal, row groups see more keys the later they lie;
// warps w and w + 4 share a scheduler, so the groups are dealt so that each
// scheduler gets one early and one late group. S = Q.K^T stays in registers
// as C fragments; the online softmax runs on the fragment, each thread
// holding two rows, with the row max taken by quad shuffles (l is summed per
// thread and over the quad at the end). P reaches P.V's A operand without a
// shuffle: the reduction index of both products is taken in a permuted
// order, logical k = tig <-> physical 2 * tig and k = tig + 4 <->
// 2 * tig + 1 (tig = lane % 4), under which the C fragment of S (columns
// 2 * tig, 2 * tig + 1) is exactly the A fragment of P, and B's two
// registers are two neighbouring rows of V, or one 8-byte (f32) or 4-byte
// (bf16) pair of a K row (and A's pairs of a q row). Shared-memory rows are
// padded (K and q: f32 rows to 8 words mod 32 for the 8-byte pairs, bf16
// rows to 4 mod 16; V: 4 words mod 16) so that each fragment read hits 32
// distinct banks. With causal and q_offset >= 0 a pass stops after the last
// stage its rows can see, and a warp skips the sub-tiles past its own last
// row: every row has seen key 0, so the skipped keys would add
// exp(-1e30 - m) = 0 and scale by exp(0) = 1, and the output is bit for bit
// the same. No intermediate reaches device memory.
//
// Shared memory (repro_torch/kernels/flash_attention.py::smem_bytes_mma,
//   with ST from mma_stage_keys):
//   (2 stages * ST rows * (K row + V row words) + 16 * warps * K row words)
//   * 4 bytes; at most 232,448 at every tile up to d 128.
// Threads (flash_attention.py::mma_threads): 32 * min(ceil(bq / 16), 8).
// Registers per thread (resource_model.py::flash_mma_registers, a model for
//   feasibility and blocks per SM; the compiler's count is
//   flash_attention_mma_attributes): DP (Q's parts; DP / 2 where q is
//   split at each use) + DP / 2 (O) + KC / 2 (S) + 40, rounded up to 8.
// Resource model (resource_model.py::flash_attention_resources): as for the
//   wgmma route, with the compute term at the TF32 peak over the number of
//   products per product (3 for f32, 2 for bf16).
#include <limits.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the mask value, as in the reference
constexpr int MAX_WARPS = 8;

// 32-bit words of a shared-memory row of dp elements of e bytes, padded so
// that the count is rem modulo mod
__host__ __device__ constexpr int row_words(int dp, int e, int rem, int mod) {
  return dp * e / 4 + ((rem - dp * e / 4) % mod + mod) % mod;
}
template <typename T>
__host__ __device__ constexpr int k_words(int dp) {
  return sizeof(T) == 4 ? row_words(dp, 4, 8, 32) : row_words(dp, 2, 4, 16);
}
template <typename T>
__host__ __device__ constexpr int v_words(int dp) {
  return row_words(dp, sizeof(T), 4, 16);
}
// keys of a sub-tile: S takes kc / 2 registers a thread
__host__ __device__ constexpr int sub_keys(int dp) { return dp <= 32 ? 64 : 32; }
// q's A fragments hold its two TF32 parts for bf16 up to DP 64; else q stays
// in registers as one f32 value and is split at each use (the parts would
// take DP registers beside O's DP / 2, and f32 needs room to split K and V)
template <typename T>
__host__ __device__ constexpr bool q_split_once(int dp) {
  return sizeof(T) == 2 && dp <= 64;
}

// the padded head dim the kernel is instantiated for, 0 above 128
__host__ __device__ constexpr int padded_d(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128 : 0;
}

// warps of a block: one per 16 query rows, at most MAX_WARPS
__host__ __device__ constexpr int block_warps(int bq) {
  return (bq + 15) / 16 < MAX_WARPS ? (bq + 15) / 16 : MAX_WARPS;
}

// a ring of two stages of st keys and the q rows of a pass
long long smem_bytes(int bq, int st, int dp, int itemsize) {
  const int kw = itemsize == 4 ? k_words<float>(dp) : k_words<__nv_bfloat16>(dp);
  const int vw = itemsize == 4 ? v_words<float>(dp) : v_words<__nv_bfloat16>(dp);
  return 4LL * (2LL * st * (kw + vw) + 16 * block_warps(bq) * kw);
}

// Fragments of m16n8k8, lane = 4 * gid + tig: A (16 x 8) a[e] at row
// gid + 8 * (e & 1), logical column tig + 4 * (e >> 1); B (8 x 8) b[e] at
// logical row tig + 4 * e, column gid; C (16 x 8) c[e] at row
// gid + 8 * (e >> 1), column 2 * tig + (e & 1). Logical column (A) and row
// (B) tig + 4 * i are physical 2 * tig + i.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
    flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int sq, int sk, int h, int kh, int d, int bq, int bk,
                     int st, int causal, int q_offset, float scale, int vec16) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int KC = sub_keys(DP), NT = KC / 8, KS = DP / 8;
  constexpr int KW = k_words<T>(DP), VW = v_words<T>(DP);
  extern __shared__ __align__(16) uint32_t smem[];
  // st keys a stage (a multiple of KC): a whole tile, or a part of one
  const int per_tile = (bk + st - 1) / st;  // stages a K tile takes
  uint32_t* ks = smem;                      // [2][st][KW]
  uint32_t* vs = ks + 2 * st * KW;          // [2][st][VW]
  uint32_t* qs = vs + 2 * st * VW;          // [16 * warps][KW], the pass's q rows

  const int tid = threadIdx.x, nthreads = blockDim.x, warps = nthreads / 32;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int bi = bh / h, head = bh % h, kvh = head / (h / kh);
  const int q0 = qt * bq;
  const long long qrow = (long long)h * d, kvrow = (long long)kh * d;
  const T* qb = q + (((long long)bi * sq + q0) * h + head) * d;
  T* ob = o + (((long long)bi * sq + q0) * h + head) * d;
  const T* kb = k + ((long long)bi * sk * kh + kvh) * d;
  const T* vb = v + ((long long)bi * sk * kh + kvh) * d;
  // With causal, row groups grow in the keys they see. Warps w and w + 4
  // share a scheduler (w % 4), so warps 4.. take the groups from the top
  // down: each scheduler gets one short and one long walk.
  const int group = warp < 4 ? warp : warps + 3 - warp;

  // n rows from src (stride elements apart) into shared rows of `words`
  // words: 16-byte cp.async where rows are whole vectors (the caller
  // commits), else plain copies; each thread walks its (row, chunk) pairs
  // without dividing
  auto copy_rows = [&](uint32_t* dst, int words, const T* src, long long stride, int n) {
    const int chunks = vec16 ? d * (int)sizeof(T) / 16 : d;  // a row's
    const int step_r = nthreads / chunks, step_c = nthreads % chunks;
    int r = tid / chunks, c = tid % chunks;
    while (r < n) {
      if (vec16)
        cp_async16(dst + r * words + 4 * c, src + r * stride + c * (16 / (int)sizeof(T)));
      else
        reinterpret_cast<T*>(dst + r * words)[c] = src[r * stride + c];
      r += step_r;
      c += step_c;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  };
  // `rows` keys from key k0 into ring slot `slot`, as one commit group
  auto load_stage = [&](int slot, int k0, int rows) {
    const long long src = (long long)k0 * kvrow;
    copy_rows(ks + slot * st * KW, KW, kb + src, kvrow, rows);
    copy_rows(vs + slot * st * VW, VW, vb + src, kvrow, rows);
    cp_async_commit();
  };
  // a stage is the keys k0 .. k0 + min(st, kend - k0) - 1, kend the end of
  // their K tile; the next stage starts where this one ends
  auto next_stage = [&](int& k0, int& kend) {
    k0 += min(st, kend - k0);
    if (k0 == kend) kend += bk;
  };

  const int n_stages = sk / bk * per_tile;
  const bool skip = causal && q_offset >= 0;
  const int groups = (bq + 15) / 16;

  // the padding of K and V (columns d..DP; rows past the end of a tile's
  // last stage, which the sub-tile walk reads and masks) must read as 0
  // or as a finite value, never as stale bits that could be NaN; the copies
  // write only real elements, after this, and a later stage leaves finite
  // values in the rows it does not write
  {
    const int dw = d * (int)sizeof(T) / 4, kpad = KS * 8 * (int)sizeof(T) / 4 - dw;
    for (int i = tid; i < 2 * st * kpad; i += nthreads) {  // columns of every row
      const int r = i / kpad, c = dw + i % kpad;
      ks[r * KW + c] = 0u;
      vs[r * VW + c] = 0u;
    }
    const int r1 = bk % st ? bk % st : st, tail = st - r1;  // rows past a tile's end
    for (int i = tid; i < 2 * tail * KW; i += nthreads)
      ks[(i / (tail * KW)) * st * KW + r1 * KW + i % (tail * KW)] = 0u;
    for (int i = tid; i < 2 * tail * VW; i += nthreads)
      vs[(i / (tail * VW)) * st * VW + r1 * VW + i % (tail * VW)] = 0u;
  }
  __syncthreads();

  for (int g0 = 0; g0 < groups; g0 += warps) {  // passes of warps * 16 rows
    const int r0 = (g0 + group) * 16;           // this warp's first row of the tile
    const bool active = r0 < bq;
    int nk = n_stages;  // stages up to the last one a row of the pass can see
    if (skip) {
      const long long last = (long long)q_offset + q0 + min((g0 + warps) * 16, bq) - 1;
      nk = (int)min((long long)nk, last / bk * per_tile + last % bk / st + 1);
    }
    const long long last_key =
        skip ? (long long)q_offset + q0 + min(r0 + 15, bq - 1) : LLONG_MAX;

    // the pass's q rows come in with the first K/V stage
    copy_rows(qs, KW, qb + g0 * 16 * qrow, qrow, min(warps * 16, bq - g0 * 16));
    load_stage(0, 0, min(st, bk));
    int k0 = 0, kend = bk;  // stage t's first key and the end of its K tile

    // q * scale in f32 as A fragments: its parts, or the value (QS)
    constexpr bool QS = q_split_once<T>(DP);
    uint32_t q_big[KS][4], q_small[QS ? KS : 1][4];
    float acc[KS][4];
#pragma unroll
    for (int u = 0; u < KS; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int t = 0; t < nk; ++t) {
      if (t + 1 < nk) {
        int n0 = k0, nend = kend;
        next_stage(n0, nend);
        load_stage((t + 1) & 1, n0, min(st, nend - n0));  // the slot stage t - 1 freed
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = group * 16 + gid + 8 * (e & 1), col = 8 * kk + 2 * tig + (e >> 1);
            const float x = (g0 * 16 + row < bq && col < d)
                                ? to_float(reinterpret_cast<const T*>(qs + row * KW)[col]) * scale
                                : 0.f;
            if constexpr (QS)
              split(x, q_big[kk][e], q_small[kk][e]);
            else
              q_big[kk][e] = __float_as_uint(x);
          }
      }
      const int rows = min(st, kend - k0);
      for (int c0 = 0; active && c0 < rows; c0 += KC) {
        const long long key0 = (long long)k0 + c0;
        if (key0 > last_key) break;  // every row of the warp masks these keys
        const uint32_t* kt = ks + (t & 1) * st * KW;
        const uint32_t* vt = vs + (t & 1) * st * VW;
        // S = (q * scale) K^T over KC keys
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t a_big[4], a_small[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (QS) {
              a_big[e] = q_big[kk][e];
              a_small[e] = q_small[kk][e];
            } else {
              split(__uint_as_float(q_big[kk][e]), a_big[e], a_small[e]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint32_t* kr = kt + (c0 + 8 * nt + gid) * KW;
            if constexpr (F32) {
              const uint2 w = *reinterpret_cast<const uint2*>(kr + 8 * kk + 2 * tig);
              mma3(s[nt], a_big, a_small, __uint_as_float(w.x), __uint_as_float(w.y));
            } else {
              const uint32_t w = kr[4 * kk + tig];  // columns 8kk + 2tig and + 1
              mma2(s[nt], a_big, a_small, w << 16, w & 0xffff0000u);
            }
          }
        }
        // the mask, then the online softmax on the fragment
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 8 * nt + 2 * tig + (e & 1);  // key within the sub-tile
            // the row's last visible key relative to key0 (with causal)
            const long long vis = (long long)q_offset + q0 + r0 + gid + 8 * (e >> 1) - key0;
            if (c0 + j >= rows)
              s[nt][e] = __int_as_float(0xff800000);  // -inf: past the tile, no key
            else if (causal && vis < j)
              s[nt][e] = NEG_INF;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
          }
        float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          corr[i] = expf(m[i] - mx[i]);
          m[i] = mx[i];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
            sum[e >> 1] += s[nt][e];
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
        for (int u = 0; u < KS; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] *= corr[e >> 1];
        // acc += P V: S's C fragment of keys 8nt.. is P's A fragment
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t p_big[4], p_small[4];
          split(s[nt][0], p_big[0], p_small[0]);
          split(s[nt][2], p_big[1], p_small[1]);
          split(s[nt][1], p_big[2], p_small[2]);
          split(s[nt][3], p_big[3], p_small[3]);
          const uint32_t* v0 = vt + (c0 + 8 * nt + 2 * tig) * VW;  // key 2tig; + VW: 2tig + 1
#pragma unroll
          for (int u = 0; u < KS; ++u) {
            const int col = 8 * u + gid;
            if constexpr (F32) {
              mma3(acc[u], p_big, p_small, __uint_as_float(v0[col]),
                   __uint_as_float(v0[VW + col]));
            } else {
              const uint16_t* v0h = reinterpret_cast<const uint16_t*>(v0);
              const uint16_t* v1h = reinterpret_cast<const uint16_t*>(v0 + VW);
              mma2(acc[u], p_big, p_small, (uint32_t)v0h[col] << 16, (uint32_t)v1h[col] << 16);
            }
          }
        }
      }
      __syncthreads();  // stage t read: its slot is free for t + 2, q's rows for the next pass
      next_stage(k0, kend);
    }

    if (active) {
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      }
      // each thread's two neighbouring columns go out as one store where d
      // is even (then every row, and so every pair, is aligned)
#pragma unroll
      for (int u = 0; u < KS; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + gid + 8 * i, col = 8 * u + 2 * tig;
          if (row >= bq || col >= d) continue;
          T* dst = ob + row * qrow + col;
          const float a0 = acc[u][2 * i] * inv[i], a1 = acc[u][2 * i + 1] * inv[i];
          if constexpr (F32) {
            if (d % 2 == 0)
              *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
            else {
              dst[0] = a0;
              if (col + 1 < d) dst[1] = a1;
            }
          } else {
            if (d % 2 == 0)
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a0, a1);
            else {
              dst[0] = __float2bfloat16(a0);
              if (col + 1 < d) dst[1] = __float2bfloat16(a1);
            }
          }
        }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h,
           int kh, int d, int bq, int bk, int st, int causal, int q_offset, float scale,
           int threads, int smem, cudaStream_t s) {
  static int smem_allowed = 0;  // the largest size set so far for this kernel
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(flash_mma_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch's check would report it
      return (int)e;
    }
    smem_allowed = smem;
  }
  const int vec16 = (d * (int)sizeof(T)) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  dim3 grid((unsigned)(b * h), (unsigned)(sq / bq));
  flash_mma_kernel<T, DP><<<grid, threads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, h, kh, d, bq, bk, st, causal,
      q_offset, scale, vec16);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, flash_mma_kernel<T, DP>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// calls f.template operator()<T, DP>() for an instantiated (dtype, DP),
// else returns cudaErrorInvalidValue
template <typename F>
int dispatch(int dtype, int dp, F f) {
#define FLASH_MMA_CASE(DP_)                                                               \
  if (dp == DP_)                                                                          \
    return dtype == DTYPE_F32 ? f.template operator()<float, DP_>()                        \
                              : f.template operator()<__nv_bfloat16, DP_>();
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  FLASH_MMA_CASE(16)
  FLASH_MMA_CASE(32)
  FLASH_MMA_CASE(64)
  FLASH_MMA_CASE(96)
  FLASH_MMA_CASE(128)
#undef FLASH_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

struct Launch {
  const void *q, *k, *v;
  void* o;
  int b, sq, sk, h, kh, d, bq, bk, st, causal, q_offset;
  float scale;
  int threads, smem;
  cudaStream_t s;
  template <typename T, int DP>
  int operator()() const {
    return launch<T, DP>(q, k, v, o, b, sq, sk, h, kh, d, bq, bk, st, causal, q_offset, scale,
                         threads, smem, s);
  }
};

struct Attr {
  int *regs, *local_bytes;
  template <typename T, int DP>
  int operator()() const {
    return attributes<T, DP>(regs, local_bytes);
  }
};

}  // namespace

// cfg holds b, sq, sk, h, kh, d, bq, bk, causal, q_offset, dtype, threads,
// smem and the keys a stage holds (flash_attention.py::mma_stage_keys): the
// wrapper builds it once for a call's shapes and options, so a call passes
// 7 arguments, not 20 (each costs the host a conversion)
extern "C" int flash_attention_mma_launch(const void* q, const void* k, const void* v, void* o,
                                          const int* cfg, float scale, void* stream) {
  const int b = cfg[0], sq = cfg[1], sk = cfg[2], h = cfg[3], kh = cfg[4], d = cfg[5],
            bq = cfg[6], bk = cfg[7], causal = cfg[8], q_offset = cfg[9], dtype = cfg[10],
            threads = cfg[11], smem = cfg[12], st = cfg[13];
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2, dp = padded_d(d);
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || kh <= 0 || d <= 0 || dp == 0 || bq <= 0 ||
      bk <= 0 || sq % bq != 0 || sk % bk != 0 || h % kh != 0 || sq / bq > 65535 ||
      st <= 0 || st % sub_keys(dp) != 0 || threads != 32 * block_warps(bq) ||
      (long long)smem < smem_bytes(bq, st, dp, itemsize))
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, dp,
                  Launch{q, k, v, o, b, sq, sk, h, kh, d, bq, bk, st, causal, q_offset, scale,
                         threads, smem, (cudaStream_t)stream});
}

// the compiler's registers per thread and local (spill) bytes at one head dim
extern "C" int flash_attention_mma_attributes(int d, int dtype, int* regs, int* local_bytes) {
  return dispatch(dtype, padded_d(d), Attr{regs, local_bytes});
}
