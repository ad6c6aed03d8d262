// The mma flash kernel (flash_mma_kernel) and its host helpers: the
// template and its launch, shared by two translation units so that nvcc
// builds them in parallel. csrc/flash_attention.cu holds the design notes,
// the instantiations up to DP 128, the dispatch and the C entry points;
// csrc/flash_attention_wide.cu the instantiations at DP 160, 192 and 256,
// whose bodies are the largest (in one unit with the others, nvcc took 33 s
// on it, the rest of the library at most 22 s a file).
#pragma once

#include <limits.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace flash_mma {

constexpr float NEG_INF = -1e30f;  // the mask value, as in the reference
constexpr int MAX_WARPS = 8;
constexpr long long SMEM_PER_BLOCK = 232448;  // the most dynamic shared memory a block may have

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
// above DP 128 q is not held in registers: each product reads its A
// fragment from the pass's q rows in shared memory
__host__ __device__ constexpr bool q_in_smem(int dp) { return dp > 128; }

// the padded head dim the kernel is instantiated for, 0 above 256
__host__ __device__ constexpr int padded_d(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128
       : d <= 160 ? 160 : d <= 192 ? 192 : d <= 256 ? 256 : 0;
}

inline int kw_of(int dp, int itemsize) {
  return itemsize == 4 ? k_words<float>(dp) : k_words<__nv_bfloat16>(dp);
}
inline int vw_of(int dp, int itemsize) {
  return itemsize == 4 ? v_words<float>(dp) : v_words<__nv_bfloat16>(dp);
}

// the most warps of a block at this head dim and type: MAX_WARPS, or fewer
// (halving) where that many warps' q rows and two stages of one sub-tile
// would not fit a block (f32 at DP 256: 4)
inline int max_warps(int dp, int itemsize) {
  const long long stages = 2LL * sub_keys(dp) * (kw_of(dp, itemsize) + vw_of(dp, itemsize));
  int w = MAX_WARPS;
  while (w > 1 && 4LL * (stages + 16LL * w * kw_of(dp, itemsize)) > SMEM_PER_BLOCK) w /= 2;
  return w;
}

// warps of a block: one per 16 query rows, at most max_warps
inline int block_warps(int bq, int dp, int itemsize) {
  const int mw = max_warps(dp, itemsize);
  return (bq + 15) / 16 < mw ? (bq + 15) / 16 : mw;
}

// a ring of two stages of st keys and the q rows of a pass
inline long long smem_bytes(int bq, int st, int dp, int itemsize) {
  return 4LL * (2LL * st * (kw_of(dp, itemsize) + vw_of(dp, itemsize)) +
                16 * block_warps(bq, dp, itemsize) * kw_of(dp, itemsize));
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
    if constexpr (q_in_smem(DP)) {  // q's padding columns too: the products read them
      for (int i = tid; i < 16 * warps * kpad; i += nthreads)
        qs[(i / kpad) * KW + dw + i % kpad] = 0u;
    }
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

    // q * scale in f32 as A fragments: its parts, or the value (QS); none
    // above DP 128 (QM), where the products read q from shared memory
    constexpr bool QS = q_split_once<T>(DP), QM = q_in_smem(DP);
    uint32_t q_big[QM ? 1 : KS][4], q_small[QS ? KS : 1][4];
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
      if constexpr (!QM) {
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
        if constexpr (QM) {
          // A fragments from the pass's q rows: elements (row gid, col
          // 8kk + 2tig), (gid + 8, same), (gid, + 1), (gid + 8, + 1), one
          // pair of each of two rows; unrolled 4 times, not KS: the
          // fragments hold no registers from one step to the next, and a
          // full unroll would double these instantiations' code
          const uint32_t* qr = qs + (group * 16 + gid) * KW;
#pragma unroll 4
          for (int kk = 0; kk < KS; ++kk) {
            uint32_t a_big[4], a_small[4];
            float x[4];
            if constexpr (F32) {
              const uint2 w0 = *reinterpret_cast<const uint2*>(qr + 8 * kk + 2 * tig);
              const uint2 w1 = *reinterpret_cast<const uint2*>(qr + 8 * KW + 8 * kk + 2 * tig);
              x[0] = __uint_as_float(w0.x);
              x[1] = __uint_as_float(w1.x);
              x[2] = __uint_as_float(w0.y);
              x[3] = __uint_as_float(w1.y);
            } else {
              const uint32_t w0 = qr[4 * kk + tig], w1 = qr[8 * KW + 4 * kk + tig];
              x[0] = __uint_as_float(w0 << 16);
              x[1] = __uint_as_float(w1 << 16);
              x[2] = __uint_as_float(w0 & 0xffff0000u);
              x[3] = __uint_as_float(w1 & 0xffff0000u);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) split(x[e] * scale, a_big[e], a_small[e]);
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
        } else {
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

// declares (PREFIX extern) or instantiates (PREFIX empty) the launch and
// the attributes of one (dtype, DP)
#define FLASH_MMA_INSTANCES(PREFIX, T, DP)                                                  \
  PREFIX template int launch<T, DP>(const void*, const void*, const void*, void*, int, int, \
                                    int, int, int, int, int, int, int, int, int, float, int, \
                                    int, cudaStream_t);                                      \
  PREFIX template int attributes<T, DP>(int*, int*);

}  // namespace flash_mma
