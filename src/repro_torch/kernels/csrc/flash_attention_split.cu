// The mma flash kernel above head dim 256: the head dim cut into column
// slices, one warp a slice, at f32 accuracy on mma.sync (split TF32, as
// csrc/flash_attention.cu, whose notes give the products, the fragments and
// the permuted reduction index).
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention(), lines 24-103) at head dims 257-1024, in f32 and bf16
// (csrc/flash_attention.cu's kernel takes d up to 256, and
// csrc/flash_attention_fma.cu d above 1024; the rule is
// repro_torch/kernels/flash_attention.py::route). Same function and the same
// rules: q scaled by 1/sqrt(d) in f32, masked scores -1e30, m, l and O in
// f32, the l == 0 guard, the causal stop after the last stage a pass can see
// and each warp's skip of the sub-tiles past its last row, one rounding of
// the output.
//
// What bounds it on the H100: operations (4 d FLOP per (query, key) pair).
// What held the mma kernel at 256: each warp owns 16 query rows and every
// column of O, DP / 2 registers a thread (256 at d 512), and its q rows and
// two K/V stages of 32 keys pass a block above DP 256.
//
// The design. d is zero-padded to DP, a multiple of 8, and cut into
// NS = ceil(DP / 128) column slices. A row group of 16 query rows is served
// by NS warps, warp j holding O's columns 128 j .. 128 j + 127 (64
// registers a thread) and computing its partial S = (q * scale) K^T over
// those columns only (q read from the pass's rows in shared memory, split at
// each use). The NS partials go to shared memory, and after a barrier of the
// group's warps (a named barrier, one id a group) every warp adds them in
// one fixed order, slice 0 first: each warp then holds the same S bits, so
// the row maxima, the online softmax and P agree between the warps and
// their O columns belong to one softmax. Each warp then multiplies P by its
// own columns of V. A second group barrier before the next sub-tile's
// partials are written keeps a slow reader's partials in place. A block
// holds up to 8 warps: NS warps a group and 8 / NS groups (one above DP 512),
// halved where they do not fit. The K/V ring keeps two stages; a sub-tile is
// 32 keys, or 16 or 8 where two stages of 32 do not fit a block beside the q
// rows and the partials (f32 at DP 1024: 8), and a stage holds a whole
// block_k tile where two fit, else the largest multiple of the sub-tile
// that does (repro_torch/kernels/flash_attention.py::mma_split_plan and
// mma_stage_keys; split_plan here computes the same).
//
// Shared memory (flash_attention.py::smem_bytes_mma):
//   4 * (2 * ST * (K row + V row words) + 16 * groups * K row words
//        + 16 * KC * warps), rows padded as the mma kernel pads them.
// Threads (flash_attention.py::mma_threads): 32 * NS * groups.
// Registers per thread (resource_model.py::flash_mma_registers): 64 (O) +
//   KC / 2 (S) + 40; the compiler's count is flash_attention_mma_attributes.
#include "flash_attention_mma.cuh"

namespace flash_mma {

constexpr int SLICE = 128;         // columns of O a warp holds
constexpr int SPLIT_MAX_D = 1024;  // the largest head dim: 8 slices, one group a block

// the padded head dim of the split kernel, 0 outside 257..1024
__host__ __device__ constexpr int split_d(int d) {
  return d > 256 && d <= SPLIT_MAX_D ? (d + 7) / 8 * 8 : 0;
}
__host__ __device__ constexpr int split_slices(int dp) { return (dp + SLICE - 1) / SLICE; }

// two stages of st keys, the q rows of g groups, the partial S (16 x kc f32)
// of each of their warps
inline long long split_smem(int g, int st, int kc, int dp, int itemsize) {
  return 4LL * (2LL * st * (kw_of(dp, itemsize) + vw_of(dp, itemsize)) +
                16LL * g * kw_of(dp, itemsize) + 16LL * kc * g * split_slices(dp));
}

struct SplitPlan {
  int kc, groups;
};

// the sub-tile (32, 16 or 8 keys, the largest first) and the most groups of
// a block (MAX_WARPS / NS, halving) whose two stages of one sub-tile, q rows
// and partials fit a block
inline SplitPlan split_plan(int dp, int itemsize) {
  const int ns = split_slices(dp);
  for (int kc = 32; kc >= 8; kc /= 2)
    for (int g = MAX_WARPS / ns; g >= 1; g /= 2)
      if (split_smem(g, kc, kc, dp, itemsize) <= SMEM_PER_BLOCK) return {kc, g};
  return {0, 0};
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T, int KC>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
    flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int sq, int sk, int h, int kh, int d, int bq, int bk,
                       int st, int causal, int q_offset, float scale, int vec16) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NT = KC / 8, US = SLICE / 8;
  const int DP = split_d(d), NS = split_slices(DP);
  const int KW = k_words<T>(DP), VW = v_words<T>(DP);
  extern __shared__ __align__(16) uint32_t smem[];
  const int per_tile = (bk + st - 1) / st;  // stages a K tile takes
  const int tid = threadIdx.x, nthreads = blockDim.x, warps = nthreads / 32;
  const int groups = warps / NS;             // row groups of a pass
  uint32_t* ks = smem;                       // [2][st][KW]
  uint32_t* vs = ks + 2 * st * KW;           // [2][st][VW]
  uint32_t* qs = vs + 2 * st * VW;           // [16 * groups][KW], the pass's q rows
  float* part = reinterpret_cast<float*>(qs + 16 * groups * KW);  // [warps][NT][32][4]

  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int group = warp / NS, slice = warp % NS;
  const int col0 = SLICE * slice;                   // this warp's first column
  const int nu = min(US, (DP - col0) / 8);          // and its 8-column tiles
  const int bar = 1 + group, bar_threads = 32 * NS;  // the group's named barrier
  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int bi = bh / h, head = bh % h, kvh = head / (h / kh);
  const int q0 = qt * bq;
  const long long qrow = (long long)h * d, kvrow = (long long)kh * d;
  const T* qb = q + (((long long)bi * sq + q0) * h + head) * d;
  T* ob = o + (((long long)bi * sq + q0) * h + head) * d;
  const T* kb = k + ((long long)bi * sk * kh + kvh) * d;
  const T* vb = v + ((long long)bi * sk * kh + kvh) * d;

  // n rows from src into shared rows of `words` words (as the mma kernel)
  auto copy_rows = [&](uint32_t* dst, int words, const T* src, long long stride, int n) {
    const int chunks = vec16 ? d * (int)sizeof(T) / 16 : d;
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
  auto load_stage = [&](int slot, int k0, int rows) {
    const long long src = (long long)k0 * kvrow;
    copy_rows(ks + slot * st * KW, KW, kb + src, kvrow, rows);
    copy_rows(vs + slot * st * VW, VW, vb + src, kvrow, rows);
    cp_async_commit();
  };
  auto next_stage = [&](int& k0, int& kend) {
    k0 += min(st, kend - k0);
    if (k0 == kend) kend += bk;
  };

  const int n_stages = sk / bk * per_tile;
  const bool skip = causal && q_offset >= 0;
  const int tile_groups = (bq + 15) / 16;

  // padding columns d..DP of K, V and q, and rows past a tile's last stage,
  // read as 0 (the copies, after this, write only real elements)
  {
    const int dw = d * (int)sizeof(T) / 4, kpad = DP * (int)sizeof(T) / 4 - dw;
    for (int i = tid; i < 2 * st * kpad; i += nthreads) {
      const int r = i / kpad, c = dw + i % kpad;
      ks[r * KW + c] = 0u;
      vs[r * VW + c] = 0u;
    }
    const int r1 = bk % st ? bk % st : st, tail = st - r1;
    for (int i = tid; i < 2 * tail * KW; i += nthreads)
      ks[(i / (tail * KW)) * st * KW + r1 * KW + i % (tail * KW)] = 0u;
    for (int i = tid; i < 2 * tail * VW; i += nthreads)
      vs[(i / (tail * VW)) * st * VW + r1 * VW + i % (tail * VW)] = 0u;
    for (int i = tid; i < 16 * groups * kpad; i += nthreads)
      qs[(i / kpad) * KW + dw + i % kpad] = 0u;
  }
  __syncthreads();

  for (int g0 = 0; g0 < tile_groups; g0 += groups) {  // passes of groups * 16 rows
    const int r0 = (g0 + group) * 16;                  // this group's first row of the tile
    const bool active = r0 < bq;
    int nk = n_stages;
    if (skip) {
      const long long last = (long long)q_offset + q0 + min((g0 + groups) * 16, bq) - 1;
      nk = (int)min((long long)nk, last / bk * per_tile + last % bk / st + 1);
    }
    const long long last_key =
        skip ? (long long)q_offset + q0 + min(r0 + 15, bq - 1) : LLONG_MAX;

    copy_rows(qs, KW, qb + g0 * 16 * qrow, qrow, min(groups * 16, bq - g0 * 16));
    load_stage(0, 0, min(st, bk));
    int k0 = 0, kend = bk;

    float acc[US][4];
#pragma unroll
    for (int u = 0; u < US; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int t = 0; t < nk; ++t) {
      if (t + 1 < nk) {
        int n0 = k0, nend = kend;
        next_stage(n0, nend);
        load_stage((t + 1) & 1, n0, min(st, nend - n0));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int rows = min(st, kend - k0);
      for (int c0 = 0; active && c0 < rows; c0 += KC) {  // uniform over the group
        const long long key0 = (long long)k0 + c0;
        if (key0 > last_key) break;
        const uint32_t* kt = ks + (t & 1) * st * KW;
        const uint32_t* vt = vs + (t & 1) * st * VW;
        // this warp's partial S over its columns
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const uint32_t* qr = qs + (group * 16 + gid) * KW;
#pragma unroll 4
        for (int kk = 0; kk < nu; ++kk) {
          const int c = col0 + 8 * kk;
          uint32_t a_big[4], a_small[4];
          float x[4];
          if constexpr (F32) {
            const uint2 w0 = *reinterpret_cast<const uint2*>(qr + c + 2 * tig);
            const uint2 w1 = *reinterpret_cast<const uint2*>(qr + 8 * KW + c + 2 * tig);
            x[0] = __uint_as_float(w0.x);
            x[1] = __uint_as_float(w1.x);
            x[2] = __uint_as_float(w0.y);
            x[3] = __uint_as_float(w1.y);
          } else {
            const uint32_t w0 = qr[c / 2 + tig], w1 = qr[8 * KW + c / 2 + tig];
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
              const uint2 w = *reinterpret_cast<const uint2*>(kr + c + 2 * tig);
              mma3(s[nt], a_big, a_small, __uint_as_float(w.x), __uint_as_float(w.y));
            } else {
              const uint32_t w = kr[c / 2 + tig];
              mma2(s[nt], a_big, a_small, w << 16, w & 0xffff0000u);
            }
          }
        }
        // the group's partials, added in slice order by every warp
        group_sync(bar, bar_threads);  // the last sub-tile's partials are read
        float* mine = part + warp * (NT * 128);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float4*>(mine + (nt * 32 + lane) * 4) =
              make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
        group_sync(bar, bar_threads);
        const float* gp = part + group * NS * (NT * 128);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float4 a = *reinterpret_cast<const float4*>(gp + (nt * 32 + lane) * 4);
          for (int j = 1; j < NS; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(gp + (j * NT * 32 + nt * 32 + lane) * 4);
            a.x += b.x;
            a.y += b.y;
            a.z += b.z;
            a.w += b.w;
          }
          s[nt][0] = a.x;
          s[nt][1] = a.y;
          s[nt][2] = a.z;
          s[nt][3] = a.w;
        }
        // the mask, then the online softmax on the fragment
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 8 * nt + 2 * tig + (e & 1);
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
        for (int u = 0; u < US; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] *= corr[e >> 1];
        // acc += P V over this warp's columns
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t p_big[4], p_small[4];
          split(s[nt][0], p_big[0], p_small[0]);
          split(s[nt][2], p_big[1], p_small[1]);
          split(s[nt][1], p_big[2], p_small[2]);
          split(s[nt][3], p_big[3], p_small[3]);
          const uint32_t* v0 = vt + (c0 + 8 * nt + 2 * tig) * VW;
#pragma unroll
          for (int u = 0; u < US; ++u) {
            if (u >= nu) break;
            const int col = col0 + 8 * u + gid;
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
#pragma unroll
      for (int u = 0; u < US; ++u) {
        if (u >= nu) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + gid + 8 * i, col = col0 + 8 * u + 2 * tig;
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
}

template <typename T, int KC>
int split_launch_t(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
                   int h, int kh, int d, int bq, int bk, int st, int causal, int q_offset,
                   float scale, int threads, int smem, cudaStream_t s) {
  static int smem_allowed = 0;  // the largest size set so far for this kernel
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(flash_split_kernel<T, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    smem_allowed = smem;
  }
  const int vec16 = (d * (int)sizeof(T)) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  dim3 grid((unsigned)(b * h), (unsigned)(sq / bq));
  flash_split_kernel<T, KC><<<grid, threads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, h, kh, d, bq, bk, st, causal,
      q_offset, scale, vec16);
  return (int)cudaGetLastError();
}

template <typename T, int KC>
int split_attributes_t(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, flash_split_kernel<T, KC>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// calls f.template operator()<T, KC>() for the sub-tile split_plan gives d
// in this type, else returns cudaErrorInvalidValue (0 < kc is checked first)
template <typename F>
int split_dispatch(int dtype, int d, F f) {
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  const int dp = split_d(d);
  if (dp == 0) return (int)cudaErrorInvalidValue;
  const int kc = split_plan(dp, dtype == DTYPE_F32 ? 4 : 2).kc;
  if (kc == 0) return (int)cudaErrorInvalidValue;
  // the sub-tiles split_plan gives: f32 32, 16 and 8 keys; bf16 32 and 16
  if (dtype == DTYPE_F32)
    return kc == 32 ? f.template operator()<float, 32>()
         : kc == 16 ? f.template operator()<float, 16>()
                    : f.template operator()<float, 8>();
  return kc == 32 ? f.template operator()<__nv_bfloat16, 32>()
                  : f.template operator()<__nv_bfloat16, 16>();
}

struct SplitLaunch {
  const void *q, *k, *v;
  void* o;
  int b, sq, sk, h, kh, d, bq, bk, st, causal, q_offset;
  float scale;
  int threads, smem;
  cudaStream_t s;
  template <typename T, int KC>
  int operator()() const {
    return split_launch_t<T, KC>(q, k, v, o, b, sq, sk, h, kh, d, bq, bk, st, causal, q_offset,
                                 scale, threads, smem, s);
  }
};

struct SplitAttr {
  int *regs, *local_bytes;
  template <typename T, int KC>
  int operator()() const {
    return split_attributes_t<T, KC>(regs, local_bytes);
  }
};

// cfg as flash_attention_mma_launch takes it
int split_launch(const void* q, const void* k, const void* v, void* o, const int* cfg,
                 float scale, cudaStream_t stream) {
  const int b = cfg[0], sq = cfg[1], sk = cfg[2], h = cfg[3], kh = cfg[4], d = cfg[5],
            bq = cfg[6], bk = cfg[7], causal = cfg[8], q_offset = cfg[9], dtype = cfg[10],
            threads = cfg[11], smem = cfg[12], st = cfg[13];
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2, dp = split_d(d);
  if (dp == 0 || b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || kh <= 0 || bq <= 0 || bk <= 0 ||
      sq % bq != 0 || sk % bk != 0 || h % kh != 0 || sq / bq > 65535 || st <= 0)
    return (int)cudaErrorInvalidValue;
  const SplitPlan pl = split_plan(dp, itemsize);
  const int groups = (bq + 15) / 16 < pl.groups ? (bq + 15) / 16 : pl.groups;
  if (pl.kc == 0 || st % pl.kc != 0 || threads != 32 * split_slices(dp) * groups ||
      (long long)smem < split_smem(groups, st, pl.kc, dp, itemsize))
    return (int)cudaErrorInvalidValue;
  return split_dispatch(dtype, d,
                        SplitLaunch{q, k, v, o, b, sq, sk, h, kh, d, bq, bk, st, causal,
                                    q_offset, scale, threads, smem, stream});
}

int split_attributes(int d, int dtype, int* regs, int* local_bytes) {
  return split_dispatch(dtype, d, SplitAttr{regs, local_bytes});
}

}  // namespace flash_mma
