// Mamba2 SSD chunked scan, hand-written for Hopper.
//
// Replaces the two Pallas kernels of src/repro/kernels/ssd_scan.py:
// _ssd_chunk_kernel (lines 24-52, pallas_call at 82: per (batch, chunk) the
// intra-chunk term, the chunk's own state and its decay) and
// _ssd_inter_kernel (lines 55-61, pallas_call at 121: the inter-chunk term
// C . S_prev * exp(cs)), together with the jnp recurrence between them
// (lax.scan S <- S * decay + S_loc from initial_state, lines 106-116) and the
// cumsum the second pass recomputes (lines 119-120). Inputs x [b,s,nh,dh],
// dt [b,s,nh] and B, C [b,s,N] in one type (f32 or bf16), A [nh] f32;
// everything is computed in f32 and y = y_intra + y_inter is rounded once to
// x's type; the final state is f32.
//
// What bounds it on the H100: bytes. The whole scan must read x, dt, B, C
// and write y and the final state once: ~435 MB at mamba2-780m widths
// (b=8, s=4096, nh=48, dh=64, N=128, bf16), 0.13 ms at 3.35 TB/s, while the
// work it needs (~80 GFLOP with the causal half of each chunk's L x L block)
// is 0.08 ms at the bf16 tensor-core peak. These kernels do every product as
// f32 FMAs on the CUDA cores, so they cannot go below FLOP / 67e12 s
// (~1.2 ms). So these kernels take only what the tensor-core routes do not
// (repro_torch/kernels/ssd_scan.py::route decides before the launch): bf16
// at the sizes csrc/ssd_scan_wgmma.cu is instantiated for (dh 64, N 64 or
// 128, chunk 64-256) take that kernel, every other call whose block fits
// takes the mma route (split products on mma.sync, no y_inter scratch:
// csrc/ssd_scan_mma.cu up to dh 128, N 128 and chunk 256 where a chunk's
// tiles fit a block, csrc/ssd_scan_stream.cu the rest, its chunks streamed
// in sub-tiles), and this file's state and intra kernels run what is left:
// N above what two warps' streamed block holds (352 in f32, 640 in bf16).
// Its chunk cumsum (ssd_cumsum_launch) runs first on every route.
//
// What the design does about it. The Pallas block holds an [L, L, nh] f32
// decay tensor in VMEM (12.6 MB at L=256, nh=48); a Hopper block has 227 KB.
// So the work is cut three ways, in three launches on one stream:
//
//  1. ssd_cumsum_kernel: one thread per (batch, chunk, head) adds dt*A row
//     by row into cs [b,s,nh] f32 (rounded multiply, rounded add: the order
//     repro_torch/kernels/ssd_scan.py::chunk_cumsum adds in). Both other
//     kernels read cs; nothing recomputes it.
//  2. ssd_state_kernel: one block per (batch, head, slice of ps columns of
//     dh) walks the chunks in order, so the recurrence costs no launch per
//     chunk. It keeps the carried state [ps][N] in shared memory, stages C
//     and B rows tq at a time, writes y_inter = (C_l . S_prev) exp(cs_l) for
//     its columns into an f32 scratch, accumulates the chunk's own state
//     sum_l (dt_l exp(cs_L - cs_l) x_l) B_l and then folds it in:
//     S <- S * exp(cs_L) + S_loc. S_loc and S_prev never reach device
//     memory. Last it writes the final state.
//     The y_inter scratch does: f32 [b,s,nh,dh], 402.7 MB at mamba2-780m
//     widths, written here and read back by kernel 3, so 805 MB of traffic
//     beyond the scan's 435 MB bound (0.24 ms at 3.35 TB/s). It is small
//     beside the FMA time; the wgmma route keeps y_inter in registers.
//  3. ssd_intra_kernel: one block per (batch, chunk, row tile of tl rows).
//     It computes C . B^T for its rows once ([<=L][tl] in shared memory,
//     B staged tl rows at a time) and reuses it for every head. For each
//     head it stages dt*x tl rows at a time, forms the masked decay tile
//     P = G * exp(cs_l - cs_s) (s <= l) on the fly, accumulates P . (dt x)
//     into an f32 tile, and finally writes y = cast(acc + y_inter). Only the
//     row tiles at or below the diagonal are walked (the causal half).
//
// Every product (C.B^T, P.(dt x), C.S, (dt x)^T.B) is one shared-memory
// matrix product, gemm_kmajor: both operands k-major, each thread a 4x4
// register tile fed by two float4 loads per step of k, so 16 FMAs cost two
// shared-memory loads (a scalar inner loop pays two loads per FMA). Hence
// the output dims are whole float4s: dh and N are zero-padded to 4 (dh4,
// N4) in shared memory, and operands that arrive row-major from device
// memory (C, B rows; the state) are stored transposed.
//
// Tiles: every call picks them (repro_torch/kernels/ssd_scan.py::row_tile,
// state_plan) so that its blocks fit: the largest row tile tl of 64, 32,
// 16, 8 (at most L rounded up to 4), the largest state tile tq of 32, 16,
// 8, and with it the largest state slice ps of 64, 32, 16, 8 (at most dh
// rounded up to 4). A chunk that tl or tq does not divide ends in a masked
// tile (its missing rows staged as zeros, never written), and a dh that ps
// does not divide in a masked slice, so any dh, N and chunk launch whose
// smallest tiles fit (chunks up to about 3,500 rows at dh and N of 256).
//
// Shared memory (repro_torch/kernels/ssd_scan.py::smem_bytes_*), f32:
//   intra: lt*(tl+4) + tl*dh4 + 2*lt + max(2*N*(tl+4), tl*dh4 + tl*(tl+4)),
//     lt = L rounded up to whole row tiles
//   state: N*(tq+4) + tq*N4 + tq*ps + 2*pad4(L) + N4*ps + ps*(N4+4)
//   At L=256, N=128, dh=64 (tl 64, tq 32, ps 64) that is 157,696 B and
//   111,616 B; at dh 128, N 256, L 256 the row tile drops to 32.
// Resource model (resource_model.py::ssd_scan_resources): the three
// launches' times added, each as blocks in waves over the SMs at the
// occupancy shared memory and threads allow.
#include "common.cuh"

template <typename T>
__global__ void ssd_cumsum_kernel(const T* __restrict__ dt, const float* __restrict__ A,
                                  float* __restrict__ cs, long long n_rows, int L, int nh) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * nh) return;
  const long long bc = idx / nh;
  const int h = (int)(idx - bc * nh);
  const T* d = dt + bc * L * nh + h;
  float* o = cs + bc * L * nh + h;
  const float a = A[h];
  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    // no fused multiply-add: the plain version rounds the product first
    acc = __fadd_rn(acc, __fmul_rn(to_float(d[(long long)l * nh]), a));
    o[(long long)l * nh] = acc;
  }
}

// pad a count of floats to a whole number of float4s (keeps every shared
// array 16-byte aligned)
__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// out(m, n) = sum over k of A[k*lda + m] * B[k*ldb + n], for m < M, n < Nn,
// both operands in shared memory, k-major. Each thread owns 4x4 output tiles
// (tile t: rows 4*(t / (Nn/4)), columns 4*(t % (Nn/4)), so neighbouring
// threads read neighbouring float4s of B and the same float4 of A) and sums
// over k in ascending order in registers; epi(m, n, value) takes each
// result. M and Nn are multiples of 4, as are lda, ldb and both bases.
template <typename Epi>
__device__ __forceinline__ void gemm_kmajor(const float* __restrict__ A, int lda,
                                            const float* __restrict__ B, int ldb, int M,
                                            int Nn, int K, Epi epi) {
  const int tiles_n = Nn >> 2;
  const int tiles = (M >> 2) * tiles_n;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int m0 = (t / tiles_n) << 2, n0 = (t % tiles_n) << 2;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(A + k * lda + m0);
      const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + n0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(m0 + i, n0 + j, acc[i][j]);
  }
}

// Stage rows x cols values of T (row r at src + r * ld) into shared memory
// as f32: store(r, c, value) puts each one, and zeros into the rest of
// rows_to x cols_to (a masked tile's missing rows, padded columns), so
// that no stale value reaches a product. Rows whose length, stride and start
// are whole 16-byte vectors go by 16-byte loads, several in flight per
// thread; anything else element by element.
template <typename T, typename Store>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long ld, int rows,
                                           int cols, int rows_to, int cols_to, Store store) {
  constexpr int V = Vec16<T>::N;
  if (cols % V == 0 && ld % V == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int vpr = cols / V, total = rows * vpr;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = idx / vpr, c0 = (idx - r * vpr) * V;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * ld + c0);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) store(r, c0 + e, to_float(v[e]));
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int r = idx / cols, c = idx - r * cols;
      store(r, c, to_float(src[r * ld + c]));
    }
  }
  if (rows < rows_to || cols < cols_to) {
    for (int idx = threadIdx.x; idx < rows_to * cols_to; idx += blockDim.x) {
      const int r = idx / cols_to, c = idx - r * cols_to;
      if (r >= rows || c >= cols) store(r, c, 0.f);
    }
  }
}

template <typename T>
__global__ void ssd_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                                 const T* __restrict__ B, const T* __restrict__ C,
                                 const float* __restrict__ cs, const float* __restrict__ s0,
                                 float* __restrict__ y_inter, float* __restrict__ s_final,
                                 int nc, int L, int nh, int dh, int N, int tq, int ps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int np = pad4(N), ldc = tq + 4, ldd = np + 4;
  float* Ct = smem;                  // [N][tq+4]  C rows, transposed
  float* Bt = Ct + N * ldc;          // [tq][N4]   B rows
  float* xt = Bt + tq * np;          // [tq][ps]   x * w
  float* ecs = xt + tq * ps;         // [L]        exp(cs_l)
  float* wl = ecs + pad4(L);         // [L]        w_l = dt_l * exp(cs_L - cs_l)
  float* St = wl + pad4(L);          // [N4][ps]   carried state, transposed
  float* dS = St + np * ps;          // [ps][N4+4] this chunk's own state

  const int tid = threadIdx.x, nt = blockDim.x;
  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const int p0 = blockIdx.y * ps, pc = min(ps, dh - p0);  // this slice's columns of dh
  const long long s = (long long)nc * L;
  const long long sbase = ((long long)bi * nh + h) * dh + p0;  // [b,nh,dh,N] row of q=0
  const long long xrow = (long long)nh * dh;                    // x and y_inter row stride

  for (int idx = tid; idx < ps * np; idx += nt) {
    const int q = idx / np, n = idx - q * np;
    St[n * ps + q] = s0 && q < pc && n < N ? s0[(sbase + q) * N + n] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const long long row0 = bi * s + (long long)c * L;
    const float cs_end = cs[(row0 + L - 1) * nh + h];
    for (int l = tid; l < L; l += nt) {
      const float cl = cs[(row0 + l) * nh + h];
      ecs[l] = expf(cl);
      wl[l] = to_float(dt[(row0 + l) * nh + h]) * expf(cs_end - cl);
    }
    for (int j0 = 0; j0 < L; j0 += tq) {
      const int rows = min(tq, L - j0);  // fewer in a masked last tile
      __syncthreads();  // St, ecs and wl are current; the last tile's readers are done
      const T* crow = C + (row0 + j0) * N;
      const T* brow = B + (row0 + j0) * N;
      stage_rows(crow, N, rows, N, tq, N, [&](int j, int n, float v) { Ct[n * ldc + j] = v; });
      stage_rows(brow, N, rows, N, tq, np, [&](int j, int n, float v) { Bt[j * np + n] = v; });
      stage_rows(x + (row0 + j0) * xrow + h * dh + p0, xrow, rows, pc, tq, ps,
                 [&](int j, int q, float v) { xt[j * ps + q] = j < rows ? v * wl[j0 + j] : v; });
      __syncthreads();
      // inter-chunk term for these rows: (C_l . S_prev[q, :]) * exp(cs_l)
      float* yo = y_inter + (row0 + j0) * xrow + h * dh + p0;
      gemm_kmajor(Ct, ldc, St, ps, tq, ps, N, [&](int j, int q, float v) {
        if (j < rows && q < pc) yo[j * xrow + q] = v * ecs[j0 + j];
      });
      // this chunk's own state: sum over the rows of xt[l][q] * B_l[n]
      const bool first = j0 == 0;
      gemm_kmajor(xt, ps, Bt, np, ps, np, tq, [&](int q, int n, float v) {
        float* d = dS + q * ldd + n;
        *d = first ? v : *d + v;
      });
    }
    __syncthreads();  // every reader of St and writer of dS in this chunk is done
    const float decay = expf(cs_end);
    for (int idx = tid; idx < ps * np; idx += nt) {
      const int n = idx / ps, q = idx - n * ps;
      St[idx] = St[idx] * decay + dS[q * ldd + n];
    }
    __syncthreads();  // before the next chunk's ecs, wl and dS are written
  }
  for (int idx = tid; idx < pc * N; idx += nt) {
    const int q = idx / N, n = idx - q * N;
    s_final[(sbase + q) * N + n] = St[n * ps + q];
  }
}

template <typename T>
__global__ void ssd_intra_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                                 const T* __restrict__ B, const T* __restrict__ C,
                                 const float* __restrict__ cs,
                                 const float* __restrict__ y_inter, T* __restrict__ y,
                                 int L, int nh, int dh, int N, int tl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldt = tl + 4, dhp = pad4(dh);
  const int lt = (L + tl - 1) / tl * tl;  // the chunk's rows, padded to whole row tiles
  float* Gt = smem;                      // [lt][tl+4]  C_l . B_s, transposed (s-major)
  float* acc = Gt + lt * ldt;            // [tl][dh4]
  float* csh = acc + tl * dhp;           // [lt]        one head's cumsum
  float* dth = csh + lt;                 // [lt]        one head's dt
  float* stage = dth + lt;
  float* Cs = stage;                     // phase 1: [N][tl+4]  C rows, transposed
  float* Bs = Cs + N * ldt;              //          [N][tl+4]  B rows, transposed
  float* xs = stage;                     // phase 2: [tl][dh4]  dt * x
  float* Pt = xs + tl * dhp;             //          [tl][tl+4] masked decay * G, s-major

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long row0 = (long long)blockIdx.x * L;  // first row of the chunk in [b*s]
  const int rt = blockIdx.y, l0 = rt * tl, n_st = rt + 1;
  const int rows = min(tl, L - l0);  // fewer in a masked last row tile
  const long long xrow = (long long)nh * dh;

  // phase 1: G = C . B^T for rows l0.. of this tile against the s tiles at
  // or below the diagonal; shared by every head
  stage_rows(C + (row0 + l0) * N, N, rows, N, tl, N,
             [&](int i, int n, float v) { Cs[n * ldt + i] = v; });
  for (int st = 0; st < n_st; ++st) {
    __syncthreads();
    stage_rows(B + (row0 + st * tl) * N, N, min(tl, L - st * tl), N, tl, N,
               [&](int j, int n, float v) { Bs[n * ldt + j] = v; });
    __syncthreads();
    float* gs = Gt + st * tl * ldt;
    gemm_kmajor(Cs, ldt, Bs, ldt, tl, tl, N,
                [&](int i, int j, float v) { gs[j * ldt + i] = v; });
  }

  // phase 2: every head reuses G
  for (int h = 0; h < nh; ++h) {
    __syncthreads();  // G is complete; the last head's readers are done
    for (int l = tid; l < n_st * tl; l += nt) {
      csh[l] = l < L ? cs[(row0 + l) * nh + h] : 0.f;
      dth[l] = l < L ? to_float(dt[(row0 + l) * nh + h]) : 0.f;
    }
    for (int idx = tid; idx < tl * dhp; idx += nt) acc[idx] = 0.f;
    for (int st = 0; st < n_st; ++st) {
      const int s0 = st * tl, srows = min(tl, L - s0);
      __syncthreads();  // csh and dth are current; the last tile's readers are done
      stage_rows(x + (row0 + s0) * xrow + h * dh, xrow, srows, dh, tl, dhp,
                 [&](int j, int p, float v) { xs[j * dhp + p] = v * dth[s0 + j]; });
      for (int idx = tid; idx < tl * tl; idx += nt) {
        const int j = idx / tl, i = idx - j * tl;
        const int la = l0 + i, sa = s0 + j;
        Pt[j * ldt + i] = sa <= la && la < L ? Gt[sa * ldt + i] * expf(csh[la] - csh[sa]) : 0.f;
      }
      __syncthreads();
      gemm_kmajor(Pt, ldt, xs, dhp, tl, dhp, tl,
                  [&](int i, int p, float v) { acc[i * dhp + p] += v; });
    }
    __syncthreads();
    for (int idx = tid; idx < rows * dh; idx += nt) {
      const int i = idx / dh, p = idx - i * dh;
      const long long o = (row0 + l0 + i) * xrow + h * dh + p;
      y[o] = from_float<T>(acc[i * dhp + p] + y_inter[o]);
    }
  }
}

static long long intra_smem(int L, int N, int dh, int tl) {
  const long long ldt = tl + 4, dhp = pad4(dh), lt = (L + tl - 1) / tl * (long long)tl;
  const long long stage1 = 2LL * N * ldt;
  const long long stage2 = tl * dhp + tl * ldt;
  const long long stage = stage1 > stage2 ? stage1 : stage2;
  return 4LL * (lt * ldt + tl * dhp + 2LL * lt + stage);
}

static long long state_smem(int L, int N, int tq, int ps) {
  const long long np = pad4(N);
  return 4LL * ((long long)N * (tq + 4) + tq * np + (long long)tq * ps + 2LL * pad4(L) +
                np * ps + ps * (np + 4));
}

// the chunk cumsum alone, cs [n_rows * L, nh] f32 from dt in `dtype`; the
// bf16 wgmma route (csrc/ssd_scan_wgmma.cu) launches it too
extern "C" int ssd_cumsum_launch(const void* dt, const void* A, void* cs, long long n_rows,
                                 int L, int nh, int dtype, void* stream) {
  if (n_rows <= 0 || L <= 0 || nh <= 0 || (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  const long long n_cs = n_rows * nh;
  const unsigned blocks = (unsigned)((n_cs + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    ssd_cumsum_kernel<float><<<blocks, 256, 0, st>>>((const float*)dt, (const float*)A,
                                                     (float*)cs, n_rows, L, nh);
  else
    ssd_cumsum_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        (const __nv_bfloat16*)dt, (const float*)A, (float*)cs, n_rows, L, nh);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  const void* s0, void* cs, void* y_inter, void* y, void* s_final, int b, int s,
                  int nh, int dh, int N, int L, int tl, int tq, int ps, int threads,
                  int smem_intra, int smem_state, cudaStream_t st) {
  const int nc = s / L;
  const long long n_rows = (long long)b * nc;
  cudaError_t e = (cudaError_t)ssd_cumsum_launch(
      dt, A, cs, n_rows, L, nh, sizeof(T) == 4 ? DTYPE_F32 : DTYPE_BF16, st);
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(ssd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_state);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)e;
  }
  ssd_state_kernel<T><<<dim3((unsigned)(b * nh), (unsigned)((dh + ps - 1) / ps)), threads,
                        smem_state, st>>>(
      (const T*)x, (const T*)dt, (const T*)B, (const T*)C, (const float*)cs,
      (const float*)s0, (float*)y_inter, (float*)s_final, nc, L, nh, dh, N, tq, ps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_intra);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  ssd_intra_kernel<T><<<dim3((unsigned)n_rows, (unsigned)((L + tl - 1) / tl)), threads,
                        smem_intra, st>>>(
      (const T*)x, (const T*)dt, (const T*)B, (const T*)C, (const float*)cs,
      (const float*)y_inter, (T*)y, L, nh, dh, N, tl);
  return (int)cudaGetLastError();
}

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* s0, void* cs, void* y_inter, void* y,
                               void* s_final, int b, int s, int nh, int dh, int N, int L,
                               int tl, int tq, int ps, int dtype, int threads, int smem_intra,
                               int smem_state, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || dh <= 0 || N <= 0 || L <= 0 || tl <= 0 || tq <= 0 ||
      ps <= 0 || s % L != 0 || tl % 4 != 0 || tq % 4 != 0 || ps % 4 != 0 ||
      (dh + ps - 1) / ps > 65535 || (L + tl - 1) / tl > 65535 || threads < 32 ||
      threads > 1024 || (long long)smem_intra < intra_smem(L, N, dh, tl) ||
      (long long)smem_state < state_smem(L, N, tq, ps) ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch<float>(x, dt, A, B, C, s0, cs, y_inter, y, s_final, b, s, nh, dh, N, L, tl,
                         tq, ps, threads, smem_intra, smem_state, st);
  return launch<__nv_bfloat16>(x, dt, A, B, C, s0, cs, y_inter, y, s_final, b, s, nh, dh, N,
                               L, tl, tq, ps, threads, smem_intra, smem_state, st);
}
