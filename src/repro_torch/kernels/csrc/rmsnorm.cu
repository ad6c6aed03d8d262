// RMSNorm, out = x * rsqrt(mean(x^2) + eps) * w, hand-written for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (pallas_call in rmsnorm(), lines 9-34; callers flatten leading dims as
// src/repro/kernels/ops.py:31-38 does).
//
// What bounds it on the H100: bytes. A row of d elements is read once and
// written once, with about 4 FLOP per element: 2 * rows * d * itemsize bytes
// plus w, ~1 FLOP per byte in bf16, far below the f32 units' ridge. The least
// time is (2 * rows * d + d) * itemsize / 3.35e12 s.
//
// What the design does about it: to stream at the memory rate, each SM
// needs tens of KB of loads in flight. A CTA of THREADS = 512 threads takes
// `block_rows` rows (the DSE's tile); each of its 16 warps owns whole rows
// (rows warp, warp + 16, ...), so a row needs no barrier: the sum of squares
// is reduced with warp shuffles only. w is converted to f32 into shared
// memory once per CTA. Four paths, chosen by the wrapper
// (repro_torch/kernels/rmsnorm.py::path) before the launch:
//   registers: rows of whole 16-byte vectors of at most 8 KB. Each lane
//     issues all its NV <= 16 vector loads of the row at once and keeps them
//     in registers for the write (64 registers at d = 4096 in bf16), so 16
//     warps hold 128 KB in flight per CTA. The two-pass path on the same
//     rows is 1.2-2.7x slower (chip_smoke.py's rmsnorm sweep prints both).
//   two-pass: longer rows of whole vectors. The first pass reads the row for
//     the sum of squares, the second reads it again (from L2: a CTA's rows in
//     flight are a few hundred KB against 50 MB) and writes; HBM bytes are
//     unchanged.
//   scalar: rows that are not whole 16-byte vectors, two passes of one
//     element per lane.
//   wide: rows whose w in f32 (4 * d bytes) does not fit a block's shared
//     memory, d above 58,112. One CTA a row (block_rows sets no tile here:
//     a row already holds tens of KB of loads): each thread sums the
//     squares of its vectors (or elements), the 16 warps' sums meet in 64
//     bytes of static shared memory, and the second pass reads the row
//     again (from L2 where it is still there: 128 KB at d = 65,536 in
//     bf16) together with w from device memory (L2 after the first rows).
//     Bound by bytes like the others; it moves the row three times instead
//     of twice, and w once a row from L2. Whole 16-byte vectors where d and
//     the three pointers allow, else one element a thread.
// Statistics are f32 and the result is rounded once to the input type, as in
// the Pallas kernel. The ragged last CTA masks its rows; nothing is padded.
//
// Shared memory (repro_torch/kernels/rmsnorm.py::smem_bytes): 4 * d bytes,
//   w in f32; 0 dynamic bytes on the wide path.
// Resource model (resource_model.py::rmsnorm_resources):
//   n_blocks = ceil(rows / block_rows), threads = 512, registers per thread
//   modelled as 4 * NV + 32 on the register path (NV vectors per lane), 40
//   on the others; flops = 4 * rows * d, bytes = (2 * rows * d + n_blocks * d)
//   * itemsize, est = waves * max(flops / (peak_f32 / C), bytes / (hbm_bw / C)),
//   waves = ceil(n_blocks / (132 * blocks per SM)),
//   C = max(min(n_blocks, 132 * blocks per SM), 132), blocks per SM being
//   what shared memory, threads and registers allow.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

enum { PATH_SCALAR = 0, PATH_TWO_PASS = 1, PATH_REGISTERS = 2, PATH_WIDE = 3 };

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& raw) {
  const T* pv = reinterpret_cast<const T*>(&raw);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < Vec16<T>::N; ++k) {
    const float f = to_float(pv[k]);
    ss += f * f;
  }
  return ss;
}

template <typename T>
__device__ __forceinline__ uint4 normalise(const uint4& raw, const float* wv, float inv) {
  const T* pv = reinterpret_cast<const T*>(&raw);
  uint4 res;
  T* po = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < Vec16<T>::N; ++k) po[k] = from_float<T>((to_float(pv[k]) * inv) * wv[k]);
  return res;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ float* load_w(const T* __restrict__ w, int d) {
  extern __shared__ float ws[];
  for (int c = threadIdx.x; c < d; c += blockDim.x) ws[c] = to_float(w[c]);
  __syncthreads();
  return ws;
}

// the row in registers: NV 16-byte vectors per lane, vector v = lane + 32 * i
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, 1)
    rmsnorm_registers(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                      int rows, int d, int block_rows, float eps) {
  constexpr int V = Vec16<T>::N;
  const float* ws = load_w(w, d);
  const int nvec = d / V, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * block_rows, r1 = min(r0 + block_rows, rows);
  for (int r = r0 + threadIdx.x / 32; r < r1; r += WARPS) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * d);
    uint4* orow = reinterpret_cast<uint4*>(out + (size_t)r * d);
    uint4 buf[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec) buf[i] = xr[lane + 32 * i];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec) ss += sum_squares<T>(buf[i]);
    const float inv = rsqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) orow[v] = normalise<T>(buf[i], ws + v * V, inv);
    }
  }
}

// two passes over the row, the second from L2: whole vectors (VECTOR) or
// one element per lane
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 1)
    rmsnorm_two_pass(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                     int rows, int d, int block_rows, float eps) {
  constexpr int V = VECTOR ? Vec16<T>::N : 1;
  const float* ws = load_w(w, d);
  const int n = d / V, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * block_rows, r1 = min(r0 + block_rows, rows);
  for (int r = r0 + threadIdx.x / 32; r < r1; r += WARPS) {
    const T* xr = x + (size_t)r * d;
    T* orow = out + (size_t)r * d;
    float ss = 0.f;
    if (VECTOR) {
#pragma unroll 4
      for (int v = lane; v < n; v += 32)
        ss += sum_squares<T>(reinterpret_cast<const uint4*>(xr)[v]);
    } else {
#pragma unroll 4
      for (int c = lane; c < n; c += 32) {
        const float f = to_float(xr[c]);
        ss += f * f;
      }
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)d + eps);
    if (VECTOR) {
#pragma unroll 4
      for (int v = lane; v < n; v += 32)
        reinterpret_cast<uint4*>(orow)[v] =
            normalise<T>(reinterpret_cast<const uint4*>(xr)[v], ws + v * V, inv);
    } else {
#pragma unroll 4
      for (int c = lane; c < n; c += 32) orow[c] = from_float<T>((to_float(xr[c]) * inv) * ws[c]);
    }
  }
}

// one row a CTA, w read from device memory: rows whose w in f32 would not
// fit shared memory; whole vectors (VECTOR) or one element per thread
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 1)
    rmsnorm_wide(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                 int rows, int d, int block_rows, float eps) {
  constexpr int V = VECTOR ? Vec16<T>::N : 1;
  __shared__ float partial[WARPS];
  const int n = d / V, tid = threadIdx.x, r = blockIdx.x;
  const T* xr = x + (size_t)r * d;
  T* orow = out + (size_t)r * d;
  float ss = 0.f;
  if (VECTOR) {
#pragma unroll 4
    for (int v = tid; v < n; v += THREADS)
      ss += sum_squares<T>(reinterpret_cast<const uint4*>(xr)[v]);
  } else {
#pragma unroll 4
    for (int c = tid; c < n; c += THREADS) {
      const float f = to_float(xr[c]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if (tid % 32 == 0) partial[tid / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) total += partial[i];
  const float inv = rsqrtf(total / (float)d + eps);
  if (VECTOR) {
#pragma unroll 4
    for (int v = tid; v < n; v += THREADS) {
      const uint4 wraw = reinterpret_cast<const uint4*>(w)[v];
      const T* pw = reinterpret_cast<const T*>(&wraw);
      float wv[V];
#pragma unroll
      for (int k = 0; k < V; ++k) wv[k] = to_float(pw[k]);
      reinterpret_cast<uint4*>(orow)[v] =
          normalise<T>(reinterpret_cast<const uint4*>(xr)[v], wv, inv);
    }
  } else {
#pragma unroll 4
    for (int c = tid; c < n; c += THREADS)
      orow[c] = from_float<T>((to_float(xr[c]) * inv) * to_float(w[c]));
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, T*, int, int, int, float);

// nv: vectors per lane on the register path; on the wide path, whether the
// rows and pointers take 16-byte vectors
template <typename T>
Kernel<T> pick(int path, int nv) {
  if (path == PATH_SCALAR) return rmsnorm_two_pass<T, false>;
  if (path == PATH_TWO_PASS) return rmsnorm_two_pass<T, true>;
  if (path == PATH_WIDE) return nv ? rmsnorm_wide<T, true> : rmsnorm_wide<T, false>;
  if (path != PATH_REGISTERS) return nullptr;
  switch (nv) {
    case 1: return rmsnorm_registers<T, 1>;
    case 2: return rmsnorm_registers<T, 2>;
    case 4: return rmsnorm_registers<T, 4>;
    case 8: return rmsnorm_registers<T, 8>;
    case 16: return rmsnorm_registers<T, 16>;
    default: return nullptr;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int d, int block_rows, float eps,
           int path, int nv, int threads, int smem, cudaStream_t s) {
  if (path == PATH_WIDE)
    nv = d % Vec16<T>::N == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  Kernel<T> kern = pick<T>(path, nv);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)e;
  }
  const int grid = path == PATH_WIDE ? rows : (rows + block_rows - 1) / block_rows;
  kern<<<grid, threads, smem, s>>>((const T*)x, (const T*)w, (T*)out, rows, d, block_rows, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// path: 0 scalar, 1 two-pass, 2 registers with `nv` vectors per lane (1, 2,
// 4, 8 or 16, at least ceil(d * itemsize / 16 / 32)), 3 wide (no shared
// memory asked; `nv` is not read)
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int d,
                              int block_rows, float eps, int dtype, int path, int nv,
                              int threads, int smem, void* stream) {
  const int v = dtype == DTYPE_F32 ? 4 : 8;
  if (rows <= 0 || d <= 0 || block_rows <= 0 || threads != THREADS ||
      ((path == PATH_TWO_PASS || path == PATH_REGISTERS) && d % v != 0) ||
      (path == PATH_REGISTERS && (long long)nv * 32 * v < d) ||
      (path != PATH_WIDE && smem < 4LL * d) || smem < 0 ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch<float>(x, w, out, rows, d, block_rows, eps, path, nv, threads, smem, s);
  return launch<__nv_bfloat16>(x, w, out, rows, d, block_rows, eps, path, nv, threads, smem, s);
}
