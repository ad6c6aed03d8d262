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
// What the design does about it: one block per `block_rows` rows (the DSE's
// tile) walks its rows one after another. w is converted to f32 into shared
// memory once per block. Each row is read once from device memory with
// 16-byte loads where d allows (neighbouring threads on neighbouring
// addresses), kept in shared memory as f32 while the sum of squares
// accumulates in f32, reduced across each warp with shuffles and then across
// the block, and written once. Statistics are f32 and the result is cast
// back to the input type, as in the Pallas kernel. The ragged last block
// masks its rows; nothing is padded.
//
// Shared memory (repro_torch/kernels/rmsnorm.py::smem_bytes):
//   4 * (2 * d + 33) bytes: w and one row in f32, 33 floats for the reduction.
// Resource model (resource_model.py::rmsnorm_resources):
//   n_blocks = ceil(rows / block_rows), per block: flops = 4 * block_rows * d,
//   bytes = (2 * block_rows * d + d) * itemsize,
//   est = waves * max(flops / (peak_f32 / C), bytes / (hbm_bw / C)),
//   waves = ceil(n_blocks / (132 * blocks per SM)),
//   C = max(min(n_blocks, 132 * blocks per SM), 132), blocks per SM being
//   what shared memory and threads allow.
#include "common.cuh"

template <typename T, bool VECTOR>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               T* __restrict__ out, int rows, int d, int block_rows,
                               float eps) {
  extern __shared__ float smem[];
  float* ws = smem;         // [d]  w in f32
  float* xs = smem + d;     // [d]  the current row in f32
  float* red = smem + 2 * d;  // [33] block reduction
  constexpr int V = Vec16<T>::N;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int c = tid; c < d; c += nt) ws[c] = to_float(w[c]);
  __syncthreads();

  const int r0 = blockIdx.x * block_rows;
  const int r1 = min(r0 + block_rows, rows);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (size_t)r * d;
    T* orow = out + (size_t)r * d;
    float ss = 0.f;
    if (VECTOR) {
      for (int c = tid * V; c < d; c += nt * V) {
        uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
        const T* pv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = to_float(pv[k]);
          xs[c + k] = f;
          ss += f * f;
        }
      }
    } else {
      for (int c = tid; c < d; c += nt) {
        const float f = to_float(xr[c]);
        xs[c] = f;
        ss += f * f;
      }
    }
    // each thread reads back only the xs entries it wrote itself, so the
    // barriers inside block_sum are the only ones a row needs
    const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);
    if (VECTOR) {
      for (int c = tid * V; c < d; c += nt * V) {
        uint4 raw;
        T* po = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) po[k] = from_float<T>((xs[c + k] * inv) * ws[c + k]);
        *reinterpret_cast<uint4*>(orow + c) = raw;
      }
    } else {
      for (int c = tid; c < d; c += nt) orow[c] = from_float<T>((xs[c] * inv) * ws[c]);
    }
  }
}

template <typename T>
static int launch(const void* x, const void* w, void* out, int rows, int d, int block_rows,
                  float eps, int vector, int threads, int smem, cudaStream_t s) {
  auto kern = vector ? rmsnorm_kernel<T, true> : rmsnorm_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)e;
  }
  const int grid = (rows + block_rows - 1) / block_rows;
  kern<<<grid, threads, smem, s>>>((const T*)x, (const T*)w, (T*)out, rows, d, block_rows, eps);
  return (int)cudaGetLastError();
}

extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int d,
                              int block_rows, float eps, int dtype, int vector, int threads,
                              int smem, void* stream) {
  const int v = dtype == DTYPE_F32 ? 4 : 8;
  if (rows <= 0 || d <= 0 || block_rows <= 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || (vector && d % v != 0) || smem < 4 * (2 * d + 33) ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch<float>(x, w, out, rows, d, block_rows, eps, vector, threads, smem, s);
  return launch<__nv_bfloat16>(x, w, out, rows, d, block_rows, eps, vector, threads, smem, s);
}
