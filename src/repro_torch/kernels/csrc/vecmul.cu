// Z = X * Y on a 1-D vector, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/vecmul.py::_vecmul_kernel
// (pallas_call in vecmul(), lines 24-50).
//
// What bounds it on the H100: bytes. Each element is read twice and written
// once (3 * L * itemsize bytes) for one multiply, 1/12 FLOP per byte in f32,
// far below the ~20 FLOP per byte at which the f32 units would become the
// limit. The least time is 3 * L * itemsize / 3.35e12 s.
//
// What the design does about it: one block per `block` elements (the DSE's
// tile), one 16-byte load of X, one of Y and one 16-byte store of Z per
// thread, neighbouring threads on neighbouring addresses, so every warp
// moves 512 contiguous bytes per access. The Pallas kernel pads L up to a
// multiple of `block` and slices back; here the last block masks its tail
// element by element, so no padded copy is made. Where a base pointer is not
// 16-byte aligned the same walk runs with scalar accesses. No shared memory.
//
// Resource model (repro_torch/kernels/resource_model.py::vecmul_resources):
//   threads = block / (16 / itemsize), smem = 0, n_blocks = ceil(L / block),
//   per block: flops = block, bytes = 3 * block * itemsize,
//   est = waves * max(flops / (peak_f32 / C), bytes / (hbm_bw / C)),
//   C = max(min(n_blocks, 132 SMs * blocks per SM), 132),
//   waves = ceil(n_blocks / (132 * blocks per SM)).
#include "common.cuh"

template <typename T, bool VECTOR>
__global__ void vecmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              T* __restrict__ z, long long n, int block) {
  constexpr int V = Vec16<T>::N;
  const long long i = (long long)blockIdx.x * block + (long long)threadIdx.x * V;
  if (VECTOR && i + V <= n) {
    uint4 a = *reinterpret_cast<const uint4*>(x + i);
    uint4 b = *reinterpret_cast<const uint4*>(y + i);
    uint4 c;
    const T* pa = reinterpret_cast<const T*>(&a);
    const T* pb = reinterpret_cast<const T*>(&b);
    T* pc = reinterpret_cast<T*>(&c);
#pragma unroll
    for (int k = 0; k < V; ++k) pc[k] = from_float<T>(to_float(pa[k]) * to_float(pb[k]));
    *reinterpret_cast<uint4*>(z + i) = c;
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (i + k < n) z[i + k] = from_float<T>(to_float(x[i + k]) * to_float(y[i + k]));
  }
}

template <typename T>
static void launch(const void* x, const void* y, void* z, long long n, int block,
                   int vector, cudaStream_t s) {
  const int threads = block / Vec16<T>::N;
  const long long grid = (n + block - 1) / block;
  if (vector)
    vecmul_kernel<T, true><<<(unsigned)grid, threads, 0, s>>>(
        (const T*)x, (const T*)y, (T*)z, n, block);
  else
    vecmul_kernel<T, false><<<(unsigned)grid, threads, 0, s>>>(
        (const T*)x, (const T*)y, (T*)z, n, block);
}

extern "C" int vecmul_launch(const void* x, const void* y, void* z, long long n,
                             int block, int dtype, int vector, void* stream) {
  const int v = dtype == DTYPE_F32 ? 4 : 8;
  if (n <= 0 || block <= 0 || block % v != 0 || block / v > 1024 ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  if ((n + block - 1) / block > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    launch<float>(x, y, z, n, block, vector, s);
  else
    launch<__nv_bfloat16>(x, y, z, n, block, vector, s);
  return (int)cudaGetLastError();
}
