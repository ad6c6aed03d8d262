// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exports one `extern "C"` launcher with a plain C
// interface (pointers as void*, the stream as void*), bound from Python with
// ctypes. A launcher checks its arguments, launches on the caller's stream,
// never synchronises, and returns cudaGetLastError() so that a refused launch
// (too many threads, too much shared memory) reaches the Python wrapper,
// which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with repro_torch/kernels/_build.py::DTYPE_CODES
enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// elements of T in one 16-byte vector access
template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };
