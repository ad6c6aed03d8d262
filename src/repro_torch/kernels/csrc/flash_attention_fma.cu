// Blockwise (flash) attention with online softmax on f32 FMAs, hand-written
// for Hopper: the route for the calls that the mma route (split TF32 on the
// tensor cores: csrc/flash_attention.cu up to d 256, its split kernel
// csrc/flash_attention_split.cu up to d 1024) cannot take, head dims above
// 1024, where this kernel fits tiles of a few rows;
// csrc/flash_attention_wgmma.cu takes the bf16 tiles it is instantiated
// for. The rule is repro_torch/kernels/flash_attention.py::route.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention(), lines 24-103) for those calls: q [b, sq, h, d], k and v
// [b, sk, kh, d], GQA (query head `hd` reads KV head `hd / (h / kh)`), q
// scaled by 1/sqrt(d) in f32, causal keeps q_offset + i >= j, masked scores
// are -1e30 (not -inf, so a fully masked row averages V), m, l and the
// accumulator in f32, an l == 0 -> 1 guard, output in q's type.
//
// What bounds it on the H100: operations. 4 * d FLOP per (query, key) pair
// that the mask keeps, against (b*sq*h + 2*b*sk*kh) * d * itemsize bytes.
// This kernel does its two products as plain f32 FMAs on the CUDA cores, so
// it cannot go below FLOP / 67e12 s; it runs only where the tensor-core
// routes cannot.
//
// What the design does about it: one block of 256 threads per (b*h, q tile
// of block_q rows). The Pallas grid walks K/V in block_k slices inside the
// kernel; here the same loop runs inside the block, staging each K/V tile in
// shared memory in the input type, so each K/V element is read from device
// memory once per q tile. The q tile (pre-scaled f32), the score tile, the
// f32 accumulator and the per-row m, l and correction live in shared memory
// for the whole walk, so no intermediate goes back to device memory. Row
// strides of d+1 and block_k+1 floats keep the threads of a warp on distinct
// banks. With causal and q_offset >= 0 the walk stops after the last K tile
// that any row of the q tile can see: every row has already seen key 0, so
// the skipped tiles would add exp(-1e30 - m) = 0 and multiply by
// exp(m - m) = 1, and the output is unchanged.
//
// Shared memory (repro_torch/kernels/flash_attention.py::smem_bytes_fma):
//   4 * (bq*d + bq*(d+1) + bq*(bk+1) + bq) + 2 * bk * d * itemsize bytes.
//   The row m and the correction sit in the padding columns of the q and
//   score tiles, which keeps (64, 64) tiles at d=128 in bf16 to two blocks
//   per SM.
// Resource model (resource_model.py::flash_attention_resources):
//   n_blocks = b*h*(sq/bq); FLOP = 4*bq*bk*d per K tile walked (masked
//   entries of a walked tile are computed too);
//   bytes = q + o tiles + the K/V tiles walked, each once per q tile;
//   est = waves * max(FLOP/n_blocks / (peak_f32 / C), bytes/n_blocks / (hbm_bw / C)),
//   waves = ceil(n_blocks / (132 * blocks per SM)),
//   C = max(min(n_blocks, 132 * blocks per SM), 132), blocks per SM being
//   what shared memory and threads allow.
#include "common.cuh"

#define NEG_INF (-1e30f)

static long long flash_smem_bytes(int bq, int bk, int d, int itemsize) {
  return 4LL * ((long long)bq * d + (long long)bq * (d + 1) + (long long)bq * (bk + 1) + bq) +
         2LL * bk * d * itemsize;
}

template <typename T>
__global__ void flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                             int h, int kh, int d, int bq, int bk, int causal, int q_offset,
                             float scale) {
  extern __shared__ float smem[];
  float* acc = smem;                   // [bq][d]
  float* qs = acc + bq * d;            // [bq][d+1]  q * scale; column d holds m
  float* ss = qs + bq * (d + 1);       // [bq][bk+1] scores, then p; column bk
                                       //            holds exp(m_old - m_new)
  float* lrow = ss + bq * (bk + 1);    // [bq]
  T* ks = reinterpret_cast<T*>(lrow + bq);  // [bk][d]
  T* vs = ks + bk * d;                      // [bk][d]

  const int tid = threadIdx.x, nt = blockDim.x;
  const int bh = blockIdx.x, qt = blockIdx.y;
  const int bi = bh / h, head = bh % h, kvh = head / (h / kh);
  const int q0 = qt * bq;
  const long long qrow = (long long)h * d, kvrow = (long long)kh * d;
  const T* qb = q + ((long long)bi * sq * h + head) * d;
  T* ob = o + ((long long)bi * sq * h + head) * d;
  const T* kb = k + ((long long)bi * sk * kh + kvh) * d;
  const T* vb = v + ((long long)bi * sk * kh + kvh) * d;

  for (int idx = tid; idx < bq * d; idx += nt) {
    const int i = idx / d, c = idx - i * d;
    qs[i * (d + 1) + c] = to_float(qb[(q0 + i) * qrow + c]) * scale;
    acc[idx] = 0.f;
  }
  for (int i = tid; i < bq; i += nt) {
    qs[i * (d + 1) + d] = NEG_INF;
    lrow[i] = 0.f;
  }

  int nk = sk / bk;
  if (causal && q_offset >= 0) {
    const long long last = (long long)q_offset + q0 + bq - 1;  // last query position
    nk = (int)min((long long)nk, last / bk + 1);
  }

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * bk;
    __syncthreads();  // the previous tile's readers of ks, vs and ss are done
    for (int idx = tid; idx < bk * d; idx += nt) {
      const int j = idx / d, c = idx - j * d;
      ks[idx] = kb[(k0 + j) * kvrow + c];
      vs[idx] = vb[(k0 + j) * kvrow + c];
    }
    __syncthreads();
    // S = (q * scale) K^T: neighbouring threads take neighbouring rows
    for (int idx = tid; idx < bq * bk; idx += nt) {
      const int j = idx / bq, i = idx - j * bq;
      const float* qr = qs + i * (d + 1);
      const T* kr = ks + j * d;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qr[c], to_float(kr[c]), s);
      if (causal && q_offset + q0 + i < k0 + j) s = NEG_INF;
      ss[i * (bk + 1) + j] = s;
    }
    __syncthreads();
    // online softmax, one thread per row
    for (int i = tid; i < bq; i += nt) {
      float* sr = ss + i * (bk + 1);
      float* m = qs + i * (d + 1) + d;
      const float m_old = *m;
      float m_new = m_old;
      for (int j = 0; j < bk; ++j) m_new = fmaxf(m_new, sr[j]);
      float sum = 0.f;
      for (int j = 0; j < bk; ++j) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      const float corr = expf(m_old - m_new);
      lrow[i] = lrow[i] * corr + sum;
      *m = m_new;
      sr[bk] = corr;
    }
    __syncthreads();
    // acc = acc * corr + P V: neighbouring threads take neighbouring columns
    for (int idx = tid; idx < bq * d; idx += nt) {
      const int i = idx / d, c = idx - i * d;
      const float* pr = ss + i * (bk + 1);
      float a = acc[idx] * pr[bk];
      for (int j = 0; j < bk; ++j) a = fmaf(pr[j], to_float(vs[j * d + c]), a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < bq * d; idx += nt) {
    const int i = idx / d, c = idx - i * d;
    float l = lrow[i];
    if (l == 0.f) l = 1.f;
    ob[(q0 + i) * qrow + c] = from_float<T>(acc[idx] / l);
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
                  int h, int kh, int d, int bq, int bk, int causal, int q_offset, float scale,
                  int threads, int smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return (int)e;
  }
  dim3 grid((unsigned)(b * h), (unsigned)(sq / bq));
  flash_kernel<T><<<grid, threads, smem, s>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                               sq, sk, h, kh, d, bq, bk, causal, q_offset,
                                               scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_fma_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int sq, int sk, int h, int kh, int d, int bq,
                                      int bk, int causal, int q_offset, float scale,
                                      int dtype, int threads, int smem, void* stream) {
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2;
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || kh <= 0 || d <= 0 || bq <= 0 || bk <= 0 ||
      sq % bq != 0 || sk % bk != 0 || h % kh != 0 || sq / bq > 65535 || threads < 32 ||
      threads > 1024 || (long long)smem < flash_smem_bytes(bq, bk, d, itemsize) ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, o, b, sq, sk, h, kh, d, bq, bk, causal, q_offset, scale,
                         threads, smem, s);
  return launch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kh, d, bq, bk, causal, q_offset,
                               scale, threads, smem, s);
}
