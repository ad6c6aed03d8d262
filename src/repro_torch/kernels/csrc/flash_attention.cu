// Blockwise (flash) attention with online softmax on Hopper's tensor cores
// at f32 accuracy: both products on mma.sync m16n8k8 TF32, each operand
// split into two TF32 parts.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention(), lines 24-103) for the calls that
// csrc/flash_attention_wgmma.cu does not take (f32 inputs; bf16 at a head
// dim other than 64 or 128, a block outside {64, 128, 256, 512} or a
// sequence shorter than 64), at every tile up to d 256;
// csrc/flash_attention_split.cu takes d 257-1024 on the same products, the
// head dim cut into slices of 128 columns, and csrc/flash_attention_fma.cu
// d above 1024 (the rule is repro_torch/kernels/flash_attention.py::route). Same function: q
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
// Each warp owns 16 query rows; a CTA has ceil(bq / 16) warps, at most 8
// (4 for f32 at DP 256, where 8 warps' q rows and two stages of one
// sub-tile would pass a block: max_warps), and a larger q tile runs in
// passes of 16 rows a warp (16 warps would leave 128 registers a thread;
// the kernel takes 170-255 at d 64 and up). The head dim is zero-padded
// inside the kernel to the next of 16, 32, 64, 96, 128, 160, 192 and 256
// (DP): the zero columns add nothing to Q.K^T, and the padded output
// columns are not written. The pass's q rows and K and V come in the input
// type through 16-byte cp.async (q with the first stage), K and V into a
// ring of two stages of ST keys, so the next stage's copy overlaps this
// one's products. A stage holds a whole tile of bk keys (ST = bk rounded up
// to KC) where two such stages and the q rows fit a block; else ST is the
// largest multiple of KC that fits (64 keys at f32 and DP 128) and a tile
// comes in ceil(bk / ST) stages, each starting at a multiple of ST within
// the tile. The sub-tiles, the softmax and every product are the same
// either way: only the staging differs. Up to DP 128 each warp reads its 16
// rows of q once a pass, scales them and splits them into registers (A
// fragments: DP registers for the two parts; for f32, and above DP 64,
// where the parts would not leave room beside O and the splits of K and V,
// q is held as one f32 value, DP / 2 registers, and split at each use).
// Above DP 128, O alone takes DP / 2 registers (128 at DP 256), so q stays
// in shared memory, where the pass already staged it: each product reads
// its A fragment from there (the same conflict-free pairs as K), scales
// and splits it at each use, in both types. The warps walk a
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
//   * 4 bytes; at most 232,448 at every tile up to d 256 (f32 at DP 256,
//   4 warps and 32 keys a stage: 67,584 + 134,144 B).
// Threads (flash_attention.py::mma_threads): 32 * min(ceil(bq / 16),
//   max_warps(DP, itemsize)).
// Registers per thread (resource_model.py::flash_mma_registers, a model for
//   feasibility and blocks per SM; the compiler's count is
//   flash_attention_mma_attributes): DP (Q's parts; DP / 2 where q is
//   split at each use; 0 above DP 128, where q stays in shared memory) +
//   DP / 2 (O) + KC / 2 (S) + 40, rounded up to 8.
// Resource model (resource_model.py::flash_attention_resources): as for the
//   wgmma route, with the compute term at the TF32 peak over the number of
//   products per product (3 for f32, 2 for bf16).
// Files: the kernel template and its launch in csrc/flash_attention_mma.cuh;
//   the instantiations at DP 160-256 in csrc/flash_attention_wide.cu, a
//   translation unit of their own that nvcc builds beside this one; d
//   257-1024 in csrc/flash_attention_split.cu, which the C entry points
//   below hand those calls to.
#include "flash_attention_mma.cuh"

namespace flash_mma {

// DP 160, 192 and 256 are instantiated in csrc/flash_attention_wide.cu
FLASH_MMA_INSTANCES(extern, float, 160)
FLASH_MMA_INSTANCES(extern, __nv_bfloat16, 160)
FLASH_MMA_INSTANCES(extern, float, 192)
FLASH_MMA_INSTANCES(extern, __nv_bfloat16, 192)
FLASH_MMA_INSTANCES(extern, float, 256)
FLASH_MMA_INSTANCES(extern, __nv_bfloat16, 256)

// d 257-1024, in csrc/flash_attention_split.cu
int split_launch(const void* q, const void* k, const void* v, void* o, const int* cfg,
                 float scale, cudaStream_t stream);
int split_attributes(int d, int dtype, int* regs, int* local_bytes);

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
  FLASH_MMA_CASE(160)
  FLASH_MMA_CASE(192)
  FLASH_MMA_CASE(256)
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

}  // namespace flash_mma

using namespace flash_mma;

// cfg holds b, sq, sk, h, kh, d, bq, bk, causal, q_offset, dtype, threads,
// smem and the keys a stage holds (flash_attention.py::mma_stage_keys): the
// wrapper builds it once for a call's shapes and options, so a call passes
// 7 arguments, not 20 (each costs the host a conversion). d above 256 goes
// to the split kernel.
extern "C" int flash_attention_mma_launch(const void* q, const void* k, const void* v, void* o,
                                          const int* cfg, float scale, void* stream) {
  if (cfg[5] > 256) return split_launch(q, k, v, o, cfg, scale, (cudaStream_t)stream);
  const int b = cfg[0], sq = cfg[1], sk = cfg[2], h = cfg[3], kh = cfg[4], d = cfg[5],
            bq = cfg[6], bk = cfg[7], causal = cfg[8], q_offset = cfg[9], dtype = cfg[10],
            threads = cfg[11], smem = cfg[12], st = cfg[13];
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2, dp = padded_d(d);
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || kh <= 0 || d <= 0 || dp == 0 || bq <= 0 ||
      bk <= 0 || sq % bq != 0 || sk % bk != 0 || h % kh != 0 || sq / bq > 65535 ||
      st <= 0 || st % sub_keys(dp) != 0 || threads != 32 * block_warps(bq, dp, itemsize) ||
      (long long)smem < smem_bytes(bq, st, dp, itemsize))
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, dp,
                  Launch{q, k, v, o, b, sq, sk, h, kh, d, bq, bk, st, causal, q_offset, scale,
                         threads, smem, (cudaStream_t)stream});
}

// the compiler's registers per thread and local (spill) bytes at one head dim
extern "C" int flash_attention_mma_attributes(int d, int dtype, int* regs, int* local_bytes) {
  if (d > 256) return split_attributes(d, dtype, regs, local_bytes);
  return dispatch(dtype, padded_d(d), Attr{regs, local_bytes});
}
