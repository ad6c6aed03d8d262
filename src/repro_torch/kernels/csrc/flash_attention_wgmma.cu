// Blockwise (flash) attention for bf16 on Hopper's tensor cores: both
// products on `wgmma`, K/V sub-tiles brought in by TMA.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention(), lines 24-103) for bf16 inputs at every d up to 256
// that is a multiple of 8, with block_q and block_k in {64, 128, 256, 512};
// f32 inputs, bf16 at any other d up to 256 and any other tile take
// csrc/flash_attention.cu, d above 256 csrc/flash_attention_fma.cu (the
// rule is repro_torch/kernels/flash_attention.py::route, whose WGMMA_D and
// WGMMA_BLOCKS list the same). Same function: q [b, sq, h, d], k and v
// [b, sk, kh, d], GQA (query head `hd` reads KV head `hd / (h / kh)`),
// scores scaled by 1/sqrt(d) in f32, causal keeps q_offset + i >= j, masked
// scores are -1e30 (so a fully masked row averages V), m, l and the
// accumulator in f32, an l == 0 -> 1 guard, output in bf16. P is rounded to
// bf16 for the P.V product, as every Hopper flash kernel does; l is summed
// from the f32 P. The plain version (flash_attention_plain) rounds P the
// same way on this route, and walks each block_k tile in the same
// sub-tiles.
//
// What bounds it on the H100: operations. 4 * d FLOP per (query, key) pair
// that the mask keeps, ~1,000 FLOP per byte at llama3-8b widths, far above
// the bf16 ridge of ~295; the least time is FLOP / 989e12 s.
//
// What the design does about it: one CTA per (b*h, q tile of bq rows), the
// longest causal q tiles launched first. A CTA takes its q tile in passes
// of QP = min(bq, 128) rows and walks K and V in sub-tiles of
// KS = min(bk, 128) keys (min(bk, 64) at DP 256); DP (the padded head dim),
// QP and KS are the template parameters, bq and bk loop counts, so ten
// (DP, QP, KS) take every tile of {64, 128, 256, 512}^2 at every head
// dim, and a large tile needs the shared memory and registers of
// (128, 128); each is instantiated twice, for d == DP and for d < DP (whose
// epilogue writes d columns, see flash_wgmma_kernel). A call's d is zero-padded to DP = 64 (d <= 64), 128 (d <= 128)
// or 256: the tensor maps span the call's d columns with the call's row
// stride, so TMA fills columns d .. DP-1 of q, K and V with zeros (their
// products add nothing to S, and O's padded columns stay 0), and the
// epilogue writes the first d columns. TMA needs row strides of a multiple
// of 16 bytes, hence d % 8 == 0. The scale is the call's own 1/sqrt(d). At
// d = 80 the products do DP / d = 1.6 times the work the call needs.
// Warps 0 .. 4*QP/64-1 are consumer warpgroups of 64 query rows each; the
// warps after them are the producer, whose first lane loads a pass's q rows and then that pass's K and V sub-tiles through a
// ring of STAGES = 2 stages with cp.async.bulk.tensor (3-D maps over
// [b*s, heads, d] with a box of one head, 64 columns = 128 bytes per box,
// 128-byte swizzle), each stage's completion on an mbarrier (`full`), its
// release by the consumers on another (`empty`), so the next sub-tile's
// load overlaps this one's math. Each pass restarts the ring at stage 0:
// every pass but the last is padded with empty steps (the producer arrives
// on `full` without a copy, the consumers only release the stage) to a
// multiple of 2 * STAGES steps, so each stage's phase is even at a pass's
// start and the walk within a pass is the single-pass walk, as the compiler
// schedules it (a ring position carried across passes made it schedule the
// softmax worse, and slowed the one-pass tiles). A pass's q buffer is
// released (`q_empty`) after its walk, so the next pass's q load overlaps
// the epilogue and the padding. Each pass walks K/V again; they come
// from L2 (one (batch, KV head) holds 2 MB of K and V at 4096 x 128, the 8
// KV heads of llama3-8b 16 MB of the 50 MB). Passes run last first, so with
// causal the longest walks come first within a CTA as across CTAs. Each
// consumer warpgroup computes S = Q.K^T with wgmma.m64n64k16 (both operands
// K-major in shared memory, S in registers; DP / 16 k-steps), scales S by
// log2(e)/sqrt(d) in f32, masks only the sub-tiles that cross the diagonal,
// and runs the online softmax row-parallel in registers, once a sub-tile:
// each thread owns two rows of its fragment, reduces max over its quad with
// shuffles and takes exp2f. P goes to bf16 in registers and is the register
// A operand of the P.V wgmma, V the shared-memory B operand with the
// transpose bit (V is keys x d, MN-major): one m64n64k16 per 64-column box
// of V and 16 keys, DP / 64 boxes. With causal and q_offset >= 0 a
// pass stops after the last sub-tile its rows can see: every row has seen
// key 0, so the skipped keys would add exp(-1e30 - m) = 0 and scale by 1.
// At bq <= 128 and bk <= KS a CTA runs one pass over whole tiles. No
// intermediate reaches device memory.
//
// Shared memory (repro_torch/kernels/flash_attention.py::smem_bytes_wgmma):
//   1024 (alignment slack) + 2 * DP * (QP + 2 * STAGES * KS) + 8 * (2 + 2 * STAGES)
//   bytes: a pass's q rows, STAGES K and V sub-tiles in bf16, and the
//   mbarriers (q full and empty, a full and an empty per stage); 164,912 B
//   at DP = 128 for every tile from (128, 128) up, 197,680 B at DP = 256
//   (sub-tiles of 64 keys) from (128, 64) up.
// Threads: 128 * QP / 64 consumers and a producer warp, or at DP 256 with
//   QP = 128 a producer warpgroup: 384. The compiler allocates registers in
//   warpgroups, so 288 threads leave 168 a thread, and at DP 256 O alone
//   takes 128 (with a producer warp it spilled). There the producer
//   warpgroup gives its registers back (setmaxnreg.dec to 40) and the two
//   consumer warpgroups take them (setmaxnreg.inc to 232): 2 x 128 x 232 +
//   128 x 40 = 64,512 of the SM's 65,536, the CTA launching at 168.
// Registers per thread (resource_model.py::flash_wgmma_registers, a model
//   used for feasibility and blocks per SM; the compiler's count is
//   flash_attention_wgmma_attributes, which reports the instantiation a tile
//   runs on): KS / 2 (S) + DP / 2 (O) + KS / 4 (P in bf16) + 48, rounded up
//   to 8: 208 at DP 128, KS 128 (168 compiled), 224 at DP 256, KS 64 (a
//   consumer's, within its 232). Sub-tiles of 128 keys at DP 256 would
//   take 272; nor passes of 256 rows: 544 threads leave 120 each. O is
//   never split by columns across warpgroups: each would compute S again.
// Resource model (resource_model.py::flash_attention_resources): as for the
//   FMA kernel, with the compute term at peak_flops_bf16, the work of the
//   passes and sub-tiles the kernel walks at DP, and blocks per SM also
//   dividing the SM's 65,536 registers.
// Files: the kernel template and its launch in
//   csrc/flash_attention_wgmma.cuh; the instantiations for d below 64 and
//   65-120 in csrc/flash_attention_wgmma_padded.cu and at DP 256 in
//   csrc/flash_attention_wgmma_wide.cu, translation units of their own that
//   nvcc builds beside this one.
#include "flash_attention_wgmma.cuh"

namespace flash_wgmma {

FLASH_WGMMA_INSTANCES(, 64, 64, 64, false)
FLASH_WGMMA_INSTANCES(, 64, 64, 128, false)
FLASH_WGMMA_INSTANCES(, 64, 128, 64, false)
FLASH_WGMMA_INSTANCES(, 64, 128, 128, false)
FLASH_WGMMA_INSTANCES(, 128, 64, 64, false)
FLASH_WGMMA_INSTANCES(, 128, 64, 128, false)
FLASH_WGMMA_INSTANCES(, 128, 128, 64, false)
FLASH_WGMMA_INSTANCES(, 128, 128, 128, false)
// d below 64 and 65-120 are instantiated in csrc/flash_attention_wgmma_padded.cu
FLASH_WGMMA_INSTANCES(extern, 64, 64, 64, true)
FLASH_WGMMA_INSTANCES(extern, 64, 64, 128, true)
FLASH_WGMMA_INSTANCES(extern, 64, 128, 64, true)
FLASH_WGMMA_INSTANCES(extern, 64, 128, 128, true)
FLASH_WGMMA_INSTANCES(extern, 128, 64, 64, true)
FLASH_WGMMA_INSTANCES(extern, 128, 64, 128, true)
FLASH_WGMMA_INSTANCES(extern, 128, 128, 64, true)
FLASH_WGMMA_INSTANCES(extern, 128, 128, 128, true)
// DP 256 in csrc/flash_attention_wgmma_wide.cu
FLASH_WGMMA_INSTANCES(extern, 256, 64, 64, false)
FLASH_WGMMA_INSTANCES(extern, 256, 128, 64, false)
FLASH_WGMMA_INSTANCES(extern, 256, 64, 64, true)
FLASH_WGMMA_INSTANCES(extern, 256, 128, 64, true)

// calls f.template operator()<DP, QP, KS, PADDED>() for the instantiation a
// call at head dim d and a tile of bq x bk runs on (DP = padded_d(d), passes
// of min(bq, 128) rows, sub-tiles of min(bk, max_sub_keys(DP)) keys, each
// dividing its block; PADDED where d < DP), else returns
// cudaErrorInvalidValue
template <typename F>
int dispatch(int d, int bq, int bk, F f) {
  const int dp = padded_d(d), kmax = max_sub_keys(dp);
  const int qp = bq < MAX_PASS ? bq : MAX_PASS, ks = bk < kmax ? bk : kmax;
  if (dp == 0 || bq <= 0 || bk <= 0 || bq % qp != 0 || bk % ks != 0)
    return (int)cudaErrorInvalidValue;
#define FLASH_WGMMA_CASE(D_, QP_, KS_)                                    \
  if (dp == D_ && qp == QP_ && ks == KS_)                                 \
    return d < D_ ? f.template operator()<D_, QP_, KS_, true>()          \
                  : f.template operator()<D_, QP_, KS_, false>();
  FLASH_WGMMA_CASE(64, 64, 64)
  FLASH_WGMMA_CASE(64, 64, 128)
  FLASH_WGMMA_CASE(64, 128, 64)
  FLASH_WGMMA_CASE(64, 128, 128)
  FLASH_WGMMA_CASE(128, 64, 64)
  FLASH_WGMMA_CASE(128, 64, 128)
  FLASH_WGMMA_CASE(128, 128, 64)
  FLASH_WGMMA_CASE(128, 128, 128)
  FLASH_WGMMA_CASE(256, 64, 64)
  FLASH_WGMMA_CASE(256, 128, 64)
#undef FLASH_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

// the launch of one call, for dispatch
struct Launch {
  const void *q, *k, *v;
  void* o;
  int b, sq, sk, h, kh, d, bq, causal, q_offset;
  float scale;
  int threads, smem;
  cudaStream_t s;
  template <int D, int QP, int KS, bool PADDED>
  int operator()() const {
    return launch<D, QP, KS, PADDED>(q, k, v, o, b, sq, sk, h, kh, d, bq, causal, q_offset,
                                     scale, threads, smem, s);
  }
};

// the compiler's attributes of one instantiation, for dispatch
struct Attr {
  int *regs, *local_bytes;
  template <int D, int QP, int KS, bool PADDED>
  int operator()() const {
    return attributes<D, QP, KS, PADDED>(regs, local_bytes);
  }
};

}  // namespace flash_wgmma

using namespace flash_wgmma;

extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* o, int b, int sq, int sk, int h, int kh,
                                            int d, int bq, int bk, int causal, int q_offset,
                                            float scale, int threads, int smem, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || kh <= 0 || bq <= 0 || bk <= 0 || h % kh != 0 ||
      sq % bq != 0 ||
      sk % bk != 0 || sq / bq > 65535 || (reinterpret_cast<uintptr_t>(o) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(d, bq, bk,
                  Launch{q, k, v, o, b, sq, sk, h, kh, d, bq, causal, q_offset, scale, threads,
                         smem, s});
}

// the compiler's registers per thread and local (spill) bytes for the
// instantiation a call at head dim d and a tile of bq x bk runs on
extern "C" int flash_attention_wgmma_attributes(int d, int bq, int bk, int* regs,
                                                int* local_bytes) {
  return dispatch(d, bq, bk, Attr{regs, local_bytes});
}
