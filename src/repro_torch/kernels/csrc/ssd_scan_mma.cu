// Mamba2 SSD chunked scan on Hopper's tensor cores at f32 accuracy: one walk
// over the chunks per (batch, head), every product on mma.sync with each
// f32 operand split into parts that the tensor core multiplies exactly, the
// carried state in registers, no y_inter scratch.
//
// Replaces the Pallas kernels of src/repro/kernels/ssd_scan.py,
// _ssd_chunk_kernel (body at 24, pallas_call at 82: per (batch, chunk) the
// intra-chunk term, the chunk's own state and its decay) and
// _ssd_inter_kernel (body at 55, pallas_call at 121: C . S_prev * exp(cs)),
// with the lax.scan recurrence between them (106-116), for every call that
// csrc/ssd_scan_wgmma.cu is not instantiated for (f32 inputs; bf16 at chunk
// 32, or another dh, N or chunk) up to dh 128, N 128 and chunk 256 where
// one chunk's tiles fit a block's shared memory; csrc/ssd_scan_stream.cu
// takes the rest of the route, its chunks streamed in sub-tiles (the rules
// are repro_torch/kernels/ssd_scan.py::route and mma_streams). Same function:
// x [b,s,nh,dh], dt [b,s,nh], B and C [b,s,N] in one type (f32 or bf16), A
// [nh] f32; y = y_intra + y_inter rounded once to x's type, the final state
// in f32, `initial_state` threaded in. Nothing is rounded on the way: the
// splits keep f32 (ssd_scan_plain rounds nowhere on this route).
//
// What bounds it on the H100: bytes at mamba2-780m widths (b=8 s=4096 nh=48
// dh=64 N=128, bf16): x, dt, B, C read and y, the final state written once,
// ~435 MB, 0.13 ms at 3.35 TB/s. The kernel it replaces ran every product
// as f32 FMAs on the CUDA cores (at most 67 TFLOP/s) and sent y_inter
// through an f32 scratch of y's size (805 MB of traffic). One TF32 product
// keeps 10 mantissa bits and would not hold f32 to its plain version
// (PLAIN_REL, 2^-14 of each row's largest value). So:
//  - f32 inputs: m16n8k8 TF32, each f32 operand split into big = tf32(x)
//    and small = x - big (csrc/mma_tf32.cuh, as flash attention's mma
//    route): three products a product;
//  - bf16 inputs: C, B and x are exact in bf16, so each product has at most
//    one f32 operand (S_prev, x w or P). It is split into three bf16 parts,
//    hi + mid + lo (what is left is below 2^-24 of it), and each part
//    multiplied on m16n8k16 bf16: three products of twice the depth, G = C
//    . B^T one. On the H100 an m16n8k16 bf16 mma.sync issues as fast as an
//    m16n8k8 TF32 one (scripts/ssd_mma_profile.py measures both), so this
//    takes 3 issues where split TF32 takes 4 per 16 of depth (C, B and x
//    exact: two products of two steps), and 1 where it takes 2 for G. An
//    all-TF32 version of this kernel was slower at mamba2-780m widths; this
//    departs from it for that reason.
//
// The design. Two launches on one stream:
//  1. ssd_cumsum_kernel (csrc/ssd_scan.cu, unchanged): cs [b,s,nh] f32 in
//     the order repro_torch/kernels/ssd_scan.py::chunk_cumsum adds.
//  2. ssd_mma_kernel: one CTA per (batch, head), head fastest, so the heads
//     that run together share a batch's B and C rows in L2. Warp w owns
//     columns 16w .. 16w + 15 of dh (dh zero-padded inside the kernel to 32,
//     64 or 128: 2, 4 or 8 warps; the padded columns are not written) and
//     holds its 16 x N slice of the carried state S in registers as m16n8 C
//     fragments (N padded to 64 or 128: 32 or 64 floats a thread; the
//     padding columns stay 0). The CTA walks the chunks in order, so the
//     recurrence costs no launch. A chunk's C, B and x rows come in the
//     input type through 16-byte cp.async (element copies where a row is
//     not whole 16-byte vectors) into a ring of two stages where two fit,
//     else one; the next chunk's copy and its cs and dt (into registers) are
//     issued right after the barrier that opens a chunk, so they land while
//     it is computed. Per chunk, with cs, dt, exp(cs_l) and
//     w_l = dt_l exp(cs_L - cs_l) in shared memory (two sets, by the
//     chunk's parity), over row tiles of 32 rows:
//       - G = C_tile . B^T over the m16n8 tiles at or below the diagonal,
//         shared out among the warps (four partial sums a tile, so four
//         products are in flight), and P = G exp(cs_l - cs_s) dt_s, masked
//         to s <= l, written once to shared memory in f32;
//       - (a) acc = C_tile . S_prev^T, S's C fragments giving the B
//         fragments in registers: for TF32 every reduction index is taken
//         permuted (logical k = tig <-> physical 2 tig, tig + 4 <->
//         2 tig + 1), under which a C fragment's columns 2 tig, 2 tig + 1
//         are a B fragment's rows; for bf16 they are one bf16 pair of m16n8k16's
//         B fragment as they stand. Each row is scaled by exp(cs_l) before
//         anything else adds to acc;
//       - a barrier, then (c) acc += P . x, P the A operand (8-byte pairs of
//         a P row, read by every warp), x the B operand;
//       - (d) y = acc, rounded once to x's type, two columns a store;
//     then (b) S <- S exp(cs_L), and S += (x w)^T . B accumulated straight
//     into S's fragments (S_prev is unchanged until then). bf16 tiles are
//     read with ldmatrix (x4; .trans for x and for B in (b)). The final
//     state is written in f32 at the end. Neither S nor y_inter reaches
//     device memory. A chunk of one row tile takes two barriers (one more
//     with one stage, and one a row tile where P has one buffer).
//
// Traps, and what the code does about them:
//  - the decay is never factored as exp(cs_l) exp(-cs_s): cs reaches about
//    -115 at chunk 256 and exp(+115) overflows f32. exp(cs_l - cs_s) is
//    taken per (l, s) pair; where s > l it may be inf, and the mask's select
//    drops it before anything reads it. Every exp is expf (w as torch.exp
//    gives it; P and exp(cs_l) reach y, held to 2^-14 in f32).
//  - padding: a chunk's rows are padded to 16 (rows past L read as zero,
//    with w = dt = 0 and cs = cs_L, so they add nothing), N to 64 or 128 and
//    dh to 16 w; the stage tiles are zeroed once, and the copies write only
//    real elements, so the padding stays zero.
//  - banks: shared rows of C, B and x are padded to 8 words mod 32 (f32:
//    the 8-byte pairs of 8 rows hit 32 distinct banks) or 4 mod 32 (bf16:
//    ldmatrix's 8 rows of 16 bytes do), P's rows to 8 mod 32. f32's scalar
//    reads of rows 2 tig and 2 tig + 1 (x, and B in (b)) meet 2-way
//    conflicts; f32 runs at the CI sizes, bound by latency.
//
// What holds it: latency. At mamba2-780m widths, chunk 32, a warp issues
// 226 bf16 products a chunk (G's share 16, (a) 96, (c) 18, (b) 96), three
// warps to an SM sub-partition (three CTAs an SM, 168 registers a thread);
// at mma.sync's issue rate that is about a third of a chunk's time
// (scripts/ssd_mma_profile.py sets the two side by side). The rest is the
// chain of dependent phases between a chunk's two barriers, which three
// CTAs do not hide; copying the chunk's rows by TMA boxes instead of
// cp.async, or reordering the products, moved it by no more than 2% in
// trials on the H100.
//
// Shared memory (repro_torch/kernels/ssd_scan.py::smem_bytes_mma), with
// LP = L padded to 16, NP = N padded to 64 or 128, DP = dh padded to 16 w:
//   4 * (stages * LP * (2 * in_words(NP) + in_words(DP)) + 8 * LP
//        + pbufs * 32 * p_words(LP)),
//   stages 2 and P buffers 2 (1 where a chunk has one row tile) where they
//   fit 227 KB, else fewer stages first: 50,176 B at mamba2-780m widths and
//   chunk 32.
// Threads (ssd_scan.py::mma_threads): 32 w. Registers: the launch bounds ask
// for 168 a thread (three CTAs an SM at dh 64); the compiler's count is
// ssd_scan_mma_attributes.
// Resource model (resource_model.py::ssd_scan_resources): the cumsum and one
// walk per (batch, head), the walk's products at the TF32 peak over 3 (f32)
// or the bf16 peak over 3 (bf16).
#include "ssd_mma.cuh"

// csrc/ssd_scan.cu
extern "C" int ssd_cumsum_launch(const void* dt, const void* A, void* cs, long long n_rows,
                                 int L, int nh, int dtype, void* stream);

namespace {

constexpr int MAX_L = 256;  // the longest chunk the kernel takes
constexpr int MAX_N = 128;  // the largest state size

// 8-column tiles of the state a warp holds: N padded to 64 or 128
__host__ __device__ constexpr int n_tiles(int n) { return n <= 64 ? 8 : n <= MAX_N ? 16 : 0; }
// warps of a CTA: one per 16 columns of dh padded to 32, 64 or 128
__host__ __device__ constexpr int warps_for(int dh) {
  return dh <= 32 ? 2 : dh <= 64 ? 4 : dh <= 128 ? 8 : 0;
}
// CTAs an SM is asked to hold: as many as leave a thread 168 registers
__host__ __device__ constexpr int min_blocks(int w) {
  return 65536 / (32 * w * 168) > 0 ? 65536 / (32 * w * 168) : 1;
}

long long plan_bytes(int L, int N, int dh, int itemsize, int stages, int pbufs) {
  const int lp = pad16(L), cw = in_words(8 * n_tiles(N), itemsize);
  const int xw = in_words(16 * warps_for(dh), itemsize);
  return 4LL * ((long long)stages * lp * (2 * cw + xw) + 8LL * lp +
                (long long)pbufs * RT * p_words(lp));
}

struct Plan {
  int stages, pbufs;
  long long bytes;
};

// the ring's stages and P's buffers: two each where they fit (one P buffer
// where a chunk has one row tile), fewer stages first; stages 0 where one
// stage and one buffer do not fit
Plan plan(int L, int N, int dh, int itemsize) {
  const int pmax = pad16(L) > RT ? 2 : 1;
  const int opts[4][2] = {{2, 2}, {2, 1}, {1, 2}, {1, 1}};
  for (const auto& o : opts) {
    if (o[1] > pmax) continue;
    const long long b = plan_bytes(L, N, dh, itemsize, o[0], o[1]);
    if (b <= SMEM_LIMIT) return {o[0], o[1], b};
  }
  return {0, 0, 0};
}

// Fragments, lane = 4 * gid + tig. m16n8k8 TF32 (f32 inputs): A (16 x 8)
// a[e] at row gid + 8 * (e & 1), logical column tig + 4 * (e >> 1); B
// (8 x 8) b[e] at logical row tig + 4 * e, column gid; every reduction index
// is taken permuted: logical tig + 4 * i is physical 2 * tig + i.
// m16n8k16 bf16 (bf16 inputs): A (16 x 16) a[e] the pair at row
// gid + 8 * (e & 1), columns 2 * tig + 8 * (e >> 1) and + 1; B (16 x 8) b[e]
// the pair at rows 2 * tig + 8 * e and + 1, column gid. C (16 x 8) of both:
// c[e] at row gid + 8 * (e >> 1), column 2 * tig + (e & 1).
template <typename T, int W, int NT>
__global__ void __launch_bounds__(32 * W, min_blocks(W))
    ssd_mma_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ cs,
                   const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_final,
                   int s, int nh, int dh, int N, int L, int stages, int pbufs, int vec_bc,
                   int vec_x) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NTH = 32 * W, QV = MAX_L / NTH;
  constexpr int CW = in_words(8 * NT, sizeof(T)), XW = in_words(16 * W, sizeof(T));
  extern __shared__ __align__(16) uint32_t smem[];
  const int LP = pad16(L), PW = p_words(LP);
  const int CT = LP * CW;             // words of a stage's C (and B) rows
  const int SW = 2 * CT + LP * XW;    // words of a stage: C, B and x rows
  // [2][4][LP]: cs_l, dt_l, exp(cs_l) and w_l of the even and odd chunks
  float* const vbase = reinterpret_cast<float*>(smem + stages * SW);
  float* const pbuf = vbase + 8 * LP;  // [pbufs][RT][PW]: P of a row tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int lm = lane / 8, li = lane % 8;  // ldmatrix: the lane's matrix and row
  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const int nc = s / L, p0 = 16 * warp;
  const long long xrow = (long long)nh * dh;

  // the stage tiles' padding must read as 0: zero them once; the copies
  // write only real elements
  for (int i = tid; i < stages * SW; i += NTH) smem[i] = 0u;
  __syncthreads();

  // rows [0, L) of src (stride elements apart, cols elements each) into
  // shared rows of `words` words, by 16-byte cp.async where rows are whole
  // vectors (the caller commits), else element by element; each thread
  // walks its (row, unit) pairs without dividing
  auto copy_rows = [&](uint32_t* dst, int words, const T* src, long long stride, int cols,
                       int v16) {
    const int per = v16 ? cols * (int)sizeof(T) / 16 : cols;  // units of a row
    const int step_r = NTH / per, step_c = NTH % per;
    int r = tid / per, c = tid % per;
    while (r < L) {
      if (v16)
        cp_async16(dst + r * words + 4 * c, src + r * stride + c * (16 / (int)sizeof(T)));
      else
        reinterpret_cast<T*>(dst + r * words)[c] = src[r * stride + c];
      r += step_r;
      c += step_c;
      if (c >= per) {
        c -= per;
        ++r;
      }
    }
  };
  auto load_chunk = [&](int c, int st) {
    uint32_t* sc = smem + st * SW;
    const long long r0 = (long long)bi * s + (long long)c * L;
    copy_rows(sc, CW, Cm + r0 * N, N, N, vec_bc);
    copy_rows(sc + CT, CW, Bm + r0 * N, N, N, vec_bc);
    copy_rows(sc + 2 * CT, XW, x + r0 * xrow + (long long)h * dh, xrow, dh, vec_x);
    cp_async_commit();
  };
  // a chunk's cs and dt (strided by nh) into registers, QV rows a thread,
  // and cs_L; dt stays in its type until it is used, so that nothing waits
  // for the loads before the next chunk
  float pcs[QV], pend;
  T pdt[QV];
  auto prefetch = [&](int c) {
    const long long r0 = (long long)bi * s + (long long)c * L;
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      const int l = tid + q * NTH;
      if (l < L) {
        pcs[q] = cs[(r0 + l) * nh + h];
        pdt[q] = dt[(r0 + l) * nh + h];
      }
    }
    pend = cs[(r0 + L - 1) * nh + h];
  };

  // this warp's 16 x N slice of the carried state: S[j] is the C fragment
  // of columns 8j .. 8j + 7
  float S[NT][4];
  const long long srow = ((long long)bi * nh + h) * dh;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + gid + 8 * (e >> 1), n = 8 * j + 2 * tig + (e & 1);
      S[j][e] = (s0 != nullptr && p < dh && n < N) ? s0[(srow + p) * N + n] : 0.f;
    }

  prefetch(0);
  load_chunk(0, 0);
  for (int c = 0; c < nc; ++c) {
    const int st = stages == 2 ? (c & 1) : 0;
    float* const vcs = vbase + (c & 1) * 4 * LP;
    float* const vdt = vcs + LP;
    float* const vec = vdt + LP;
    float* const vw = vec + LP;
    const float cs_end = pend;
    // the chunk's vectors; rows past L add nothing (w = dt = 0)
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      const int l = tid + q * NTH;
      if (l < L) {
        const float d = to_float(pdt[q]);
        vcs[l] = pcs[q];
        vdt[l] = d;
        vec[l] = expf(pcs[q]);
        vw[l] = d * expf(cs_end - pcs[q]);
      } else if (l < LP) {
        vcs[l] = cs_end;
        vdt[l] = 0.f;
        vec[l] = 0.f;
        vw[l] = 0.f;
      }
    }
    cp_async_wait<0>();
    // the chunk's tiles and vectors are in, and every warp is done with
    // chunk c - 1: its stage, vectors and P are free
    __syncthreads();
    if (c + 1 < nc) {
      if (stages == 2) load_chunk(c + 1, st ^ 1);
      prefetch(c + 1);
    }
    const uint32_t* sc = smem + st * SW;  // C rows
    const uint32_t* sb = sc + CT;         // B rows
    const uint32_t* sx = sb + CT;         // x rows
    const long long ybase =
        ((long long)bi * s + (long long)c * L) * xrow + (long long)h * dh;

    for (int i = 0, r0 = 0; r0 < LP; ++i, r0 += RT) {
      const int mts = LP - r0 >= RT ? 2 : 1;  // m16 tiles in this row tile
      float* const P = pbuf + (pbufs == 2 ? (i & 1) : 0) * RT * PW;
      if (pbufs == 1 && i > 0) __syncthreads();  // the last row tile's readers of P are done

      // G = C_tile . B^T over the m16n8 tiles at or below the diagonal,
      // shared out among the warps; P = G exp(cs_l - cs_s) dt_s, masked to
      // s <= l, into shared memory
      const int ng0 = r0 / 8 + 2;  // s-tiles of m-tile 0 (m-tile 1 has two more)
      const int ntiles = ng0 + (mts == 2 ? ng0 + 2 : 0);
      for (int t = warp; t < ntiles; t += W) {
        const int mt = t < ng0 ? 0 : 1, sn = t - mt * ng0;
        const int R = r0 + 16 * mt;
        // four partial sums, so that four products are in flight, added at
        // the end
        float gp[4][4] = {};
        if constexpr (F32) {
          const uint32_t* ca = sc + (R + gid) * CW + 2 * tig;
          const uint32_t* bb = sb + (8 * sn + gid) * CW + 2 * tig;
#pragma unroll
          for (int kk = 0; kk < NT; ++kk) {
            uint32_t ab[4], as[4];
            split_pairs(ld2(ca + 8 * kk), ld2(ca + 8 * CW + 8 * kk), ab, as);
            const float2 bv = ld2(bb + 8 * kk);
            mma3(gp[kk % 4], ab, as, bv.x, bv.y);
          }
        } else {  // bf16: both exact, one bf16 product a step of 16
          const uint32_t* ca = sc + (R + li + 8 * (lm & 1)) * CW + 4 * (lm >> 1);
          const uint32_t* bb = sb + (8 * sn + li) * CW + 4 * lm;
#pragma unroll
          for (int k4 = 0; k4 < NT / 4; ++k4) {  // columns 32 k4 .. 32 k4 + 31 of n
            uint32_t bw[4], c0[4], c1[4];
            ldsm4(bw, bb + 16 * k4);      // B fragments of both steps of 16
            ldsm4(c0, ca + 16 * k4);      // A fragment of the first
            ldsm4(c1, ca + 16 * k4 + 8);  // and of the second
            mma_bf16(gp[2 * (k4 & 1)], c0, bw[0], bw[1]);
            mma_bf16(gp[2 * (k4 & 1) + 1], c1, bw[2], bw[3]);
          }
        }
        float g[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) g[e] = (gp[0][e] + gp[1][e]) + (gp[2][e] + gp[3][e]);
        const int sc0 = 8 * sn + 2 * tig;  // this thread's columns sc0, sc0 + 1
        const float cs0 = vcs[sc0], cs1 = vcs[sc0 + 1], d0 = vdt[sc0], d1 = vdt[sc0 + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int l = R + gid + 8 * hh;
          const float cl = vcs[l];
          // exp(cs_l - cs_s), never exp(cs_l) exp(-cs_s); where s > l it may
          // be inf, and the select drops it
          const float v0 = sc0 <= l ? g[2 * hh] * expf(cl - cs0) * d0 : 0.f;
          const float v1 = sc0 + 1 <= l ? g[2 * hh + 1] * expf(cl - cs1) * d1 : 0.f;
          *reinterpret_cast<float2*>(P + (l - r0) * PW + sc0) = make_float2(v0, v1);
        }
      }

      // (a) acc = C_tile . S_prev^T: S's C fragment of columns 8kk .. is the
      // B fragment of this warp's two column tiles
      float acc[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int pt = 0; pt < 2; ++pt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][pt][e] = 0.f;
      if constexpr (F32) {
#pragma unroll
        for (int k2 = 0; k2 < NT / 2; ++k2) {  // k-steps 2 k2 and 2 k2 + 1
          uint32_t sbig[2][4], ssmall[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) split(S[2 * k2 + q][e], sbig[q][e], ssmall[q][e]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= mts) break;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const uint32_t* ca = sc + (r0 + 16 * mt + gid) * CW + 8 * (2 * k2 + q) + 2 * tig;
              uint32_t ab[4], as[4];
              split_pairs(ld2(ca), ld2(ca + 8 * CW), ab, as);
#pragma unroll
              for (int pt = 0; pt < 2; ++pt)
                mma_parts(acc[mt][pt], ab, as, sbig[q][2 * pt], sbig[q][2 * pt + 1],
                          ssmall[q][2 * pt], ssmall[q][2 * pt + 1]);
            }
          }
        }
      } else {
        // bf16: C exact; S_prev in three bf16 parts, whose pairs (columns
        // 2 tig, 2 tig + 1 of S's C fragments 2 k2 and 2 k2 + 1) are the B
        // fragments of the step of 16
#pragma unroll
        for (int k2 = 0; k2 < NT / 2; ++k2) {
          uint32_t b0[2][3], b1[2][3];  // [pt][part]
#pragma unroll
          for (int pt = 0; pt < 2; ++pt) {
            split3(S[2 * k2][2 * pt], S[2 * k2][2 * pt + 1], b0[pt]);
            split3(S[2 * k2 + 1][2 * pt], S[2 * k2 + 1][2 * pt + 1], b1[pt]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= mts) break;
            uint32_t cw[4];
            ldsm4(cw, sc + (r0 + 16 * mt + li + 8 * (lm & 1)) * CW + 4 * (lm >> 1) + 8 * k2);
#pragma unroll
            for (int pt = 0; pt < 2; ++pt)
#pragma unroll
              for (int q = 0; q < 3; ++q) mma_bf16(acc[mt][pt], cw, b0[pt][q], b1[pt][q]);
          }
        }
      }
      // rows times exp(cs_l) before any P . x product adds to them
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float el = vec[r0 + 16 * mt + gid + 8 * (e >> 1)];
          acc[mt][0][e] *= el;
          acc[mt][1][e] *= el;
        }
      __syncthreads();  // P is complete

      // (c) acc += P . x over s <= the m-tile's last row, 16 rows of s a step
      const int k2_end = r0 / 16 + mts;
      for (int k2 = 0; k2 < k2_end; ++k2) {
        if constexpr (F32) {
          // x rows 16 k2 + 8 q + 2 tig and + 1 at this thread's column of
          // column tile pt: xb[q][pt] = {b0, b1}
          uint32_t xb[2][2][2];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int pt = 0; pt < 2; ++pt) {
              const uint32_t* xr = sx + (16 * k2 + 8 * q + 2 * tig) * XW + p0 + 8 * pt + gid;
              xb[q][pt][0] = xr[0];
              xb[q][pt][1] = xr[XW];
            }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= mts || k2 > r0 / 16 + mt) continue;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float* pr = P + (16 * mt + gid) * PW + 16 * k2 + 8 * q + 2 * tig;
              uint32_t ab[4], as[4];
              split_pairs(ld2(pr), ld2(pr + 8 * PW), ab, as);
#pragma unroll
              for (int pt = 0; pt < 2; ++pt)
                mma3(acc[mt][pt], ab, as, __uint_as_float(xb[q][pt][0]),
                     __uint_as_float(xb[q][pt][1]));
            }
          }
        } else {
          // bf16: x exact, its B fragments by ldmatrix.trans (matrix 2 q + pt:
          // rows 16 k2 + 8 q .., columns p0 + 8 pt ..); P in three parts
          uint32_t xr[4];
          ldsm4t(xr, sx + (16 * k2 + li + 8 * (lm >> 1)) * XW + p0 / 2 + 4 * (lm & 1));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= mts || k2 > r0 / 16 + mt) continue;
            const float* pr = P + (16 * mt + gid) * PW + 16 * k2 + 2 * tig;
            const float2 v[4] = {ld2(pr), ld2(pr + 8 * PW), ld2(pr + 8), ld2(pr + 8 * PW + 8)};
            uint32_t a[3][4];
            split3_frag(v, a);
#pragma unroll
            for (int pt = 0; pt < 2; ++pt)
#pragma unroll
              for (int q = 0; q < 3; ++q) mma_bf16(acc[mt][pt], a[q], xr[pt], xr[2 + pt]);
          }
        }
      }

      // (d) y, once, in x's type: two neighbouring columns a store where dh
      // is even (then every pair is aligned)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int l = r0 + 16 * mt + gid + 8 * hh;
          if (mt >= mts || l >= L) continue;
#pragma unroll
          for (int pt = 0; pt < 2; ++pt) {
            const int col = p0 + 8 * pt + 2 * tig;
            if (col >= dh) continue;
            T* dst = y + ybase + l * xrow + col;
            const float v0 = acc[mt][pt][2 * hh], v1 = acc[mt][pt][2 * hh + 1];
            if constexpr (F32) {
              if (dh % 2 == 0) {
                *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
              } else {
                dst[0] = v0;
                if (col + 1 < dh) dst[1] = v1;
              }
            } else {
              if (dh % 2 == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
              } else {
                dst[0] = __float2bfloat16(v0);
                if (col + 1 < dh) dst[1] = __float2bfloat16(v1);
              }
            }
          }
        }
    }

    // (b) S <- S exp(cs_L) + (x w)^T . B, accumulated into S's fragments:
    // A = (x w)^T (this warp's columns of x, the chunk's rows), B = B rows,
    // 16 rows a step
    const float decay = expf(cs_end);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] *= decay;
    for (int k2 = 0; k2 < LP / 16; ++k2) {
      if constexpr (F32) {
        // rows ra = 16 k2 + 8 q + 2 tig and ra + 1: a[0] (column p0 + gid,
        // row ra), a[1] (p0 + 8 + gid, ra), a[2] and a[3] (row ra + 1)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ra = 16 * k2 + 8 * q + 2 * tig;
          const float wa = vw[ra], wb = vw[ra + 1];
          const uint32_t* xa = sx + ra * XW + p0 + gid;
          uint32_t ab[4], as[4];
          split(__uint_as_float(xa[0]) * wa, ab[0], as[0]);
          split(__uint_as_float(xa[8]) * wa, ab[1], as[1]);
          split(__uint_as_float(xa[XW]) * wb, ab[2], as[2]);
          split(__uint_as_float(xa[XW + 8]) * wb, ab[3], as[3]);
          const uint32_t* bra = sb + ra * CW + gid;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma3(S[j], ab, as, __uint_as_float(bra[8 * j]), __uint_as_float(bra[CW + 8 * j]));
        }
      } else {
        // bf16: x by ldmatrix.trans (matrix 2 q + pt: rows 16 k2 + 8 q ..,
        // columns p0 + 8 pt ..) is (x w)^T's A fragment once scaled by w;
        // x w in three parts; B exact, by ldmatrix.trans too
        uint32_t xr[4];
        ldsm4t(xr, sx + (16 * k2 + li + 8 * (lm >> 1)) * XW + p0 / 2 + 4 * (lm & 1));
        const float2 wa = ld2(vw + 16 * k2 + 2 * tig), wb = ld2(vw + 16 * k2 + 8 + 2 * tig);
        float2 v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xv = bf16x2_unpack(xr[e]), w = e < 2 ? wa : wb;
          v[e] = make_float2(xv.x * w.x, xv.y * w.y);
        }
        uint32_t a[3][4];
        split3_frag(v, a);
        const uint32_t* bq = sb + (16 * k2 + li + 8 * (lm & 1)) * CW + 4 * (lm >> 1);
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          uint32_t bw[4];  // B fragments of columns 16 j2 .. and 16 j2 + 8 ..
          ldsm4t(bw, bq + 8 * j2);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            mma_bf16(S[2 * j2], a[q], bw[0], bw[1]);
            mma_bf16(S[2 * j2 + 1], a[q], bw[2], bw[3]);
          }
        }
      }
    }
    if (stages == 1) {
      __syncthreads();  // every warp is done with the stage
      if (c + 1 < nc) load_chunk(c + 1, 0);
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + gid + 8 * (e >> 1), n = 8 * j + 2 * tig + (e & 1);
      if (p < dh && n < N) s_final[(srow + p) * N + n] = S[j][e];
    }
}

template <typename T, int W, int NT>
int launch(const void* x, const void* dt, const void* B, const void* C, const void* s0,
           const void* cs, void* y, void* s_final, int b, int s, int nh, int dh, int N, int L,
           const Plan& pl, int smem, cudaStream_t st) {
  static int smem_allowed = 0;  // the largest size set so far for this kernel
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(ssd_mma_kernel<T, W, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch's check would report it
      return (int)e;
    }
    smem_allowed = smem;
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_bc = (N * (int)sizeof(T)) % 16 == 0 && aligned(B) && aligned(C);
  const int vec_x = (dh * (int)sizeof(T)) % 16 == 0 && aligned(x);
  ssd_mma_kernel<T, W, NT><<<(unsigned)(b * nh), 32 * W, smem, st>>>(
      (const T*)x, (const T*)dt, (const T*)B, (const T*)C, (const float*)cs, (const float*)s0,
      (T*)y, (float*)s_final, s, nh, dh, N, L, pl.stages, pl.pbufs, vec_bc, vec_x);
  return (int)cudaGetLastError();
}

template <typename T, int W, int NT>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, ssd_mma_kernel<T, W, NT>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// calls f.template operator()<T, W, NT>() for an instantiated (dtype, warps,
// state tiles), else returns cudaErrorInvalidValue
template <typename F>
int dispatch(int dtype, int w, int nt, F f) {
#define SSD_MMA_CASE(W_, NT_)                                                  \
  if (w == W_ && nt == NT_)                                                    \
    return dtype == DTYPE_F32 ? f.template operator()<float, W_, NT_>()        \
                              : f.template operator()<__nv_bfloat16, W_, NT_>();
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  SSD_MMA_CASE(2, 8)
  SSD_MMA_CASE(2, 16)
  SSD_MMA_CASE(4, 8)
  SSD_MMA_CASE(4, 16)
  SSD_MMA_CASE(8, 8)
  SSD_MMA_CASE(8, 16)
#undef SSD_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

struct Launch {
  const void *x, *dt, *B, *C, *s0, *cs;
  void *y, *s_final;
  int b, s, nh, dh, N, L;
  Plan pl;
  int smem;
  cudaStream_t st;
  template <typename T, int W, int NT>
  int operator()() const {
    return launch<T, W, NT>(x, dt, B, C, s0, cs, y, s_final, b, s, nh, dh, N, L, pl, smem, st);
  }
};

struct Attr {
  int *regs, *local_bytes;
  template <typename T, int W, int NT>
  int operator()() const {
    return attributes<T, W, NT>(regs, local_bytes);
  }
};

}  // namespace

// csrc/ssd_scan_stream.cu: the calls this file's kernel does not take
int ssd_stream_launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                      const void* s0, void* cs, void* y, void* s_final, int b, int s, int nh,
                      int dh, int N, int L, int dtype, int threads, int smem, void* stream);

// x [b,s,nh,dh], dt [b,s,nh], B and C [b,s,N] in one type (dtype), A [nh]
// f32, s0 [b,nh,dh,N] f32 or null; cs [b,s,nh] f32 is the cumsum's output;
// y in x's type and s_final [b,nh,dh,N] f32 are written. threads and smem
// must be what repro_torch/kernels/ssd_scan.py's mma_launch gives. A call
// above dh 128, N 128 or chunk 256, or whose chunk tiles do not fit a block
// (ssd_scan.py::mma_streams), goes to the streamed kernel.
extern "C" int ssd_scan_mma_launch(const void* x, const void* dt, const void* A, const void* B,
                                   const void* C, const void* s0, void* cs, void* y,
                                   void* s_final, int b, int s, int nh, int dh, int N, int L,
                                   int dtype, int threads, int smem, void* stream) {
  const int w = warps_for(dh);
  if (N > 0 && L > 0 && (N > MAX_N || L > MAX_L || w == 0 ||
                         plan(L, N, dh, dtype == DTYPE_F32 ? 4 : 2).stages == 0))
    return ssd_stream_launch(x, dt, A, B, C, s0, cs, y, s_final, b, s, nh, dh, N, L, dtype,
                             threads, smem, stream);
  if (b <= 0 || s <= 0 || nh <= 0 || dh <= 0 || N <= 0 || L <= 0 || s % L != 0 ||
      threads != 32 * w || (dtype != DTYPE_F32 && dtype != DTYPE_BF16) ||
      (long long)b * nh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan(L, N, dh, dtype == DTYPE_F32 ? 4 : 2);
  if (pl.stages == 0 || (long long)smem < pl.bytes) return (int)cudaErrorInvalidValue;
  const int e = ssd_cumsum_launch(dt, A, cs, (long long)b * (s / L), L, nh, dtype, stream);
  if (e != 0) return e;
  return dispatch(dtype, w, n_tiles(N),
                  Launch{x, dt, B, C, s0, cs, y, s_final, b, s, nh, dh, N, L, pl, smem,
                         (cudaStream_t)stream});
}

// the compiler's registers per thread and local (spill) bytes at one head
// dim and state size
extern "C" int ssd_scan_mma_attributes(int dh, int N, int dtype, int* regs, int* local_bytes) {
  return dispatch(dtype, warps_for(dh), n_tiles(N), Attr{regs, local_bytes});
}
