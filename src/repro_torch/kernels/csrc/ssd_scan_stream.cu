// The SSD scan's mma route past the whole-chunk kernel's limits: a chunk's
// rows streamed in sub-tiles, dh cut into slices across the grid, the
// carried state in shared memory, every product on mma.sync with each f32
// operand split into parts the tensor core multiplies exactly (as
// csrc/ssd_scan_mma.cu, whose notes give the products, the fragments and
// the traps; the helpers are in csrc/ssd_mma.cuh).
//
// Replaces the Pallas kernels of src/repro/kernels/ssd_scan.py,
// _ssd_chunk_kernel (body at 24, pallas_call at 82) and _ssd_inter_kernel
// (body at 55, pallas_call at 121), with the lax.scan recurrence between them
// (106-116), for the calls of the mma route that csrc/ssd_scan_mma.cu does
// not take: dh or N above 128, a chunk above 256, or a chunk whose whole C,
// B and x rows and P buffers do not fit a block (f32 at chunk 256: about
// 394 KB at mamba2-780m widths). The rule is
// repro_torch/kernels/ssd_scan.py::mma_streams. Same function, nothing
// rounded on the way; y rounded once to x's type, the final state in f32.
//
// What bounds it on the H100: bytes at the main path's widths, as the
// whole-chunk kernel. The kernels it replaces ran every product as f32 FMAs
// on the CUDA cores and sent y_inter through an f32 scratch of y's size.
//
// The design. ssd_cumsum_kernel (csrc/ssd_scan.cu) first, then one CTA per
// (batch, head, slice of 8 W columns of dh), W warps (2, 4, 6 or 8: the
// launch's threads, ssd_scan.py::stream_warps), two warps to each 16
// columns: warp i owns columns 16 (i % (W / 2)) .. + 15 of the slice, and
// of a row tile (and of the state's columns in (b)) the half i / (W / 2),
// so a CTA's warps double without its shared memory growing. Each CTA
// recomputes G = C . B^T, which does not depend on dh. The carried state of
// the slice, [8 W][N padded to 32] in f32, stays in shared memory (a warp
// reads its 16 rows in (a) and writes its half of their columns in (b),
// steps apart, so the state needs no barrier of its own); N is any size
// whose rows fit. The CTA walks the chunks in order. Per chunk, with cs_l, dt_l and
// w_l = dt_l exp(cs_L - cs_l) in shared memory, a sequence of steps, each
// one sub-tile of 32 rows of B and x (with the row tile's 32 C rows at its
// first sub-tile) brought by 16-byte cp.async into a ring of two slots,
// the next step's copy issued right after the barrier that opens a step:
//   - for each row tile of 32 rows (a warp its half of them), the sub-tiles
//     at or below its diagonal: at the first, (a) acc = C_tile . S_prev^T,
//     each row scaled by
//     exp(cs_l); at each, G = C_tile . B_sub^T over the 16 x 8 tiles at or
//     below the diagonal, shared out among the warps, P = G
//     exp(cs_l - cs_s) dt_s masked to s <= l into a 32 x 32 f32 buffer, a
//     barrier, and acc += P . x_sub; at the diagonal, y = acc, rounded once;
//   - then (b) a second walk over the sub-tiles, after the last row tile
//     has read S_prev: S <- S exp(cs_L) at the first, and
//     S += (x_sub w)^T . B_sub at each.
// Two barriers a step, one more a chunk (before its vectors are written).
// The chunk's rows are padded to 32; rows and keys past L read stale finite
// values or zeros (everything is zeroed once, and the copies write only
// real elements), which the mask (s <= l), w = dt = 0 and the stores past L
// keep out of y and S.
//
// Shared memory (repro_torch/kernels/ssd_scan.py::smem_bytes_stream), with
// LP = L padded to 32, NP = N padded to 32, DS = 8 W:
//   4 * (DS * state_words(NP) + 3 * LP + 2 * 32 * in_words(NP)
//        + 2 * 32 * (in_words(NP) + in_words(DS)) + 32 * p_words(32)).
// Threads (ssd_scan.py::stream_warps): 32 W. Registers: at most 128 (the
// launch bounds leave room for two CTAs of 8 warps an SM); the compiler's
// count is ssd_scan_stream_attributes.
// Resource model (resource_model.py::ssd_scan_resources): the cumsum and
// one walk per (batch, head, slice), the products at the TF32 peak over 3
// (f32) or the bf16 peak over 3 (bf16).
#include "ssd_mma.cuh"

// csrc/ssd_scan.cu
extern "C" int ssd_cumsum_launch(const void* dt, const void* A, void* cs, long long n_rows,
                                 int L, int nh, int dtype, void* stream);

namespace {

constexpr int KS = 32;  // rows of a sub-tile
constexpr int MAX_WARPS = 8;

__host__ __device__ constexpr int pad32(int n) { return (n + 31) & ~31; }
// a row of the carried state (f32, 8-byte pairs read from 8 rows)
__host__ __device__ constexpr int state_words(int np) { return row_words(np, 4, 8, 32); }

// words of the kernel's shared memory at W warps (a slice of 8 W columns)
__host__ __device__ constexpr long long stream_words(int L, int N, int W, int itemsize) {
  return (long long)8 * W * state_words(pad32(N)) + 3LL * pad32(L) +
         2LL * RT * in_words(pad32(N), itemsize) +
         2LL * KS * (in_words(pad32(N), itemsize) + in_words(8 * W, itemsize)) +
         (long long)RT * p_words(KS);
}

// a step of a chunk's walk: phase 0 the row tiles (row tile r against
// sub-tile j <= r), phase 1 the state update (sub-tile j)
struct Step {
  int c, ph, r, j;
};
__device__ __forceinline__ void advance(Step& t, int nr) {
  if (t.ph == 0) {
    if (t.j < t.r) {
      ++t.j;
    } else if (t.r + 1 < nr) {
      ++t.r;
      t.j = 0;
    } else {
      t.ph = 1;
      t.j = 0;
    }
  } else if (t.j + 1 < nr) {
    ++t.j;
  } else {
    t = Step{t.c + 1, 0, 0, 0};
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)
    ssd_stream_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ cs, const float* __restrict__ s0,
                      T* __restrict__ y, float* __restrict__ s_final, int s, int nh, int dh,
                      int N, int L, int vec_bc, int vec_x) {
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) uint32_t smem[];
  const int NTH = blockDim.x, W = NTH / 32, WC = W / 2, DS = 16 * WC;
  const int LP = pad32(L), NP = pad32(N), NR = LP / RT;
  const int CW = in_words(NP, sizeof(T)), XW = in_words(DS, sizeof(T));
  const int SW = state_words(NP), PW = p_words(KS), SLOT = KS * (CW + XW);
  float* const Ss = reinterpret_cast<float*>(smem);  // [DS][SW]: the carried state
  float* const vcs = Ss + DS * SW;                     // [LP]: cs_l
  float* const vdt = vcs + LP;                         // [LP]: dt_l
  float* const vw = vdt + LP;                          // [LP]: w_l
  uint32_t* const cbuf = reinterpret_cast<uint32_t*>(vw + LP);  // [2][RT][CW]: C rows
  uint32_t* const ring = cbuf + 2 * RT * CW;  // [2][KS][CW + XW]: B rows, then x rows
  float* const P = reinterpret_cast<float*>(ring + 2 * SLOT);  // [RT][PW]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int lm = lane / 8, li = lane % 8;
  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const int pb = blockIdx.y * DS, ncols = min(DS, dh - pb);  // the slice's columns of dh
  // the warp's 16 columns of the slice, and its half: m-tile `half` of a
  // row tile, columns [half NP / 2, (half + 1) NP / 2) of the state in (b)
  const int nc = s / L, p0 = 16 * (warp % WC), mt = warp / WC;
  const long long xrow = (long long)nh * dh, srow = ((long long)bi * nh + h) * dh + pb;
  const int vx = vec_x && (ncols * (int)sizeof(T)) % 16 == 0;

  // padding reads as 0: zero everything once; the copies write only real
  // elements
  const int words = (int)stream_words(L, N, W, sizeof(T));
  for (int i = tid; i < words; i += NTH) smem[i] = 0u;
  __syncthreads();
  if (s0 != nullptr)
    for (int i = tid; i < ncols * N; i += NTH) Ss[(i / N) * SW + i % N] = s0[srow * N + i];

  // rows [0, n) of src (stride elements apart, cols elements each) into
  // shared rows of `words` words, as the whole-chunk kernel copies
  auto copy_rows = [&](uint32_t* dst, int wds, const T* src, long long stride, int cols,
                       int v16, int n) {
    const int per = v16 ? cols * (int)sizeof(T) / 16 : cols;
    const int step_r = NTH / per, step_c = NTH % per;
    int r = tid / per, c = tid % per;
    while (r < n) {
      if (v16)
        cp_async16(dst + r * wds + 4 * c, src + r * stride + c * (16 / (int)sizeof(T)));
      else
        reinterpret_cast<T*>(dst + r * wds)[c] = src[r * stride + c];
      r += step_r;
      c += step_c;
      if (c >= per) {
        c -= per;
        ++r;
      }
    }
  };
  // step t's rows into ring slot `slot` (and C rows at a row tile's first
  // sub-tile), as one commit group
  auto issue = [&](const Step& t, int slot) {
    const long long row0 = (long long)bi * s + (long long)t.c * L;
    const int k0 = KS * t.j, nk = min(KS, L - k0);
    uint32_t* sl = ring + slot * SLOT;
    copy_rows(sl, CW, Bm + (row0 + k0) * N, N, N, vec_bc, nk);
    copy_rows(sl + KS * CW, XW, x + (row0 + k0) * xrow + (long long)h * dh + pb, xrow, ncols,
              vx, nk);
    if (t.ph == 0 && t.j == 0) {
      const int l0 = RT * t.r;
      copy_rows(cbuf + (t.r & 1) * RT * CW, CW, Cm + (row0 + l0) * N, N, N, vec_bc,
                min(RT, L - l0));
    }
    cp_async_commit();
  };

  const int steps = NR * (NR + 1) / 2 + NR;  // of a chunk
  Step nx{0, 0, 0, 0};
  issue(nx, 0);
  int slot = 0;
  float acc[2][4];  // [pt][e]: rows 16 mt .. of the row tile, columns p0 ..
  for (int c = 0; c < nc; ++c) {
    const long long row0 = (long long)bi * s + (long long)c * L;
    const float cs_end = cs[(row0 + L - 1) * nh + h];
    __syncthreads();  // every warp is done with chunk c - 1's vectors
    for (int l = tid; l < LP; l += NTH) {
      if (l < L) {
        const float cl = cs[(row0 + l) * nh + h], d = to_float(dt[(row0 + l) * nh + h]);
        vcs[l] = cl;
        vdt[l] = d;
        vw[l] = d * expf(cs_end - cl);
      } else {
        vcs[l] = cs_end;
        vdt[l] = 0.f;
        vw[l] = 0.f;
      }
    }
    Step cur{c, 0, 0, 0};
    for (int k = 0; k < steps; ++k, slot ^= 1, advance(cur, NR)) {
      cp_async_wait<0>();
      __syncthreads();  // step k's rows are in; every warp is done with step k - 1
      if (c + 1 < nc || k + 1 < steps) {
        advance(nx, NR);
        issue(nx, slot ^ 1);
      }
      const uint32_t* sb = ring + slot * SLOT;  // B rows of the sub-tile
      const uint32_t* sx = sb + KS * CW;         // its x rows
      const int kb = KS * cur.j;                 // its first row in the chunk

      if (cur.ph == 0) {
        const int R = RT * cur.r;  // the row tile's first row
        const uint32_t* sc = cbuf + (cur.r & 1) * RT * CW;
        const bool diag = cur.j == cur.r;
        if (cur.j == 0) {
          // (a) acc = C_tile . S_prev^T, then each row times exp(cs_l)
#pragma unroll
          for (int pt = 0; pt < 2; ++pt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
          for (int k2 = 0; k2 < NP / 16; ++k2) {
            if constexpr (F32) {
              // S's pairs (row p0 + 8 pt + gid, columns 8 kk + 2 tig, + 1)
              // are the B fragments of k-step kk = 2 k2 + q
              uint32_t bb[2][2][2], bs[2][2][2];  // [q][pt][b0, b1]
#pragma unroll
              for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int pt = 0; pt < 2; ++pt) {
                  const float2 sv = ld2(Ss + (p0 + 8 * pt + gid) * SW + 16 * k2 + 8 * q + 2 * tig);
                  split(sv.x, bb[q][pt][0], bs[q][pt][0]);
                  split(sv.y, bb[q][pt][1], bs[q][pt][1]);
                }
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const uint32_t* ca = sc + (16 * mt + gid) * CW + 16 * k2 + 8 * q + 2 * tig;
                uint32_t ab[4], as[4];
                split_pairs(ld2(ca), ld2(ca + 8 * CW), ab, as);
#pragma unroll
                for (int pt = 0; pt < 2; ++pt)
                  mma_parts(acc[pt], ab, as, bb[q][pt][0], bb[q][pt][1], bs[q][pt][0],
                            bs[q][pt][1]);
              }
            } else {
              // bf16: S_prev in three bf16 parts, the pairs at columns
              // 16 k2 + 2 tig and 16 k2 + 8 + 2 tig the B fragment
              uint32_t b0[2][3], b1[2][3];  // [pt][part]
#pragma unroll
              for (int pt = 0; pt < 2; ++pt) {
                const float* sr = Ss + (p0 + 8 * pt + gid) * SW + 16 * k2 + 2 * tig;
                split3(sr[0], sr[1], b0[pt]);
                split3(sr[8], sr[9], b1[pt]);
              }
              uint32_t cw[4];
              ldsm4(cw, sc + (16 * mt + li + 8 * (lm & 1)) * CW + 4 * (lm >> 1) + 8 * k2);
#pragma unroll
              for (int pt = 0; pt < 2; ++pt)
#pragma unroll
                for (int q = 0; q < 3; ++q) mma_bf16(acc[pt], cw, b0[pt][q], b1[pt][q]);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float el = expf(vcs[R + 16 * mt + gid + 8 * (e >> 1)]);
            acc[0][e] *= el;
            acc[1][e] *= el;
          }
        }

        // G = C_tile . B_sub^T over the 16 x 8 tiles at or below the
        // diagonal, shared out among the warps; P = G exp(cs_l - cs_s) dt_s,
        // masked to s <= l
        const int ntiles = diag ? 6 : 8;  // on the diagonal m-tile 0 has two
        for (int t = warp; t < ntiles; t += W) {
          const int gm = diag ? (t < 2 ? 0 : 1) : t / 4;  // the tile's m-tile
          const int sn = diag ? (t < 2 ? t : t - 2) : t % 4;
          float gp[4][4] = {};
          if constexpr (F32) {
            const uint32_t* ca = sc + (16 * gm + gid) * CW + 2 * tig;
            const uint32_t* bq = sb + (8 * sn + gid) * CW + 2 * tig;
            for (int k8 = 0; k8 < NP / 32; ++k8) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int kk = 4 * k8 + q;
                uint32_t ab[4], as[4];
                split_pairs(ld2(ca + 8 * kk), ld2(ca + 8 * CW + 8 * kk), ab, as);
                const float2 bv = ld2(bq + 8 * kk);
                mma3(gp[q], ab, as, bv.x, bv.y);
              }
            }
          } else {
            const uint32_t* ca = sc + (16 * gm + li + 8 * (lm & 1)) * CW + 4 * (lm >> 1);
            const uint32_t* bq = sb + (8 * sn + li) * CW + 4 * lm;
            for (int k4 = 0; k4 < NP / 32; ++k4) {
              uint32_t bw[4], c0[4], c1[4];
              ldsm4(bw, bq + 16 * k4);
              ldsm4(c0, ca + 16 * k4);
              ldsm4(c1, ca + 16 * k4 + 8);
              mma_bf16(gp[0], c0, bw[0], bw[1]);
              mma_bf16(gp[1], c1, bw[2], bw[3]);
            }
          }
          float g[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) g[e] = (gp[0][e] + gp[1][e]) + (gp[2][e] + gp[3][e]);
          const int s0c = kb + 8 * sn + 2 * tig;  // this thread's keys s0c, s0c + 1
          const float cs0 = vcs[s0c], cs1 = vcs[s0c + 1], d0 = vdt[s0c], d1 = vdt[s0c + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int lr = 16 * gm + gid + 8 * hh, l = R + lr;
            const float cl = vcs[l];
            // exp(cs_l - cs_s), never exp(cs_l) exp(-cs_s); the select drops
            // what lies past the diagonal
            const float v0 = s0c <= l ? g[2 * hh] * expf(cl - cs0) * d0 : 0.f;
            const float v1 = s0c + 1 <= l ? g[2 * hh + 1] * expf(cl - cs1) * d1 : 0.f;
            *reinterpret_cast<float2*>(P + lr * PW + 8 * sn + 2 * tig) = make_float2(v0, v1);
          }
        }
        __syncthreads();  // P is complete

        // acc += P . x_sub, 16 keys a step; on the diagonal m-tile 0 sees
        // the first 16 keys only
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          if constexpr (F32) {
            if (diag && k2 > mt) continue;
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
            for (int q = 0; q < 2; ++q) {
              const float* pr = P + (16 * mt + gid) * PW + 16 * k2 + 8 * q + 2 * tig;
              uint32_t ab[4], as[4];
              split_pairs(ld2(pr), ld2(pr + 8 * PW), ab, as);
#pragma unroll
              for (int pt = 0; pt < 2; ++pt)
                mma3(acc[pt], ab, as, __uint_as_float(xb[q][pt][0]),
                     __uint_as_float(xb[q][pt][1]));
            }
          } else {
            if (diag && k2 > mt) continue;
            uint32_t xr[4];
            ldsm4t(xr, sx + (16 * k2 + li + 8 * (lm >> 1)) * XW + p0 / 2 + 4 * (lm & 1));
            const float* pr = P + (16 * mt + gid) * PW + 16 * k2 + 2 * tig;
            const float2 v[4] = {ld2(pr), ld2(pr + 8 * PW), ld2(pr + 8), ld2(pr + 8 * PW + 8)};
            uint32_t a[3][4];
            split3_frag(v, a);
#pragma unroll
            for (int pt = 0; pt < 2; ++pt)
#pragma unroll
              for (int q = 0; q < 3; ++q) mma_bf16(acc[pt], a[q], xr[pt], xr[2 + pt]);
          }
        }

        if (diag) {
          // y, once, in x's type: two neighbouring columns a store where dh
          // is even
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int l = R + 16 * mt + gid + 8 * hh;
            if (l >= L) continue;
#pragma unroll
            for (int pt = 0; pt < 2; ++pt) {
              const int col = p0 + 8 * pt + 2 * tig;
              if (col >= ncols) continue;
              T* dst = y + (row0 + l) * xrow + (long long)h * dh + pb + col;
              const float v0 = acc[pt][2 * hh], v1 = acc[pt][2 * hh + 1];
              if constexpr (F32) {
                if (dh % 2 == 0) {
                  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                } else {
                  dst[0] = v0;
                  if (col + 1 < ncols) dst[1] = v1;
                }
              } else {
                if (dh % 2 == 0) {
                  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
                } else {
                  dst[0] = __float2bfloat16(v0);
                  if (col + 1 < ncols) dst[1] = __float2bfloat16(v1);
                }
              }
            }
          }
        }
      } else {
        // (b) S <- S exp(cs_L) (at the first sub-tile) + (x_sub w)^T . B_sub,
        // this warp's rows of S and its half of their columns, one 8-column
        // tile (f32) or two (bf16) at a time
        const float decay = cur.j == 0 ? expf(cs_end) : 1.f;
        float* const s_lo = Ss + (p0 + gid) * SW + 2 * tig;  // rows p0 + gid and + 8
        if constexpr (F32) {
          uint32_t ab[4][4], as[4][4];  // (x w)^T's A fragments of the 4 k-steps
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int ra = 8 * kk + 2 * tig;
            const float wa = vw[kb + ra], wb = vw[kb + ra + 1];
            const uint32_t* xa = sx + ra * XW + p0 + gid;
            split(__uint_as_float(xa[0]) * wa, ab[kk][0], as[kk][0]);
            split(__uint_as_float(xa[8]) * wa, ab[kk][1], as[kk][1]);
            split(__uint_as_float(xa[XW]) * wb, ab[kk][2], as[kk][2]);
            split(__uint_as_float(xa[XW + 8]) * wb, ab[kk][3], as[kk][3]);
          }
          for (int jn = mt * NP / 16; jn < (mt + 1) * NP / 16; ++jn) {
            float* const sr = s_lo + 8 * jn;
            const float2 u0 = ld2(sr), u1 = ld2(sr + 8 * SW);
            float cf[4] = {u0.x * decay, u0.y * decay, u1.x * decay, u1.y * decay};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t* br = sb + (8 * kk + 2 * tig) * CW + 8 * jn + gid;
              mma3(cf, ab[kk], as[kk], __uint_as_float(br[0]), __uint_as_float(br[CW]));
            }
            *reinterpret_cast<float2*>(sr) = make_float2(cf[0], cf[1]);
            *reinterpret_cast<float2*>(sr + 8 * SW) = make_float2(cf[2], cf[3]);
          }
        } else {
          uint32_t a[2][3][4];  // [k2][part]
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2) {
            uint32_t xr[4];
            ldsm4t(xr, sx + (16 * k2 + li + 8 * (lm >> 1)) * XW + p0 / 2 + 4 * (lm & 1));
            const float2 wa = ld2(vw + kb + 16 * k2 + 2 * tig);
            const float2 wb = ld2(vw + kb + 16 * k2 + 8 + 2 * tig);
            float2 v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 xv = bf16x2_unpack(xr[e]), w = e < 2 ? wa : wb;
              v[e] = make_float2(xv.x * w.x, xv.y * w.y);
            }
            split3_frag(v, a[k2]);
          }
          for (int j2 = mt * NP / 32; j2 < (mt + 1) * NP / 32; ++j2) {
            float* const sr = s_lo + 16 * j2;
            const float2 u0 = ld2(sr), u1 = ld2(sr + 8 * SW), u2 = ld2(sr + 8),
                         u3 = ld2(sr + 8 * SW + 8);
            float c0[4] = {u0.x * decay, u0.y * decay, u1.x * decay, u1.y * decay};
            float c1[4] = {u2.x * decay, u2.y * decay, u3.x * decay, u3.y * decay};
#pragma unroll
            for (int k2 = 0; k2 < 2; ++k2) {
              uint32_t bw[4];  // B fragments of columns 16 j2 .. and 16 j2 + 8 ..
              ldsm4t(bw, sb + (16 * k2 + li + 8 * (lm & 1)) * CW + 4 * (lm >> 1) + 8 * j2);
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                mma_bf16(c0, a[k2][q], bw[0], bw[1]);
                mma_bf16(c1, a[k2][q], bw[2], bw[3]);
              }
            }
            *reinterpret_cast<float2*>(sr) = make_float2(c0[0], c0[1]);
            *reinterpret_cast<float2*>(sr + 8 * SW) = make_float2(c0[2], c0[3]);
            *reinterpret_cast<float2*>(sr + 8) = make_float2(c1[0], c1[1]);
            *reinterpret_cast<float2*>(sr + 8 * SW + 8) = make_float2(c1[2], c1[3]);
          }
        }
      }
    }
  }

  __syncthreads();  // every warp's rows of S are final
  for (int i = tid; i < ncols * N; i += NTH) s_final[srow * N + i] = Ss[(i / N) * SW + i % N];
}

template <typename T>
int stream_launch_t(const void* x, const void* dt, const void* B, const void* C, const void* s0,
                    const void* cs, void* y, void* s_final, int b, int s, int nh, int dh, int N,
                    int L, int W, int smem, cudaStream_t st) {
  static int smem_allowed = 0;  // the largest size set so far for this kernel
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(ssd_stream_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    smem_allowed = smem;
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_bc = (N * (int)sizeof(T)) % 16 == 0 && aligned(B) && aligned(C);
  const int vec_x = (dh * (int)sizeof(T)) % 16 == 0 && aligned(x);
  const dim3 grid((unsigned)(b * nh), (unsigned)((dh + 8 * W - 1) / (8 * W)));
  ssd_stream_kernel<T><<<grid, 32 * W, smem, st>>>(
      (const T*)x, (const T*)dt, (const T*)B, (const T*)C, (const float*)cs, (const float*)s0,
      (T*)y, (float*)s_final, s, nh, dh, N, L, vec_bc, vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

// called by ssd_scan_mma_launch (csrc/ssd_scan_mma.cu) for the calls its
// whole-chunk kernel does not take; threads are 32 W for an even W of 2-8
// (repro_torch/kernels/ssd_scan.py::stream_warps picks it) and smem at
// least the block's
int ssd_stream_launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                      const void* s0, void* cs, void* y, void* s_final, int b, int s, int nh,
                      int dh, int N, int L, int dtype, int threads, int smem, void* stream) {
  const int itemsize = dtype == DTYPE_F32 ? 4 : 2;
  if (b <= 0 || s <= 0 || nh <= 0 || dh <= 0 || N <= 0 || L <= 0 || s % L != 0 ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16) || (long long)b * nh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int W = threads / 32;
  if (threads % 64 != 0 || W < 2 || W > MAX_WARPS ||
      (long long)smem < 4 * stream_words(L, N, W, itemsize) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int e = ssd_cumsum_launch(dt, A, cs, (long long)b * (s / L), L, nh, dtype, stream);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == DTYPE_F32
             ? stream_launch_t<float>(x, dt, B, C, s0, cs, y, s_final, b, s, nh, dh, N, L, W,
                                      smem, st)
             : stream_launch_t<__nv_bfloat16>(x, dt, B, C, s0, cs, y, s_final, b, s, nh, dh, N,
                                              L, W, smem, st);
}

// the compiler's registers per thread and local (spill) bytes of the
// streamed kernel in one type
extern "C" int ssd_scan_stream_attributes(int dtype, int* regs, int* local_bytes) {
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = dtype == DTYPE_F32
                      ? cudaFuncGetAttributes(&a, ssd_stream_kernel<float>)
                      : cudaFuncGetAttributes(&a, ssd_stream_kernel<__nv_bfloat16>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
