"""Mamba2 SSD chunked scan (state-space duality).

Counterpart of ``repro/kernels/ssd_scan.py``: x [b, s, nh, dh], dt
[b, s, nh] (post-softplus), A [nh] (negative, f32), B and C [b, s, N].
Per chunk of ``chunk`` rows, in f32, with cs = cumsum(dt * A) over the
chunk:

* y_intra[l,h,p] = sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) dt_s x_s[h,p];
* the chunk's own state S_loc[h,p,n] = sum_l B_l[n] dt_l exp(cs_L - cs_l)
  x_l[h,p] and its decay exp(cs_L);
* the recurrence S <- S * decay + S_loc from ``initial_state`` (or 0);
* y_inter[l,h,p] = (C_l . S_prev[h,p,:]) exp(cs_l).

y = (y_intra + y_inter) rounded once to x's dtype; the final state is f32.

``ssd_scan_cuda`` launches one of three hand-written Hopper routes, chosen by
:func:`route` before the launch, each after the chunk cumsum of
``csrc/ssd_scan.cu``:

* ``wgmma`` (``csrc/ssd_scan_wgmma.cu``): bf16 at dh in ``WGMMA_DH``, N in
  ``WGMMA_N`` and a chunk in ``WGMMA_CHUNKS``; one chunk walk per (batch,
  head) on ``wgmma`` with the state in registers;
* ``mma``: every other call, on ``mma.sync`` with each f32 operand split
  into parts the tensor core multiplies exactly (f32 inputs: two TF32
  parts, three products a product; bf16 inputs, where C, B and x are
  exact: the one f32 operand in three bf16 parts, three bf16 products), no
  y_inter scratch. Up to dh ``MMA_MAX_DH``, N ``MMA_MAX_N`` and a chunk of
  ``MMA_MAX_CHUNK`` whose chunk tiles fit one block
  (``csrc/ssd_scan_mma.cu``): one chunk walk per (batch, head), whole chunks
  staged, the state in registers. Every other size (:func:`mma_streams`:
  f32 chunk 256 at mamba2-780m and zamba2-2.7b widths, dh or N above 128, a
  chunk above 256) on ``csrc/ssd_scan_stream.cu``: one walk per (batch,
  head, slice of dh), a chunk's rows streamed in sub-tiles of
  ``STREAM_KEYS``, the state in shared memory (:func:`stream_warps`);
* ``fma`` (``csrc/ssd_scan.cu``): what no mma block holds (N above about
  350 in f32, 650 in bf16); the state walk with the inter-chunk term into
  an f32 y_inter scratch, then the intra-chunk term, on f32 FMAs, at tiles
  picked for each call (:func:`row_tile`, :func:`state_plan`).

A failed build or launch raises; no route stands in for another.
``ssd_scan_plain`` computes the same function in plain torch over the same
chunks, with the cumsum taken in the kernel's order, so the CPU tests reach
the chunking, the recurrence and ``initial_state``. On the wgmma route it
rounds to bf16 where that kernel feeds the tensor cores one bf16 value:
x * w for the chunk's own state, and S_prev for the inter-chunk term (P
enters that kernel's products as two bf16 parts, close enough to f32). On
the mma route it rounds nowhere: the split keeps f32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.device import H100_SXM
from repro_torch.kernels import _build

SOURCES = {"fma": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "wgmma": "src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu",
           "mma": "src/repro_torch/kernels/csrc/ssd_scan_mma.cu"}
#: the mma route's kernel for the calls whose chunks it streams, and its
#: launch count's key (the route's other kernel counts under
#: "ssd_scan/mma"; see :func:`launch_key`)
STREAM_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_stream.cu"
STREAM_KEY = "ssd_scan/mma:stream"
REPLACES = "src/repro/kernels/ssd_scan.py:24"

#: threads per CUDA block of the FMA route (state and intra kernels)
THREADS = 256

#: the wgmma route's sizes (``SSD_WGMMA_CASE`` in its source lists the same
#: product): head dim, state size and chunk. wgmma's M is 64, so a chunk
#: below 64 has no tile; mamba2-780m has N 128, zamba2-2.7b N 64
WGMMA_DH = (64,)
WGMMA_N = (64, 128)
WGMMA_CHUNKS = (64, 128, 256)


#: the whole-chunk mma kernel's limits: dh is padded inside the kernel to
#: 32, 64 or 128 (one warp per 16 columns), N to 64 or 128 and held in
#: registers (N / 2 floats a thread), and a chunk's cs and dt take at most
#: 256 rows; past them, or where a chunk's tiles do not fit a block, the
#: route streams (:func:`mma_streams`)
MMA_MAX_DH = 128
MMA_MAX_N = 128
MMA_MAX_CHUNK = 256
#: rows of the mma kernels' row tile (the P buffer's rows)
MMA_ROW_TILE = 32
#: rows of the streamed kernel's sub-tiles (B and x) and its most warps (two
#: per 16 columns of a slice of dh)
STREAM_KEYS = 32
STREAM_MAX_WARPS = 8


@functools.lru_cache(maxsize=None)
def route(dtype: torch.dtype, chunk: int, dh: int, N: int) -> str:
    """Which kernel runs a call at the chunk it runs (``min(chunk, s)``),
    decided before the launch: ``"wgmma"`` for bf16 at a size the wgmma
    kernel is instantiated for; else ``"mma"`` where a block of one of its
    kernels fits (whole chunks or streamed, :func:`mma_launch`); else
    ``"fma"`` (N above what two warps' streamed block holds: about 350 in
    f32, 650 in bf16)."""
    if (dtype == torch.bfloat16 and dh in WGMMA_DH and N in WGMMA_N
            and chunk in WGMMA_CHUNKS):
        return "wgmma"
    return "mma" if mma_launch(chunk, N, dh, 4 if dtype == torch.float32 else 2)[0] else "fma"


def mma_streams(chunk: int, N: int, dh: int, itemsize: int) -> bool:
    """Whether the mma route streams the call's chunks
    (``csrc/ssd_scan_stream.cu``): above ``MMA_MAX_DH``, ``MMA_MAX_N`` or
    ``MMA_MAX_CHUNK``, or where one chunk's tiles do not fit a block for the
    whole-chunk kernel (:func:`mma_plan`)."""
    return not (dh <= MMA_MAX_DH and N <= MMA_MAX_N and chunk <= MMA_MAX_CHUNK
                and mma_plan(chunk, N, dh, itemsize)[0])


def launch_key(dtype: torch.dtype, chunk: int, dh: int, N: int) -> str:
    """The launch count's key of the kernel a call runs at the chunk it runs:
    ``"ssd_scan/<route>"``, and where the mma route streams the streamed
    kernel's :data:`STREAM_KEY`. Each launch counts under one key; a
    route's launches are the sum of its kernels' (the key up to ``:``)."""
    path = route(dtype, chunk, dh, N)
    if path == "mma" and mma_streams(chunk, N, dh, dtype.itemsize):
        return STREAM_KEY
    return f"ssd_scan/{path}"


def mma_warps(dh: int) -> int:
    """Warps of an mma block: one per 16 columns of dh padded to 32, 64 or
    128 (``SSD_MMA_CASE`` in its source lists the same); 0 above 128."""
    return next((w for w in (2, 4, 8) if 16 * w >= dh), 0)


def mma_threads(dh: int) -> int:
    """The mma kernel's threads."""
    return 32 * mma_warps(dh)


def mma_state_cols(N: int) -> int:
    """The state columns each warp of the mma kernel holds: N padded to 64
    or 128 (``SSD_MMA_CASE`` lists both); 0 above 128."""
    return next((n for n in (64, 128) if n >= N), 0)


def _mma_bytes(chunk: int, N: int, dh: int, itemsize: int, stages: int,
               pbufs: int) -> int:
    lp = -(-chunk // 16) * 16
    rem = 8 if itemsize == 4 else 4
    cw = _build.row_words(mma_state_cols(N), itemsize, rem, 32)
    xw = _build.row_words(16 * mma_warps(dh), itemsize, rem, 32)
    return 4 * (stages * lp * (2 * cw + xw) + 8 * lp
                + pbufs * MMA_ROW_TILE * _build.row_words(lp, 4, 8, 32))


def mma_plan(chunk: int, N: int, dh: int, itemsize: int) -> Tuple[int, int]:
    """(stages, P buffers) of the mma kernel: two chunks in flight and two
    P buffers (one where a chunk has one row tile) where they fit one
    block's shared memory, fewer stages first; (0, 0) where one of each
    does not fit."""
    pmax = 2 if -(-chunk // 16) * 16 > MMA_ROW_TILE else 1
    for stages, pbufs in ((2, 2), (2, 1), (1, 2), (1, 1)):
        if pbufs <= pmax and _mma_bytes(chunk, N, dh, itemsize, stages, pbufs) \
                <= H100_SXM.smem_per_block:
            return stages, pbufs
    return 0, 0


def smem_bytes_mma(chunk: int, N: int, dh: int, itemsize: int) -> int:
    """Dynamic shared memory the mma kernel asks for: per stage the chunk's
    C, B and x rows in the input type (rows padded to 16, N to 64 or 128,
    dh to 16 per warp; each row padded to 8 words mod 32 for f32, 4 mod 32
    for bf16); cs, dt, exp(cs) and w of two chunks in f32; P's buffers of 32
    f32 rows, each padded to 8 words mod 32. 0 where it does not fit. The
    launch and the resource model both call this."""
    stages, pbufs = mma_plan(chunk, N, dh, itemsize)
    return _mma_bytes(chunk, N, dh, itemsize, stages, pbufs) if stages else 0


def _stream_bytes(chunk: int, N: int, warps: int, itemsize: int) -> int:
    lp, np_ = -(-chunk // 32) * 32, -(-N // 32) * 32
    rem = 8 if itemsize == 4 else 4
    cw = _build.row_words(np_, itemsize, rem, 32)
    xw = _build.row_words(8 * warps, itemsize, rem, 32)
    state = 8 * warps * _build.row_words(np_, 4, 8, 32)
    return 4 * (state + 3 * lp + 2 * MMA_ROW_TILE * cw + 2 * STREAM_KEYS * (cw + xw)
                + MMA_ROW_TILE * _build.row_words(STREAM_KEYS, 4, 8, 32))


@functools.lru_cache(maxsize=None)
def stream_warps(chunk: int, N: int, dh: int, itemsize: int) -> int:
    """Warps W of a block of the streamed kernel, which owns a slice of 8 W
    columns of dh (two warps to each 16 columns, each taking half of a row
    tile's rows): of the even counts up to ``STREAM_MAX_WARPS`` and two per
    16 columns of dh whose block fits, the one that keeps the most warps
    resident on an SM (the blocks its shared memory holds, at most two of 8
    warps, as the launch bounds allow), the larger on a tie (fewer slices,
    each recomputing G); 0 where two warps' block does not fit."""
    best = most = 0
    for w in range(2, min(STREAM_MAX_WARPS, 2 * -(-dh // 16)) + 1, 2):
        nbytes = _stream_bytes(chunk, N, w, itemsize)
        if nbytes > H100_SXM.smem_per_block:
            break
        blocks = H100_SXM.smem_per_sm // (nbytes + H100_SXM.smem_reserved_per_block)
        resident = w * min(blocks, 2 * STREAM_MAX_WARPS // w)
        if resident >= most:
            best, most = w, resident
    return best


def smem_bytes_stream(chunk: int, N: int, dh: int, itemsize: int) -> int:
    """Dynamic shared memory the streamed kernel asks for at
    :func:`stream_warps` (8 W columns of dh a block): the slice's state
    [8 W][N padded to 32] in f32 (rows padded to 8 words mod 32); cs, dt
    and w of a chunk (its rows padded to 32) in f32; two row tiles of C rows
    and two sub-tiles of B and x rows in the input type (rows padded as the
    whole-chunk kernel pads them); one 32 x 32 P buffer. 0 where it does
    not fit."""
    w = stream_warps(chunk, N, dh, itemsize)
    return _stream_bytes(chunk, N, w, itemsize) if w else 0


def mma_launch(chunk: int, N: int, dh: int, itemsize: int) -> Tuple[int, int]:
    """(threads, dynamic shared memory) of the mma route's launch: the
    whole-chunk kernel's, or where it streams the streamed kernel's; (0, 0)
    where no block fits. The launch and the resource model both call
    this."""
    if mma_streams(chunk, N, dh, itemsize):
        return 32 * stream_warps(chunk, N, dh, itemsize), smem_bytes_stream(chunk, N, dh, itemsize)
    return mma_threads(dh), smem_bytes_mma(chunk, N, dh, itemsize)


def _wgmma_smem(chunk: int, N: int, dh: int, stages: int) -> int:
    stage = chunk * (2 * N + dh) * 2 + (8 * chunk + 1023) // 1024 * 1024
    return 1024 + stages * stage + dh * N * 2 + 8 * stages * (chunk // 64 + 1)


def wgmma_stages(chunk: int, N: int, dh: int = 64) -> int:
    """Chunks in flight in the wgmma kernel's TMA ring: 2 where they fit one
    block's shared memory, else 1 (chunk 256 at N 128)."""
    return 2 if _wgmma_smem(chunk, N, dh, 2) <= H100_SXM.smem_per_block else 1


def smem_bytes_wgmma(chunk: int, N: int, dh: int = 64) -> int:
    """Dynamic shared memory the wgmma kernel asks for: 1024 bytes of
    alignment slack; per stage C, B and x of one chunk in bf16 and its cs
    and dt in f32 (padded to 1024 bytes); S_prev in bf16; the mbarriers.
    The launch and the resource model both call this."""
    return _wgmma_smem(chunk, N, dh, wgmma_stages(chunk, N, dh))


def _two_ctas_fit(chunk: int, N: int, dh: int) -> bool:
    dev = H100_SXM
    return 2 * (smem_bytes_wgmma(chunk, N, dh) + dev.smem_reserved_per_block) <= dev.smem_per_sm


def wgmma_warpgroups(chunk: int, N: int, dh: int = 64) -> int:
    """The wgmma kernel's consumer warpgroups: one per 64 columns of the
    state, which each holds in registers; at N = 64 a second one (holding
    no state, taking half the row tiles) where two CTAs of one warpgroup
    would not fit an SM's shared memory (chunk 256)."""
    if N >= 128:
        return N // 64
    return 1 if _two_ctas_fit(chunk, N, dh) else 2


def wgmma_threads(chunk: int, N: int, dh: int = 64) -> int:
    """The wgmma kernel's threads: its consumer warpgroups and the producer
    warp."""
    return 128 * wgmma_warpgroups(chunk, N, dh) + 32


def wgmma_ctas_per_sm(chunk: int, N: int, dh: int = 64) -> int:
    """CTAs of the wgmma kernel its launch bounds ask one SM to hold: 2
    where two fit the SM's shared memory and still leave each thread 168
    registers (one consumer warpgroup; the compiler then keeps each
    thread's registers to what two CTAs allow), else 1."""
    ok = H100_SXM.regs_per_sm // (2 * wgmma_threads(chunk, N, dh)) >= 168
    return 2 if _two_ctas_fit(chunk, N, dh) and ok else 1


#: the FMA kernels' tile sizes, largest first: each call takes the largest
#: row tile, and the largest state slice and state tile, whose blocks fit
FMA_TILES = (64, 32, 16, 8)
#: the state kernel's tile stops at 32 rows, which keeps two of its blocks on
#: an SM at mamba2-780m widths
FMA_STATE_TILES = (32, 16, 8)


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _intra_bytes(chunk: int, N: int, dh: int, tl: int) -> int:
    lt = -(-chunk // tl) * tl  # the chunk's rows, the last row tile padded
    ldt, dhp = tl + 4, _pad4(dh)
    stage = max(2 * N * ldt, tl * dhp + tl * ldt)
    return 4 * (lt * ldt + tl * dhp + 2 * lt + stage)


def _state_bytes(chunk: int, N: int, tq: int, ps: int) -> int:
    np_ = _pad4(N)
    return 4 * (N * (tq + 4) + tq * np_ + tq * ps + 2 * _pad4(chunk) + np_ * ps
                + ps * (np_ + 4))


@functools.lru_cache(maxsize=None)
def row_tile(chunk: int, N: int, dh: int) -> int:
    """Rows of a chunk one intra block computes: the largest of
    ``FMA_TILES`` (at most the chunk rounded up to 4) whose block fits; a
    chunk it does not divide ends in a masked row tile. 0 where none fits."""
    return next((t for t in (min(c, _pad4(chunk)) for c in FMA_TILES)
                 if _intra_bytes(chunk, N, dh, t) <= H100_SXM.smem_per_block), 0)


@functools.lru_cache(maxsize=None)
def state_plan(chunk: int, N: int, dh: int) -> Tuple[int, int]:
    """(state tile, state slice) of the state kernel: the rows of a chunk it
    stages at a time (the largest of ``FMA_STATE_TILES``, at most the chunk
    rounded up to 4; a masked last tile where it does not divide the
    chunk) and the columns of dh one block owns (the largest of
    ``FMA_TILES``, at most dh rounded up to 4; a masked last slice), the
    tile first, whose block fits. (0, 0) where none fits."""
    for tq in (min(t, _pad4(chunk)) for t in FMA_STATE_TILES):
        for ps in (min(p, _pad4(dh)) for p in FMA_TILES):
            if _state_bytes(chunk, N, tq, ps) <= H100_SXM.smem_per_block:
                return tq, ps
    return 0, 0


def smem_bytes_intra(chunk: int, N: int, dh: int) -> int:
    """Dynamic shared memory of the intra kernel at its row tile tl, in
    f32: C.B^T for the row tile, s-major [lt][tl+4] (lt the chunk's rows
    padded to whole row tiles); the accumulator [tl][dh4] (dh padded to 4);
    one head's cumsum and dt [lt] each; and a staging area that holds first
    C and B tiles transposed, [N][tl+4] each, and later one head's dt*x tile
    [tl][dh4] and masked decay tile [tl][tl+4]. 0 where no row tile fits.
    The launch and the resource model call this."""
    tl = row_tile(chunk, N, dh)
    return _intra_bytes(chunk, N, dh, tl) if tl else 0


def smem_bytes_state(chunk: int, N: int, dh: int) -> int:
    """Dynamic shared memory of the state kernel at its state tile tq and
    slice ps, in f32 (N4 is N padded to 4): C rows transposed [N][tq+4], B
    rows [tq][N4], the weighted x tile [tq][ps], the chunk's exp(cs) and
    row weights [chunk] each, the carried state transposed [N4][ps] and the
    chunk's own state [ps][N4+4]. 0 where no plan fits."""
    tq, ps = state_plan(chunk, N, dh)
    return _state_bytes(chunk, N, tq, ps) if tq else 0


def supported(chunk: int, N: int, dh: int) -> bool:
    """Whether the FMA kernels take these sizes: any dh and N (padded to 4
    inside the kernels) and any chunk whose smallest tiles fit a block
    (every chunk up to about 3,500 rows at dh and N of 256; the Pallas
    kernel holds an [L, L, nh] decay block, which a TPU's VMEM refuses far
    below that)."""
    return row_tile(chunk, N, dh) > 0 and state_plan(chunk, N, dh)[0] > 0


def _chunk(x, dt, A, B, C, chunk: int) -> int:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or B.shape != C.shape:
        raise ValueError(f"ssd_scan takes x [b,s,nh,dh], dt [b,s,nh], A [nh], "
                         f"B, C [b,s,N]; got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    b, s, nh, _ = x.shape
    if tuple(dt.shape) != (b, s, nh) or A.shape[0] != nh or B.shape[:2] != (b, s):
        raise ValueError("ssd_scan: dt, A, B and C do not fit x")
    L = min(chunk, s)
    if L <= 0 or s % L:
        raise ValueError(f"chunk must divide the sequence: s={s} chunk={L}")
    return L


def chunk_cumsum(dt: torch.Tensor, A: torch.Tensor, chunk: int) -> torch.Tensor:
    """cs [b, s, nh] f32: the running sum of dt * A within each chunk, one
    row after another (the order the kernel adds in, so both round alike)."""
    b, s, nh = dt.shape
    dA = (dt.float() * A.float()).view(b, s // chunk, chunk, nh)
    cs = torch.empty_like(dA)
    acc = torch.zeros_like(dA[:, :, 0])
    for l in range(chunk):
        acc = acc + dA[:, :, l]
        cs[:, :, l] = acc
    return cs.view(b, s, nh)


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 256,
                   initial_state: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in plain torch over the kernel's chunks; returns
    (y [b,s,nh,dh] in x's dtype, final_state [b,nh,dh,N] f32)."""
    L = _chunk(x, dt, A, B, C, chunk)
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    nc = s // L
    # the wgmma kernel feeds x * w and S_prev to the tensor cores in bf16
    rnd = ((lambda t: t.to(torch.bfloat16).float())
           if route(x.dtype, L, dh, N) == "wgmma" else (lambda t: t))
    cs = chunk_cumsum(dt, A, L).view(b, nc, L, nh)
    xc = x.float().view(b, nc, L, nh, dh)
    dtc = dt.float().view(b, nc, L, nh)
    Bc = B.float().view(b, nc, L, N)
    Cc = C.float().view(b, nc, L, N)

    # intra-chunk term, one head at a time (C.B^T is shared by all heads)
    G = Cc @ Bc.transpose(-1, -2)  # [b, nc, L, S]
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    y_intra = torch.empty(b, nc, L, nh, dh, dtype=torch.float32, device=x.device)
    for h in range(nh):
        csh = cs[..., h]
        diff = (csh[..., :, None] - csh[..., None, :]).masked_fill(~causal, -torch.inf)
        att = G * torch.exp(diff)
        y_intra[..., h, :] = att @ (xc[..., h, :] * dtc[..., h, None])

    # the chunk's own state and decay, then the recurrence over chunks
    w = dtc * torch.exp(cs[:, :, -1:, :] - cs)  # [b, nc, L, nh]
    S_loc = torch.einsum("bcln,bclhp->bchpn", Bc, rnd(xc * w[..., None]))
    decay = torch.exp(cs[:, :, -1, :])  # [b, nc, nh]
    S = (torch.zeros(b, nh, dh, N, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    S_prev = torch.empty(b, nc, nh, dh, N, dtype=torch.float32, device=x.device)
    for c in range(nc):
        S_prev[:, c] = S
        S = S * decay[:, c, :, None, None] + S_loc[:, c]

    # inter-chunk term
    y_inter = torch.einsum("bcln,bchpn->bclhp", Cc, rnd(S_prev)) * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(b, s, nh, dh).to(x.dtype)
    return y, S


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 256,
                  initial_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan on x's card, through the kernel :func:`route` names."""
    L = _chunk(x, dt, A, B, C, chunk)
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (dt, A, B, C))
            and dt.dtype == x.dtype and B.dtype == x.dtype and C.dtype == x.dtype
            and A.dtype == torch.float32):
        raise ValueError("ssd_scan_cuda takes x, dt, B, C of one dtype and A "
                         "in float32, all on one card")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan_cuda takes contiguous tensors")
    path = route(x.dtype, L, dh, N)
    if path == "fma" and not supported(L, N, dh):
        raise ValueError(f"ssd_scan_cuda: no tile of the FMA kernels fits a block "
                         f"at dh={dh}, N={N}, chunk={L}")
    s0 = None
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, nh, dh, N) or initial_state.device != dev:
            raise ValueError(f"initial_state must be [b,nh,dh,N] = "
                             f"{(b, nh, dh, N)} on x's card")
        s0 = initial_state.float().contiguous()
    s0_ptr = s0.data_ptr() if s0 is not None else None
    code = _build.dtype_code(x)
    cs = torch.empty(b, s, nh, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    S = torch.empty(b, nh, dh, N, dtype=torch.float32, device=dev)
    lib = _build.library()
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            s0_ptr, cs.data_ptr())
    if path == "mma":
        err = lib.ssd_scan_mma_launch(
            *ptrs, y.data_ptr(), S.data_ptr(), b, s, nh, dh, N, L, code,
            *mma_launch(L, N, dh, x.element_size()), _build.stream_ptr(dev))
        _build.check("ssd_scan_mma_launch", err)
    elif path == "wgmma":
        err = lib.ssd_scan_wgmma_launch(
            *ptrs, y.data_ptr(), S.data_ptr(), b, s, nh, dh, N, L, wgmma_threads(L, N, dh),
            smem_bytes_wgmma(L, N, dh), _build.stream_ptr(dev))
        _build.check("ssd_scan_wgmma_launch", err)
    else:
        y_inter = torch.empty(b, s, nh, dh, dtype=torch.float32, device=dev)
        err = lib.ssd_scan_launch(
            *ptrs, y_inter.data_ptr(), y.data_ptr(), S.data_ptr(), b, s, nh, dh, N,
            L, row_tile(L, N, dh), *state_plan(L, N, dh), code, THREADS,
            smem_bytes_intra(L, N, dh), smem_bytes_state(L, N, dh),
            _build.stream_ptr(dev))
        _build.check("ssd_scan_launch", err)
    _build.LAUNCHES["ssd_scan"] += 1
    _build.LAUNCHES[launch_key(x.dtype, L, dh, N)] += 1
    return y, S


def wgmma_attributes(chunk: int, N: int, dh: int = 64) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) the compiler gave the
    wgmma kernel at this size; builds the library. Raises for a size that
    is not instantiated."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _build.library().ssd_scan_wgmma_attributes(
        dh, N, chunk, ctypes.byref(regs), ctypes.byref(local))
    _build.check("ssd_scan_wgmma_attributes", err)
    return regs.value, local.value


def mma_attributes(dh: int, N: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) the compiler gave the
    whole-chunk mma kernel at this head dim, state size and dtype; builds
    the library."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _build.library().ssd_scan_mma_attributes(
        dh, N, _build.DTYPE_CODES[dtype], ctypes.byref(regs), ctypes.byref(local))
    _build.check("ssd_scan_mma_attributes", err)
    return regs.value, local.value


def stream_attributes(dtype: torch.dtype) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) the compiler gave the
    streamed mma kernel in this dtype (one instantiation a dtype); builds
    the library."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _build.library().ssd_scan_stream_attributes(
        _build.DTYPE_CODES[dtype], ctypes.byref(regs), ctypes.byref(local))
    _build.check("ssd_scan_stream_attributes", err)
    return regs.value, local.value
