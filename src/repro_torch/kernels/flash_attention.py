"""Blockwise (flash) attention with online softmax, GQA and a causal mask.

Counterpart of ``repro/kernels/flash_attention.py``: q [b, sq, h, d],
k and v [b, sk, kh, d]; query head ``hd`` reads KV head ``hd // (h // kh)``;
q is scaled by 1/sqrt(d) in f32; causal keeps ``q_offset + i >= j``
(aligned to the top left, shifted by ``q_offset``); masked scores are
-1e30; m, l and the accumulator are f32 with an ``l == 0 -> 1`` guard;
blocks are ``min(block, seq)`` and must divide the sequence.

``flash_attention_cuda`` launches one of three hand-written Hopper kernels
(one CUDA block per (b*h, q tile)), chosen by :func:`route` before the
launch: bf16 inputs at every d up to 256 that is a multiple of 8, with
block_q and block_k in {64, 128, 256, 512}, take
``csrc/flash_attention_wgmma.cu`` (``wgmma`` products, TMA-fed K/V; d
zero-padded by TMA to 64, 128 or 256 (:func:`wgmma_head_dim`); a q tile
above 128 rows runs in passes of 128, a K tile in sub-tiles of up to 128
keys, 64 at d above 128); every other call up to d = 256 (f32; bf16 at a d
that is not a multiple of 8, another tile or a sequence shorter than 64)
takes ``csrc/flash_attention.cu`` (``mma.sync`` TF32 products with
each operand split into two TF32 parts, three products per product for f32
and two where the operand is bf16, which keeps f32 accuracy: plain TF32
would not hold f32 to its plain version; its K/V ring holds whole tiles
where two fit a block, else sub-tiles; above d = 128 q stays in shared
memory); d 257-1024 takes the same route's split kernel
(``csrc/flash_attention_split.cu``: the head dim in slices of 128 columns,
one warp a slice, the slices' partial scores added in one fixed order) at
every tile; d above 1024 takes ``csrc/flash_attention_fma.cu`` (f32 FMAs
on the CUDA cores, one K/V stage), which refuses a tile whose shared
memory does not fit.
A failed build or launch raises; no route stands in for another.
``flash_attention_plain`` walks the same ``block_q`` / ``block_k`` tiles
with the same online softmax in plain torch, including the causal tile
skip, so the CPU tests exercise the GQA mapping, the causal offsets and the
``l == 0`` guard. On the wgmma route it walks each K tile in that kernel's
sub-tiles and rounds P to bf16 before the P.V product, as the kernel does
(l is summed from the f32 P).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.core.device import H100_SXM
from repro_torch.kernels import _build

SOURCES = {"mma": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "wgmma": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
           "fma": "src/repro_torch/kernels/csrc/flash_attention_fma.cu"}
#: the mma route's kernel above d = 256, and its launch count's key (the
#: route's other kernel counts under "flash_attention/mma"; see
#: :func:`launch_key`)
SPLIT_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_split.cu"
SPLIT_KEY = "flash_attention/mma:split"
REPLACES = "src/repro/kernels/flash_attention.py:24"

NEG_INF = -1e30

#: head dims the mma kernel is instantiated for; d is zero-padded inside
#: the kernel to the next of them (``FLASH_MMA_CASE`` in its source lists
#: the same)
MMA_D = (16, 32, 64, 96, 128, 160, 192, 256)
#: above 256 the mma route's split kernel pads d to a multiple of 8 and cuts
#: it into slices of ``MMA_SLICE`` columns, one warp a slice, up to
#: ``MMA_MAX_D`` (``SLICE`` and ``SPLIT_MAX_D`` in its source); a larger d
#: goes to the FMA kernel
MMA_SLICE = 128
MMA_MAX_D = 1024
#: most warps of an mma block (16 query rows each; fewer where their q rows
#: would not leave a block room for two stages of one sub-tile, see
#: :func:`mma_max_warps`); a larger q tile runs in passes of 16 rows a warp
MMA_WARPS = 8
#: threads per CUDA block of the FMA kernel
FMA_THREADS = 256

#: head dims the wgmma kernel is instantiated for; d (a multiple of 8) is
#: zero-padded by TMA to the next of them (``padded_d`` in its source
#: computes the same)
WGMMA_D = (64, 128, 256)
#: block_q and block_k it takes: a q tile runs in passes of
#: ``min(block_q, WGMMA_MAX)`` rows and a K tile in sub-tiles of
#: ``min(block_k, WGMMA_MAX)`` keys, or of at most ``WGMMA_WIDE_KEYS`` at
#: DP 256; the pass, the sub-tile and DP are the template parameters
#: (``FLASH_WGMMA_CASE`` in its source lists them); 256-key sub-tiles would
#: take 128 + DP/2 + 64 registers a thread for S, O and P alone, 128-key
#: sub-tiles at DP 256 would take 272 in all, and 256-row passes would leave
#: 544 threads 120 registers each
WGMMA_BLOCKS = (64, 128, 256, 512)
WGMMA_MAX = 128
WGMMA_WIDE_KEYS = 64

#: K/V stages in the wgmma kernel's TMA ring
WGMMA_STAGES = 2


@functools.lru_cache(maxsize=None)
def route(dtype: torch.dtype, d: int, block_q: int, block_k: int) -> str:
    """Which kernel runs a call at the tile it runs (``min(block, seq)``),
    decided before the launch: ``"wgmma"`` for bf16 at a head dim that
    :func:`wgmma_head_dim` pads (a multiple of 8 up to 256) and
    ``block_q``, ``block_k`` in ``WGMMA_BLOCKS``; else ``"mma"`` where d is
    at most ``MMA_MAX_D``; else ``"fma"``."""
    if (dtype == torch.bfloat16 and wgmma_head_dim(d) and block_q in WGMMA_BLOCKS
            and block_k in WGMMA_BLOCKS):
        return "wgmma"
    return "mma" if mma_head_dim(d) else "fma"


@functools.lru_cache(maxsize=None)
def wgmma_head_dim(d: int) -> int:
    """The head dim the wgmma kernel pads ``d`` to (TMA fills the columns
    from d up with zeros), 0 where it takes none: d must be a multiple of 8
    (TMA's row strides are multiples of 16 bytes) and at most 256."""
    if d <= 0 or d % 8:
        return 0
    return next((p for p in WGMMA_D if p >= d), 0)


def wgmma_pass_rows(block_q: int) -> int:
    """Query rows of one pass of the wgmma kernel (a template parameter)."""
    return min(block_q, WGMMA_MAX)


def wgmma_sub_keys(block_k: int, d: int) -> int:
    """Keys of one K/V sub-tile of the wgmma kernel at head dim ``d`` (a
    template parameter): its online softmax and its rounding of P run once
    a sub-tile. At most 128, or 64 where d pads to 256 (O's 128 registers a
    thread leave room for S of 64 keys)."""
    return min(block_k, WGMMA_WIDE_KEYS if wgmma_head_dim(d) > 128 else WGMMA_MAX)


#: registers a thread of a consumer and of the producer warpgroup where the
#: producer is a warpgroup (``CONSUMER_REGS`` and ``PRODUCER_REGS`` in the
#: kernel's source): 2 x 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536
WGMMA_CONSUMER_REGS = 232
WGMMA_PRODUCER_REGS = 40


def wgmma_producer_threads(block_q: int, d: int) -> int:
    """The wgmma kernel's producer threads: one warp, or at DP 256 with
    passes of 128 rows a whole warpgroup, which gives its registers to the
    two consumer warpgroups (``setmaxnreg``): 288 threads leave 168 a
    thread as the compiler allocates them, and O alone takes 128."""
    return 128 if wgmma_head_dim(d) > 128 and wgmma_pass_rows(block_q) > 64 else 32


def wgmma_threads(block_q: int, d: int) -> int:
    """The wgmma kernel's threads: one consumer warpgroup per 64 rows of a
    pass and the producer (:func:`wgmma_producer_threads`)."""
    return 128 * (wgmma_pass_rows(block_q) // 64) + wgmma_producer_threads(block_q, d)


def smem_bytes_wgmma(block_q: int, block_k: int, d: int) -> int:
    """Dynamic shared memory the wgmma kernel asks for: 1024 bytes of
    alignment slack, a pass's bf16 q rows, ``WGMMA_STAGES`` K and V
    sub-tiles, all at the padded head dim, and the mbarriers (q full and
    empty, a full and an empty per stage). The launch and the resource
    model both call this."""
    qp, ks, dp = wgmma_pass_rows(block_q), wgmma_sub_keys(block_k, d), wgmma_head_dim(d)
    return 1024 + 2 * dp * (qp + 2 * WGMMA_STAGES * ks) + 8 * (2 + 2 * WGMMA_STAGES)


@functools.lru_cache(maxsize=None)
def mma_head_dim(d: int) -> int:
    """The head dim the mma route pads ``d`` to, 0 where it takes none: the
    next of ``MMA_D`` up to 256, else d rounded up to 8 up to ``MMA_MAX_D``."""
    if d <= MMA_D[-1]:
        return next((p for p in MMA_D if p >= d), 0)
    return -(-d // 8) * 8 if d <= MMA_MAX_D else 0


def mma_slices(d: int) -> int:
    """Warps that share a group of 16 query rows on the mma route: 1 up to
    d = 256, else one per ``MMA_SLICE`` columns of the padded head dim."""
    dp = mma_head_dim(d)
    return 1 if dp <= MMA_D[-1] else -(-dp // MMA_SLICE)


@functools.lru_cache(maxsize=None)
def mma_split_plan(d: int, itemsize: int) -> Tuple[int, int]:
    """(sub-tile keys, most row groups of a block) of the split kernel (d
    above 256): the largest sub-tile of 32, 16 and 8 keys, and with it the
    most groups (``MMA_WARPS`` // slices, halving), whose two stages of one
    sub-tile, q rows (16 a group) and partial scores (16 x sub-tile f32 a
    warp) fit a block; ``split_plan`` in its source computes the same.
    (0, 0) where none fits."""
    ns = mma_slices(d)
    k_words, v_words = _mma_row_words(d, itemsize)
    for kc in (32, 16, 8):
        g = MMA_WARPS // ns
        while g >= 1:
            if 4 * (2 * kc * (k_words + v_words) + 16 * g * k_words + 16 * kc * g * ns) \
                    <= H100_SXM.smem_per_block:
                return kc, g
            g //= 2
    return 0, 0


@functools.lru_cache(maxsize=None)
def mma_sub_keys(d: int, itemsize: int = 4) -> int:
    """Keys of the sub-tile each warp of the mma kernel takes at once (its
    S fragment holds half as many registers): 64 up to d = 32, else 32; the
    split kernel's from :func:`mma_split_plan`."""
    if mma_slices(d) > 1:
        return mma_split_plan(d, itemsize)[0]
    return 64 if mma_head_dim(d) <= 32 else 32


@functools.lru_cache(maxsize=None)
def mma_max_warps(d: int, itemsize: int) -> int:
    """The most warps of an mma block at this head dim and type:
    ``MMA_WARPS``, halved until their q rows (16 a warp) and two stages of
    one sub-tile fit a block (4 for f32 at d above 192; ``max_warps`` in the
    kernel's source computes the same); above d = 256 the slices times
    :func:`mma_split_plan`'s groups."""
    if mma_slices(d) > 1:
        return mma_slices(d) * mma_split_plan(d, itemsize)[1]
    k_words, v_words = _mma_row_words(d, itemsize)
    stages = 2 * mma_sub_keys(d) * (k_words + v_words)
    warps = MMA_WARPS
    while warps > 1 and 4 * (stages + 16 * warps * k_words) > H100_SXM.smem_per_block:
        warps //= 2
    return warps


@functools.lru_cache(maxsize=None)
def mma_threads(block_q: int, d: int, itemsize: int) -> int:
    """The mma kernel's threads: one warp per 16 query rows (per 16 rows
    and slice above d = 256), at most :func:`mma_max_warps`."""
    ns = mma_slices(d)
    return 32 * ns * min(-(-block_q // 16), mma_max_warps(d, itemsize) // ns)


def _mma_row_words(d: int, itemsize: int) -> Tuple[int, int]:
    """Words of a K (and q) row and of a V row in the mma kernel's shared
    memory, padded for conflict-free fragment reads (K and q: f32 to 8
    words mod 32, bf16 to 4 mod 16; V: 4 words mod 16)."""
    dp = mma_head_dim(d)
    k_words = (_build.row_words(dp, 4, 8, 32) if itemsize == 4
               else _build.row_words(dp, 2, 4, 16))
    return k_words, _build.row_words(dp, itemsize, 4, 16)


def _mma_fixed_words(block_q: int, d: int, itemsize: int) -> int:
    """Words of the mma kernel's shared memory beside the K/V ring: the q
    rows of one pass (16 a row group) and, above d = 256, each warp's
    partial scores (16 x sub-tile f32)."""
    k_words, _ = _mma_row_words(d, itemsize)
    warps, ns = mma_threads(block_q, d, itemsize) // 32, mma_slices(d)
    partials = 16 * mma_sub_keys(d, itemsize) * warps if ns > 1 else 0
    return 16 * (warps // ns) * k_words + partials


@functools.lru_cache(maxsize=None)
def mma_stage_keys(block_q: int, block_k: int, d: int, itemsize: int) -> int:
    """Keys one stage of the mma kernel's two-stage K/V ring holds: the
    whole ``block_k`` tile, rounded up to whole sub-tiles, where two such
    stages and a pass's q rows (and partial scores) fit a block; else the
    largest multiple of the sub-tile that fits, and the kernel brings a
    tile in that many keys at a time (its result does not depend on it)."""
    kc = mma_sub_keys(d, itemsize)
    k_words, v_words = _mma_row_words(d, itemsize)
    whole = -(-block_k // kc) * kc
    room = H100_SXM.smem_per_block - 4 * _mma_fixed_words(block_q, d, itemsize)
    fit = room // (8 * (k_words + v_words)) // kc * kc
    return whole if whole <= fit else fit


@functools.lru_cache(maxsize=None)
def smem_bytes_mma(block_q: int, block_k: int, d: int, itemsize: int) -> int:
    """Dynamic shared memory the mma kernel asks for: two stages of
    :func:`mma_stage_keys` K and V rows in the input type, the q rows of
    one pass (16 a row group), each row padded as :func:`_mma_row_words`
    says, and above d = 256 the warps' partial scores. The launch and the
    resource model both call this."""
    k_words, v_words = _mma_row_words(d, itemsize)
    return 4 * (2 * mma_stage_keys(block_q, block_k, d, itemsize) * (k_words + v_words)
                + _mma_fixed_words(block_q, d, itemsize))


def smem_bytes_fma(block_q: int, block_k: int, d: int, itemsize: int) -> int:
    """Dynamic shared memory the FMA kernel asks for: the f32 accumulator
    [bq, d], the scaled q tile [bq, d+1] and the score tile [bq, bk+1] in
    f32 (their padding columns hold each row's m and correction), l per
    row, and one K and one V tile in the input type. The launch and the
    resource model both call this."""
    return (4 * (block_q * d + block_q * (d + 1) + block_q * (block_k + 1) + block_q)
            + 2 * block_k * d * itemsize)


def k_tiles_walked(q_tile: int, block_q: int, block_k: int, sk: int, *,
                   causal: bool, q_offset: int) -> int:
    """K tiles the kernel walks for q tile ``q_tile``: all of them, or with
    causal and ``q_offset >= 0`` only those that some row of the tile can
    see (the rest would leave the output unchanged)."""
    n_k = sk // block_k
    if causal and q_offset >= 0:
        last = q_offset + q_tile * block_q + block_q - 1
        n_k = min(n_k, last // block_k + 1)
    return n_k


def _tiles(q_shape, k_shape, v_shape, block_q: int, block_k: int) -> Tuple[int, int]:
    if len(q_shape) != 4 or len(k_shape) != 4 or k_shape != v_shape:
        raise ValueError(f"flash_attention takes q [b,sq,h,d] and k, v "
                         f"[b,sk,kh,d], got {tuple(q_shape)}, "
                         f"{tuple(k_shape)}, {tuple(v_shape)}")
    b, sq, h, d = q_shape
    if k_shape[0] != b or k_shape[3] != d or h % k_shape[2]:
        raise ValueError(f"k/v {tuple(k_shape)} do not fit q {tuple(q_shape)}")
    sk = k_shape[1]
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"blocks must divide the sequences: sq={sq} "
                         f"block_q={bq} sk={sk} block_k={bk}")
    return bq, bk


def _blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
            block_k: int) -> Tuple[int, int]:
    return _tiles(q.shape, k.shape, v.shape, block_q, block_k)


def flash_attention_plain(q, k, v, *, causal: bool = True, block_q: int = 512,
                          block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Flash attention in plain torch over the kernel's tiles."""
    bq, bk = _blocks(q, k, v, block_q, block_k)
    d = q.shape[3]
    on_wgmma = route(q.dtype, d, bq, bk) == "wgmma"
    # the wgmma kernel runs its softmax once a sub-tile and takes P in bf16
    return _flash_walk(q, k, v, causal=causal, bq=bq, bk=bk, q_offset=q_offset,
                       sub_k=wgmma_sub_keys(bk, d) if on_wgmma else bk, round_p=on_wgmma)


def _flash_walk(q, k, v, *, causal: bool, bq: int, bk: int, q_offset: int, sub_k: int,
                round_p: bool) -> torch.Tensor:
    """The tile walk of :func:`flash_attention_plain`: the K tiles each q
    tile can see, each in steps of ``sub_k`` keys (one online-softmax update
    a step), P rounded to q's dtype for P.V where ``round_p``."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    # [b, kh, g, sq, d]: head hd = kvh * g + gi reads KV head kvh
    qf = (q.float() * scale).view(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)  # [b, kh, 1, sk, d]
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    out = torch.empty(b, kh, g, sq, d, dtype=torch.float32, device=q.device)
    for qt in range(sq // bq):
        q_t = qf[..., qt * bq:(qt + 1) * bq, :]
        q_pos = q_offset + qt * bq + torch.arange(bq, device=q.device)
        m = torch.full((b, kh, g, bq), NEG_INF, device=q.device)
        l = torch.zeros(b, kh, g, bq, device=q.device)
        acc = torch.zeros(b, kh, g, bq, d, device=q.device)
        n_k = k_tiles_walked(qt, bq, bk, sk, causal=causal, q_offset=q_offset)
        for k0 in range(0, n_k * bk, sub_k):
            k_t = kf[..., k0:k0 + sub_k, :]
            v_t = vf[..., k0:k0 + sub_k, :]
            s = q_t @ k_t.transpose(-1, -2)
            if causal:
                k_pos = k0 + torch.arange(sub_k, device=q.device)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            p_v = p.to(q.dtype).float() if round_p else p
            acc = acc * corr[..., None] + p_v @ v_t
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[..., qt * bq:(qt + 1) * bq, :] = acc / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def launch_key(dtype: torch.dtype, d: int, block_q: int, block_k: int) -> str:
    """The launch count's key of the kernel a call runs at these tiles:
    ``"flash_attention/<route>"``, and on ``mma`` above d = 256 the split
    kernel's :data:`SPLIT_KEY`. Each launch counts under one key; a route's
    launches are the sum of its kernels' (the key up to ``:``)."""
    path = route(dtype, d, block_q, block_k)
    return SPLIT_KEY if path == "mma" and mma_slices(d) > 1 else f"flash_attention/{path}"


@functools.lru_cache(maxsize=1024)
def _launch_plan(q_shape, k_shape, v_shape, dtype: torch.dtype, block_q: int,
                 block_k: int, causal: bool, q_offset: int) -> Tuple[str, tuple, str, object]:
    """A call's launch, worked out once for its shapes and options (at small
    shapes the host's share of a call is comparable to the kernel's): the
    C entry point, its arguments between the four pointers and the stream,
    the launch count's key (:func:`launch_key`), and what must outlive the
    arguments
    (the mma launcher takes its integers as one array)."""
    bq, bk = _tiles(q_shape, k_shape, v_shape, block_q, block_k)
    b, sq, h, d = q_shape
    _, sk, kh, _ = k_shape
    path = route(dtype, d, bq, bk)
    ints = (b, sq, sk, h, kh, d, bq, bk, int(causal), q_offset)
    scale = 1.0 / math.sqrt(d)
    itemsize, code = dtype.itemsize, _build.DTYPE_CODES.get(dtype, -1)
    cfg = None
    if path == "wgmma":
        args = (*ints, scale, wgmma_threads(bq, d), smem_bytes_wgmma(bq, bk, d))
    elif path == "mma":
        cfg = (ctypes.c_int * 14)(*ints, code, mma_threads(bq, d, itemsize),
                                  smem_bytes_mma(bq, bk, d, itemsize),
                                  mma_stage_keys(bq, bk, d, itemsize))
        args = (ctypes.addressof(cfg), scale)
    else:
        args = (*ints, scale, code, FMA_THREADS, smem_bytes_fma(bq, bk, d, itemsize))
    return f"flash_attention_{path}_launch", args, launch_key(dtype, d, bq, bk), cfg


def flash_attention_cuda(q, k, v, *, causal: bool = True, block_q: int = 512,
                         block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Flash attention on ``q``'s card, through the kernel :func:`route`
    names."""
    entry, args, key, _ = _launch_plan(q.shape, k.shape, v.shape, q.dtype, block_q,
                                       block_k, bool(causal), int(q_offset))
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and k.dtype == q.dtype and v.dtype == q.dtype):
        raise ValueError("flash_attention_cuda takes CUDA tensors of one "
                         "dtype on one card")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda takes contiguous tensors")
    _build.dtype_code(q)  # raises for a dtype the kernels do not take
    o = torch.empty_like(q)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *args,
        _build.stream_ptr(q.device))
    _build.check(entry, err)
    _build.LAUNCHES["flash_attention"] += 1
    _build.LAUNCHES[key] += 1
    return o


def wgmma_attributes(d: int, block_q: int, block_k: int) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) the compiler gave the
    wgmma kernel's instantiation that a call at head dim ``d`` and a tile of
    ``block_q`` x ``block_k`` runs on (:func:`wgmma_head_dim`, passes of
    :func:`wgmma_pass_rows`, sub-tiles of :func:`wgmma_sub_keys`); builds
    the library. Raises for a call the route does not take."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _build.library().flash_attention_wgmma_attributes(
        d, block_q, block_k, ctypes.byref(regs), ctypes.byref(local))
    _build.check("flash_attention_wgmma_attributes", err)
    return regs.value, local.value


def mma_attributes(d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) the compiler gave the
    mma kernel at ``d``'s padded head dim (above 256, the split kernel's
    instantiation at its sub-tile); builds the library. Raises above
    ``MMA_MAX_D``."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _build.library().flash_attention_mma_attributes(
        d, _build.DTYPE_CODES[dtype], ctypes.byref(regs), ctypes.byref(local))
    _build.check("flash_attention_mma_attributes", err)
    return regs.value, local.value
