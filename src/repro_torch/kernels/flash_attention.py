"""Blockwise (flash) attention with online softmax, GQA and a causal mask.

Counterpart of ``repro/kernels/flash_attention.py``: q [b, sq, h, d],
k and v [b, sk, kh, d]; query head ``hd`` reads KV head ``hd // (h // kh)``;
q is scaled by 1/sqrt(d) in f32; causal keeps ``q_offset + i >= j``
(aligned to the top left, shifted by ``q_offset``); masked scores are
-1e30; m, l and the accumulator are f32 with an ``l == 0 -> 1`` guard;
blocks are ``min(block, seq)`` and must divide the sequence.

``flash_attention_cuda`` launches one of two hand-written Hopper kernels
(one CUDA block per (b*h, q tile)), chosen by :func:`route` before the
launch: bf16 inputs at d = 64 or 128 with block_q and block_k of 64 or 128
(the tiles it is instantiated for) take ``csrc/flash_attention_wgmma.cu``
(``wgmma`` products, TMA-fed K/V); every other call (f32, whose TF32 would
not hold it to its plain version; bf16 at another d, another tile or a
sequence shorter than 64) takes ``csrc/flash_attention.cu`` (f32 FMAs).
A failed build or launch raises; neither route stands in for the other.
``flash_attention_plain`` walks the same ``block_q`` / ``block_k`` tiles
with the same online softmax in plain torch, including the causal tile
skip, so the CPU tests exercise the GQA mapping, the causal offsets and the
``l == 0`` guard. On the wgmma route it rounds P to bf16 before the P.V
product, as that kernel does (l is summed from the f32 P).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCES = {"fma": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "wgmma": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"}
REPLACES = "src/repro/kernels/flash_attention.py:24"

NEG_INF = -1e30

#: threads per CUDA block of the FMA kernel
THREADS = 256

#: head dims the wgmma kernel is instantiated for
WGMMA_D = (64, 128)
#: block_q and block_k it is instantiated for (``FLASH_WGMMA_CASE`` in its
#: source lists the same product): with block_k 256, S, O and P alone would
#: take 128 + d/2 + 64 registers a thread, and block_q 256 would leave 544
#: threads 120 registers each
WGMMA_BLOCKS = (64, 128)

#: K/V stages in the wgmma kernel's TMA ring
WGMMA_STAGES = 2


def route(dtype: torch.dtype, d: int, block_q: int, block_k: int) -> str:
    """Which kernel runs a call at the tile it runs (``min(block, seq)``),
    decided before the launch: ``"wgmma"`` for bf16 at a head dim in
    ``WGMMA_D`` and ``block_q``, ``block_k`` in ``WGMMA_BLOCKS``, ``"fma"``
    otherwise."""
    return ("wgmma" if dtype == torch.bfloat16 and d in WGMMA_D
            and block_q in WGMMA_BLOCKS and block_k in WGMMA_BLOCKS else "fma")


def wgmma_threads(block_q: int) -> int:
    """The wgmma kernel's threads: one consumer warpgroup per 64 query rows
    and one producer warp."""
    return 128 * (block_q // 64) + 32


def smem_bytes_wgmma(block_q: int, block_k: int, d: int) -> int:
    """Dynamic shared memory the wgmma kernel asks for: 1024 bytes of
    alignment slack, the bf16 q tile, ``WGMMA_STAGES`` K and V tiles and
    the mbarriers. The launch and the resource model both call this."""
    return (1024 + 2 * d * (block_q + 2 * WGMMA_STAGES * block_k)
            + 8 * (1 + 2 * WGMMA_STAGES))


def smem_bytes(block_q: int, block_k: int, d: int, itemsize: int) -> int:
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


def _blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
            block_k: int) -> Tuple[int, int]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [b,sq,h,d] and k, v "
                         f"[b,sk,kh,d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    sk = k.shape[1]
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"blocks must divide the sequences: sq={sq} "
                         f"block_q={bq} sk={sk} block_k={bk}")
    return bq, bk


def flash_attention_plain(q, k, v, *, causal: bool = True, block_q: int = 512,
                          block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Flash attention in plain torch over the kernel's tiles."""
    bq, bk = _blocks(q, k, v, block_q, block_k)
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    # [b, kh, g, sq, d]: head hd = kvh * g + gi reads KV head kvh
    qf = (q.float() * scale).view(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)  # [b, kh, 1, sk, d]
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    round_p = route(q.dtype, d, bq, bk) == "wgmma"  # P.V takes P in bf16 there
    out = torch.empty(b, kh, g, sq, d, dtype=torch.float32, device=q.device)
    for qt in range(sq // bq):
        q_t = qf[..., qt * bq:(qt + 1) * bq, :]
        q_pos = q_offset + qt * bq + torch.arange(bq, device=q.device)
        m = torch.full((b, kh, g, bq), NEG_INF, device=q.device)
        l = torch.zeros(b, kh, g, bq, device=q.device)
        acc = torch.zeros(b, kh, g, bq, d, device=q.device)
        n_k = k_tiles_walked(qt, bq, bk, sk, causal=causal, q_offset=q_offset)
        for t in range(n_k):
            k_t = kf[..., t * bk:(t + 1) * bk, :]
            v_t = vf[..., t * bk:(t + 1) * bk, :]
            s = q_t @ k_t.transpose(-1, -2)
            if causal:
                k_pos = t * bk + torch.arange(bk, device=q.device)
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


def flash_attention_cuda(q, k, v, *, causal: bool = True, block_q: int = 512,
                         block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Flash attention on ``q``'s card, through the kernel :func:`route`
    names."""
    bq, bk = _blocks(q, k, v, block_q, block_k)
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and k.dtype == q.dtype and v.dtype == q.dtype):
        raise ValueError("flash_attention_cuda takes CUDA tensors of one "
                         "dtype on one card")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda takes contiguous tensors")
    code = _build.dtype_code(q)
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    o = torch.empty_like(q)
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    args = (b, sq, sk, h, kh, d, bq, bk, int(bool(causal)), int(q_offset),
            1.0 / math.sqrt(d))
    path = route(q.dtype, d, bq, bk)
    if path == "wgmma":
        err = lib.flash_attention_wgmma_launch(
            *ptrs, *args, wgmma_threads(bq), smem_bytes_wgmma(bq, bk, d),
            _build.stream_ptr(q.device))
        _build.check("flash_attention_wgmma_launch", err)
    else:
        err = lib.flash_attention_launch(
            *ptrs, *args, code, THREADS, smem_bytes(bq, bk, d, q.element_size()),
            _build.stream_ptr(q.device))
        _build.check("flash_attention_launch", err)
    _build.LAUNCHES["flash_attention"] += 1
    _build.LAUNCHES[f"flash_attention/{path}"] += 1
    return o


def wgmma_attributes(d: int, block_q: int, block_k: int) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) the compiler gave the
    wgmma kernel at this tile; builds the library. Raises for a tile that
    is not instantiated."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _build.library().flash_attention_wgmma_attributes(
        d, block_q, block_k, ctypes.byref(regs), ctypes.byref(local))
    _build.check("flash_attention_wgmma_attributes", err)
    return regs.value, local.value
