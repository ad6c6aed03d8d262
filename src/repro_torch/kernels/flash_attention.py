"""Blockwise (flash) attention with online softmax, GQA and a causal mask.

Counterpart of ``repro/kernels/flash_attention.py``: q [b, sq, h, d],
k and v [b, sk, kh, d]; query head ``hd`` reads KV head ``hd // (h // kh)``;
q is scaled by 1/sqrt(d) in f32; causal keeps ``q_offset + i >= j``
(aligned to the top left, shifted by ``q_offset``); masked scores are
-1e30; m, l and the accumulator are f32 with an ``l == 0 -> 1`` guard;
blocks are ``min(block, seq)`` and must divide the sequence.

``flash_attention_cuda`` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (one CUDA block per (b*h, q tile)).
``flash_attention_plain`` walks the same ``block_q`` / ``block_k`` tiles
with the same online softmax in plain torch, including the causal tile
skip, so the CPU tests exercise the GQA mapping, the causal offsets and the
``l == 0`` guard.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:24"

NEG_INF = -1e30

#: threads per CUDA block
THREADS = 256


def smem_bytes(block_q: int, block_k: int, d: int, itemsize: int) -> int:
    """Dynamic shared memory the kernel asks for: the f32 accumulator
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
            acc = acc * corr[..., None] + p @ v_t
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[..., qt * bq:(qt + 1) * bq, :] = acc / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True, block_q: int = 512,
                         block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Flash attention through ``csrc/flash_attention.cu`` on ``q``'s card."""
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
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h, kh,
        d, bq, bk, int(bool(causal)), int(q_offset), 1.0 / math.sqrt(d), code,
        THREADS, smem_bytes(bq, bk, d, q.element_size()),
        _build.stream_ptr(q.device))
    _build.check("flash_attention_launch", err)
    _build.LAUNCHES["flash_attention"] += 1
    return o
