"""Plain torch oracles for the port's kernels (the ``ref.py`` contract).

Counterpart of ``repro/kernels/ref.py``: the correctness gate holds every
candidate tile against these. ``ssd_ref`` comes with the SSD kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def vecmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Element-wise vector multiply: Z_i = X_i * Y_i (the paper's §4 kernel)."""
    return x * y


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 * inv) * w.float()).to(x.dtype)


def attention_ref(q, k, v, *, causal: bool = True,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Naive full-softmax attention. q, k, v: [b, s, h, d] (same head
    counts). The causal mask is aligned to the bottom right
    (``tril(k=sk-sq)``) and masked scores are -1e30, as in the reference."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
