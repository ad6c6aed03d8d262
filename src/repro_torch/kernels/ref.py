"""Plain torch oracles for the port's kernels (the ``ref.py`` contract).

Counterpart of ``repro/kernels/ref.py``: the correctness gate holds every
candidate tile against these.
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


def ssd_ref(x, dt, A, B, C, initial_state=None):
    """Exact sequential SSD recurrence (the oracle for ``ssd_scan``).

    x: [b, s, nh, dh]; dt: [b, s, nh] (post-softplus); A: [nh] negative;
    B, C: [b, s, N]. Returns (y [b,s,nh,dh] in x's dtype, final_state
    [b,nh,dh,N] in f32), one step per position as in the reference.
    """
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    h = (torch.zeros(b, nh, dh, N, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float().clone())
    A32, dt32, B32, C32 = A.float(), dt.float(), B.float(), C.float()
    ys = torch.empty(b, s, nh, dh, dtype=torch.float32, device=x.device)
    for t in range(s):
        dA = torch.exp(dt32[:, t] * A32[None, :])  # [b, nh]
        h = h * dA[..., None, None] + (
            (dt32[:, t, :, None] * x[:, t].float())[..., None]
            * B32[:, t, None, None, :])
        ys[:, t] = torch.einsum("bhpn,bn->bhp", h, C32[:, t])
    return ys.to(x.dtype), h
