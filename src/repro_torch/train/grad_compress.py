"""Gradient compression with error feedback.

Counterpart of ``repro/train/grad_compress.py``. Two codecs, both applied
to gradients before the optimizer:

* ``int8``: per-tensor symmetric quantization (4x fewer bytes than f32 on
  the wire for the cross-pod gradient reduction);
* ``topk``: keep the top 1% magnitudes per tensor (a sparse all-reduce).

Error feedback accumulates the residual ``g - decompress(compress(g))``
into the next step, so compression bias does not accumulate. In one
process the codec's round trip is the numerics-faithful stand-in for the
compressed collective; the byte saving is credited in the roofline's
collective term (``wire_bytes_factor``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

TOPK_FRAC = 0.01


def init_error_feedback(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    amax = g.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk_roundtrip(g: torch.Tensor) -> torch.Tensor:
    flat = g.reshape(-1)
    n = flat.shape[0]
    if n <= 1 << 22:
        k = max(int(n * TOPK_FRAC), 1)
        thresh = torch.topk(flat.abs(), k).values[-1]
    else:
        # huge tensors: estimate the magnitude threshold from a strided
        # sample instead of sorting billions of elements (the reference's
        # branch; every full-width MLP leaf takes it)
        stride = n // (1 << 20)
        sample = flat[::stride].abs()
        k = max(int(sample.shape[0] * TOPK_FRAC), 1)
        thresh = torch.topk(sample, k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat))
    return kept.reshape(g.shape)


@torch.no_grad()
def compress_decompress(kind: str, grads: Dict[str, torch.Tensor],
                        ef: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """Returns (decompressed f32 grads, new error-feedback state); ``ef`` 's
    tensors are updated in place and returned."""
    codec = {"int8": _int8_roundtrip, "topk": _topk_roundtrip}[kind]
    dec = {}
    for k, g in grads.items():
        e = ef[k]
        g32 = g.float() + e
        dec[k] = codec(g32)
        e.copy_(g32 - dec[k])
    return dec, ef


def wire_bytes_factor(kind: str) -> float:
    """Bytes-on-the-wire multiplier vs uncompressed bf16 gradients."""
    return {"none": 1.0, "int8": 0.5, "topk": 2.5 * TOPK_FRAC}[kind]
