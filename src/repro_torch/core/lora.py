"""LoRA (Hu et al., 2022) in torch: the paper's parameter-efficient
fine-tuning mechanism (§3.2.2). The base model's weights are frozen and
small low-rank A·B adapters are trained on accumulated hardware data
points.

Counterpart of ``repro/core/lora.py``, over a flat ``{name: tensor}``
dict of weights (the surrogate's ``w0, b0, ...``): one (A, B) adapter per
2-D weight, None for the others. A is ``scale * randn`` from an explicit
``torch.Generator`` (the reference draws from ``jax.random``, so the
numbers differ; :func:`lora_from_numpy` carries the reference's over), B
is zeros, so a fresh adapter leaves the weights as they were. Used to
adapt the learned cost model (``cost_model.py``) as the DB grows.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

Adapters = Dict[str, Optional[Dict[str, torch.Tensor]]]


def init_lora(params: Mapping[str, torch.Tensor], gen: torch.Generator,
              rank: int = 8, scale: float = 0.01) -> Adapters:
    """One (A, B) adapter per 2-D weight, drawn in sorted name order (the
    order of the reference's flattened dict); other weights get None."""
    out: Adapters = {}
    for k in sorted(params):
        leaf = params[k]
        if leaf.dim() == 2:
            fi, fo = leaf.shape
            out[k] = {"a": scale * torch.randn(fi, rank, generator=gen),
                      "b": torch.zeros(rank, fo)}
        else:
            out[k] = None
    return out


def lora_from_numpy(adapters: Mapping[str, Optional[Mapping[str, np.ndarray]]]) -> Adapters:
    """Adapters holding ``adapters`` (numpy ``a``/``b`` per weight name, or
    None), e.g. the reference's ``init_lora`` output."""
    return {k: None if ad is None else
            {n: torch.tensor(np.asarray(ad[n], np.float32)) for n in ("a", "b")}
            for k, ad in adapters.items()}


def apply_lora(params: Mapping[str, torch.Tensor], lora: Adapters) -> Dict[str, torch.Tensor]:
    """Effective weights: W + A @ B (frozen base + adapters)."""
    out = {}
    for k, p in params.items():
        ad = lora.get(k)
        out[k] = p if ad is None or p.dim() != 2 else p + ad["a"] @ ad["b"]
    return out


def lora_param_count(lora: Adapters) -> int:
    return sum(t.numel() for ad in lora.values() if ad is not None for t in ad.values())
