"""Unified model API: family dispatch, abstract shapes and input specs.

Counterpart of ``repro/models/model.py`` for the dense family.
``abstract_params``, ``abstract_cache`` and ``input_specs`` give tensors
on the ``meta`` device (shapes and dtypes, never allocated), which
the dry run turns into sharded fake tensors and the measured tier into
zeros on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import transformer


def _family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: it comes "
            f"with the other model families, ROADMAP queue 1 item 9")


# ---------------------------------------------------------------------------
# init / prefill / decode dispatch
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, seed: int = 0, device="cpu"):
    """(values, logical axes), flat dicts keyed by dotted tree path."""
    _family(cfg)
    return transformer.init_dense(cfg, seed, device)


def abstract_params(cfg: ArchConfig):
    """(meta-device values, logical axes) without allocating anything."""
    return init_params(cfg, device="meta")


def loss_fn(cfg: ArchConfig, params, batch, constrain=lambda a, k: a, remat: str = "none",
            loss_chunk: int = 0):
    """(loss, metrics) of a train batch ``{"tokens", "targets"}``."""
    _family(cfg)
    return transformer.dense_loss(cfg, params, batch, constrain, remat, loss_chunk)


def prefill_fn(cfg: ArchConfig, params, batch, cache, constrain=lambda a, k: a):
    _family(cfg)
    return transformer.dense_prefill(cfg, params, batch, cache, constrain)


def decode_fn(cfg: ArchConfig, params, batch, cache, constrain=lambda a, k: a):
    _family(cfg)
    return transformer.dense_decode(cfg, params, batch, cache, constrain)


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, device="cpu"):
    _family(cfg)
    return transformer.init_dense_cache(cfg, batch_size, max_len,
                                        transformer.torch_dtype(cfg), device)


def abstract_cache(cfg: ArchConfig, batch_size: int, max_len: int):
    return init_cache(cfg, batch_size, max_len, device="meta")


def params_from_reference(cfg: ArchConfig, tree: Mapping[str, Any],
                          device="cpu") -> Dict[str, torch.Tensor]:
    """The port's parameters from the reference's value tree (nested dicts
    of arrays, stacked over layers, as ``split_params`` gives it), so both
    packages compute the same thing. Values pass through float32, which
    holds bf16 and f32 exactly, and land in the config's dtype."""
    _family(cfg)
    dtype = transformer.torch_dtype(cfg)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
            else:
                t = torch.from_numpy(np.asarray(v, dtype=np.float32).copy())
                out[name] = t.to(device=device, dtype=dtype)

    walk(tree, "")
    _, axes = abstract_params(cfg)
    if set(out) != set(axes):
        raise ValueError(f"reference tree has {sorted(set(out) ^ set(axes))} "
                         f"that the port's {cfg.name} does not")
    return out


# ---------------------------------------------------------------------------
# input specs per shape cell
# ---------------------------------------------------------------------------
def cell_supported(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.sub_quadratic():
        return False, "full attention is quadratic at 524k ctx (see DESIGN.md §4)"
    return True, ""


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of a cell.

    train   -> {"batch": {"tokens": (B, S), "targets": (B, S)}}
    prefill -> {"batch": {"tokens": (B, S)}, "cache": {...}}
    decode  -> {"batch": {"tokens": (B, 1)}, "cache": {...}}
    """
    _family(cfg)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        return {"batch": {k: torch.empty((B, S), dtype=torch.int32, device="meta")
                          for k in ("tokens", "targets")}}
    cache = abstract_cache(cfg, B, S)
    n = S if cell.kind == "prefill" else 1
    return {"batch": {"tokens": torch.empty((B, n), dtype=torch.int32, device="meta")},
            "cache": cache}
