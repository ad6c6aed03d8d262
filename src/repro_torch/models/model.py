"""Unified model API: family dispatch, abstract shapes and input specs.

Counterpart of ``repro/models/model.py``, for all six families: dense, moe
and vlm (``transformer``), ssm (``ssm_lm``), hybrid (``hybrid``) and audio
(``encdec``). ``abstract_params``, ``abstract_cache`` and ``input_specs``
give tensors on the ``meta`` device (shapes and dtypes, never allocated),
which the dry run turns into sharded fake tensors and the measured tier
into zeros on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models.transformer import FRONTEND_DIM

_TRANSFORMER = ("dense", "moe", "vlm")


def _pick(cfg: ArchConfig, table: Dict[str, Any]):
    fam = "transformer" if cfg.family in _TRANSFORMER else cfg.family
    if fam not in table:
        raise ValueError(cfg.family)
    return table[fam]


# ---------------------------------------------------------------------------
# init / loss / prefill / decode dispatch
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, seed: int = 0, device="cpu"):
    """(values, logical axes), flat dicts keyed by dotted tree path."""
    return _pick(cfg, {"transformer": transformer.init_dense, "ssm": ssm_lm.init_ssm_lm,
                       "hybrid": hybrid.init_hybrid, "audio": encdec.init_encdec})(
        cfg, seed, device)


def abstract_params(cfg: ArchConfig):
    """(meta-device values, logical axes) without allocating anything."""
    return init_params(cfg, device="meta")


def loss_fn(cfg: ArchConfig, params, batch, constrain=lambda a, k: a, remat: str = "none",
            loss_chunk: int = 0):
    """(loss, metrics) of a train batch (``{"tokens", "targets"}``, and
    ``"frontend"`` for vlm and audio)."""
    return _pick(cfg, {"transformer": transformer.dense_loss, "ssm": ssm_lm.ssm_loss,
                       "hybrid": hybrid.hybrid_loss, "audio": encdec.encdec_loss})(
        cfg, params, batch, constrain, remat, loss_chunk)


def prefill_fn(cfg: ArchConfig, params, batch, cache, constrain=lambda a, k: a):
    return _pick(cfg, {"transformer": transformer.dense_prefill, "ssm": ssm_lm.ssm_prefill,
                       "hybrid": hybrid.hybrid_prefill, "audio": encdec.encdec_prefill})(
        cfg, params, batch, cache, constrain)


def decode_fn(cfg: ArchConfig, params, batch, cache, constrain=lambda a, k: a):
    return _pick(cfg, {"transformer": transformer.dense_decode, "ssm": ssm_lm.ssm_decode,
                       "hybrid": hybrid.hybrid_decode, "audio": encdec.encdec_decode})(
        cfg, params, batch, cache, constrain)


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, device="cpu"):
    dt = transformer.torch_dtype(cfg)
    if cfg.family == "ssm":
        return ssm_lm.init_ssm_cache(cfg, batch_size, dt, device)
    return _pick(cfg, {"transformer": transformer.init_dense_cache,
                       "hybrid": hybrid.init_hybrid_cache,
                       "audio": encdec.init_encdec_cache})(cfg, batch_size, max_len, dt, device)


def abstract_cache(cfg: ArchConfig, batch_size: int, max_len: int):
    return init_cache(cfg, batch_size, max_len, device="meta")


def params_from_reference(cfg: ArchConfig, tree: Mapping[str, Any],
                          device="cpu") -> Dict[str, torch.Tensor]:
    """The port's parameters from the reference's value tree (nested dicts
    of arrays, stacked over layers, as ``split_params`` gives it), so both
    packages compute the same thing. Values pass through float32, which
    holds bf16 and f32 exactly, and each leaf lands in the dtype the
    reference's init gives it, which the port's init mirrors (the config's
    dtype, but f32 for Mamba2's ``A_log``, ``D`` and ``dt_bias`` in any
    model)."""
    want, axes = abstract_params(cfg)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
            else:
                t = torch.from_numpy(np.asarray(v, dtype=np.float32).copy())
                out[name] = t.to(device=device,
                                 dtype=want[name].dtype if name in want else torch.float32)

    walk(tree, "")
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


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of a cell.

    train   -> {"batch": {"tokens": (B, S), "targets": (B, S)}}
    prefill -> {"batch": {"tokens": (B, S)}, "cache": {...}}
    decode  -> {"batch": {"tokens": (B, 1)}, "cache": {...}}

    vlm: the text is ``S - frontend_len`` tokens, after ``"frontend"`` [B,
    F, 1024] f32 patch embeddings; audio: ``S`` tokens beside ``"frontend"``
    [B, F, 1024] frame embeddings (train and prefill).
    """
    B, S = cell.global_batch, cell.seq_len
    fam = cfg.family
    text = S - cfg.frontend_len if fam == "vlm" else S
    if cell.kind == "decode":
        return {"batch": {"tokens": _meta((B, 1))}, "cache": abstract_cache(cfg, B, S)}
    if cell.kind == "train":
        batch = {"tokens": _meta((B, text)), "targets": _meta((B, text))}
    elif cell.kind == "prefill":
        batch = {"tokens": _meta((B, text))}
    else:
        raise ValueError(cell.kind)
    if fam in ("vlm", "audio"):
        batch["frontend"] = _meta((B, cfg.frontend_len, FRONTEND_DIM), torch.float32)
    if cell.kind == "train":
        return {"batch": batch}
    return {"batch": batch, "cache": abstract_cache(cfg, B, S)}
