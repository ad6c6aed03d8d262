"""Dense decoder-only transformer (llama3 / qwen3 / stablelm backbone).

Counterpart of the dense half of ``repro/models/transformer.py``. Layers
are stacked on a leading axis, as in the reference (whose ``lax.scan``
keeps its HLO depth-independent); here a Python loop over
``constrain.walk`` indexes them, and the dry run traces one layer and
weights it by the depth. The cache layout is the reference's,
``[n_layers, b, S, kh, dh]``, and is updated in place (the reference
donates it).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamInit
from repro_torch.sharding.plan import full_walk, is_sharded, local_call, shard_offset

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


def init_dense(cfg, seed: int = 0, device="cpu"):
    """(values, logical axes): flat dicts keyed by the reference's tree
    paths joined with ``.``."""
    init = ParamInit(torch_dtype(cfg), device, seed)
    d, n = cfg.d_model, cfg.n_layers
    if cfg.moe is not None:
        raise NotImplementedError("moe layers come with the other model families "
                                  "(ROADMAP queue 1 item 9)")
    init.normal("embed", (cfg.vocab, d), ("vocab", "embed"))
    stack, ax = (n,), ("layers",)
    init.ones("blocks.ln1", (n, d), ("layers", "embed"))
    L.init_attention(init, "blocks.attn", cfg, stack=stack, stack_axes=ax)
    init.ones("blocks.ln2", (n, d), ("layers", "embed"))
    L.init_mlp(init, "blocks.mlp", d, cfg.d_ff, stack=stack, stack_axes=ax)
    init.ones("ln_f", (d,), ("embed",))
    if not cfg.tie_embeddings:
        init.normal("lm_head", (d, cfg.vocab), ("embed", "vocab"))
    return init.values, init.axes


def layer_params(params: Dict[str, torch.Tensor], i: int) -> Dict[str, Dict]:
    """Layer ``i`` 's parameters as ``{"ln1", "attn": {...}, "ln2", "mlp": {...}}``."""
    out: Dict = {"attn": {}, "mlp": {}}
    for k, v in params.items():
        if k.startswith("blocks."):
            path = k.split(".")[1:]
            if len(path) == 1:
                out[path[0]] = v[i]
            else:
                out[path[0]][path[1]] = v[i]
    return out


def _embed_inputs(cfg, params, batch, constrain):
    """Token embedding. Returns (x [b,s,d], positions [b,s])."""
    tok = batch["tokens"]
    x = torch.nn.functional.embedding(tok, params["embed"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return constrain(x, "hidden"), positions


def _logits(cfg, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))


def _last_token(constrain, x):
    """x[:, -1:], taken from the shard that holds it when the sequence is
    sharded (one all-reduce of [b, 1, d] instead of gathering x)."""
    mesh = getattr(constrain, "mesh", None)
    from torch.distributed.tensor import DTensor

    if not (is_sharded(mesh) and isinstance(x, DTensor)
            and any(p.is_shard(1) for p in x.placements)):
        return x[:, -1:]
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate

    xp = x.placements
    off, n = shard_offset(mesh, xp, x.shape[1], 1)
    mine = off + n == x.shape[1]
    dims = [i for i, p in enumerate(xp) if p.is_shard(1)]
    out_p = tuple(Replicate() if p.is_shard(1) else p for p in xp)

    def local(xl):
        last = xl[:, -1:] if mine else torch.zeros_like(xl[:, -1:])
        for i in dims:
            last = funcol.all_reduce(last, "sum", (mesh, i))
        return last

    return local_call(local, mesh, [(x, xp)], [out_p])


def _layer_body(cfg, constrain, x, lp, lcache, positions, window):
    """Returns (out, new_cache). Each branch's output is placed as the
    residual before it is added (on a sharded mesh its row-parallel sums
    are reduced there, once, in the activations' dtype, where DTensor
    would otherwise carry them as pending sums into the next norm)."""
    a, new_cache = L.attention_block(
        lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
        positions=positions, causal=True, window=window,
        cache=lcache, constrain=constrain,
    )
    h = x + constrain(a, "hidden")
    m = L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps), constrain)
    return h + constrain(m, "hidden"), new_cache


def _run_layers(cfg, params, x, positions, cache, constrain):
    """The layer loop; ``cache`` (or ``None``) is updated in place."""
    walk = getattr(constrain, "walk", full_walk)
    for i, _ in walk(cfg.n_layers, "uniform"):
        lcache = None
        if cache is not None:
            lcache = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]}
        x, _ = _layer_body(cfg, constrain, x, layer_params(params, i), lcache,
                           positions, cfg.swa_window)
    return L.rmsnorm(x, params["ln_f"], cfg.norm_eps)


def dense_forward(cfg, params, batch, *, cache=None, constrain=lambda a, k: a):
    """Returns (hidden [b,s,d], new_cache)."""
    if cache is None:
        x, positions = _embed_inputs(cfg, params, batch, constrain)
    else:
        # decode: single new token at position cache["len"]
        tok = batch["tokens"]  # [b, 1]
        x = torch.nn.functional.embedding(tok, params["embed"])
        positions = cache["len"][:, None] + torch.zeros_like(tok)
        x = constrain(x, "hidden")
    x = _run_layers(cfg, params, x, positions, cache, constrain)
    new_cache = None if cache is None else {"k": cache["k"], "v": cache["v"],
                                            "len": cache["len"] + 1}
    return x, new_cache


def init_dense_cache(cfg, batch_size: int, max_len: int, dtype: torch.dtype,
                     device="cpu") -> Dict[str, torch.Tensor]:
    kh, dh = cfg.n_kv_heads, cfg.head_dim()
    S = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    return {
        "k": torch.zeros((cfg.n_layers, batch_size, S, kh, dh), dtype=dtype, device=device),
        "v": torch.zeros((cfg.n_layers, batch_size, S, kh, dh), dtype=dtype, device=device),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


def dense_prefill(cfg, params, batch, cache, constrain=lambda a, k: a):
    """Populate the cache from a prompt; returns (last-token logits, cache)."""
    x, positions = _embed_inputs(cfg, params, batch, constrain)
    s = x.shape[1]
    x = _run_layers(cfg, params, x, positions, cache, constrain)
    logits = _logits(cfg, params, _last_token(constrain, x))
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache["len"] + s}


def dense_decode(cfg, params, batch, cache, constrain=lambda a, k: a):
    x, new_cache = dense_forward(cfg, params, batch, cache=cache, constrain=constrain)
    return _logits(cfg, params, x), new_cache
