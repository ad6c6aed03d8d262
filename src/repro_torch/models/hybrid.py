"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention+MLP
block applied every ``hybrid_attn_every`` layers, specialised per use by
that use's LoRA deltas (arXiv:2411.15242).

Counterpart of ``repro/models/hybrid.py``. The layer loop is two nested
walks, the outer over the ``n_uses`` groups, the inner over each group's
Mamba layers; then the shared block, whose input is ``[x, x0] @ in_proj``
(``x0`` the token embedding). Each use has a KV cache of its own. Under
``remat="full"`` a whole group is recomputed in backward (the reference
checkpoints its group body).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import ssm_lm
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamInit
from repro_torch.sharding.plan import full_walk


def _init_lora(init: ParamInit, prefix: str, cfg, n_uses: int) -> None:
    """Per-use LoRA adapters for the shared attention + MLP block (the
    ``b`` halves start at zero, as the reference's)."""
    d, h, kh, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim(), cfg.d_ff
    r = cfg.hybrid_lora_rank
    n = (n_uses,)
    for nm, (fi, fo) in {
        "wq": (d, h * dh), "wk": (d, kh * dh), "wv": (d, kh * dh), "wo": (h * dh, d),
    }.items():
        init.normal(f"{prefix}.attn.{nm}_lora_a", (*n, fi, r), ("layers", None, "lora_rank"))
        init.zeros(f"{prefix}.attn.{nm}_lora_b", (*n, r, fo), ("layers", "lora_rank", None))
    init.normal(f"{prefix}.mlp.wi_lora_a", (*n, d, r), ("layers", "embed", "lora_rank"))
    init.zeros(f"{prefix}.mlp.wi_lora_b", (*n, r, ff), ("layers", "lora_rank", "ffn"))
    init.normal(f"{prefix}.mlp.wo_lora_a", (*n, ff, r), ("layers", "ffn", "lora_rank"))
    init.zeros(f"{prefix}.mlp.wo_lora_b", (*n, r, d), ("layers", "lora_rank", "embed"))


def n_uses(cfg) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every


def init_hybrid(cfg, seed: int = 0, device="cpu"):
    init = ParamInit(T.torch_dtype(cfg), device, seed)
    d = cfg.d_model
    init.normal("embed", (cfg.vocab, d), ("vocab", "embed"))
    M.init_mamba_layer(init, "blocks", cfg, stack=(cfg.n_layers,), stack_axes=("layers",))
    init.normal("shared.in_proj", (2 * d, d), (None, "embed"))
    init.ones("shared.ln1", (d,), ("embed",))
    L.init_attention(init, "shared.attn", cfg)
    init.ones("shared.ln2", (d,), ("embed",))
    L.init_mlp(init, "shared.mlp", d, cfg.d_ff)
    _init_lora(init, "lora", cfg, n_uses(cfg))
    init.ones("ln_f", (d,), ("embed",))
    if not cfg.tie_embeddings:
        init.normal("lm_head", (d, cfg.vocab), ("embed", "vocab"))
    return init.values, init.axes


def _shared_block(cfg, sp, lora, x, x0, positions, acache, constrain):
    """The shared attention + MLP block with one use's LoRA adapters."""
    inp = L.rows_matmul(constrain, x, sp["in_proj"], x0)
    h = L.rmsnorm(inp, sp["ln1"], cfg.norm_eps)
    a, _ = L.attention_block({**sp["attn"], **lora["attn"]}, h, cfg, positions=positions,
                             causal=True, cache=acache, constrain=constrain, use_lora=True)
    h2 = x + constrain(a, "hidden")
    m = L.mlp_block({**sp["mlp"], **lora["mlp"]}, L.rmsnorm(h2, sp["ln2"], cfg.norm_eps),
                    constrain, use_lora=True)
    return constrain(h2 + constrain(m, "hidden"), "hidden")


def hybrid_forward(cfg, params, batch, *, cache=None, constrain=lambda a, k: a,
                   remat: str = "none"):
    """cache: ``{"mamba": {"conv", "ssm"} stacked [L, ...], "attn": {"k", "v"}
    [n_uses, b, S, kh, dh], "len": [b]}``, updated in place. Returns
    (hidden, new_cache)."""
    every = cfg.hybrid_attn_every
    x = torch.nn.functional.embedding(batch["tokens"], L.gathered(params["embed"], -1))
    x = constrain(x, "hidden")
    x0 = x  # original embedding, concatenated into every shared-block input
    b, s, _ = x.shape
    if cache is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    else:
        positions = cache["len"][:, None] + torch.zeros((b, s), dtype=torch.int32,
                                                        device=x.device)
    walk = getattr(constrain, "walk", full_walk)
    mstack = T.layer_stack(params, "blocks.")
    lstack = T.layer_stack(params, "lora.")
    sp = T.sub_tree(params, "shared")
    mcache = None if cache is None else cache["mamba"]

    for gi, _ in walk(n_uses(cfg), "uniform"):
        acache = None
        if cache is not None:
            acache = {"k": cache["attn"]["k"][gi], "v": cache["attn"]["v"][gi],
                      "len": cache["len"]}

        def group(x, lora, gi=gi, acache=acache):
            x = ssm_lm.run_mamba_layers(cfg, mstack, x, mcache, constrain,
                                        (gi * every + j for j, _ in walk(every, "uniform")))
            return _shared_block(cfg, sp, lora, x, x0, positions, acache, constrain)

        x = T._remat("full" if remat == "full" else "none", group, x,
                     T.layer_params(lstack, gi))
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    if cache is None:
        return x, None
    return x, {"mamba": cache["mamba"], "attn": cache["attn"], "len": cache["len"] + s}


def hybrid_loss(cfg, params, batch, constrain=lambda a, k: a, remat: str = "none",
                loss_chunk: int = 0):
    x, _ = hybrid_forward(cfg, params, batch, constrain=constrain, remat=remat)
    loss, tokens = T.ce_loss(cfg, params, x, batch["targets"], constrain, loss_chunk)
    return loss, {"loss": loss, "tokens": tokens}


def init_hybrid_cache(cfg, batch_size: int, max_len: int, dtype: torch.dtype, device="cpu"):
    kh, dh = cfg.n_kv_heads, cfg.head_dim()
    shape = (n_uses(cfg), batch_size, max_len, kh, dh)
    return {
        "mamba": ssm_lm.init_ssm_cache(cfg, batch_size, dtype, device),
        "attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)},
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


def hybrid_prefill(cfg, params, batch, cache, constrain=lambda a, k: a):
    x, cache = hybrid_forward(cfg, params, batch, cache=cache, constrain=constrain)
    return T._logits(cfg, params, T._last_token(constrain, x)), cache


def hybrid_decode(cfg, params, batch, cache, constrain=lambda a, k: a):
    x, cache = hybrid_forward(cfg, params, batch, cache=cache, constrain=constrain)
    return T._logits(cfg, params, x), cache
