"""Encoder-decoder transformer (seamless-m4t backbone).

Counterpart of ``repro/models/encdec.py``. The audio frontend is a stub:
``input_specs`` gives precomputed frame embeddings [b, F, 1024], which the
encoder takes through a learned projection and attends over without a
causal mask. The decoder is a causal transformer with cross-attention over
the encoder's output; its decode cache holds the self-attention KV and the
cross-attention KV (``ck``, ``cv``), which prefill computes once per
decoder layer from the encoder's output.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamInit
from repro_torch.sharding.plan import full_walk


def init_encdec(cfg, seed: int = 0, device="cpu"):
    init = ParamInit(T.torch_dtype(cfg), device, seed)
    d = cfg.d_model
    init.normal("frontend_proj", (T.FRONTEND_DIM, d), (None, "embed"))
    init.normal("embed", (cfg.vocab, d), ("vocab", "embed"))
    for name, n, cross in (("enc_blocks", cfg.n_enc_layers, False),
                           ("dec_blocks", cfg.n_layers, True)):
        st, ax = (n,), ("layers",)
        init.ones(f"{name}.ln1", (n, d), ("layers", "embed"))
        L.init_attention(init, f"{name}.attn", cfg, stack=st, stack_axes=ax)
        if cross:
            init.ones(f"{name}.ln_x", (n, d), ("layers", "embed"))
            L.init_attention(init, f"{name}.xattn", cfg, stack=st, stack_axes=ax)
        init.ones(f"{name}.ln2", (n, d), ("layers", "embed"))
        L.init_mlp(init, f"{name}.mlp", d, cfg.d_ff, stack=st, stack_axes=ax)
    init.ones("ln_enc", (d,), ("embed",))
    init.ones("ln_f", (d,), ("embed",))
    init.normal("lm_head", (d, cfg.vocab), ("embed", "vocab"))
    return init.values, init.axes


def _cross_kv(p, enc_out, constrain):
    x = constrain(enc_out, "hidden_in")
    return L._project_in(x, p["wk"]), L._project_in(x, p["wv"])


def _cross_attend(p, x, ck, cv, cfg, constrain):
    b, s, _ = x.shape
    F = ck.shape[1]
    x = constrain(x, "hidden_in")
    q = constrain(L._project_in(x, p["wq"]), "heads")
    walk = getattr(constrain, "walk", full_walk)
    if s == 1:
        def one(q_, k_, v_, **kw):
            kv_len = torch.full((q_.shape[0],), F, dtype=torch.int32, device=q_.device)
            return L.decode_attention(q_, k_, v_, kv_len, **kw)

        o = L.attend(constrain, one, q, ck, cv, seq_local=True)
    else:
        o = L.attend(constrain, lambda q_, k_, v_: L.chunked_attention(
            q_, k_, v_, causal=False, walk=walk), q, ck, cv)
    return L._project_out(constrain(o, "heads"), p["wo"])


def _remat_kind(remat: str) -> str:
    return "full" if remat == "full" else "none"


def encode(cfg, params, frames, constrain=lambda a, k: a, remat: str = "none"):
    # the frames projected where the residual's sequence shards put them
    x = L.rows_matmul(constrain, constrain(frames, "hidden").to(T.torch_dtype(cfg)),
                      params["frontend_proj"])
    x = constrain(x, "hidden")
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    walk = getattr(constrain, "walk", full_walk)
    stack = T.layer_stack(params, "enc_blocks.")

    def body(x, lp):
        a, _ = L.attention_block(lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
                                 positions=positions, causal=False, constrain=constrain)
        h = x + constrain(a, "hidden")
        m = L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps), constrain)
        return constrain(h + constrain(m, "hidden"), "hidden")

    for i, _ in walk(cfg.n_enc_layers, "uniform"):
        x = T._remat(_remat_kind(remat), body, x, T.layer_params(stack, i))
    return L.rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def decode_stack(cfg, params, tokens, enc_out, *, cache=None, constrain=lambda a, k: a,
                 remat: str = "none"):
    """cache: ``{"k", "v"`` self-KV [L, b, S, kh, dh], ``"ck", "cv"``
    cross-KV [L, b, F, kh, dh], ``"len"`` [b]}``, the self-KV updated in
    place. Returns (hidden, new_cache)."""
    x = torch.nn.functional.embedding(tokens, L.gathered(params["embed"], -1))
    x = constrain(x, "hidden")
    b, s, _ = x.shape
    if cache is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    else:
        positions = cache["len"][:, None] + torch.zeros((b, s), dtype=torch.int32,
                                                        device=x.device)
    walk = getattr(constrain, "walk", full_walk)
    stack = T.layer_stack(params, "dec_blocks.")
    for i, _ in walk(cfg.n_layers, "uniform"):
        lc = None
        if cache is not None:
            lc = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"],
                  "ck": cache["ck"][i], "cv": cache["cv"][i]}

        def body(x, lp, lc=lc):
            a, _ = L.attention_block(
                lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
                positions=positions, causal=True,
                cache=None if lc is None else {"k": lc["k"], "v": lc["v"], "len": lc["len"]},
                constrain=constrain)
            h = x + constrain(a, "hidden")
            if lc is None:
                ck, cv = _cross_kv(lp["xattn"], enc_out, constrain)
            else:
                ck, cv = lc["ck"], lc["cv"]
            c = _cross_attend(lp["xattn"], L.rmsnorm(h, lp["ln_x"], cfg.norm_eps), ck, cv,
                              cfg, constrain)
            h = h + constrain(c, "hidden")
            m = L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps), constrain)
            return constrain(h + constrain(m, "hidden"), "hidden")

        x = T._remat(_remat_kind(remat), body, x, T.layer_params(stack, i))
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    if cache is None:
        return x, None
    return x, {**cache, "len": cache["len"] + s}


def encdec_loss(cfg, params, batch, constrain=lambda a, k: a, remat: str = "none",
                loss_chunk: int = 0):
    enc_out = encode(cfg, params, batch["frontend"], constrain, remat)
    x, _ = decode_stack(cfg, params, batch["tokens"], enc_out, constrain=constrain,
                        remat=remat)
    loss, tokens = T.ce_loss(cfg, params, x, batch["targets"], constrain, loss_chunk)
    return loss, {"loss": loss, "tokens": tokens}


def init_encdec_cache(cfg, batch_size: int, max_len: int, dtype: torch.dtype, device="cpu"):
    kh, dh = cfg.n_kv_heads, cfg.head_dim()
    F = cfg.frontend_len

    def z(n):
        return torch.zeros((cfg.n_layers, batch_size, n, kh, dh), dtype=dtype, device=device)

    return {"k": z(max_len), "v": z(max_len), "ck": z(F), "cv": z(F),
            "len": torch.zeros((batch_size,), dtype=torch.int32, device=device)}


def encdec_prefill(cfg, params, batch, cache, constrain=lambda a, k: a):
    """Encode the source, write each decoder layer's cross-KV into the
    cache, and prefill the decoder with the target prompt."""
    enc_out = encode(cfg, params, batch["frontend"], constrain)
    F = cache["ck"].shape[2]
    walk = getattr(constrain, "walk", full_walk)
    stack = T.layer_stack(params, "dec_blocks.xattn.")
    for i, _ in walk(cfg.n_layers, "uniform"):
        lp = {k.split(".")[-1]: v[i] for k, v in stack.items()}
        ck, cv = _cross_kv(lp, enc_out, constrain)
        for dst, new in ((cache["ck"][i], ck), (cache["cv"][i], cv)):
            L._cache_write(constrain, lambda st, c, n: L._write_prompt(st, c, n, F), dst, new)
    x, cache = decode_stack(cfg, params, batch["tokens"], enc_out, cache=cache,
                            constrain=constrain)
    return T._logits(cfg, params, T._last_token(constrain, x)), cache


def encdec_decode(cfg, params, batch, cache, constrain=lambda a, k: a):
    x, cache = decode_stack(cfg, params, batch["tokens"], None, cache=cache,
                            constrain=constrain)
    return T._logits(cfg, params, x), cache
