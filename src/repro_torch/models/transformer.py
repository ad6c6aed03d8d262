"""Decoder-only transformer: the dense, MoE and VLM families (llama3 /
qwen3 / stablelm, mixtral / qwen3-moe, the llava backbone).

Counterpart of ``repro/models/transformer.py``. Layers
are stacked on a leading axis, as in the reference (whose ``lax.scan``
keeps its HLO depth-independent); here they are taken apart by one
``unbind`` and a Python loop over ``constrain.walk`` runs them, each under
the plan's ``remat`` while autograd records, and the dry run traces one
layer and weights it by the depth. A config with ``moe`` runs
``models/moe.py``'s block in place of the MLP and adds its load-balancing
loss; one with a ``frontend`` projects the stub's embeddings
(``FRONTEND_DIM`` wide) and puts them before the text. ``dense_loss`` is
the train cells' cross-entropy. The cache layout is the reference's,
``[n_layers, b, S, kh, dh]``, and is updated in place (the reference
donates it).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import ParamInit
from repro_torch.sharding.plan import full_walk, is_sharded, local_call, shard_offset

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FRONTEND_DIM = 1024  # stub patch/frame embedding width
AUX_LOSS_COEF = 0.01


def torch_dtype(cfg) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


def init_dense(cfg, seed: int = 0, device="cpu"):
    """(values, logical axes): flat dicts keyed by the reference's tree
    paths joined with ``.``."""
    init = ParamInit(torch_dtype(cfg), device, seed)
    d, n = cfg.d_model, cfg.n_layers
    init.normal("embed", (cfg.vocab, d), ("vocab", "embed"))
    stack, ax = (n,), ("layers",)
    init.ones("blocks.ln1", (n, d), ("layers", "embed"))
    L.init_attention(init, "blocks.attn", cfg, stack=stack, stack_axes=ax)
    init.ones("blocks.ln2", (n, d), ("layers", "embed"))
    if cfg.moe is not None:
        MOE.init_moe_mlp(init, "blocks.mlp", d, cfg.moe, stack=stack, stack_axes=ax)
    else:
        L.init_mlp(init, "blocks.mlp", d, cfg.d_ff, stack=stack, stack_axes=ax)
    init.ones("ln_f", (d,), ("embed",))
    if not cfg.tie_embeddings:
        init.normal("lm_head", (d, cfg.vocab), ("embed", "vocab"))
    if cfg.frontend:
        init.normal("frontend_proj", (FRONTEND_DIM, d), (None, "embed"))
    return init.values, init.axes


def layer_stack(params: Dict[str, torch.Tensor], prefix: str = "blocks.") -> Dict[str, tuple]:
    """Each stacked ``prefix*`` parameter taken apart into its layers by
    one ``unbind`` (views): under autograd its backward is one ``stack``
    of the layers' gradients, where indexing layer by layer would give
    each layer a full-size zero gradient of the whole stack."""
    return {k: v.unbind(0) for k, v in params.items() if k.startswith(prefix)}


def layer_params(stack: Dict[str, tuple], i: int) -> Dict[str, Dict]:
    """Layer ``i`` 's parameters, from ``layer_stack``, as the nested tree
    under the stack's prefix (``{"ln1", "attn": {...}, "ln2", "mlp":
    {...}}`` for a dense layer)."""
    out: Dict = {}
    for k, v in stack.items():
        *path, leaf = k.split(".")[1:]
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v[i]
    return out


def sub_tree(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, Dict]:
    """The unstacked parameters under ``prefix.`` as a nested tree."""
    out: Dict = {}
    for k, v in params.items():
        if k.startswith(prefix + "."):
            *path, leaf = k[len(prefix) + 1:].split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
    return out


def _embed_inputs(cfg, params, batch, constrain):
    """Token (+ frontend stub) embedding. Returns (x [b,s,d], positions
    [b,s]); the frontend's rows come before the text."""
    tok = batch["tokens"]
    x = torch.nn.functional.embedding(tok, L.gathered(params["embed"], -1))
    if cfg.frontend:
        # the stub's rows projected where the residual's sequence shards
        # put them, then both parts placed whole over the sequence before
        # the concat (on a mesh the tokens' rows are a vocab-parallel
        # partial sum until placed)
        fe = L.rows_matmul(constrain, constrain(batch["frontend"], "hidden").to(x.dtype),
                           params["frontend_proj"])
        x = torch.cat([constrain(fe, "hidden_in"), constrain(x, "hidden_in")], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return constrain(x, "hidden"), positions


def _logits(cfg, params, x):
    w = (L.gathered(params["embed"], -1).T if cfg.tie_embeddings
         else L.gathered(params["lm_head"], -2))
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
    """Returns (out, aux_loss, new_cache). Each branch's output is placed
    as the residual before it is added (on a sharded mesh its row-parallel
    sums are reduced there, once, in the activations' dtype, where DTensor
    would otherwise carry them as pending sums into the next norm)."""
    a, new_cache = L.attention_block(
        lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
        positions=positions, causal=True, window=window,
        cache=lcache, constrain=constrain,
    )
    h = x + constrain(a, "hidden")
    hn = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        m, aux = MOE.moe_block(lp["mlp"], hn, cfg.moe, constrain)
    else:
        m, aux = L.mlp_block(lp["mlp"], hn, constrain), None
    return h + constrain(m, "hidden"), aux, new_cache


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the results of products with no batch dims
    (the projections and the MLP: ``mm``, or a product over a batch of
    one), recompute everything else, attention's batched products included
    (the reference's ``checkpoint_dots_with_no_batch_dims``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    batched = {aten.bmm.default: 0, aten.baddbmm.default: 1}
    if op in (aten.mm.default, aten.addmm.default) or (
            op in batched and args[batched[op]].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(remat: str, fn, *args):
    """``fn(*args)`` under the plan's ``remat`` while autograd records:
    ``full`` recomputes the whole layer in backward, ``dots`` all but the
    products ``_dots_policy`` keeps, ``none`` keeps every activation."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    import functools

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    elif remat != "full":
        raise ValueError(f"unknown remat {remat!r}")
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def _run_layers(cfg, params, x, positions, cache, constrain, remat: str = "none"):
    """The layer loop; ``cache`` (or ``None``) is updated in place.
    Returns (normed hidden, the MoE aux loss averaged over the layers, or
    ``None`` without MoE)."""
    walk = getattr(constrain, "walk", full_walk)
    stack = layer_stack(params)
    aux = None
    for i, w in walk(cfg.n_layers, "uniform"):
        lcache = None
        if cache is not None:
            lcache = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]}

        def body(x, lp):
            out, a, _ = _layer_body(cfg, constrain, x, lp, lcache, positions, cfg.swa_window)
            return out if a is None else (out, a)

        out = _remat(remat, body, x, layer_params(stack, i))
        if isinstance(out, tuple):
            # a traced step of weight w stands for w layers' aux losses
            x, a = out
            aux = a * w if aux is None else aux + a * w
        else:
            x = out
    if aux is not None:
        aux = aux / cfg.n_layers
    return L.rmsnorm(x, params["ln_f"], cfg.norm_eps), aux


def dense_forward(cfg, params, batch, *, cache=None, constrain=lambda a, k: a,
                  remat: str = "none"):
    """Returns (hidden [b,s,d], new_cache)."""
    x, _, new_cache = _forward(cfg, params, batch, cache, constrain, remat)
    return x, new_cache


def _forward(cfg, params, batch, cache, constrain, remat):
    """Returns (hidden, aux loss or ``None``, new_cache)."""
    if cache is None:
        x, positions = _embed_inputs(cfg, params, batch, constrain)
    else:
        # decode: single new token at position cache["len"]
        tok = batch["tokens"]  # [b, 1]
        x = torch.nn.functional.embedding(tok, L.gathered(params["embed"], -1))
        positions = cache["len"][:, None] + torch.zeros_like(tok)
        x = constrain(x, "hidden")
    x, aux = _run_layers(cfg, params, x, positions, cache, constrain, remat)
    new_cache = None if cache is None else {"k": cache["k"], "v": cache["v"],
                                            "len": cache["len"] + 1}
    return x, aux, new_cache


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[tgt] in f32, with the vocab split across shards:
    ``logits`` is this shard's [b, s, V_l] slice, starting at vocab entry
    ``v_off``, and ``reduce(x, op)`` all-reduces over the mesh dims that
    split the vocab. The max, the sum of exponentials and the target's
    logit are all-reduced ([b, s] each), so no shard gathers the logits;
    the gradient, softmax minus the one-hot target, needs no collective."""

    @staticmethod
    def forward(ctx, logits, tgt, v_off, reduce):
        lf = logits.float()
        vl = lf.shape[-1]
        m = reduce(lf.amax(-1), "max")
        lse = m + torch.log(reduce(torch.exp(lf - m[..., None]).sum(-1), "sum"))
        local = tgt.long() - v_off
        mine = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        t = reduce(torch.where(mine, lf.gather(-1, idx[..., None])[..., 0], 0.0), "sum")
        ctx.save_for_backward(logits, lse, idx, mine)
        return lse - t

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mine = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -mine.float()[..., None])
        return (p * g[..., None]).to(logits.dtype), None, None, None


def _nll(constrain, logits, tgt):
    """-log softmax(logits)[tgt] in f32 (targets below 0 give entry 0's).
    On a sharded mesh the vocab stays split (``_VocabParallelNLL``), where
    DTensor's log_softmax would gather the f32 logits on every shard."""
    mesh = getattr(constrain, "mesh", None)
    from torch.distributed.tensor import DTensor

    tc = tgt.clamp(min=0)
    if not (is_sharded(mesh) and isinstance(logits, DTensor)):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, tc.long()[..., None])[..., 0]
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate

    lp = logits.placements
    dims = [i for i, p in enumerate(lp) if p.is_shard(2)]
    v_off, _ = shard_offset(mesh, lp, logits.shape[2], 2)
    tp = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in lp)

    def reduce(x, op):
        for i in dims:
            x = funcol.all_reduce(x, op, (mesh, i))
        return x

    return local_call(lambda lg, t: _VocabParallelNLL.apply(lg, t, v_off, reduce), mesh,
                      [(logits, lp), (tc, tp)], [tp])


def ce_loss(cfg, params, x, tgt, constrain, loss_chunk: int = 0):
    """Cross-entropy on hidden states, in f32; targets below 0 are masked.
    ``loss_chunk`` > 0 walks the sequence in chunks, each under
    ``torch.utils.checkpoint``, so the [B, S, vocab] logits never exist at
    once (the reference's scan, a DSE memory-term knob). Returns (mean
    loss, token count)."""

    def one(xc, tc):
        # the head's input gathered over its sequence shards, as a projection's
        logits = constrain(_logits(cfg, params, constrain(xc, "hidden_in")), "logits")
        nll = _nll(constrain, logits, tc)
        mask = (tc >= 0).float()
        return (nll * mask).sum(), mask.sum()

    b, s, _ = x.shape
    if loss_chunk and s > loss_chunk and s % loss_chunk == 0:
        tot = cnt = None
        walk = getattr(constrain, "walk", full_walk)
        for i, _ in walk(s // loss_chunk, "uniform"):
            sl = slice(i * loss_chunk, (i + 1) * loss_chunk)
            nll, m = _remat("full", one, x[:, sl], tgt[:, sl])
            tot, cnt = (nll, m) if tot is None else (tot + nll, cnt + m)
    else:
        tot, cnt = one(x, tgt)
    return tot / torch.clamp(cnt, min=1.0), cnt


def dense_loss(cfg, params, batch, constrain=lambda a, k: a, remat: str = "none",
               loss_chunk: int = 0):
    """Returns (loss, {"loss", "aux", "tokens"}), as the reference's: the
    cross-entropy (on the text positions only, after a frontend) plus
    ``AUX_LOSS_COEF`` times the MoE load-balancing loss."""
    x, aux, _ = _forward(cfg, params, batch, None, constrain, remat)
    if cfg.frontend:
        x = x[:, -batch["tokens"].shape[1]:]  # loss only on text positions
    ce, tokens = ce_loss(cfg, params, x, batch["targets"], constrain, loss_chunk)
    if aux is None:
        return ce, {"loss": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device),
                    "tokens": tokens}
    return ce + AUX_LOSS_COEF * aux, {"loss": ce, "aux": aux, "tokens": tokens}


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
    x, _ = _run_layers(cfg, params, x, positions, cache, constrain)
    logits = _logits(cfg, params, _last_token(constrain, x))
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache["len"] + s}


def dense_decode(cfg, params, batch, cache, constrain=lambda a, k: a):
    x, new_cache = dense_forward(cfg, params, batch, cache=cache, constrain=constrain)
    return _logits(cfg, params, x), new_cache
