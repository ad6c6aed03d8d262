"""Pure-SSM language model (mamba2-780m): counterpart of
``repro/models/ssm_lm.py``. Mamba2 blocks stacked on a leading ``layers``
axis, walked as the dense model's layers are; the cache is the stacked
conv carries and SSM states (no length: the state is the whole history)."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamInit
from repro_torch.sharding.plan import full_walk


def init_ssm_lm(cfg, seed: int = 0, device="cpu"):
    init = ParamInit(T.torch_dtype(cfg), device, seed)
    init.normal("embed", (cfg.vocab, cfg.d_model), ("vocab", "embed"))
    M.init_mamba_layer(init, "blocks", cfg, stack=(cfg.n_layers,), stack_axes=("layers",))
    init.ones("ln_f", (cfg.d_model,), ("embed",))
    if not cfg.tie_embeddings:
        init.normal("lm_head", (cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return init.values, init.axes


def run_mamba_layers(cfg, stack, x, cache, constrain, layers, remat: str = "none"):
    """Mamba blocks ``layers`` (indices into the stacked ``blocks``) over
    ``x``; ``cache`` (stacked ``{"conv", "ssm"}`` or ``None``) is updated in
    place. ``remat="full"`` recomputes each block in backward."""
    for i in layers:
        lcache = None if cache is None else {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}

        def body(x, lp):
            return M.mamba_block(lp, x, cfg, cache=lcache, constrain=constrain)[0]

        x = T._remat(remat, body, x, T.layer_params(stack, i))
    return x


def ssm_forward(cfg, params, batch, *, cache=None, constrain=lambda a, k: a,
                remat: str = "none"):
    """Returns (hidden [b, s, d], cache). Only ``remat="full"`` recomputes
    (the reference checkpoints the block for ``full`` alone)."""
    x = torch.nn.functional.embedding(batch["tokens"], L.gathered(params["embed"], -1))
    x = constrain(x, "hidden")
    walk = getattr(constrain, "walk", full_walk)
    stack = T.layer_stack(params)
    x = run_mamba_layers(cfg, stack, x, cache, constrain,
                         (i for i, _ in walk(cfg.n_layers, "uniform")),
                         "full" if remat == "full" else "none")
    return L.rmsnorm(x, params["ln_f"], cfg.norm_eps), cache


def ssm_loss(cfg, params, batch, constrain=lambda a, k: a, remat: str = "none",
             loss_chunk: int = 0):
    x, _ = ssm_forward(cfg, params, batch, constrain=constrain, remat=remat)
    loss, tokens = T.ce_loss(cfg, params, x, batch["targets"], constrain, loss_chunk)
    return loss, {"loss": loss, "tokens": tokens}


def init_ssm_cache(cfg, batch_size: int, dtype: torch.dtype, device="cpu"):
    return M.init_mamba_cache(cfg, batch_size, dtype, device, stack=(cfg.n_layers,))


def ssm_prefill(cfg, params, batch, cache, constrain=lambda a, k: a):
    x, cache = ssm_forward(cfg, params, batch, cache=cache, constrain=constrain)
    return T._logits(cfg, params, T._last_token(constrain, x)), cache


def ssm_decode(cfg, params, batch, cache, constrain=lambda a, k: a):
    x, cache = ssm_forward(cfg, params, batch, cache=cache, constrain=constrain)
    return T._logits(cfg, params, x), cache
