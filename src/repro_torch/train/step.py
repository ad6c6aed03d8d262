"""Train step factory: loss and gradients (with microbatch accumulation),
gradient compression, and AdamW.

Counterpart of ``repro/train/step.py``. The state is a dict ``{"params",
"opt"}`` (and ``"ef"`` under gradient compression); ``train_step(state,
batch)`` returns ``(state, metrics)``, the state's tensors updated in place
(the reference donates them). On a sharded mesh the state and the batch
are DTensors placed by ``state_specs`` and the plan's batch placements.

Where gradients meet the moments: a param replicated over the data mesh
dims has a partial-sum gradient there. With ZeRO-1 (f32 moments sharded
over the data dims) it is redistributed to the moments' placements, a
reduce-scatter; with int8 moments (the param's placements) or without
ZeRO-1, an all-reduce. The new params go back to their placements by
all-gather where ZeRO-1 sharded the update.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.sharding.plan import full_walk, is_sharded
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.grad_compress import compress_decompress, init_error_feedback


def _new_state(params, plan) -> Dict[str, Any]:
    state = {"params": params,
             "opt": opt_mod.init_opt_state(params, master_weights=plan.master_weights,
                                           int8_moments=plan.opt_int8)}
    if plan.grad_compress != "none":
        state["ef"] = init_error_feedback(params)
    return state


def init_train_state(cfg, plan, seed: int = 0, device="cpu"):
    """(state, logical axes of the params): random params from ``seed`` on
    ``device``, zero optimizer state."""
    params, axes = M.init_params(cfg, seed=seed, device=device)
    return _new_state({k: v.detach() for k, v in params.items()}, plan), axes


def abstract_train_state(cfg, plan):
    """The train state on the ``meta`` device (the dry run's shapes and
    dtypes, never allocated), and the params' logical axes."""
    params, axes = M.abstract_params(cfg)
    return _new_state({k: v.detach() for k, v in params.items()}, plan), axes


def state_specs(mesh, plan, state, logical) -> Dict[str, Any]:
    """Placements for every leaf of ``state`` on ``mesh``."""
    params = state["params"]
    pspecs = plan.param_shardings(mesh, params, logical)
    out = {"params": pspecs,
           "opt": opt_mod.opt_specs(mesh, pspecs, params, zero1=plan.zero1,
                                    master=plan.master_weights, int8=plan.opt_int8)}
    if "ef" in state:
        out["ef"] = opt_mod.opt_specs(mesh, pspecs, params, zero1=plan.zero1,
                                      master=False)["m"]
    return out


def make_train_step(cfg, plan, mesh=None, opt_cfg: Optional[opt_mod.AdamWConfig] = None,
                    ctx=None):
    """``train_step(state, batch) -> (state, metrics)``; metrics ``loss``,
    ``grad_norm``, ``lr`` and (one microbatch) ``tokens``. ``ctx``
    overrides the plan's constrain hook (the dry run's counts its loops)."""
    opt_cfg = opt_cfg or opt_mod.AdamWConfig()
    ctx = ctx or plan.make_constrain(mesh)
    walk = getattr(ctx, "walk", full_walk)
    sharded = is_sharded(mesh)

    # ZeRO-2-style placement of the microbatch accumulator: without it a
    # k-microbatch step holds a full f32 gradient copy per device
    acc_pl = None
    if sharded and plan.zero1 and plan.microbatches > 1:
        values, logical = M.abstract_params(cfg)
        pspecs = plan.param_shardings(mesh, values, logical)
        acc_pl = opt_mod.opt_specs(mesh, pspecs, values, zero1=True, master=False)["m"]

    # batch-shard degree: microbatch slicing is strided so every device
    # keeps b_local/k rows per microbatch
    bdeg = 1
    if sharded:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        for ax in plan.mesh_axes("batch"):
            bdeg *= sizes.get(ax, 1)

    def to_mb(a, k):
        B, rest = a.shape[0], tuple(a.shape[1:])
        D = bdeg if (bdeg > 1 and B % bdeg == 0 and (B // bdeg) % k == 0) else 1
        if D > 1:
            x = a.reshape(D, k, B // (D * k), *rest)
            return x.transpose(0, 1).reshape(k, B // k, *rest)
        return a.reshape(k, B // k, *rest)

    def grads_of(leaves, batch):
        loss, mets = M.loss_fn(cfg, leaves, batch, ctx, plan.remat, plan.loss_chunk)
        keys = list(leaves)
        gs = torch.autograd.grad(loss, [leaves[k] for k in keys])
        return loss.detach(), mets, dict(zip(keys, gs))

    def train_step(state, batch) -> Tuple[Any, Dict[str, Any]]:
        params = state["params"]
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        k = plan.microbatches
        with torch.enable_grad():
            if k > 1:
                mb = {n: to_mb(a, k) for n, a in batch.items()}
                gsum = lsum = None
                for j, _ in walk(k, "uniform"):
                    loss_j, _, g = grads_of(leaves, {n: a[j] for n, a in mb.items()})
                    with torch.no_grad():
                        g = {n: x.float() for n, x in g.items()}
                        if acc_pl is not None:  # reduce-scatter per microbatch (ZeRO-2)
                            g = {n: x.redistribute(mesh, acc_pl[n]) for n, x in g.items()}
                        if gsum is None:
                            gsum = g
                        else:
                            for n in g:
                                gsum[n].add_(g[n])
                    lsum = loss_j if lsum is None else lsum + loss_j
                grads = {n: x / k for n, x in gsum.items()}
                loss = lsum / k
                mets = {"loss": loss}
            else:
                loss, mets, grads = grads_of(leaves, batch)
        del leaves
        if plan.grad_compress != "none":
            grads, _ = compress_decompress(plan.grad_compress, grads, state["ef"])
        _, _, omets = opt_mod.adamw_update(opt_cfg, params, grads, state["opt"])
        metrics = {"loss": loss, **omets}
        if "tokens" in mets:
            metrics["tokens"] = mets["tokens"].detach()
        return state, metrics

    return train_step
