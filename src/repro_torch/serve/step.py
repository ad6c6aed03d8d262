"""Serving steps: prefill and single-token decode under a sharding plan.

Counterpart of ``repro/serve/step.py``. ``decode_attn="sp_shardmap"``
swaps the decode attention that follows the plan's cache placements
(``gspmd``: the cache keeps its sequence shards, and the softmax's
statistics are reduced across them) for the explicit sequence-parallel one
over the ``model`` axis (``serve/sp_attention.py``).
"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.serve.sp_attention import make_sp_decode
from repro_torch.sharding.plan import PlanCtx


class ServeCtx(PlanCtx):
    """The plan's constrain hook that also carries the sp-decode kernel."""

    def __init__(self, ctx: PlanCtx, sp_decode=None):
        super().__init__(ctx._fn, attn_impl=ctx.attn_impl, mesh=ctx.mesh, walk=ctx.walk)
        if sp_decode is not None:
            self.sp_decode = sp_decode


def make_ctx(cfg, plan, mesh, *, decode: bool = False) -> ServeCtx:
    constrain = plan.make_constrain(mesh)
    sp = None
    if decode and mesh is not None and plan.decode_attn == "sp_shardmap":
        sp = make_sp_decode(mesh, plan)
    return ServeCtx(constrain, sp)


def make_prefill_step(cfg, plan, mesh=None, ctx=None):
    """``prefill_step(params, batch, cache) -> (last-token logits, cache)``;
    ``ctx`` overrides the plan's hook (the dry run passes one whose walk
    counts)."""
    ctx = ctx or make_ctx(cfg, plan, mesh, decode=False)

    def prefill_step(params, batch, cache):
        return M.prefill_fn(cfg, params, batch, cache, ctx)

    return prefill_step


def make_decode_step(cfg, plan, mesh=None, ctx=None):
    """``decode_step(params, batch, cache) -> (logits, cache)``."""
    ctx = ctx or make_ctx(cfg, plan, mesh, decode=True)

    def decode_step(params, batch, cache):
        return M.decode_fn(cfg, params, batch, cache, ctx)

    return decode_step


def serve_shardings(cfg, plan, mesh, specs_inputs):
    """Placements for (params, batch, cache) of a serve step."""
    values, logical = M.abstract_params(cfg)
    pshard = plan.param_shardings(mesh, values, logical)
    bshard = plan.batch_specs(mesh, specs_inputs["batch"])
    cshard = None
    if "cache" in specs_inputs:
        cshard = plan.cache_specs(mesh, specs_inputs["cache"])
    return pshard, bshard, cshard
