"""Token-choice top-k Mixture-of-Experts with grouped capacity dispatch.

Counterpart of ``repro/models/moe.py``. Tokens are partitioned into groups
of ``group_size``; each expert has a per-group capacity ``C ~ top_k *
group_size * cf / E``. Overflow tokens beyond capacity are dropped (their
combine weight is 0), the MaxText/Mesh-TF "dropping" formulation, so every
shape is static. The router runs in the model's dtype and is cast to f32
before the softmax; the top k are taken lower expert index first among
equal gates (``jax.lax.top_k`` 's order) and renormalised; the aux loss is
Switch's ``E * sum(mean gate * top-1 share)``.

On a sharded mesh the block runs on local shards (``local_call``): the
tokens keep their batch shards when each shard holds whole groups (else
every shard takes all of them), the experts (``expert_rule=experts``) or
their hidden width (``expert_ffn``) keep the weights' shards over the mesh
dims the tokens do not use, and the output leaves as a partial sum over
those dims, which the residual's placement reduces. The routing is
computed whole on each shard of the experts (it is a [tokens, E] product).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from repro_torch.models.layers import ParamInit
from repro_torch.sharding.plan import is_sharded, local_call, shard_offset

#: when a list, ``moe_block`` appends each call's top-k expert indices
#: [T, K] to it (``record_routing``)
_ROUTING: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def record_routing():
    """Collect the top-k expert indices of every ``moe_block`` call made
    inside the block, in call order, as [tokens, K] CPU tensors."""
    global _ROUTING
    outer, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = outer


def init_moe_mlp(init: ParamInit, prefix: str, d: int, spec, stack=(), stack_axes=()) -> None:
    E, f = spec.n_experts, spec.d_ff_expert
    Ls, La = tuple(stack), tuple(stack_axes)
    init.normal(f"{prefix}.router", (*Ls, d, E), (*La, "embed", "experts"))
    init.normal(f"{prefix}.wi", (*Ls, E, d, f), (*La, "experts", "embed", "expert_ffn"))
    init.normal(f"{prefix}.wg", (*Ls, E, d, f), (*La, "experts", "embed", "expert_ffn"))
    init.normal(f"{prefix}.wo", (*Ls, E, f, d), (*La, "experts", "expert_ffn", "embed"))


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of the last dim,
    largest first and, among equal values, lower index first (a stable
    descending sort), as ``jax.lax.top_k`` orders them."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(spec, g: int) -> int:
    return max(int(spec.top_k * g * spec.capacity_factor) // spec.n_experts, 1)


def _route(xg, router, spec, C: int):
    """Routing of groups ``xg`` [G, g, d]: returns (gates [G, g, E] f32,
    top-1 indices [G, g], dispatch [G, g, E, C] bool, combine [G, g, E, C]
    f32), with position-in-expert bookkeeping across the K choices."""
    E, K = spec.n_experts, spec.top_k
    G, g, _ = xg.shape
    logits = torch.einsum("Ggd,dE->GgE", xg, router).float()
    gates = torch.softmax(logits, dim=-1)  # [G,g,E]
    topw, topi = top_k(gates, K)  # [G,g,K]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)  # renormalise
    if _ROUTING is not None:
        _ROUTING.append(topi.reshape(-1, K).cpu())
    experts = torch.arange(E, device=xg.device)
    slots = torch.arange(C, device=xg.device)
    dispatch = torch.zeros((G, g, E, C), dtype=torch.bool, device=xg.device)
    combine = torch.zeros((G, g, E, C), dtype=torch.float32, device=xg.device)
    counts = torch.zeros((G, E), dtype=torch.int64, device=xg.device)
    for kk in range(K):
        oh = (topi[..., kk, None] == experts).long()  # [G,g,E]
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]  # [G,g,E]
        keep = (pos < C) & (oh > 0)
        slot = (pos[..., None] == slots).float() * keep[..., None]  # [G,g,E,C]
        dispatch = dispatch | (slot > 0)
        combine = combine + slot * topw[..., kk, None, None]
        counts = counts + oh.sum(dim=1)
    return gates, topi[..., 0], dispatch, combine


def _experts(xg, dispatch, combine, wi, wg, wo):
    """Dispatch ``xg`` [G, g, d] to the experts of ``wi``/``wg``/``wo`` (the
    slice of the expert axis ``dispatch`` and ``combine`` [G, g, E_l, C]
    hold), run the SwiGLU experts and combine: returns [G, g, d]."""
    dt = xg.dtype
    xe = torch.einsum("Ggd,GgEC->GECd", xg, dispatch.to(dt))
    hid = torch.nn.functional.silu(torch.einsum("GECd,Edf->GECf", xe, wg)) * torch.einsum(
        "GECd,Edf->GECf", xe, wi)
    out_e = torch.einsum("GECf,Efd->GECd", hid, wo)
    return torch.einsum("GECd,GgEC->Ggd", out_e, combine.to(dt))


def _core(x, router, wi, wg, wo, *, spec, g: int, C: int, e0: int, n_e: int):
    """The block over local tokens ``x`` [b, s, d] in groups of ``g``, with
    experts ``e0 .. e0 + n_e`` (``wi``/``wg``/``wo`` hold those). Returns
    (y [b, s, d], sum of gates over the groups [E] f32, count of top-1
    choices per expert [E] f32)."""
    b, s, d = x.shape
    E = spec.n_experts
    T = b * s
    pad = (-T) % g
    xf = x.reshape(T, d)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
    xg = xf.reshape(-1, g, d)
    gates, top1, dispatch, combine = _route(xg, router, spec, C)
    me = gates.sum(dim=(0, 1))
    ce = (top1[..., None] == torch.arange(E, device=x.device)).float().sum(dim=(0, 1))
    y = _experts(xg, dispatch[:, :, e0:e0 + n_e], combine[:, :, e0:e0 + n_e], wi, wg, wo)
    y = y.reshape(-1, d)[:T]
    return y.reshape(b, s, d), me, ce


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor, spec, constrain=lambda a, k: a):
    """x: [b, s, d] -> ([b, s, d], aux_loss scalar f32)."""
    b, s, d = x.shape
    E = spec.n_experts
    T = b * s
    g = min(spec.group_size, T)
    C = capacity(spec, g)
    n_tok = (T + (-T) % g)  # the groups' positions, padding included
    mesh = getattr(constrain, "mesh", None)
    from torch.distributed.tensor import DTensor

    if not (is_sharded(mesh) and isinstance(x, DTensor)):
        y, me, ce = _core(x, p["router"], p["wi"], p["wg"], p["wo"], spec=spec, g=g, C=C,
                          e0=0, n_e=E)
        return y, E * torch.sum((me / n_tok) * (ce / n_tok))
    from torch.distributed.tensor import Partial, Replicate, Shard

    x = constrain(x, "hidden_in")
    bp = [q.is_shard(0) for q in x.placements]
    n_shards = 1
    for i, t in enumerate(bp):
        n_shards *= mesh.size(i) if t else 1
    # the reference's groups are runs of g tokens of the flattened batch:
    # a shard's rows are whole groups when it holds a multiple of g tokens
    whole = b % n_shards == 0 and (b // n_shards * s) % g == 0
    tok = [t and whole for t in bp]
    wpl = p["wi"].placements if isinstance(p["wi"], DTensor) else (Replicate(),) * mesh.ndim
    ex = [q.is_shard(0) and not t for q, t in zip(wpl, tok)]
    ff = [q.is_shard(2) and not t for q, t in zip(wpl, tok)]
    xp = tuple(Shard(0) if t else Replicate() for t in tok)
    rep = (Replicate(),) * mesh.ndim
    w_in = tuple(Shard(0) if e else Shard(2) if f else Replicate() for e, f in zip(ex, ff))
    w_out = tuple(Shard(0) if e else Shard(1) if f else Replicate() for e, f in zip(ex, ff))
    e0, n_e = shard_offset(mesh, w_in, E, 0)
    yp = tuple(Shard(0) if t else Partial() if (e or f) else Replicate()
               for t, e, f in zip(tok, ex, ff))
    sp = tuple(Partial() if t else Replicate() for t in tok)

    y, me, ce = local_call(
        lambda *a: _core(*a, spec=spec, g=g, C=C, e0=e0, n_e=n_e), mesh,
        [(x, xp), (p["router"], rep), (p["wi"], w_in), (p["wg"], w_in), (p["wo"], w_out)],
        [yp, sp, sp])
    me = me.redistribute(mesh, rep)
    ce = ce.redistribute(mesh, rep)
    return y, E * torch.sum((me / n_tok) * (ce / n_tok))
