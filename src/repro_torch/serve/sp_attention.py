"""Sequence-parallel decode attention on local shards.

Counterpart of ``repro/serve/sp_attention.py``. KV caches for long contexts
are sharded on the *sequence* dim over the ``model`` axis (GQA head counts
rarely divide a 16-way TP axis). This plan keeps KV local whatever the
plan's other placements, and combines per-shard softmax statistics with
three small functional collectives (``layers.decode_attention`` with a
``reduce``): the max, the sum, and the output [b, kh, g, d].

It also performs the new-token cache insert locally on the owning shard.
"""
from __future__ import annotations

from repro_torch.models.layers import _insert_token, decode_attention
from repro_torch.sharding.plan import is_sharded, local_call, shard_offset


def make_sp_decode(mesh, plan, *, axis: str = "model"):
    """Returns sp_decode(q, k_new, v_new, kc, vc, slot, kv_len) -> (o, kc, vc),
    or ``None`` where there is nothing to split (no such axis, or one
    device, where the plain decode is the same computation).

    q: [b,1,h,d] k_new/v_new: [b,1,kh,d] kc/vc: [b,S,kh,d] slot/kv_len: [b].
    """
    if not is_sharded(mesh) or axis not in mesh.mesh_dim_names:
        return None
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    ax = list(mesh.mesh_dim_names).index(axis)

    def sp_decode(q, k_new, v_new, kc, vc, slot, kv_len):
        b = q.shape[0]
        bpl = plan.resolve(mesh, (b,), ("batch",))
        # the batch keeps its shards; everything else is whole, except the
        # cache's sequence, split over ``axis``
        rep = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in bpl)
        cache_pl = tuple(Shard(1) if i == ax else p for i, p in enumerate(rep))
        start, _ = shard_offset(mesh, cache_pl, kc.shape[1], 1)

        def inner(q, k_new, v_new, kc, vc, slot, kv_len):
            _insert_token(start, kc, k_new, slot)  # on the owning shard only
            _insert_token(start, vc, v_new, slot)

            def reduce(x, op):
                return funcol.all_reduce(x, op, (mesh, ax))

            o = decode_attention(q, kc, vc, kv_len, start=start, reduce=reduce)
            return o, kc, vc

        return local_call(inner, mesh,
                          [(q, rep), (k_new, rep), (v_new, rep), (kc, cache_pl),
                           (vc, cache_pl), (slot, rep[:]), (kv_len, rep[:])],
                          [rep, cache_pl, cache_pl])

    return sp_decode
