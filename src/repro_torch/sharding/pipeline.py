"""Pipeline parallelism over real ranks (GPipe schedule).

Counterpart of ``repro/sharding/pipeline.py``. Stages are carved from a
mesh axis (on the multi-pod mesh the natural choice is the ``pod`` axis:
activations cross pods once per stage boundary, the cheapest inter-pod
traffic pattern, against per-layer collectives).

Layout: layer-stacked params ``[L, ...]`` are cut into ``S`` stages of
``L/S`` consecutive layers; the rank at stage ``s`` of the stage axis runs
only its own. Microbatches stream through the classic GPipe schedule:

    T = n_micro + S - 1 ticks; at tick t, stage s processes microbatch
    (t - s); activations hop stage -> stage+1 by point-to-point send and
    receive (``dist.batch_isend_irecv``) within the stage axis's group.

Ranks along the other mesh axes hold replicas: each runs the same
pipeline over the whole microbatch stream in its own stage group. The
last stage's outputs then reach every rank of its stage group by a
broadcast (the reference's masked ``psum``), so every rank returns them.

Forward pass only (serving pipelines, pipelined prefill), as in the
reference. It runs on CPU ranks of a ``gloo`` group: one card cannot host
two NCCL ranks, and only tests call it (in the reference too).
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor of a tensor or a (nested) dict of them."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree: Any) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    return tree


def pipeline_forward(
    layer_fn: Callable,  # (layer_params, x [mb, ...]) -> x
    stacked_params,  # a tensor or nested dict of them, [L, ...], whole on every rank
    x_mb: torch.Tensor,  # [n_micro, mb, ...] microbatched inputs, on every rank
    mesh,  # DeviceMesh over the live process group
    *,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Returns y [n_micro, mb, ...] = sequential-layer application, executed
    as an S-stage pipeline over ``stage_axis``; every rank gets all of y."""
    import torch.distributed as dist

    S = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    n_micro = x_mb.shape[0]
    L = _first_leaf(stacked_params).shape[0]
    assert L % S == 0, (L, S)
    per = L // S
    sid = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    peer = [dist.get_global_rank(group, s) for s in range(S)]
    local = _tree_map(lambda a: a[sid * per:(sid + 1) * per], stacked_params)

    def run_layers(x):
        for i in range(per):
            x = layer_fn(_tree_map(lambda a: a[i], local), x)
        return x

    def valid(mb: int) -> bool:
        return 0 <= mb < n_micro

    out = torch.zeros_like(x_mb)
    buf = torch.zeros_like(x_mb[0])
    for t in range(n_micro + S - 1):
        mb = t - sid  # which microbatch this stage works on
        y = None
        if valid(mb):
            y = run_layers(x_mb[t] if sid == 0 else buf)
            if sid == S - 1:
                out[mb] = y  # the last stage records its finished microbatch
        # hop: stage s sends y to stage s+1, which works on it next tick
        ops = []
        if sid < S - 1 and y is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), peer[sid + 1], group))
        nxt = torch.empty_like(buf)
        if sid > 0 and valid(t + 1 - sid):
            ops.append(dist.P2POp(dist.irecv, nxt, peer[sid - 1], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        buf = nxt
    # only the last stage holds real outputs; it broadcasts them
    dist.broadcast(out, src=peer[S - 1], group=group)
    return out
