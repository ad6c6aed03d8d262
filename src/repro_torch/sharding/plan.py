"""Execution-plan -> sharding resolution, as DTensor placements.

Counterpart of ``repro/sharding/plan.py``. A :class:`ShardingPlan` maps
*logical* axes (embed/heads/ffn/...) to mesh axes and carries the
memory-policy knobs (remat, microbatches, ZeRO). The reference resolves a
tensor to a ``PartitionSpec`` (one entry per tensor dim); here
:meth:`ShardingPlan.resolve` gives the same decision as DTensor placements
(one per mesh dim), with the reference's device-aware fallback: a dim that
does not divide by its mesh axes is replicated (and recorded), unless its
logical axis is in ``force_uneven``.

A spec that shards one tensor dim over two mesh axes orders the shards as
it lists the axes; DTensor orders them by mesh dim. Every rule the plan
space makes lists its axes in mesh order (``("pod", "data")``,
``("data", "model")``), so the two orders, and the values each device
holds, agree.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

# logical dims of each activation "kind" passed to constrain(x, kind)
ACT_KINDS: Dict[str, Tuple[Optional[str], ...]] = {
    # residual carry: "seq" may be mesh-sharded (Megatron-style SP); compute
    # tensors shard heads/ffn/vocab instead and keep seq local ("seq_attn").
    "hidden": ("batch", "seq", "embed"),
    # the residual entering a projection, gathered over its sequence
    # shards (Megatron-SP's all-gather; GSPMD places it by itself)
    "hidden_in": ("batch", "seq_attn", "embed"),
    "heads": ("batch", "seq_attn", "heads", "head_dim"),
    "kv": ("batch", "seq_attn", "kv_heads", "head_dim"),
    "ffn": ("batch", "seq_attn", "ffn"),
    "logits": ("batch", "seq_attn", "vocab"),
    "experts_in": ("moe_groups", "experts", "capacity", "embed"),
    "expert_hidden": ("moe_groups", "experts", "capacity", "expert_ffn"),
    "ssm_inner": ("batch", "seq_attn", "ssm_inner"),
}

# logical dims of cache tensors, keyed by cache leaf name
CACHE_KINDS: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("layers", "batch", "seq_kv", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "seq_kv", "kv_heads", "head_dim"),
    "ck": ("layers", "batch", "seq_kv", "kv_heads", "head_dim"),
    "cv": ("layers", "batch", "seq_kv", "kv_heads", "head_dim"),
    "len": ("batch",),
    "conv": ("layers", "batch", "conv", "ssm_inner"),
    "ssm": ("layers", "batch", "ssm_heads", "head_dim", "ssm_state"),
}


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def is_sharded(mesh) -> bool:
    """Whether tensors on ``mesh`` are DTensors: a mesh of one device
    holds every tensor whole, so the plan's hooks leave plain tensors."""
    return mesh is not None and mesh.size() > 1


@dataclass(frozen=True)
class ShardingPlan:
    """One point in the execution-plan design space."""

    name: str = "baseline"
    # logical axis -> mesh axis (str), tuple of mesh axes, or None (replicate)
    rules: Mapping[str, Any] = field(default_factory=dict)
    remat: str = "full"  # none | dots | full
    microbatches: int = 1
    zero1: bool = True  # shard optimizer state over the data axis
    master_weights: bool = False  # keep f32 master params in the opt state
    grad_compress: str = "none"  # none | int8 | topk
    decode_attn: str = "gspmd"  # gspmd | sp_shardmap (seq-sharded flash decode)
    loss_chunk: int = 0  # CE loss sequence chunking (0 = full logits)
    attn_impl: str = "chunked"  # chunked | tri (causal-skip triangular walk)
    opt_int8: bool = False  # blockwise int8 Adam moments (8-bit Adam)
    # logical axes allowed to shard unevenly (e.g. 56 heads / 16)
    force_uneven: Tuple[str, ...] = ()
    # kernel tiling (the paper's "compute unit dimensions")
    kernel_blocks: Mapping[str, int] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        r = self.rules.get(logical)
        if r is None:
            return ()
        return (r,) if isinstance(r, str) else tuple(r)

    def resolve_spec(self, axis_sizes: Mapping[str, int], shape: Sequence[int],
                     logical_dims: Sequence[Optional[str]],
                     replicated: Optional[List] = None) -> Tuple[Any, ...]:
        """The reference's ``PartitionSpec`` entries for one tensor (a mesh
        axis name, a tuple of them, or ``None`` per tensor dim, trailing
        ``None`` s dropped). A dim its axes do not divide is replicated and,
        with ``replicated`` given, appended there as ``(dim, logical)``."""
        assert len(shape) == len(logical_dims), (shape, logical_dims)
        used: set = set()
        parts: List[Any] = []
        for i, (dim, logical) in enumerate(zip(shape, logical_dims)):
            axes = tuple(a for a in self.mesh_axes(logical)
                         if a in axis_sizes and a not in used)
            size = 1
            for a in axes:
                size *= axis_sizes[a]
            ok = dim % size == 0 or logical in self.force_uneven
            if axes and ok and dim > 0:
                used.update(axes)
                parts.append(axes[0] if len(axes) == 1 else axes)
            else:
                if axes and replicated is not None:
                    replicated.append((i, logical))
                parts.append(None)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def resolve(self, mesh, shape: Sequence[int],
                logical_dims: Sequence[Optional[str]],
                replicated: Optional[List] = None) -> Tuple[Any, ...]:
        """DTensor placements for one tensor on ``mesh``: ``Shard(d)`` on
        each mesh dim the spec puts on tensor dim ``d``, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh.mesh_dim_names)
        spec = self.resolve_spec(mesh_shape(mesh), shape, logical_dims, replicated)
        placements: List[Any] = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                placements[names.index(a)] = Shard(d)
        return tuple(placements)

    # ------------------------------------------------------------------
    def param_shardings(self, mesh, values: Mapping[str, Any],
                        logical: Mapping[str, Tuple]) -> Dict[str, Tuple]:
        """Placements per parameter, given each one's logical axes."""
        return {k: self.resolve(mesh, v.shape, logical[k]) for k, v in values.items()}

    def batch_specs(self, mesh, batch: Mapping[str, Any]) -> Dict[str, Tuple]:
        """Placements for a data batch: leading dim = batch."""
        return {k: self.resolve(mesh, v.shape, ("batch",) + (None,) * (len(v.shape) - 1))
                for k, v in batch.items()}

    def cache_specs(self, mesh, cache: Mapping[str, Any]) -> Dict[str, Tuple]:
        """Placements for a KV cache, by leaf name (``CACHE_KINDS``)."""
        out = {}
        for k, v in cache.items():
            dims = CACHE_KINDS.get(k)
            if dims is None or len(dims) != len(v.shape):
                dims = (None,) * len(v.shape)
            out[k] = self.resolve(mesh, v.shape, dims)
        return out

    # ------------------------------------------------------------------
    def make_constrain(self, mesh) -> "PlanCtx":
        """The constrain(x, kind) hook passed into models: it redistributes
        a DTensor activation to the plan's placements for its kind. A no-op
        without a mesh (or on one device). It also carries the plan
        attributes the model layers dispatch on (``attn_impl``)."""
        if not is_sharded(mesh):
            return PlanCtx(lambda x, kind: x, attn_impl=self.attn_impl)

        from torch.distributed.tensor import DTensor

        def fn(x, kind):
            dims = ACT_KINDS.get(kind)
            if dims is None or not isinstance(x, DTensor) or x.ndim != len(dims):
                return x
            return x.redistribute(mesh, self.resolve(mesh, x.shape, dims))

        return PlanCtx(fn, attn_impl=self.attn_impl, mesh=mesh)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["rules"] = dict(self.rules)
        d["kernel_blocks"] = dict(self.kernel_blocks)
        return d


def full_walk(n: int, kind: str = "uniform"):
    """A loop of ``n`` steps run in full: ``(i, 1.0)`` for every step."""
    return ((i, 1.0) for i in range(n))


class PlanCtx:
    """Callable constrain hook carrying plan attributes for model dispatch.

    ``walk(n, kind)`` is how the model runs its loops (layers, chunk
    walks): it yields ``(step, weight)``. Run for real, it yields every step
    with weight 1; the dry run swaps in a walk that runs representative
    steps and weights the counts (``core/step_analysis.py``)."""

    def __init__(self, fn: Callable, attn_impl: str = "chunked", mesh=None,
                 walk: Callable = full_walk):
        self._fn = fn
        self.attn_impl = attn_impl
        self.mesh = mesh
        self.walk = walk

    def __call__(self, x, kind):
        return self._fn(x, kind)


def shard_offset(mesh, placements, global_size: int, dim: int) -> Tuple[int, int]:
    """(offset, size) of this rank's chunk of tensor dim ``dim``, split as
    DTensor splits it (``torch.chunk`` per mesh dim, in mesh order)."""
    coord = mesh.get_coordinate()
    off, size = 0, global_size
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            m = mesh.size(i)
            chunk = -(-size // m)
            lo = min(coord[i] * chunk, size)
            off += lo
            size = min(chunk, size - lo)
    return off, size


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous on its way back: DTensor
    wraps a local gradient with the strides of the forward's local tensor,
    and views of a gradient laid out otherwise fail."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grad(x):
    return _ContiguousGrad.apply(x) if x.requires_grad else x


def local_call(fn, mesh, args: Sequence[Tuple[Any, Tuple]], out_placements: Sequence[Tuple]):
    """Run ``fn`` on local shards, like ``shard_map``: each DTensor in
    ``args`` (given as ``(tensor, placements)``) is redistributed to its
    placements and handed over as its local tensor, and each output is
    wrapped back as a DTensor with its ``out_placements``. Without a
    sharded mesh, ``fn`` runs on the tensors as they are."""
    if not is_sharded(mesh):
        return fn(*(a for a, _ in args))
    from torch.distributed.tensor import DTensor

    local = [_contiguous_grad(a.redistribute(mesh, pl).to_local()) if isinstance(a, DTensor)
             else a for a, pl in args]
    out = fn(*local)
    single = not isinstance(out, tuple)
    wrapped = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                    for o, pl in zip((out,) if single else out, out_placements))
    return wrapped[0] if single else wrapped


# ---------------------------------------------------------------------------
# Baseline plan factory — the "expert initial design" that seeds the DSE loop
# ---------------------------------------------------------------------------
def baseline_rules(multi_pod: bool = False) -> Dict[str, Any]:
    data = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": data,
        "moe_groups": data,
        "seq": "model",  # sequence-sharded residuals (SP) — memory floor
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "expert_ffn": None,
        "vocab": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "seq_kv": "model",  # decode KV caches: shard the sequence dim
        "lora_rank": None,
        "layers": None,
        "conv": None,
        "capacity": None,
    }


def baseline_plan(cfg, cell, *, multi_pod: bool = False) -> ShardingPlan:
    """Paper-faithful starting point: an expert-written initial configuration
    (SECDA-DSE §3.1 — 'an accelerator design generated initially by an expert
    designer') from which the DSE explores."""
    rules = baseline_rules(multi_pod)
    remat = "full" if cell.kind == "train" else "none"
    return ShardingPlan(name=f"baseline/{cfg.name}/{cell.name}", rules=rules, remat=remat)
