"""The design spaces: plan points and kernel tile points, each with its
device-aware template.

Counterpart of ``repro/core/design_space.py``. The plan half
(``DIMENSIONS``, ``point_to_plan``, ``baseline_point``, ``PlanTemplate``)
is the reference's, with the H100 cluster as the template's device. The
kernel half (``KernelPoint``, ``baseline_kernel_point``,
``KernelTemplate``) is the Hopper one: its ``validate`` keeps the
reference's pinned messages for unknown dims and out-of-pool values, and
its device bound is the shared memory a block may have on the H100, where
the reference bounds TPU VMEM. Both templates' ``neighbors`` yield in the
reference's order, and their ``random_points`` make the reference's draws
in the reference's order.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core import kernel_space
from repro_torch.core.device import H100_CLUSTER, H100_SXM, DeviceModel
from repro_torch.core.kernel_space import (KernelShape, default_kernel_dims,
                                           legal_kernel_dims)
from repro_torch.sharding.plan import ShardingPlan, baseline_rules

# plan dimensions the explorer may mutate, with their global value pools
DIMENSIONS: Dict[str, Tuple] = {
    "batch_rule": ("data", "data+model"),  # DP vs fully-flat FSDP-style batch
    "seq_rule": (None, "model"),  # sequence-parallel residuals
    "attn_rule": ("heads", "head_dim", "none"),
    "ffn_rule": ("model", None),
    "vocab_rule": ("model", None),
    "expert_rule": ("experts", "expert_ffn", "none"),
    "embed_rule": (None, "data"),  # ZeRO-3-style weight sharding over data
    "seq_kv_rule": ("model", None, "kv_heads"),
    "remat": ("none", "dots", "full"),
    "microbatches": (1, 2, 4, 8),
    "zero1": (True, False),
    "grad_compress": ("none", "int8", "topk"),
    "decode_attn": ("gspmd", "sp_shardmap"),
    "loss_chunk": (0, 512, 1024),
    "attn_impl": ("chunked", "tri"),  # tri = causal-skip triangular block scan
    "opt_int8": (False, True),  # blockwise int8 Adam moments
}


@dataclass(frozen=True)
class PlanPoint:
    """One candidate configuration = assignments over design dimensions."""

    dims: Mapping[str, Any]

    def key(self) -> str:
        blob = json.dumps(dict(sorted(self.dims.items())), sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def to_dict(self):
        return dict(self.dims)


def point_to_plan(cfg: ArchConfig, cell: ShapeCell, point: PlanPoint,
                  *, multi_pod: bool = False, name: Optional[str] = None) -> ShardingPlan:
    """Materialise a PlanPoint into a resolvable ShardingPlan."""
    d = dict(point.dims)
    rules = baseline_rules(multi_pod)
    data_axes = rules["batch"]

    if d.get("batch_rule") == "data+model":
        rules["batch"] = tuple(data_axes) + ("model",)
        rules["moe_groups"] = rules["batch"]
    rules["seq"] = d.get("seq_rule", "model")

    attn = d.get("attn_rule", "heads")
    rules["heads"] = "model" if attn in ("heads", "heads_pad") else None
    rules["kv_heads"] = "model" if attn in ("heads", "heads_pad") else None
    rules["head_dim"] = "model" if attn == "head_dim" else None
    force_uneven = ("heads", "kv_heads") if attn == "heads_pad" else ()

    rules["ffn"] = d.get("ffn_rule", "model")
    rules["vocab"] = d.get("vocab_rule", "model")

    expert = d.get("expert_rule", "experts")
    rules["experts"] = "model" if expert == "experts" else None
    rules["expert_ffn"] = "model" if expert == "expert_ffn" else None

    rules["embed"] = d.get("embed_rule")
    skv = d.get("seq_kv_rule", "model")
    rules["seq_kv"] = "model" if skv == "model" else None
    if skv == "kv_heads":
        rules["seq_kv"] = None  # kv_heads already sharded via attn rule

    return ShardingPlan(
        name=name or f"dse-{point.key()}",
        rules=rules,
        remat=d.get("remat", "full"),
        microbatches=int(d.get("microbatches", 1)),
        zero1=bool(d.get("zero1", True)),
        grad_compress=d.get("grad_compress", "none"),
        decode_attn=d.get("decode_attn", "gspmd"),
        loss_chunk=int(d.get("loss_chunk", 0)),
        attn_impl=d.get("attn_impl", "chunked"),
        opt_int8=bool(d.get("opt_int8", False)),
        force_uneven=force_uneven,
        kernel_blocks=d.get("kernel_blocks", {}),
    )


def baseline_point(cell: ShapeCell, template: Optional["PlanTemplate"] = None) -> PlanPoint:
    """The expert initial design (Megatron-style TP + SP + ZeRO-1 + remat).

    With a template, each dimension is clamped to the first legal value in
    preference order (device-aware ranges), so the seed is always valid —
    e.g. attn falls back heads -> head_dim -> none for llava's 56 heads.
    """
    prefs = {
        "batch_rule": ("data",),
        "seq_rule": ("model", None),
        "attn_rule": ("heads", "head_dim", "none"),
        "ffn_rule": ("model", None),
        "vocab_rule": ("model", None),
        "expert_rule": ("experts", "expert_ffn", "none"),
        "embed_rule": (None,),
        "seq_kv_rule": ("model", None),
        "remat": ("full",) if cell.kind == "train" else ("none",),
        "microbatches": (1,),
        "zero1": (True,),
        "grad_compress": ("none",),
        "decode_attn": ("gspmd",),
        "loss_chunk": (0,),
        "attn_impl": ("chunked",),
        "opt_int8": (False,),
    }
    if template is None:
        return PlanPoint(dims={k: v[0] for k, v in prefs.items()})
    legal = template.dims()
    dims = {}
    for k, pref in prefs.items():
        pool = legal.get(k, pref)
        dims[k] = next((p for p in pref if p in pool), pool[0])
    return PlanPoint(dims=dims)


@dataclass
class PlanTemplate:
    """Device-aware legal ranges for one (arch x shape x mesh) workload."""

    cfg: ArchConfig
    cell: ShapeCell
    mesh_shape: Mapping[str, int]
    device: DeviceModel = H100_CLUSTER

    def dims(self) -> Dict[str, Tuple]:
        """DIMENSIONS filtered by device/workload constraints."""
        model = self.mesh_shape.get("model", 1)
        c, cell = self.cfg, self.cell
        out: Dict[str, Tuple] = {}
        for k, vals in DIMENSIONS.items():
            vals = list(vals)
            if k == "attn_rule":
                if c.n_heads == 0:
                    vals = ["none"]
                else:
                    if c.n_heads % model != 0 and "heads" in vals:
                        vals.remove("heads")  # device-aware range narrowing
                    if c.head_dim() % model != 0 and "head_dim" in vals:
                        vals.remove("head_dim")
            if k == "expert_rule":
                if c.moe is None:
                    vals = ["none"]
                else:
                    if c.moe.n_experts % model != 0 and "experts" in vals:
                        vals.remove("experts")
                    if c.moe.d_ff_expert % model != 0 and "expert_ffn" in vals:
                        vals.remove("expert_ffn")
            if k == "ffn_rule" and c.d_ff and c.d_ff % model != 0:
                vals = [v for v in vals if v != "model"]
            if k == "vocab_rule" and c.vocab % model != 0:
                vals = [v for v in vals if v != "model"]
            if k == "microbatches":
                vals = [v for v in vals if cell.global_batch % v == 0]
                if cell.kind != "train":
                    vals = [1]
            if k == "opt_int8" and cell.kind != "train":
                vals = [False]
            if k in ("remat", "grad_compress", "zero1", "loss_chunk") and cell.kind != "train":
                vals = [vals[0]] if k != "remat" else ["none"]
            if k == "loss_chunk":
                vals = [v for v in vals if v == 0 or (cell.kind == "train" and cell.seq_len % v == 0)]
            if k == "decode_attn" and cell.kind != "decode":
                vals = ["gspmd"]
            if k == "attn_impl":
                if c.n_heads == 0 or cell.kind == "decode":
                    vals = ["chunked"]  # no self-attn pass to triangulate
            out[k] = tuple(vals)
        return out

    def validate(self, point: PlanPoint) -> Tuple[bool, str]:
        legal = self.dims()
        for k, v in point.dims.items():
            if k == "kernel_blocks":
                continue
            if k not in legal:
                return False, f"unknown dimension {k}"
            if v not in legal[k]:
                return False, f"{k}={v!r} outside device-aware range {legal[k]}"
        # cross-dimension constraint: each device must keep >=1 row per
        # microbatch, else the pipeline idles 1/k of the fleet
        mb = int(point.dims.get("microbatches", 1))
        if mb > 1:
            bdeg = self.mesh_shape.get("pod", 1) * self.mesh_shape.get("data", 1)
            if point.dims.get("batch_rule") == "data+model":
                bdeg *= self.mesh_shape.get("model", 1)
            b_local = self.cell.global_batch // min(bdeg, self.cell.global_batch)
            if b_local % mb != 0:
                return False, (f"microbatches={mb} but only {b_local} "
                               f"rows/device under batch_rule="
                               f"{point.dims.get('batch_rule')}")
        return True, ""

    def neighbors(self, point: PlanPoint) -> Iterator[PlanPoint]:
        """All single-dimension mutations (the Explorer's permutation set)."""
        legal = self.dims()
        for k, vals in legal.items():
            for v in vals:
                if v != point.dims.get(k):
                    yield PlanPoint(dims={**point.dims, k: v})

    def repair(self, point: PlanPoint) -> PlanPoint:
        """Template-specific candidate repair (the search layer delegates
        here, so strategies stay design-space-agnostic): the only plan-space
        cross-dimension clash — a microbatch count the per-device batch
        can't absorb — is fixed by dropping back to microbatches=1."""
        ok, _ = self.validate(point)
        if ok:
            return point
        return PlanPoint(dims={**point.dims, "microbatches": 1})

    def random_points(self, rng, n: int) -> List[PlanPoint]:
        legal = self.dims()
        keys = sorted(legal)
        out = []
        for _ in range(n):
            p = PlanPoint(dims={k: legal[k][rng.randrange(len(legal[k]))]
                                for k in keys})
            out.append(self.repair(p))
        return out


@dataclass(frozen=True)
class KernelPoint(PlanPoint):
    """A kernel-space candidate: assignments over one kernel's tile dims.

    Shares ``PlanPoint``'s key/serialization contract so the CostDB,
    caches, and search strategies treat both spaces identically.
    """


def baseline_kernel_point(shape: KernelShape,
                          template: Optional["KernelTemplate"] = None
                          ) -> KernelPoint:
    """The expert initial design for a kernel cell: the shipped defaults,
    snapped into the shape's legal pools and, with a template, repaired to
    fit the device."""
    p = KernelPoint(dims=default_kernel_dims(shape))
    if template is not None:
        p = template.repair(p)
    return p


@dataclass
class KernelTemplate:
    """Device-aware legal tile ranges for one kernel workload shape: the
    same ``dims`` / ``validate`` / ``neighbors`` / ``repair`` /
    ``random_points`` surface as the reference's, with legality meaning
    grid divisibility plus a launch the H100 accepts (shared memory per
    block and threads per block, from the Hopper resource model)."""

    kshape: KernelShape
    device: DeviceModel = H100_SXM

    def dims(self) -> Dict[str, Tuple]:
        """Legal pools, divisibility-filtered against the workload shape."""
        return legal_kernel_dims(self.kshape)

    def _resources(self, dims: Mapping[str, Any]):
        return kernel_space.kernel_resources(self.kshape, dims, self.device)

    def validate(self, point: PlanPoint) -> Tuple[bool, str]:
        """(ok, reason): unknown dims and out-of-pool values give the
        reference's pinned messages; the device constraint is the shared
        memory and threads one block of the port's kernel needs."""
        legal = self.dims()
        for k, v in point.dims.items():
            if k not in legal:
                return False, f"unknown dimension {k}"
            if v not in legal[k]:
                return False, f"{k}={v!r} outside device-aware range {legal[k]}"
        res = self._resources(point.dims)
        if not res.feasible:
            if res.vmem_bytes > self.device.smem_per_block:
                return False, (f"shared memory {res.vmem_bytes} B per block "
                               f"exceeds {self.device.smem_per_block} B limit")
            regs = res.regs_per_thread
            if regs and (regs > self.device.max_regs_per_thread
                         or regs * res.threads > self.device.regs_per_sm):
                return False, (f"{regs} registers per thread for {res.threads} "
                               f"threads exceed {self.device.regs_per_sm} per SM")
            return False, (f"{res.threads} threads per block outside "
                           f"1..{self.device.max_threads_per_block}")
        return True, ""

    def neighbors(self, point: PlanPoint) -> Iterator[PlanPoint]:
        """Single-dimension mutations, filtered to validity (closure
        property: every yielded point passes ``validate``)."""
        legal = self.dims()
        for k, vals in legal.items():
            for v in vals:
                if v != point.dims.get(k):
                    cand = KernelPoint(dims={**point.dims, k: v})
                    ok, _ = self.validate(cand)
                    if ok:
                        yield cand

    def repair(self, point: PlanPoint) -> KernelPoint:
        """Snap a candidate into the template: unknown dims are dropped,
        out-of-pool values fall back to the shipped default, and block
        dims shrink (largest first) until the block fits the device."""
        legal = self.dims()
        dims = dict(default_kernel_dims(self.kshape))
        for k, v in point.dims.items():
            if k in legal and v in legal[k]:
                dims[k] = v
        while not self._resources(dims).feasible:
            shrinkable = [(k, [v for v in legal[k]
                               if isinstance(v, int) and v < dims[k]])
                          for k in dims if isinstance(dims[k], int)]
            shrinkable = [(k, vs) for k, vs in shrinkable if vs]
            if not shrinkable:
                break  # nothing left to shrink; validate() will reject
            k, vs = max(shrinkable, key=lambda kv: dims[kv[0]])
            dims[k] = max(vs)
        return KernelPoint(dims=dims)

    def random_points(self, rng, n: int) -> List[KernelPoint]:
        """n uniform samples over the legal pools, each repaired to a
        valid point (closure property shared with ``neighbors``)."""
        legal = self.dims()
        keys = sorted(legal)
        out = []
        for _ in range(n):
            p = KernelPoint(dims={k: legal[k][rng.randrange(len(legal[k]))]
                                  for k in keys})
            out.append(self.repair(p))
        return out
