"""Chain-of-Thought scaffold (paper §3.2.1, Fig. 4).

The CoT component structures the LLM's exploration reasoning into explicit
stages, each producing an auditable trace:

  1. ANALYZE   — which roofline term dominates, by how much, and why;
  2. ENUMERATE — candidate plan mutations whose preconditions hold;
  3. ESTIMATE  — napkin math for the expected delta of each candidate on the
                 dominant term (hardware-grounded closed forms);
  4. RANK      — sort by predicted win; emit top-k proposals.

The same scaffold is embedded into the LLM prompt (so a real model reasons
step-by-step), and executed symbolically by MockLLM so the loop is exact and
hermetic offline.

Counterpart of ``repro/core/cot.py``, copied: the same moves, estimates
and compounds, so the same point and metrics give the same trace.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# move catalog: (dimension, value) with precondition + effect rationale
@dataclass(frozen=True)
class Move:
    dim: str
    value: Any
    targets: Tuple[str, ...]  # which roofline terms it attacks
    rationale: str

    def applies(self, point: Dict, metrics: Dict) -> bool:
        return point.get(self.dim) != self.value


MOVES: List[Move] = [
    Move("batch_rule", "data+model", ("collective", "compute"),
         "flatten batch over all chips: removes TP activation all-reduces; "
         "grads reduce over the full mesh instead"),
    Move("batch_rule", "data", ("memory",),
         "restore 2D DP x TP so params/optimizer shard over the model axis"),
    Move("embed_rule", "data", ("memory",),
         "ZeRO-3-style weight sharding over the data axis (all-gather per layer)"),
    Move("seq_rule", "model", ("memory",),
         "sequence-parallel residuals: saved activations shrink by the TP degree"),
    Move("seq_rule", None, ("collective",),
         "drop SP resharding: removes per-layer seq all-gathers when memory allows"),
    Move("attn_rule", "head_dim", ("memory", "collective"),
         "shard head_dim when head count does not divide the TP axis"),
    Move("attn_rule", "heads", ("compute",), "shard attention by heads (local softmax)"),
    Move("expert_rule", "expert_ffn", ("memory",),
         "shard the expert FFN dim when n_experts does not divide the TP axis"),
    Move("expert_rule", "experts", ("collective",),
         "expert parallelism: each chip holds n_experts/TP experts"),
    Move("vocab_rule", "model", ("memory",), "shard embedding/LM-head vocab"),
    Move("loss_chunk", 1024, ("memory",),
         "chunk the CE loss so [B,S,V] logits are never materialised"),
    Move("loss_chunk", 512, ("memory",), "finer CE chunking"),
    Move("remat", "full", ("memory",), "full activation remat (+1 fwd of compute)"),
    Move("remat", "dots", ("compute",),
         "keep matmul outputs: removes the remat recompute fwd pass"),
    Move("remat", "none", ("compute",), "no remat when memory headroom exists"),
    Move("microbatches", 2, ("memory",), "halve per-step activation footprint"),
    Move("microbatches", 4, ("memory",), "quarter activation footprint"),
    Move("zero1", True, ("memory",), "shard optimizer m/v over the data axis"),
    Move("grad_compress", "int8", ("collective",),
         "int8 gradient all-reduce (4x wire reduction) with error feedback"),
    Move("decode_attn", "sp_shardmap", ("collective", "memory"),
         "flash-decoding shard_map: KV stays sequence-sharded; only softmax "
         "stats cross the mesh instead of the whole cache"),
    Move("seq_kv_rule", "model", ("memory",), "shard decode KV caches on sequence"),
    Move("opt_int8", True, ("memory",),
         "blockwise int8 Adam moments: optimizer state 8B -> 2B per param"),
    Move("attn_impl", "tri", ("compute",),
         "triangular block scan: skip fully-masked causal blocks "
         "(~0.5x attention FLOPs; O(s*w) for sliding window)"),
]


@dataclass
class CoTTrace:
    analyze: str = ""
    enumerate: List[str] = field(default_factory=list)
    estimate: List[Tuple[str, float, str]] = field(default_factory=list)
    rank: List[str] = field(default_factory=list)

    def render(self) -> str:
        lines = ["Step 1 — ANALYZE:", "  " + self.analyze, "Step 2 — ENUMERATE:"]
        lines += [f"  - {e}" for e in self.enumerate]
        lines.append("Step 3 — ESTIMATE (napkin math):")
        lines += [f"  - {m}: predicted x{f:.2f} on target term — {w}"
                  for m, f, w in self.estimate]
        lines.append("Step 4 — RANK:")
        lines += [f"  {i+1}. {r}" for i, r in enumerate(self.rank)]
        return "\n".join(lines)


def _estimate_factor(move: Move, point: Dict, metrics: Dict, workload: Dict,
                     mesh_model: int) -> Tuple[float, str]:
    """Closed-form napkin estimate of the dominant-term multiplier."""
    dom = metrics.get("dominant", "collective")
    if dom not in move.targets:
        return 1.0, "does not address the dominant term"
    if move.dim == "batch_rule" and move.value == "data+model":
        return 0.15, ("TP activation all-reduces (O(L·b_local·s·d) wire) vanish; "
                      "remaining wire = one gradient reduce over params")
    if move.dim == "loss_chunk" and move.value:
        v = workload.get("vocab", 1e5)
        return 0.5, f"logits [B,S,{int(v)}] become [B,{move.value},{int(v)}] per chunk"
    if move.dim == "decode_attn":
        return 0.1, "cache all-gather (GB) replaced by softmax stats (KB)"
    if move.dim == "attn_rule" and move.value == "head_dim":
        return 0.5, "attention tensors shard on head_dim instead of replicating"
    if move.dim == "expert_rule":
        return 0.3, "expert weights shard instead of replicating"
    if move.dim == "microbatches":
        return 1.0 / float(move.value), "activation live set divides by k"
    if move.dim == "remat" and move.value == "full":
        return 0.6, "live activations drop to one residual per layer"
    if move.dim == "remat" and move.value in ("dots", "none"):
        return 0.75, "removes the extra remat forward pass (8NDf -> 6NDf)"
    if move.dim == "grad_compress":
        return 0.6, "gradient wire bytes x0.25 on the DP axis"
    if move.dim == "zero1":
        return 0.8, "optimizer state divides by the data-axis degree"
    if move.dim == "seq_rule" and move.value == "model":
        return 0.7, "residual live set divides by TP degree"
    if move.dim == "seq_rule" and move.value is None:
        return 0.7, "drops per-layer seq all-gather/reduce-scatter pairs"
    if move.dim == "attn_impl" and move.value == "tri":
        s = workload.get("seq_len", 4096)
        return 0.75, (f"causal block skip: attention dots go S^2 -> S^2/2 "
                      f"(S={int(s)}); larger win the more attention-bound")
    return 0.9, move.rationale


def cot_propose(point: Dict, metrics: Dict, workload: Dict, *,
                mesh_model: int = 16, k: int = 4,
                template_dims: Optional[Dict] = None) -> Tuple[List[Dict], CoTTrace]:
    """Run the 4-stage CoT symbolically. Returns (proposed plan dicts, trace)."""
    trace = CoTTrace()
    dom = metrics.get("dominant", "?")
    terms = {t: metrics.get(f"{t}_s", 0.0) for t in ("compute", "memory", "collective")}
    fits = metrics.get("fits_hbm", True)
    trace.analyze = (
        f"terms: compute={terms['compute']:.3f}s memory={terms['memory']:.3f}s "
        f"collective={terms['collective']:.3f}s -> dominant={dom}; "
        + ("HBM OK" if fits else f"HBM VIOLATION ({metrics.get('per_device_gib', 0):.1f} GiB)"))

    cands: List[Tuple[float, Move]] = []
    for mv in MOVES:
        if not mv.applies(point, metrics):
            continue
        if template_dims is not None:
            legal = template_dims.get(mv.dim, ())
            if mv.value not in legal:
                trace.enumerate.append(
                    f"{mv.dim}={mv.value}: REJECTED (outside device-aware range)")
                continue
        # when HBM is violated, memory moves take absolute priority
        targets = mv.targets if fits else tuple(set(mv.targets) | {"memory"} if "memory" in mv.targets else mv.targets)
        eff_dom = dom if fits else "memory"
        f, why = _estimate_factor(mv, point, {**metrics, "dominant": eff_dom},
                                  workload, mesh_model)
        trace.enumerate.append(f"{mv.dim}={mv.value}: {mv.rationale}")
        if f < 1.0:
            cands.append((f, mv))
            trace.estimate.append((f"{mv.dim}={mv.value}", f, why))

    cands.sort(key=lambda t: t[0])
    proposals = []
    for f, mv in cands[:k]:
        newp = {kk: vv for kk, vv in point.items() if kk != "__key__"}
        newp[mv.dim] = mv.value
        proposals.append(newp)
        trace.rank.append(f"{mv.dim}={mv.value} (predicted x{f:.2f})")

    # compound moves: single mutations often trade the dominant term against
    # HBM feasibility, so propose the known-good combinations as one step
    for combo, why in _compounds(point, metrics, workload):
        legal = True
        if template_dims is not None:
            legal = all(v in template_dims.get(kk, ()) for kk, v in combo.items())
        if legal and any(point.get(kk) != v for kk, v in combo.items()):
            newp = {kk: vv for kk, vv in point.items() if kk != "__key__"}
            newp.update(combo)
            if newp not in proposals:
                proposals.append(newp)
                trace.rank.append(f"compound {combo} — {why}")
    return proposals[: max(k, 4)], trace


def _compounds(point: Dict, metrics: Dict, workload: Dict):
    """Multi-dimension proposals (learned from negative data points: the
    best single moves frequently overflow HBM without a paired memory move)."""
    dom = metrics.get("dominant")
    fits = metrics.get("fits_hbm", True)
    out = []
    is_train = workload.get("is_train", 0.0) >= 1.0
    if is_train and (dom == "collective" or not fits):
        out.append((
            {"batch_rule": "data+model", "embed_rule": "data",
             "loss_chunk": 1024, "seq_rule": None},
            "flat DP over all chips + FSDP weight sharding + chunked CE: "
            "removes TP activation all-reduces AND keeps params/logits in HBM"))
        out.append((
            {"batch_rule": "data+model", "embed_rule": "data",
             "loss_chunk": 1024, "seq_rule": None, "remat": "dots"},
            "same + matmul-output remat policy (drops the recompute fwd)"))
    if workload.get("is_decode", 0.0) >= 1.0:
        out.append((
            {"decode_attn": "sp_shardmap", "seq_kv_rule": "model"},
            "sequence-sharded KV + flash-decoding stat combine"))
    if not fits and is_train:
        out.append((
            {"loss_chunk": 1024, "microbatches": 4, "remat": "full"},
            "emergency memory triage: chunked CE + 4 microbatches + full remat"))
        out.append((
            {"embed_rule": "data", "loss_chunk": 1024, "seq_rule": "model",
             "remat": "full", "microbatches": 2, "zero1": True, "opt_int8": True},
            "large-model memory triage: 2D weight sharding (TP x data) + "
            "chunked CE + SP residuals + ZeRO-2 sharded grad accumulation"))
        out.append((
            {"embed_rule": "data", "loss_chunk": 1024, "seq_rule": "model",
             "remat": "full", "microbatches": 4, "zero1": True,
             "attn_impl": "tri", "opt_int8": True},
            "same with 4 microbatches + causal-skip attention"))
    return out
