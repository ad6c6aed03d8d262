"""MCP-style tool registry (paper §5.1: 'full system integration through
MCP-based automation').

Each SECDA-DSE component exposes an API endpoint for data interchange; the
LLM Stack drives exploration by calling these tools. This is an in-process
registry with JSON-schema'd tools — the transport is a function call here,
but the contract (named tools, typed args, JSON results) matches MCP so a
real server can wrap ``Registry.call`` 1:1.

Counterpart of ``repro/core/mcp.py``, copied; the plan template reads the
evaluator's ``mesh_shape`` (axis name -> size), as the loop does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class Tool:
    name: str
    description: str
    schema: Dict[str, Any]
    fn: Callable[..., Any]


@dataclass
class Registry:
    tools: Dict[str, Tool] = field(default_factory=dict)
    log: List[Dict[str, Any]] = field(default_factory=list)

    def register(self, name: str, description: str, schema: Dict[str, Any]):
        def deco(fn):
            self.tools[name] = Tool(name, description, schema, fn)
            return fn

        return deco

    def list_tools(self) -> List[Dict[str, Any]]:
        return [{"name": t.name, "description": t.description,
                 "inputSchema": t.schema} for t in self.tools.values()]

    def call(self, name: str, **kwargs) -> Any:
        if name not in self.tools:
            raise KeyError(f"unknown tool {name!r}; have {sorted(self.tools)}")
        t = self.tools[name]
        required = t.schema.get("required", [])
        missing = [r for r in required if r not in kwargs]
        if missing:
            raise TypeError(f"tool {name}: missing required args {missing}")
        result = t.fn(**kwargs)
        self.log.append({"tool": name, "args": {k: str(v)[:120] for k, v in kwargs.items()}})
        return result


def build_registry(*, evaluator, db, llm_stack, cost_model=None) -> Registry:
    """Wire the SECDA-DSE components into the tool registry."""
    reg = Registry()

    @reg.register("simulate", "Dry-run compile + roofline evaluation of a plan",
                  {"type": "object",
                   "properties": {"arch": {"type": "string"},
                                  "shape": {"type": "string"},
                                  "point": {"type": "object"}},
                   "required": ["arch", "shape", "point"]})
    def _simulate(arch: str, shape: str, point: Dict, iteration: int = -1,
                  source: str = "mcp"):
        from repro_torch.core.design_space import PlanPoint

        dp = evaluator.evaluate(arch, shape, PlanPoint(dims=point),
                                source=source, iteration=iteration)
        db.append(dp)
        return dp

    @reg.register("query_cost_db", "Query prior hardware data points",
                  {"type": "object",
                   "properties": {"arch": {"type": "string"},
                                  "shape": {"type": "string"},
                                  "status": {"type": "string"}},
                   "required": []})
    def _query(arch: Optional[str] = None, shape: Optional[str] = None,
               status: Optional[str] = None):
        return db.query(arch=arch, shape=shape, status=status)

    @reg.register("best_design", "Best known design for a workload",
                  {"type": "object",
                   "properties": {"arch": {"type": "string"},
                                  "shape": {"type": "string"}},
                   "required": ["arch", "shape"]})
    def _best(arch: str, shape: str):
        return db.best(arch, shape)

    @reg.register("propose", "LLM-stack reasoning-guided plan refinement",
                  {"type": "object",
                   "properties": {"arch": {"type": "string"},
                                  "shape": {"type": "string"},
                                  "point": {"type": "object"},
                                  "metrics": {"type": "object"}},
                   "required": ["arch", "shape", "point", "metrics"]})
    def _propose(arch: str, shape: str, point: Dict, metrics: Dict, k: int = 4):
        from repro_torch.configs import SHAPE_BY_NAME, get_config
        from repro_torch.core.design_space import PlanPoint, PlanTemplate

        cfg = get_config(arch)
        cell = SHAPE_BY_NAME[shape]
        template = PlanTemplate(cfg, cell, evaluator.mesh_shape)
        pts, rejected, raw = llm_stack.propose(
            arch, shape, cfg, cell, template, PlanPoint(dims=point), metrics, k=k)
        for dp in rejected:
            db.append(dp)
        return {"proposals": pts, "rejected": len(rejected), "transcript": raw}

    @reg.register("finetune_cost_model", "LoRA-finetune the surrogate on the DB",
                  {"type": "object", "properties": {"rank": {"type": "integer"}},
                   "required": []})
    def _finetune(rank: int = 4, steps: int = 200):
        if cost_model is None:
            return {"status": "no cost model attached"}
        if not cost_model.trained:
            loss = cost_model.pretrain(db)
            return {"status": "pretrained", "loss": loss}
        loss = cost_model.finetune_lora(db, rank=rank, steps=steps)
        return {"status": "lora-finetuned", "loss": loss,
                "adapter_params": _lora_size(cost_model)}

    return reg


def _lora_size(cost_model) -> int:
    from repro_torch.core import lora as lora_mod

    return 0 if cost_model.lora is None else lora_mod.lora_param_count(cost_model.lora)
