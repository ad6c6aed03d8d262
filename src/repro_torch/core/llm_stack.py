"""LLM Stack (paper §3.2): RAG + CoT + client + fine-tuning orchestration.

Builds the prompt from retrieved context (prior hardware data points + code
fragments), embeds the CoT scaffold and a machine-readable TASK block, calls
the LLM client, parses/validates the response against the template, and
returns proposals. Invalid responses are surfaced as *rejected* data points.

Counterpart of ``repro/core/llm_stack.py``, copied; the system prompt
names the GPU cluster instead of a TPU.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cost_db import CostDB, DataPoint, workload_features
from repro_torch.core.design_space import PlanPoint, PlanTemplate
from repro_torch.core.llm_client import LLMClient, MockLLM, parse_json_answer
from repro_torch.core.rag import CodeIndex, DesignRetriever, summarize_datapoint

SYSTEM_PROMPT = (
    "You are a GPU-cluster execution-plan design assistant inside SECDA-DSE. "
    "Reason step by step (ANALYZE -> ENUMERATE -> ESTIMATE -> RANK) and then "
    "emit a final ```json block with {\"proposals\": [plan dicts]}. Plans must "
    "stay inside the device-aware ranges given in <TASK>."
)


@dataclass
class LLMStack:
    client: LLMClient = field(default_factory=MockLLM)
    db: Optional[CostDB] = None
    code_index: Optional[CodeIndex] = None

    def _context(self, arch: str, point: Dict, workload: Dict, k: int = 5) -> str:
        parts = []
        if self.db is not None:
            retr = DesignRetriever(self.db).retrieve(point, workload, k=k, arch=arch)
            if retr:
                parts.append("Similar prior hardware data points:")
                parts += ["  " + summarize_datapoint(d) for d in retr]
        if self.code_index is not None:
            frags = self.code_index.retrieve(
                f"{arch} sharding plan remat collective {point}", k=2)
            for tag, text in frags:
                parts.append(f"--- {tag} ---\n{text[:400]}")
        return "\n".join(parts)

    # ------------------------------------------------------------------
    def propose(self, arch: str, shape: str, cfg, cell, template: PlanTemplate,
                point: PlanPoint, metrics: Dict, *, k: int = 4,
                ) -> Tuple[List[PlanPoint], List[DataPoint], str]:
        """Refine candidates around ``point``. Returns (valid proposals,
        rejected negative data points, raw LLM transcript)."""
        wl = workload_features(cfg, cell)
        task = {
            "kind": "propose_plans",
            "point": {kk: vv for kk, vv in point.dims.items()},
            "metrics": {kk: metrics.get(kk) for kk in
                        ("compute_s", "memory_s", "collective_s", "bound_s",
                         "dominant", "fits_hbm", "per_device_gib")},
            "workload": wl,
            "template": {kk: list(vv) for kk, vv in template.dims().items()},
            "mesh_model": template.mesh_shape.get("model", 16),
            "k": k,
        }
        prompt = (
            f"Workload: {arch}/{shape}. Improve the execution plan.\n"
            + self._context(arch, dict(point.dims), wl)
            + "\n<TASK>" + json.dumps(task, default=str) + "</TASK>\n"
            "Follow the CoT scaffold and emit the final json block.")
        raw = self.client.complete(prompt, system=SYSTEM_PROMPT)
        ans = parse_json_answer(raw)
        valid: List[PlanPoint] = []
        rejected: List[DataPoint] = []
        if not ans or "proposals" not in ans:
            rejected.append(DataPoint(
                arch=arch, shape=shape, mesh="-", point=dict(point.dims),
                status="rejected", reason="unparseable LLM response",
                source=f"llm:{self.client.name}",
                metrics={"workload": wl}))
            return valid, rejected, raw
        for prop in ans["proposals"]:
            cand = PlanPoint(dims={kk: prop.get(kk, point.dims.get(kk))
                                   for kk in point.dims})
            ok, why = template.validate(cand)
            if ok:
                valid.append(cand)
            else:
                rejected.append(DataPoint(
                    arch=arch, shape=shape, mesh="-", point=dict(cand.dims),
                    status="rejected", reason=f"template violation: {why}",
                    source=f"llm:{self.client.name}",
                    metrics={"workload": wl}))
        return valid, rejected, raw

    # ------------------------------------------------------------------
    def generate_accelerator(self, spec: str, length: int = 4096) -> Tuple[Optional[Dict], str]:
        """Paper §4: NL spec -> SECDA-native kernel design (vecmul demo)."""
        task = {"kind": "generate_accelerator", "spec": spec, "length": length}
        prompt = ("Create a SECDA-native accelerator from this specification.\n"
                  "<TASK>" + json.dumps(task) + "</TASK>")
        raw = self.client.complete(prompt, system=SYSTEM_PROMPT)
        return parse_json_answer(raw), raw
