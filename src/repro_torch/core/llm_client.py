"""LLM client protocol (paper §3.2.1: Ollama-served local models).

Counterpart of ``repro/core/llm_client.py``, copied apart from what the
§4 demo's design describes:

* ``OllamaClient`` — HTTP client matching the paper's deployment (model-
  swappable, no code change). It talks to a local server at ``host``;
  nothing here starts one.
* ``MockLLM`` — hermetic deterministic stand-in. For *propose* prompts it
  executes the same CoT scaffold embedded in the prompt (so loop mechanics,
  parsing, validation and negative-datapoint paths are exercised exactly);
  for *generate-accelerator* prompts (the paper's §4 vecmul experiment) it
  instantiates the port's vecmul kernel (``kernels/csrc/vecmul.cu``) from
  the NL spec: the design's keys and ``parameters`` are the reference's.
"""
from __future__ import annotations

import json
import re
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol


class LLMClient(Protocol):
    name: str

    def complete(self, prompt: str, *, system: str = "") -> str: ...


@dataclass
class OllamaClient:
    """Minimal Ollama /api/generate client (swap models via ``model=``)."""

    model: str = "qwen2.5-coder:7b"
    host: str = "http://localhost:11434"
    name: str = "ollama"
    timeout: float = 120.0

    def complete(self, prompt: str, *, system: str = "") -> str:
        payload = json.dumps({
            "model": self.model, "prompt": prompt, "system": system,
            "stream": False,
        }).encode()
        req = urllib.request.Request(
            f"{self.host}/api/generate", data=payload,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())["response"]


@dataclass
class MockLLM:
    """Deterministic offline 'LLM': executes the prompt's embedded task spec.

    The prompt carries machine-readable JSON blocks (context the LLM Stack
    always provides); the mock consumes them the way a fine-tuned model is
    *trained* to — making the full SECDA-DSE loop runnable and testable
    without network or GPU inference.
    """

    name: str = "mock"
    calls: List[str] = field(default_factory=list)

    def complete(self, prompt: str, *, system: str = "") -> str:
        self.calls.append(prompt)
        task = _json_block(prompt, "TASK")
        if task is None:
            return "UNSUPPORTED PROMPT"
        if task.get("kind") == "propose_plans":
            from repro_torch.core.cot import cot_propose

            proposals, trace = cot_propose(
                task["point"], task["metrics"], task["workload"],
                mesh_model=task.get("mesh_model", 16),
                k=task.get("k", 4),
                template_dims={k: tuple(v) for k, v in task.get("template", {}).items()}
                if task.get("template") else None,
            )
            return (trace.render() + "\n\nFINAL ANSWER:\n```json\n"
                    + json.dumps({"proposals": proposals}) + "\n```")
        if task.get("kind") == "generate_accelerator":
            return _generate_vecmul(task)
        return "UNSUPPORTED TASK"


def _json_block(text: str, tag: str) -> Optional[Dict]:
    m = re.search(rf"<{tag}>\s*(\{{.*?\}})\s*</{tag}>", text, re.S)
    if not m:
        return None
    try:
        return json.loads(m.group(1))
    except json.JSONDecodeError:
        return None


def _generate_vecmul(task: Dict) -> str:
    """NL spec -> the port's CUDA vecmul kernel instantiation (paper
    Appendix)."""
    spec = task.get("spec", "")
    L = task.get("length", 4096)
    # parse "two input vectors X and Y", "element-wise multiplication", buffers
    wants_mul = bool(re.search(r"element-?wise\s+multiplication", spec, re.I))
    wants_load = bool(re.search(r"load", spec, re.I))
    wants_store = bool(re.search(r"(store|written?\s+back)", spec, re.I))
    design = {
        "kernel": "vecmul" if wants_mul else "unknown",
        "interfaces": {"in": ["X", "Y"], "out": ["Z"]},
        "modules": {
            "load": ("16-byte vector loads, global memory -> registers"
                     if wants_load else None),
            "compute": "one multiply per element per thread, in registers",
            "store": ("16-byte vector stores, registers -> global memory"
                      if wants_store else None),
        },
        "parameters": {"L": L, "block": min(L, 1024)},
        "buffers": ["X_regs", "Y_regs", "Z_regs"],
    }
    reasoning = (
        "Step 1: the spec asks for two AXI-stream inputs -> two operands in "
        "global memory, each thread loading its elements into registers.\n"
        "Step 2: element-wise multiply maps to one CUDA thread per 16-byte "
        "vector, 'block' elements per CTA, all CTAs in parallel (the 'L "
        "parallel ops').\nStep 3: load-compute-store = vector load -> "
        "multiply in registers -> vector store (csrc/vecmul.cu).\n")
    return (reasoning + "\nFINAL ANSWER:\n```json\n" + json.dumps(design) + "\n```")


def parse_json_answer(text: str) -> Optional[Dict]:
    m = re.search(r"```json\s*(\{.*?\})\s*```", text, re.S)
    if not m:
        return None
    try:
        return json.loads(m.group(1))
    except json.JSONDecodeError:
        return None
