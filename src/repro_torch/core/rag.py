"""Retrieval-Augmented Generation module (paper §3.2.1).

Two retrieval sources, both vectorized:
  * the cost-model DB — prior hardware data points featurized by
    (plan dims, workload context), retrieved by cosine similarity so the LLM
    reasons over *similar prior designs* rather than the full raw logs;
  * the template/kernel source corpus — docstrings and module sources of this
    repo, indexed by hashed bag-of-words (the SECDA-TFLite codebase analog).

Only the top-k fragments enter the prompt ("maintain token limit while
providing enough context").

Counterpart of ``repro/core/rag.py``, copied; ``CodeIndex`` is pointed at
this package's own sources by its callers.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_db import CostDB, DataPoint, featurize

_DIM = 256


def _bow_vector(text: str, dim: int = _DIM) -> np.ndarray:
    v = np.zeros(dim, np.float32)
    for tok in re.findall(r"[a-zA-Z_][a-zA-Z0-9_]+", text.lower()):
        h = int(hashlib.md5(tok.encode()).hexdigest()[:8], 16)
        v[h % dim] += 1.0
    n = np.linalg.norm(v)
    return v / n if n else v


@dataclass
class CodeIndex:
    """Hashed bag-of-words index over repo sources (the codebase RAG)."""

    roots: Sequence[Path]
    chunks: List[Tuple[str, str]] = field(default_factory=list)  # (tag, text)
    _mat: Optional[np.ndarray] = None

    def build(self) -> "CodeIndex":
        for root in self.roots:
            for py in sorted(Path(root).rglob("*.py")):
                text = py.read_text()
                # one chunk per top-level def/class + the module docstring
                parts = re.split(r"\n(?=def |class )", text)
                for part in parts:
                    head = part.strip().splitlines()[0][:80] if part.strip() else ""
                    self.chunks.append((f"{py.name}:{head}", part[:2000]))
        self._mat = np.stack([_bow_vector(t) for _, t in self.chunks]) if self.chunks else None
        return self

    def retrieve(self, query: str, k: int = 3) -> List[Tuple[str, str]]:
        if self._mat is None:
            return []
        q = _bow_vector(query)
        scores = self._mat @ q
        idx = np.argsort(-scores)[:k]
        return [self.chunks[i] for i in idx]


@dataclass
class DesignRetriever:
    """Nearest-neighbour retrieval over the cost DB's featurized designs."""

    db: CostDB

    def retrieve(self, point: Dict, workload: Dict, k: int = 5,
                 arch: Optional[str] = None) -> List[DataPoint]:
        cands = self.db.query(arch=arch) if arch else self.db.all()
        cands = [d for d in cands if d.metrics.get("workload")]
        if not cands:
            return []
        q = featurize(point, workload)
        qn = np.linalg.norm(q) or 1.0
        scored = []
        for d in cands:
            v = featurize(d.point, d.metrics["workload"])
            s = float(v @ q) / ((np.linalg.norm(v) or 1.0) * qn)
            scored.append((s, d))
        scored.sort(key=lambda t: -t[0])
        return [d for _, d in scored[:k]]


def summarize_datapoint(d: DataPoint) -> str:
    """Compact textual 'hardware data point' for the prompt context."""
    m = d.metrics
    if d.status in ("ok", "infeasible"):
        return (f"[{d.status}] {d.arch}/{d.shape} plan={_plan_str(d.point)} "
                f"bound={m.get('bound_s', float('nan')):.3f}s dom={m.get('dominant','-')} "
                f"mem={m.get('per_device_gib', float('nan')):.1f}GiB "
                f"mfu={m.get('mfu_at_bound', 0)*100:.1f}%"
                + (f" NEGATIVE: {d.reason}" if d.negative() else ""))
    return f"[{d.status}] {d.arch}/{d.shape} plan={_plan_str(d.point)} NEGATIVE: {d.reason}"


def _plan_str(point: Dict) -> str:
    keep = {k: v for k, v in point.items() if k != "__key__"}
    return ",".join(f"{k}={v}" for k, v in sorted(keep.items()))
