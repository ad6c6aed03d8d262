"""LLM-guided refinement as a SearchStrategy — wraps the LLM Stack.

Chains from the incumbent AND (paper §3.2.2) the fastest *infeasible* prior
design, so memory-violating near-winners seed memory-fixing refinements.
Unparseable or template-violating responses become ``rejected`` negative
data points appended straight to the DB (never silently dropped).

Counterpart of ``repro/search/llm_guided.py``, copied, with counts of the
valid and rejected proposals.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

from repro_torch.core.cost_db import DataPoint
from repro_torch.core.llm_stack import LLMStack
from repro_torch.search.base import (Candidate, SearchState, best_negative,
                               point_of)


@dataclass
class LLMGuided:
    """LLM-Stack-backed proposal engine (see module docstring). Determinism
    follows the client: exact with the mock LLM, best-effort with a live
    model. Failure mode: an unreachable/garbled LLM yields ``rejected``
    negative data points and an empty candidate list, never an exception."""

    llm_stack: LLMStack
    name: str = "llm"
    # proposals the stack returned over this cell: valid ones became
    # candidates, the others ``rejected`` rows (the CLI reports both)
    n_valid: int = field(default=0, init=False)
    n_rejected: int = field(default=0, init=False)

    def propose(self, state: SearchState) -> List[Candidate]:
        """Ask the stack for refinements of the incumbent and (when one
        exists) the fastest infeasible near-winner; unparseable or
        template-violating responses are appended to the DB as ``rejected``
        rows. Empty until the cell has an incumbent."""
        if state.incumbent is None:
            return []
        seeds = [(point_of(state.incumbent), state.incumbent)]
        neg = best_negative(state.db, state.arch, state.shape, state.incumbent)
        if neg is not None:
            seeds.append((point_of(neg), neg))
        out: List[Candidate] = []
        for pt, dp in seeds:
            valid, rejected, _raw = self.llm_stack.propose(
                state.arch, state.shape, state.cfg, state.cell,
                state.template, pt, dp.metrics, k=max(state.budget, 1))
            state.db.append_many(rejected)
            self.n_valid += len(valid)
            self.n_rejected += len(rejected)
            out += [Candidate(p, f"search:{self.name}") for p in valid]
        return out

    def observe(self, datapoints: Sequence[DataPoint]) -> None:
        """No-op: the stack re-reads the DB (RAG context) on every propose."""
