"""Pluggable search-strategy protocol (SECDA-DSE's interchangeable engines).

Counterpart of ``repro/search/base.py``, copied. A :class:`SearchStrategy`
is anything with

    propose(state)  -> candidates to evaluate this iteration
    observe(dps)    -> ingest the evaluated results (positive AND negative)

The loop owns dedupe, surrogate ranking, evaluation and DB appends;
strategies only decide *where to look next*. Every candidate carries a
provenance ``source`` tag that lands in the cost DB's ``source`` field.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.cost_db import (MAXIMIZE_OBJECTIVES, CostDB, DataPoint,
                                      featurize, objectives_of)
from repro_torch.core.design_space import KernelTemplate, PlanPoint, PlanTemplate


# Named scalarization-weight vectors for Pareto search: each arm turns the
# objective vector into one weighted log-scale score, so the single-score
# walkers (anneal, evolve) can sweep different regions of the front
# without a new acceptance rule. Keys index into a row's ``objectives``
# dict; keys a row lacks (plan vs kernel vectors differ) are skipped and
# the weights renormalized, so one arm table serves both design spaces.
# Under ``--objective pareto`` the Ensemble runs these as extra bandit
# members (``anneal@memory`` etc.), and the arm name lands in DB
# provenance via the member name.
WEIGHT_ARMS: Dict[str, Dict[str, float]] = {
    "latency": {"bound_s": 1.0},
    "memory": {"bound_s": 1.0, "hbm_bytes": 1.0, "vmem_bytes": 1.0,
               "vmem_util": 1.0},
    "balanced": {"bound_s": 1.0, "hbm_bytes": 0.5, "vmem_bytes": 0.5,
                 "vmem_util": 0.5, "flops_util": 0.5},
}

def weighted_objective(dp: Optional[DataPoint],
                       weights: Optional[Dict[str, float]],
                       ) -> Optional[float]:
    """One weighted scalar score (lower is better) for a feasible row's
    objective vector: the weight-normalized sum of ``log10`` objective
    values, maximize-sense objectives negated. ``None``/empty weights, or
    a row whose objectives carry none of the weighted keys, fall back to
    :func:`bound_of`; missing/failed rows return ``None``."""
    if dp is None or dp.status != "ok":
        return None
    if not weights:
        return bound_of(dp)
    objs = objectives_of(dp)
    total = wsum = 0.0
    for k in sorted(weights):
        v = objs.get(k)
        if v is None or not v > 0:
            continue
        term = math.log10(v)
        if k in MAXIMIZE_OBJECTIVES:
            term = -term
        total += weights[k] * term
        wsum += weights[k]
    if wsum == 0.0:
        return bound_of(dp)
    return total / wsum


@dataclass(frozen=True)
class Candidate:
    """A proposed design plus its provenance (recorded as DB ``source``)."""

    point: PlanPoint
    source: str


@dataclass
class SearchState:
    """Read-only view of the loop's state handed to strategies each iteration."""

    arch: str
    shape: str
    cfg: Any
    cell: Any
    template: PlanTemplate | KernelTemplate
    db: CostDB
    iteration: int
    budget: int
    incumbent: Optional[DataPoint]
    pool: List[DataPoint] = field(default_factory=list)
    cost_model: Any = None  # Optional[CostModel]
    workload: Dict[str, float] = field(default_factory=dict)
    # the evaluator's mesh name, for mesh-scoped DB lookups
    mesh: Optional[str] = None


@runtime_checkable
class SearchStrategy(Protocol):
    """propose(state) -> candidates; observe(datapoints) -> None."""

    name: str

    def propose(self, state: SearchState) -> List[Candidate]:
        """Return candidate designs for this iteration. May over-propose:
        the loop dedupes against measured DB keys, surrogate-ranks, and
        truncates to ``state.budget``. Must be deterministic given the
        strategy's seed, the state, and the DB contents."""
        ...

    def observe(self, datapoints: Sequence[DataPoint]) -> None:
        """Ingest every evaluated result of the iteration. Called exactly
        once per loop iteration, after the batch lands in the DB."""
        ...


def point_of(dp: DataPoint) -> PlanPoint:
    """A DataPoint's design, stripped of the derived ``__key__`` entry."""
    return PlanPoint(dims={k: v for k, v in dp.point.items() if k != "__key__"})


def bound_of(dp: Optional[DataPoint]) -> Optional[float]:
    """The modelled bound in seconds, or ``None`` for a missing, failed or
    infeasible data point."""
    if dp is None or dp.status != "ok":
        return None
    return dp.metrics.get("bound_s")


def best_negative(db: CostDB, arch: str, shape: str,
                  incumbent: DataPoint) -> Optional[DataPoint]:
    """Fastest *infeasible* design that beats the incumbent's bound: the
    paper's negative-datapoint chaining seed."""
    inc = incumbent.metrics.get("bound_s") or float("inf")
    neg = [d for d in db.query(arch, shape, "infeasible")
           if d.metrics.get("bound_s") and d.metrics["bound_s"] < 0.9 * inc]
    return min(neg, key=lambda d: d.metrics["bound_s"]) if neg else None


def rank_candidates(state: SearchState,
                    cands: Sequence[Candidate]) -> List[Candidate]:
    """Surrogate pre-ranking (cheapest-predicted-bound first); insertion
    order when the model is absent or untrained."""
    cm = state.cost_model
    if cm is None or not getattr(cm, "trained", False) or not cands:
        return list(cands)
    feats = np.stack([featurize(dict(c.point.dims), state.workload)
                      for c in cands])
    order = cm.rank_candidates(feats)
    return [cands[i] for i in order]


def select_candidates(state: SearchState, cands: Sequence[Candidate],
                      ) -> List[Candidate]:
    """Dedupe against the cell's *measured* design keys and in-batch,
    surrogate-rank, truncate to the iteration budget."""
    seen = state.db.keys(state.arch, state.shape, include_pruned=False)
    uniq: Dict[str, Candidate] = {}
    for c in cands:
        k = c.point.key()
        if k not in seen and k not in uniq:
            uniq[k] = c
    return rank_candidates(state, list(uniq.values()))[: state.budget]


def repair(template: PlanTemplate | KernelTemplate, point: PlanPoint) -> PlanPoint:
    """Template-delegated candidate repair: each design space owns its own
    cross-dimension fixes (``PlanTemplate.repair`` drops a clashing
    microbatch count to 1; ``KernelTemplate.repair`` snaps to the pools and
    shrinks tiles until the block fits the card), so the strategies stay
    design-space-agnostic."""
    return template.repair(point)


def mutate(template: PlanTemplate | KernelTemplate, point: PlanPoint, rng: random.Random,
           n_dims: int = 1) -> PlanPoint:
    """Mutate ``n_dims`` randomly-chosen dimensions to random legal values
    (the reference's draws, in the reference's order)."""
    legal = template.dims()
    keys = sorted(legal)
    dims = dict(point.dims)
    for k in rng.sample(keys, min(n_dims, len(keys))):
        pool = [v for v in legal[k] if v != dims.get(k)] or list(legal[k])
        dims[k] = pool[rng.randrange(len(pool))]
    return repair(template, PlanPoint(dims=dims))
