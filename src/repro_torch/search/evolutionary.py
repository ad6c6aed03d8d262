"""Evolutionary search: tournament selection + uniform crossover over
``PlanPoint.dims`` with per-dimension mutation.

Counterpart of ``repro/search/evolutionary.py``, copied: with the same seed
and the same rows it proposes what the reference proposes.

The population is every feasible design the strategy has observed (seeded
from the cost DB, so a resumed campaign inherits its gene pool), truncated
to the ``pop_size`` fittest (lowest roofline bound). Crossover recombines
dimensions from two tournament-selected parents — the operator the greedy
single-mutation neighborhood structurally lacks. Deterministic given
``seed``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_db import DataPoint
from repro_torch.core.design_space import PlanPoint
from repro_torch.search.base import (Candidate, SearchState, mutate, point_of,
                                     repair, weighted_objective)


@dataclass
class Evolutionary:
    """Tournament-selection + uniform-crossover search (see module
    docstring). Fitness is measured ``bound_s`` (seconds, lower is
    fitter); deterministic given ``seed`` and the iteration index."""

    name: str = "evolve"
    seed: int = 0
    pop_size: int = 8
    tournament: int = 2
    p_mutate: float = 0.3
    # Pareto scalarization arm (see base.WEIGHT_ARMS): None keeps bound_s
    # fitness bit-for-bit; a weight dict breeds toward the weighted
    # log-scale objective instead (scores can be negative: log10 of
    # sub-second bounds, so weighted mode tests ``is not None``, never
    # truthiness).
    weights: Optional[Dict[str, float]] = None

    # key -> (fitness, point); fittest = lowest score
    _pop: Dict[str, Tuple[float, PlanPoint]] = field(default_factory=dict,
                                                     init=False)

    def population(self) -> List[Tuple[float, PlanPoint]]:
        """The ``pop_size`` fittest observed ``(bound_s, point)`` pairs,
        fastest first; empty until a feasible design has been observed or
        seeded from the DB."""
        return sorted(self._pop.values(), key=lambda t: t[0])[: self.pop_size]

    def _fitness(self, d: DataPoint) -> Optional[float]:
        """Fitness score (lower is fitter): raw ``bound_s`` in scalar mode,
        the weighted log-scale objective under a Pareto weight arm."""
        if not self.weights:
            b = d.metrics.get("bound_s")
            return b if b else None
        return weighted_objective(d, self.weights)

    def _seed_population(self, state: SearchState) -> None:
        for d in state.db.query(state.arch, state.shape, "ok"):
            f = self._fitness(d)
            if f is not None:
                self._pop.setdefault(d.point.get("__key__", ""), (f, point_of(d)))

    def _pick(self, pop: List[Tuple[float, PlanPoint]],
              rng: random.Random) -> PlanPoint:
        contenders = [pop[rng.randrange(len(pop))]
                      for _ in range(min(self.tournament, len(pop)))]
        return min(contenders, key=lambda t: t[0])[1]

    def propose(self, state: SearchState) -> List[Candidate]:
        """``budget`` children bred by tournament + uniform crossover (with
        ``p_mutate`` single-dimension mutation), falling back to mutating
        the incumbent or a random sample while the gene pool holds fewer
        than two designs. The population self-seeds from the cell's
        feasible DB rows on first call (resume inherits the gene pool)."""
        if not self._pop:
            self._seed_population(state)
        rng = random.Random(self.seed * 6007 + state.iteration)
        pop = self.population()
        out: List[Candidate] = []
        for _ in range(max(state.budget, 1)):
            if len(pop) < 2:
                # gene pool too thin to cross: fall back to mutating whatever
                # exists (incumbent or a random template sample)
                base = (pop[0][1] if pop else
                        point_of(state.incumbent) if state.incumbent is not None
                        else state.template.random_points(rng, 1)[0])
                child = mutate(state.template, base, rng, 1)
            else:
                p1, p2 = self._pick(pop, rng), self._pick(pop, rng)
                dims = {k: (p1.dims.get(k) if rng.random() < 0.5
                            else p2.dims.get(k, p1.dims.get(k)))
                        for k in p1.dims}
                child = repair(state.template, PlanPoint(dims=dims))
                if rng.random() < self.p_mutate:
                    child = mutate(state.template, child, rng, 1)
            out.append(Candidate(child, f"search:{self.name}"))
        return out

    def observe(self, datapoints: Sequence[DataPoint]) -> None:
        """Add every feasible result to the gene pool (negatives never
        breed); compact the pool when it outgrows 4x ``pop_size``."""
        for d in datapoints:
            if d.status != "ok":
                continue
            f = self._fitness(d)
            if f is not None:
                self._pop[d.point.get("__key__", "")] = (f, point_of(d))
        if len(self._pop) > 4 * self.pop_size:  # bound memory on long runs
            keep = self.population()
            self._pop = {p.key(): (b, p) for b, p in keep}
