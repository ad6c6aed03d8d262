"""Simulated annealing over the design template (iDSE-style policy diversity).

Counterpart of ``repro/search/annealing.py``, copied: with the same seed
and the same rows it proposes what the reference proposes.

Keeps one walker. Proposal radius (number of mutated dimensions) scales with
temperature: hot walkers take multi-dimension jumps, cold walkers settle into
single-dimension polishing (the greedy limit). Acceptance is Metropolis on
``log10(bound_s)`` — a worse design is adopted with probability
``exp(-delta_decades / T)`` — so early iterations can cross roofline valleys
the greedy policy cannot. Fully deterministic given ``seed``.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.cost_db import DataPoint
from repro_torch.core.design_space import PlanPoint
from repro_torch.search.base import (Candidate, SearchState, bound_of, mutate,
                                     point_of, weighted_objective)


@dataclass
class SimulatedAnnealing:
    """Single-walker Metropolis search over the plan template (see module
    docstring). Temperatures are in decades of log10(bound_s); cooling is
    geometric per :meth:`observe` call. Deterministic given ``seed``."""

    name: str = "anneal"
    seed: int = 0
    t0: float = 0.5       # initial temperature, in log10-bound decades
    alpha: float = 0.85   # geometric cooling per observe()
    t_min: float = 0.02
    # Pareto scalarization arm (see base.WEIGHT_ARMS): None keeps the
    # classic bound_s walker bit-for-bit; a weight dict makes the walker
    # descend the weighted log-scale objective instead, same Metropolis
    # rule (weighted scores are already in decades, so deltas subtract
    # directly where the scalar path takes log10 of raw bounds).
    weights: Optional[Dict[str, float]] = None

    _temp: float = field(init=False)
    _current: Optional[Tuple[PlanPoint, float]] = field(default=None, init=False)
    _proposed: Set[str] = field(default_factory=set, init=False)
    _rng: random.Random = field(init=False)

    def __post_init__(self):
        """Initialise the walker temperature and the acceptance RNG."""
        self._temp = self.t0
        self._rng = random.Random(self.seed * 7919 + 17)

    @property
    def temperature(self) -> float:
        """Current walker temperature in log10(bound_s) decades; cools
        geometrically toward ``t_min`` with every observed iteration."""
        return self._temp

    def propose(self, state: SearchState) -> List[Candidate]:
        """``budget`` mutations of the walker position (adopted from the
        incumbent on first call): hot walkers mutate up to 3 dimensions,
        cold walkers exactly 1. Falls back to random template samples when
        the cell has no incumbent yet. Deterministic per iteration."""
        if self._current is None:
            inc_b = self._score(state.incumbent)
            if state.incumbent is not None and inc_b is not None:
                self._current = (point_of(state.incumbent), inc_b)
        base = (self._current[0] if self._current is not None
                else point_of(state.incumbent) if state.incumbent is not None
                else None)
        rng = random.Random(self.seed * 7919 + state.iteration)
        out: List[Candidate] = []
        for _ in range(max(state.budget, 1)):
            if base is None:
                p = state.template.random_points(rng, 1)[0]
            else:
                # hot -> up to 3 mutated dims, cold -> exactly 1
                n_dims = 1 + sum(rng.random() < self._temp / self.t0
                                 for _ in range(2))
                p = mutate(state.template, base, rng, n_dims)
            self._proposed.add(p.key())
            out.append(Candidate(p, f"search:{self.name}"))
        return out

    def _score(self, dp: Optional[DataPoint]) -> Optional[float]:
        """The walker's objective for a row: raw ``bound_s`` seconds in
        scalar mode (acceptance takes log10 at delta time), or the weighted
        log-scale objective when a Pareto weight arm is set."""
        if not self.weights:
            return bound_of(dp)
        return weighted_objective(dp, self.weights)

    def observe(self, datapoints: Sequence[DataPoint]) -> None:
        """Metropolis step on the fastest own-proposed feasible result — a
        better design always moves the walker, a worse one moves it with
        probability ``exp(-delta_decades / T)`` — then cool one step.
        Results this walker never proposed are ignored."""
        mine = [d for d in datapoints
                if d.point.get("__key__") in self._proposed
                and d.status == "ok" and d.metrics.get("bound_s")]
        if mine and not self.weights:
            cand = min(mine, key=lambda d: d.metrics["bound_s"])
            b = cand.metrics["bound_s"]
            if self._current is None:
                self._current = (point_of(cand), b)
            else:
                delta = math.log10(b) - math.log10(self._current[1])
                if delta <= 0 or self._rng.random() < math.exp(-delta / max(self._temp, 1e-9)):
                    self._current = (point_of(cand), b)
        elif mine:
            scored = [(s, d) for d in mine
                      if (s := self._score(d)) is not None]
            if scored:
                s, cand = min(scored, key=lambda t: t[0])
                if self._current is None:
                    self._current = (point_of(cand), s)
                else:
                    # weighted scores are already log-scale decades
                    delta = s - self._current[1]
                    if delta <= 0 or self._rng.random() < math.exp(
                            -delta / max(self._temp, 1e-9)):
                        self._current = (point_of(cand), s)
        self._temp = max(self._temp * self.alpha, self.t_min)
