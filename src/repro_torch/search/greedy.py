"""Greedy incumbent-neighborhood search (counterpart of
``repro/search/greedy.py``).

Proposes all single-dimension mutations of the incumbent (the template's
device-aware permutation set) plus a few random template samples for
diversity (paper §3.2.2). Stateless: the loop's incumbent pool IS its state.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core.cost_db import DataPoint
from repro_torch.search.base import Candidate, SearchState, point_of


@dataclass
class GreedyNeighborhood:
    """Exhaustive single-dimension mutations of the incumbent plus
    ``n_random`` random template samples. Stateless and deterministic
    given ``seed`` and the iteration index."""

    name: str = "greedy"
    seed: int = 0
    n_random: int = 1

    def propose(self, state: SearchState) -> List[Candidate]:
        """The incumbent's full device-legal neighborhood (empty when the
        cell has no incumbent yet) plus ``n_random`` repaired random
        samples."""
        rng = random.Random(self.seed + state.iteration)
        out: List[Candidate] = []
        if state.incumbent is not None:
            out += [Candidate(p, f"search:{self.name}")
                    for p in state.template.neighbors(point_of(state.incumbent))]
        out += [Candidate(p, f"search:{self.name}")
                for p in state.template.random_points(rng, self.n_random)]
        return out

    def observe(self, datapoints: Sequence[DataPoint]) -> None:
        """No-op: greedy state lives in the loop's incumbent pool."""
