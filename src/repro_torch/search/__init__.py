"""Search strategies for the DSE loop (counterpart of ``repro/search``).

``make_strategy`` builds a registered strategy by name. This slice ports
``greedy``; anneal, evolve, ensemble, the surrogate gate and the promotion
ladder come later.
"""
from __future__ import annotations

from repro_torch.search.base import (Candidate, SearchState, SearchStrategy,
                                     point_of, rank_candidates,
                                     select_candidates)
from repro_torch.search.greedy import GreedyNeighborhood

STRATEGIES = ("greedy",)


def make_strategy(name: str, *, seed: int = 0) -> SearchStrategy:
    """Build a fresh strategy instance (strategies carry per-cell state).
    Raises ``ValueError`` for a name this package does not have."""
    if name == "greedy":
        return GreedyNeighborhood(seed=seed)
    raise ValueError(f"unknown strategy {name!r}; have {STRATEGIES} "
                     f"(the others are not yet ported)")


__all__ = [
    "Candidate", "SearchState", "SearchStrategy", "STRATEGIES",
    "GreedyNeighborhood", "make_strategy", "point_of",
    "rank_candidates", "select_candidates",
]
