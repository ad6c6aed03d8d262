"""Search strategies for the DSE loop (counterpart of ``repro/search``).

``make_strategy`` builds a registered strategy by name; ``--strategy`` on
``repro_torch.launch.dse`` resolves through it. The surrogate gate and the
promotion ladder filter and promote what the strategies propose.
"""
from __future__ import annotations

from repro_torch.search.annealing import SimulatedAnnealing
from repro_torch.search.base import (Candidate, SearchState, SearchStrategy,
                                     best_negative, bound_of, point_of,
                                     rank_candidates, select_candidates,
                                     weighted_objective)
from repro_torch.search.ensemble import Ensemble
from repro_torch.search.evolutionary import Evolutionary
from repro_torch.search.gate import SurrogateGate
from repro_torch.search.greedy import GreedyNeighborhood
from repro_torch.search.ladder import (PromotionLadder, plan_promotions,
                                       select_measured_row)

STRATEGIES = ("greedy", "anneal", "evolve", "ensemble")


def make_strategy(name: str, *, seed: int = 0) -> SearchStrategy:
    """Build a fresh strategy instance (strategies carry per-cell state).

    ``"ensemble"`` is the reference's transfer-free bandit portfolio
    without its LLM member: greedy, anneal and evolve, in that order.
    Every strategy minimizes ``bound_s``. Raises ``ValueError`` for a
    name this package does not have."""
    if name == "greedy":
        return GreedyNeighborhood(seed=seed)
    if name == "anneal":
        return SimulatedAnnealing(seed=seed)
    if name == "evolve":
        return Evolutionary(seed=seed)
    if name == "ensemble":
        return Ensemble([GreedyNeighborhood(seed=seed),
                         SimulatedAnnealing(seed=seed), Evolutionary(seed=seed)])
    raise ValueError(f"unknown strategy {name!r}; have {STRATEGIES}")


__all__ = [
    "Candidate", "SearchState", "SearchStrategy", "STRATEGIES",
    "GreedyNeighborhood", "SimulatedAnnealing", "Evolutionary", "Ensemble",
    "SurrogateGate", "PromotionLadder", "plan_promotions",
    "select_measured_row", "make_strategy", "best_negative", "bound_of",
    "point_of", "rank_candidates", "select_candidates", "weighted_objective",
]
