"""Search strategies for the DSE loop (counterpart of ``repro/search``).

``make_strategy`` builds a registered strategy by name; ``--strategy`` on
``repro_torch.launch.dse`` and ``repro_torch.launch.campaign`` resolve
through it. The surrogate gate and the promotion ladder filter and
promote what the strategies propose.
"""
from __future__ import annotations

from repro_torch.search.annealing import SimulatedAnnealing
from repro_torch.search.base import (WEIGHT_ARMS, Candidate, SearchState,
                                     SearchStrategy, best_negative, bound_of,
                                     point_of, rank_candidates,
                                     select_candidates, weighted_objective)
from repro_torch.search.ensemble import Ensemble
from repro_torch.search.evolutionary import Evolutionary
from repro_torch.search.gate import SurrogateGate
from repro_torch.search.greedy import GreedyNeighborhood
from repro_torch.search.ladder import (PromotionLadder, plan_promotions,
                                       select_measured_row)
from repro_torch.search.llm_guided import LLMGuided
from repro_torch.search.transfer import TransferSeeded

STRATEGIES = ("greedy", "llm", "anneal", "evolve", "transfer", "ensemble",
              "ensemble+transfer")


def make_strategy(name: str, *, llm_stack=None, seed: int = 0,
                  objective: str = "bound_s") -> SearchStrategy:
    """Build a fresh strategy instance (strategies carry per-cell state:
    campaigns construct one per cell).

    ``"ensemble"`` is the transfer-free bandit portfolio: greedy, the LLM
    member (when an ``llm_stack`` is given), anneal and evolve, in that
    order. ``"ensemble+transfer"`` adds the cross-workload
    :class:`~repro_torch.search.transfer.TransferSeeded` member, trading
    byte-reproducible shard merges for warm starts from similar cells.

    ``objective="pareto"`` makes proposals cover the front instead of
    chasing one scalar head: ``anneal`` and ``evolve`` scalarize through
    the ``balanced`` :data:`~repro_torch.search.base.WEIGHT_ARMS` vector,
    and the ensemble gains four weight-armed members (``anneal@latency``,
    ``anneal@memory``, ``evolve@latency``, ``evolve@memory``) so the bandit
    learns *which region of the front* pays; each arm's name rides into
    DB provenance (``search:anneal@memory``). ``objective="bound_s"``
    (default) minimizes ``bound_s``. Raises ``ValueError`` for an unknown
    objective or name, or for ``"llm"`` without an ``llm_stack``."""
    if objective not in ("bound_s", "pareto"):
        raise ValueError(f"unknown objective {objective!r}; "
                         f"have ('bound_s', 'pareto')")
    pareto = objective == "pareto"
    balanced = WEIGHT_ARMS["balanced"] if pareto else None
    if name == "greedy":
        return GreedyNeighborhood(seed=seed)
    if name == "llm":
        if llm_stack is None:
            raise ValueError("strategy 'llm' needs llm_stack=")
        return LLMGuided(llm_stack)
    if name == "anneal":
        return SimulatedAnnealing(seed=seed, weights=balanced)
    if name == "evolve":
        return Evolutionary(seed=seed, weights=balanced)
    if name == "transfer":
        return TransferSeeded(seed=seed)
    if name in ("ensemble", "ensemble+transfer"):
        members: list = [GreedyNeighborhood(seed=seed)]
        if llm_stack is not None:
            members.append(LLMGuided(llm_stack))
        members += [SimulatedAnnealing(seed=seed, weights=balanced),
                    Evolutionary(seed=seed, weights=balanced)]
        if pareto:
            # weight-armed walkers: distinct deterministic seed offsets so
            # each arm explores its own trajectory; names carry the arm
            # into provenance for the bandit's offline credit rebuild
            members += [
                SimulatedAnnealing(name="anneal@latency", seed=seed + 11,
                                   weights=WEIGHT_ARMS["latency"]),
                SimulatedAnnealing(name="anneal@memory", seed=seed + 12,
                                   weights=WEIGHT_ARMS["memory"]),
                Evolutionary(name="evolve@latency", seed=seed + 13,
                             weights=WEIGHT_ARMS["latency"]),
                Evolutionary(name="evolve@memory", seed=seed + 14,
                             weights=WEIGHT_ARMS["memory"]),
            ]
        if name == "ensemble+transfer":
            members.append(TransferSeeded(seed=seed))
        return Ensemble(members)
    raise ValueError(f"unknown strategy {name!r}; have {STRATEGIES}")


__all__ = [
    "Candidate", "SearchState", "SearchStrategy", "STRATEGIES",
    "WEIGHT_ARMS", "GreedyNeighborhood", "LLMGuided", "SimulatedAnnealing",
    "Evolutionary", "TransferSeeded", "Ensemble",
    "SurrogateGate", "PromotionLadder", "plan_promotions",
    "select_measured_row", "make_strategy", "best_negative", "bound_of",
    "point_of", "rank_candidates", "select_candidates", "weighted_objective",
]
