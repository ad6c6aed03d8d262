"""Pure decision functions of the promotion ladder (tier-2 policy).

Counterpart of ``repro/core/promotion.py``, copied: which leaderboard
heads (scalar or Pareto) earn a measured run, and which duplicate measured
row is canonical. Pure functions: no clock, no
RNG, no I/O.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Set

from repro_torch.core.cost_db import DataPoint


def plan_promotions(heads: Sequence[DataPoint], measured_keys: Set[str], *,
                    top_k: int, budget_left: Optional[int] = None,
                    ) -> List[DataPoint]:
    """Pick which leaderboard heads earn a tier-2 measurement.

    ``heads`` come best-first (``CostDB.winners``); anything already
    measured (``measured_keys`` holds point ``__key__`` values) is skipped.
    At most ``top_k`` promotions, and never more than ``budget_left`` when
    a campaign-wide budget is in force."""
    if top_k <= 0:
        return []
    chosen: List[DataPoint] = []
    seen: Set[str] = set()
    for d in heads:
        key = d.point.get("__key__")
        if not key or key in measured_keys or key in seen:
            continue
        seen.add(key)
        chosen.append(d)
        if len(chosen) >= top_k:
            break
    if budget_left is not None:
        chosen = chosen[:max(int(budget_left), 0)]
    return chosen


def plan_front_promotions(front: Sequence[DataPoint],
                          measured_keys: Set[str], *, top_k: int,
                          budget_left: Optional[int] = None,
                          ) -> List[DataPoint]:
    """Front-rank promotion plan for ``--objective pareto``: the same
    dedupe/cap/budget contract as :func:`plan_promotions`, but ``front``
    comes in deterministic Pareto order (``CostDB.front``: rank, then
    crowding, boundary points first), so measured execution covers the
    front's extremes and spread instead of re-measuring the scalar head's
    neighborhood."""
    return plan_promotions(front, measured_keys, top_k=top_k,
                           budget_left=budget_left)


def select_measured_row(rows: Iterable[DataPoint]) -> Optional[DataPoint]:
    """The canonical measured row among duplicates: earliest-wins by
    ``(ts, serialized form)``, so any subset of the same rows reports the
    same measurement. ``None`` when ``rows`` is empty."""
    best: Optional[DataPoint] = None
    best_key = None
    for d in rows:
        k = (d.ts, d.to_json())
        if best is None or k < best_key:
            best, best_key = d, k
    return best
