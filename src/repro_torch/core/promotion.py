"""Pure decision function of the promotion ladder (tier-2 policy).

Counterpart of ``repro/core/promotion.py``, copied with what the
kernel-cell path uses: which leaderboard heads earn a measured run, and
which duplicate measured row is canonical. Pure functions: no clock, no
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
