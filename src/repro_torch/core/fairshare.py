"""Fair-share scheduling policy for the DSE service control plane.

Counterpart of ``repro/core/fairshare.py``, copied.

The service daemon (``repro_torch.launch.service``) multiplexes a bounded pool
of campaign workers across tenants. Every scheduling decision is made by
the pure functions here — the daemon feeds them a snapshot of tenant
state and applies the returned grants — so fairness is unit-testable and
replayable without booting an HTTP server or spawning workers (the same
pattern as ``plan_steals`` in the orchestrator; both are registered in
the RPR003 purity registry).

Policy: weighted round-robin with deficit credits. Each grant round,
every *eligible* tenant (non-empty backlog, under its worker cap and
cell budget) earns credit proportional to its priority; the tenant with
the highest accumulated credit wins the slot and pays ``1.0`` for it.
Credits persist across scheduler ticks, so a tenant that was skipped
while the pool was full catches up once slots free — a stalled tenant
cannot starve the others, and a high-priority tenant gets proportionally
more workers, not all of them.

Budget accounting is in *cells*: a tenant's submissions stop being
scheduled once the cells it has completed reach its declared budget.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class TenantSnapshot:
    """One tenant's state as seen by a scheduler tick."""
    name: str
    priority: int = 1          # >= 1; relative worker share
    backlog: int = 0           # pending + leased cells in the tenant queue
    workers: int = 0           # currently running workers
    cells_done: int = 0        # completed cells (budget accounting)
    budget_cells: Optional[int] = None  # None = unlimited
    credit: float = 0.0        # deficit carried across ticks
    stalled: bool = False      # no heartbeat progress; earns no new credit


@dataclass
class GrantPlan:
    """Result of one scheduler tick: which tenants get a new worker, and
    the credit ledger to carry into the next tick."""
    grants: List[str] = field(default_factory=list)
    credits: Dict[str, float] = field(default_factory=dict)


def budget_left(budget_cells: Optional[int], cells_done: int) -> Optional[int]:
    """Remaining cell budget (None = unlimited, floor 0)."""
    if budget_cells is None:
        return None
    return max(0, budget_cells - cells_done)


def over_budget(budget_cells: Optional[int], cells_done: int) -> bool:
    """True once a tenant has exhausted its declared cell budget."""
    left = budget_left(budget_cells, cells_done)
    return left is not None and left <= 0


def _eligible(t: TenantSnapshot, extra_workers: int,
              max_workers_per_tenant: int) -> bool:
    if t.backlog <= 0 or over_budget(t.budget_cells, t.cells_done):
        return False
    granted = t.workers + extra_workers
    # one worker per backlog cell is the useful ceiling; the per-tenant
    # cap bounds how much of the pool a single tenant may hold
    return granted < min(t.backlog, max_workers_per_tenant)


def plan_worker_grants(tenants: Sequence[TenantSnapshot], free_slots: int,
                       max_workers_per_tenant: int = 2) -> GrantPlan:
    """Deficit-weighted round-robin: assign up to ``free_slots`` workers.

    Pure function of its inputs — no clock, no RNG; ties break on
    (priority, name) so the grant order is deterministic for any
    permutation of ``tenants``.
    """
    order = sorted(tenants, key=lambda t: (-t.priority, t.name))
    credits = {t.name: t.credit for t in order}
    granted: Dict[str, int] = {t.name: 0 for t in order}
    grants: List[str] = []
    for _ in range(max(0, free_slots)):
        eligible = [t for t in order
                    if not t.stalled
                    and _eligible(t, granted[t.name],
                                  max_workers_per_tenant)]
        if not eligible:
            break
        total = sum(t.priority for t in eligible)
        for t in eligible:
            credits[t.name] += t.priority / total
        # max() keeps the first maximum, so ties fall back to the sorted
        # (-priority, name) order — deterministic for any input permutation
        winner = max(eligible, key=lambda t: (credits[t.name], t.priority))
        credits[winner.name] -= 1.0
        granted[winner.name] += 1
        grants.append(winner.name)
    return GrantPlan(grants=grants, credits=credits)


__all__ = ["TenantSnapshot", "GrantPlan", "budget_left", "over_budget",
           "plan_worker_grants"]
