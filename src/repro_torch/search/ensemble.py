"""Budget-splitting ensemble with bandit-style credit assignment.

Counterpart of ``repro/search/ensemble.py``, copied.

Each iteration the per-iteration evaluation budget is divided among member
strategies in proportion to their credit — an exponentially-decayed count of
incumbent improvements their candidates produced. Because every candidate's
provenance is recorded in the cost DB ``source`` field (``search:<member>``),
the credit ledger is reconstructable offline from the DB alone.

Allocation uses largest-remainder rounding and, when the budget allows,
guarantees every member at least one slot — a standing exploration floor so
a cold strategy can always earn credit back (the classic bandit tension).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

from repro_torch.core.cost_db import CostDB, DataPoint
from repro_torch.search.base import (Candidate, SearchState, SearchStrategy,
                               bound_of, rank_candidates)


@dataclass
class Ensemble:
    """Bandit portfolio over ``members``: per-iteration budget split in
    proportion to exponentially-decayed improvement credit (see module
    docstring). ``warm_start`` rebuilds the ledger from the cell's DB rows
    on first propose, so a resumed campaign keeps its learned allocation.
    Deterministic given deterministic members and a fixed DB."""

    members: List[SearchStrategy]
    name: str = "ensemble"
    decay: float = 0.8    # credit half-life ~3 iterations
    credit: Dict[str, float] = field(default_factory=dict)
    warm_start: bool = True

    _best_seen: Optional[float] = field(default=None, init=False)
    _warmed: bool = field(default=False, init=False)

    def __post_init__(self):
        """Seed a zero-credit ledger entry for every member."""
        for m in self.members:
            self.credit.setdefault(m.name, 0.0)

    # ------------------------------------------------------------------
    def rebuild_credit(self, db: CostDB, arch: str, shape: str,
                       mesh: Optional[str] = None) -> None:
        """Reconstruct the bandit ledger from the cell's DB ``source`` rows.

        Replays :meth:`CostDB.iteration_batches` in order: each recorded
        loop iteration (index >= 1) applies one decay step per iteration
        *gap* (an iteration that recorded no rows still decayed in-memory),
        then every feasible row that improved on the running best credits
        the member named by its ``search:<member>`` provenance tag. The
        first best (the iteration-0 expert seed) earns no credit, matching
        the live allocator. No-op on a cell with no rows. The replayed
        ledger matches the in-memory one exactly when the recorded
        iteration indices are contiguous per attempt; after a mid-cell
        crash the two attempts' same-numbered iterations merge, which
        preserves the learned *allocation* if not bit-exact credit.
        ``mesh`` scopes the replay to one mesh's measurements (a DB re-run
        under a different ``--mesh`` holds both); ``None`` = unscoped."""
        batches = db.iteration_batches(arch, shape, mesh=mesh)
        if not batches:
            return
        credit = {m.name: 0.0 for m in self.members}
        best: Optional[float] = None
        prev_it: Optional[int] = None
        for it, rows in batches:
            if it >= 1:
                steps = 1 if prev_it is None else max(it - prev_it, 1)
                for n in credit:
                    credit[n] *= self.decay ** steps
                prev_it = it
            for d in rows:
                if d.status != "ok" or not d.metrics.get("bound_s"):
                    continue
                b = d.metrics["bound_s"]
                if best is None or b < best:
                    if best is not None:
                        name = d.source.split(":", 1)[-1]
                        if name in credit:
                            credit[name] += 1.0
                    best = b
        self.credit.update(credit)
        if best is not None and (self._best_seen is None
                                 or best < self._best_seen):
            self._best_seen = best

    # ------------------------------------------------------------------
    def allocation(self, budget: int) -> Dict[str, int]:
        """Split ``budget`` proportionally to (1 + credit), largest remainder."""
        if budget <= 0 or not self.members:
            return {m.name: 0 for m in self.members}
        weights = {m.name: 1.0 + self.credit.get(m.name, 0.0) for m in self.members}
        total = sum(weights.values())
        floor = 1 if budget >= len(self.members) else 0
        spendable = budget - floor * len(self.members)
        exact = {n: spendable * w / total for n, w in weights.items()}
        alloc = {n: floor + int(exact[n]) for n in weights}
        # largest remainder, ties broken by member order (deterministic)
        remainders = sorted(weights, key=lambda n: (-(exact[n] - int(exact[n])),
                                                    [m.name for m in self.members].index(n)))
        for n in remainders[: budget - sum(alloc.values())]:
            alloc[n] += 1
        return alloc

    def propose(self, state: SearchState) -> List[Candidate]:
        """Collect each member's share of the iteration budget (allocation
        by credit), deduped against the cell's measured designs and
        surrogate-ranked per member; a member out of novel designs forfeits
        its slots to the others' surplus. On the first call, ``warm_start``
        rebuilds credit from the cell's existing DB rows (resume path)."""
        if not self._warmed:
            self._warmed = True
            if self.warm_start:
                self.rebuild_credit(state.db, state.arch, state.shape,
                                    mesh=state.mesh)
        # credit baseline = the loop's actual incumbent (which includes the
        # expert seed the members never proposed) — beating a stale
        # internal best-seen is not an improvement worth budget
        inc_b = bound_of(state.incumbent)
        if inc_b is not None and (self._best_seen is None
                                  or inc_b < self._best_seen):
            self._best_seen = inc_b
        alloc = self.allocation(state.budget)
        # dedupe against the DB *before* cutting each member to its share —
        # otherwise a member re-proposing already-evaluated designs (greedy
        # around an unchanged incumbent) silently shrinks the iteration.
        # Measured keys only: gate-pruned designs remain proposable.
        seen = set(state.db.keys(state.arch, state.shape,
                                 include_pruned=False))
        out: List[Candidate] = []
        surplus: List[Candidate] = []
        for m in self.members:
            share = alloc.get(m.name, 0)
            if share <= 0:
                continue
            sub = replace(state, budget=share)
            # each member's cut is surrogate-ranked before truncation so a
            # wide proposer (greedy's full neighborhood) spends its share well
            taken = 0
            for c in rank_candidates(sub, m.propose(sub)):
                k = c.point.key()
                if k in seen:
                    continue
                seen.add(k)
                if taken < share:
                    out.append(c)
                    taken += 1
                else:
                    surplus.append(c)
        # a member that ran out of novel designs forfeits its slots to the
        # others' surplus, keeping the evaluation budget fully spent
        out += surplus[: state.budget - len(out)]
        return out

    def observe(self, datapoints: Sequence[DataPoint]) -> None:
        """Decay every member's credit one step, then award +1 to the
        provenance member of each result that improved the best-seen bound;
        finally fan the full batch out to every member (they self-filter).
        The very first best-seen (the expert seed) earns no credit."""
        for name in self.credit:
            self.credit[name] *= self.decay
        for d in datapoints:
            if d.status != "ok" or not d.metrics.get("bound_s"):
                continue
            b = d.metrics["bound_s"]
            if self._best_seen is None or b < self._best_seen:
                if self._best_seen is not None:  # an actual improvement
                    name = d.source.split(":", 1)[-1]
                    if name in self.credit:
                        self.credit[name] += 1.0
                self._best_seen = b
        for m in self.members:
            m.observe(datapoints)
