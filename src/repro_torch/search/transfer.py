"""Cross-workload transfer search: seed a cell from similar finished cells.

LLM-DSE (arXiv:2505.12188) and iDSE (arXiv:2505.22086) both attribute their
edge over blind search to *reusing prior-design context*. This strategy makes
that a first-class proposal engine: a new cell's initial population is
transplanted from the **winners** of the most similar already-explored cells
in the shared cost DB, ranked by the same featurized cosine similarity RAG
retrieval uses (:mod:`repro_torch.core.rag`). Donor designs are *adapted* into the
target cell's device-aware template — dimensions whose donor value is illegal
here snap to the expert baseline preference — so a transplant is always a
valid candidate, never a template rejection.

After the transplants are spent, the strategy polishes: it mutates around the
best design it has personally produced (or the loop incumbent), so it keeps
earning budget in an :class:`~repro_torch.search.ensemble.Ensemble` portfolio after
the seeding phase.

Determinism: given a fixed DB file, seed, and iteration, proposals are fully
deterministic (donor ties break lexicographically, mutations use a seeded
RNG). Note the caveat this implies for sharded campaigns: the *shared DB* a
cell sees depends on which cells ran before it in the same process, so a
sharded run with transfer enabled may legitimately explore differently than a
single-process run — byte-identical shard/merge reproduction is only
guaranteed for the transfer-free strategies (see docs/architecture.md).

Counterpart of ``repro/search/transfer.py``, copied.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.cost_db import DataPoint, featurize
from repro_torch.core.design_space import PlanPoint, PlanTemplate, baseline_point
from repro_torch.search.base import (Candidate, SearchState, mutate, point_of,
                               repair)


def adapt_point(template: PlanTemplate, point: PlanPoint,
                fallback: Optional[PlanPoint] = None) -> Optional[PlanPoint]:
    """Project a donor-cell design into ``template``'s legal ranges.

    Every template dimension takes the donor's value when legal here,
    otherwise the ``fallback`` (expert baseline) value, otherwise the first
    legal value; donor-only dimensions are dropped. The result is repaired
    for cross-dimension constraints and re-validated — returns ``None`` if
    even the repaired point is illegal (the caller must skip it), so this
    function never emits a template rejection."""
    legal = template.dims()
    fb = fallback.dims if fallback is not None else {}
    dims = {}
    for k, vals in legal.items():
        v = point.dims.get(k)
        if v not in vals:
            v = fb.get(k) if fb.get(k) in vals else vals[0]
        dims[k] = v
    p = repair(template, PlanPoint(dims=dims))
    ok, _ = template.validate(p)
    return p if ok else None


@dataclass
class TransferSeeded:
    """Transfer-seeded search over the shared campaign DB.

    ``k_donor_cells`` similar cells each contribute their ``per_donor``
    fastest feasible designs as the initial population; later iterations
    mutate around the best own result. Stateful per cell (donor scouting
    happens once, on first :meth:`propose`) — campaigns must construct a
    fresh instance per cell, like every other strategy."""

    name: str = "transfer"
    seed: int = 0
    k_donor_cells: int = 3
    per_donor: int = 2

    _seeds: List[PlanPoint] = field(default_factory=list, init=False)
    _scouted: bool = field(default=False, init=False)
    _proposed: Set[str] = field(default_factory=set, init=False)
    _best_own: Optional[Tuple[PlanPoint, float]] = field(default=None,
                                                         init=False)

    # ------------------------------------------------------------------
    def donor_cells(self, state: SearchState) -> List[Tuple[float, str, str]]:
        """Similarity-ranked ``(cosine, arch, shape)`` donor cells.

        A donor is any *other* cell in the DB holding at least one feasible
        measured design on this cell's mesh (unscoped when ``state.mesh`` is
        None — a cross-mesh bound is not comparable). Similarity is cosine
        over the shared featurization of the cells' workload context (the
        vector RAG retrieval uses), so e.g. decode cells prefer decode
        donors. Ties break lexicographically by (arch, shape) —
        deterministic for a fixed DB."""
        me = (state.arch, state.shape)
        q = featurize({}, state.workload)
        qn = float(np.linalg.norm(q)) or 1.0
        donors = {}
        for d in state.db.all():
            cell = (d.arch, d.shape)
            if cell == me or cell in donors or d.status != "ok":
                continue
            if state.mesh is not None and d.mesh != state.mesh:
                continue
            wl = d.metrics.get("workload")
            if wl and d.metrics.get("bound_s"):
                donors[cell] = wl
        scored = []
        for (a, s), wl in donors.items():
            v = featurize({}, wl)
            sim = float(v @ q) / ((float(np.linalg.norm(v)) or 1.0) * qn)
            scored.append((sim, a, s))
        scored.sort(key=lambda t: (-t[0], t[1], t[2]))
        return scored[: self.k_donor_cells]

    def _transplants(self, state: SearchState) -> List[PlanPoint]:
        """Adapted winner designs from the donor cells, best donors first,
        deduplicated by design key (donors often share a winning plan)."""
        fb = baseline_point(state.cell, state.template)
        out: List[PlanPoint] = []
        seen: Set[str] = set()
        for _sim, a, s in self.donor_cells(state):
            for w in state.db.winners(a, s, k=self.per_donor,
                                      mesh=state.mesh):
                p = adapt_point(state.template, point_of(w), fb)
                if p is not None and p.key() not in seen:
                    seen.add(p.key())
                    out.append(p)
        return out

    # ------------------------------------------------------------------
    def propose(self, state: SearchState) -> List[Candidate]:
        """Un-spent transplants first, then seeded mutations around the best
        own result (or the incumbent; random template samples when neither
        exists). Always returns exactly ``max(state.budget, 1)`` candidates;
        with an empty DB it degrades to deterministic random exploration."""
        if not self._scouted:
            self._scouted = True
            self._seeds = self._transplants(state)
        budget = max(state.budget, 1)
        out: List[Candidate] = []
        while self._seeds and len(out) < budget:
            out.append(Candidate(self._seeds.pop(0), f"search:{self.name}"))
        rng = random.Random(self.seed * 9173 + state.iteration)
        base = (self._best_own[0] if self._best_own is not None
                else point_of(state.incumbent)
                if state.incumbent is not None else None)
        for _ in range(budget - len(out)):
            p = (mutate(state.template, base, rng, 1) if base is not None
                 else state.template.random_points(rng, 1)[0])
            out.append(Candidate(p, f"search:{self.name}"))
        for c in out:
            self._proposed.add(c.point.key())
        return out

    def observe(self, datapoints: Sequence[DataPoint]) -> None:
        """Adopt the fastest feasible *own-proposed* result as the next
        mutation base. Results from other strategies are ignored — the
        transplanted lineage is what this engine is credited for."""
        mine = [d for d in datapoints
                if d.point.get("__key__") in self._proposed
                and d.status == "ok" and d.metrics.get("bound_s")]
        if not mine:
            return
        best = min(mine, key=lambda d: d.metrics["bound_s"])
        b = best.metrics["bound_s"]
        if self._best_own is None or b < self._best_own[1]:
            self._best_own = (point_of(best), b)
