"""Pareto dominance, non-dominated sorting, and deterministic front order.

Counterpart of ``repro/core/pareto.py``, copied. Under ``--objective
pareto`` designs rank by an *objective vector* (see
``repro_torch.core.cost_db.derive_objectives``) instead of the scalar
``bound_s``. Every function here is a pure function of its arguments (no
wall clock, no RNG), because merged Pareto leaderboards must stay
byte-identical under any shard order, queue kill, or steal, exactly like
the scalar ones.

Conventions:

* every objective is **minimized**: callers negate maximize-objectives
  before building vectors (``cost_db.MAXIMIZE_OBJECTIVES``);
* vectors within one ranking call must share one dimensionality and one
  key order (``cost_db.pareto_rows`` aligns them over the sorted union of
  objective keys, missing values -> ``+inf``);
* the deterministic total order is ``(rank, -crowding, tiebreak)`` where
  the tiebreak is ``(ts, serialized row)``: two DBs holding the same
  rows in any order produce the same front, byte for byte.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

Vector = Sequence[float]

_INF = float("inf")


def dominates(a: Vector, b: Vector) -> bool:
    """True when ``a`` Pareto-dominates ``b``: no worse in every objective
    and strictly better in at least one (minimization). Equal vectors never
    dominate each other."""
    better = False
    for x, y in zip(a, b):
        if x > y:
            return False
        if x < y:
            better = True
    return better


def front_ranks(vectors: Sequence[Vector]) -> List[int]:
    """Non-dominated sorting: rank 0 is the Pareto front, rank 1 the front
    of what remains after peeling rank 0, and so on. O(n^2) per peel —
    campaign cells hold tens of designs, not millions. Duplicated vectors
    share a rank (neither dominates the other)."""
    n = len(vectors)
    ranks = [-1] * n
    remaining = list(range(n))
    rank = 0
    while remaining:
        front = [i for i in remaining
                 if not any(dominates(vectors[j], vectors[i])
                            for j in remaining if j != i)]
        for i in front:
            ranks[i] = rank
        remaining = [i for i in remaining if ranks[i] == -1]
        rank += 1
    return ranks


def crowding_distances(vectors: Sequence[Vector]) -> List[float]:
    """NSGA-II crowding distance within one front: boundary points get
    ``inf``, interior points the sum of normalized neighbor gaps per
    objective. Callers must pass the front in a canonical order — with
    value ties, which index lands on the boundary follows input order
    (``front_order`` sorts fronts canonically before calling this)."""
    n = len(vectors)
    if n == 0:
        return []
    dist = [0.0] * n
    for k in range(len(vectors[0])):
        order = sorted(range(n), key=lambda i: vectors[i][k])
        dist[order[0]] = dist[order[-1]] = _INF
        span = vectors[order[-1]][k] - vectors[order[0]][k]
        if span <= 0:
            continue
        for pos in range(1, n - 1):
            i = order[pos]
            if dist[i] == _INF:
                continue
            dist[i] += (vectors[order[pos + 1]][k]
                        - vectors[order[pos - 1]][k]) / span
    return dist


def front_order(vectors: Sequence[Vector], tiebreaks: Sequence,
                ) -> Tuple[List[int], List[int], List[float]]:
    """Deterministic total order over ``vectors``: ``(order, ranks,
    crowding)`` where ``order`` lists indices sorted by
    ``(rank, -crowding, tiebreak)`` — front first, within a front the most
    spread-out (boundary) points first, ties broken by the caller's
    ``tiebreaks`` (the cost DB uses ``(ts, to_json())``).

    Crowding is computed per front over a canonical ``(vector, tiebreak)``
    ordering of that front, so the result is a pure function of the *set*
    of (vector, tiebreak) pairs — insertion order never matters."""
    if len(vectors) != len(tiebreaks):
        raise ValueError(f"{len(vectors)} vectors, {len(tiebreaks)} tiebreaks")
    ranks = front_ranks(vectors)
    crowding = [0.0] * len(vectors)
    for r in sorted(set(ranks)):
        members = [i for i in range(len(vectors)) if ranks[i] == r]
        members.sort(key=lambda i: (tuple(vectors[i]), tiebreaks[i]))
        for i, d in zip(members, crowding_distances(
                [vectors[i] for i in members])):
            crowding[i] = d
    order = sorted(range(len(vectors)),
                   key=lambda i: (ranks[i], -crowding[i], tiebreaks[i]))
    return order, ranks, crowding


def hypervolume(vectors: Sequence[Vector], ref: Vector) -> float:
    """Exact hypervolume dominated by ``vectors`` w.r.t. reference point
    ``ref`` (minimization: the volume of the union of boxes
    ``[v, ref]``). Recursive dimension sweep — exponential in objective
    count, fine for the <=4-objective fronts campaigns produce. Points not
    strictly better than ``ref`` in every objective contribute nothing."""
    pts = sorted({tuple(float(x) for x in v) for v in vectors
                  if all(x < r for x, r in zip(v, ref))})
    return _hv(pts, tuple(float(r) for r in ref))


def _hv(pts: List[Tuple[float, ...]], ref: Tuple[float, ...]) -> float:
    if not pts:
        return 0.0
    if len(ref) == 1:
        return ref[0] - min(p[0] for p in pts)
    total = 0.0
    for i, p in enumerate(pts):  # pts sorted ascending by first coordinate
        hi = pts[i + 1][0] if i + 1 < len(pts) else ref[0]
        width = hi - p[0]
        if width > 0:
            total += width * _hv(sorted(q[1:] for q in pts[:i + 1]),
                                 ref[1:])
    return total


__all__ = ["dominates", "front_ranks", "crowding_distances", "front_order",
           "hypervolume"]
