"""Surrogate-gated evaluation: skip evaluations the cost model rules out.

Counterpart of ``repro/search/gate.py``, copied. LLM-DSE's "amortize
expensive evaluations" lever: before a candidate reaches the evaluation
tier (for a kernel cell: a launch on the card and a check against the
oracle), predict its bound with the learned surrogate and
prune it when the prediction is more than the gate threshold times the
incumbent. Pruned candidates are recorded as ``pruned`` data points carrying
the prediction (so later analysis can audit the gate) — they are *not* used as fine-tuning targets, since they
have no measured outcome (see ``CostDB.training_set``).

Calibration guard: the gate stays disabled until the surrogate's validation
RMSE on held-out DB rows (a deterministic ~20% key-hash split the model
never trains on) drops below ``max_val_rmse`` decades of log10(bound).
Calibration is **per-cell when possible**: when the current ``(arch, shape,
mesh)`` cell holds at least ``min_val_points`` held-out rows, the guard
trusts the cell-local RMSE (a surrogate can be sharp on one workload and
useless on another); otherwise it falls back to the global validation set.
``require_calibration=False`` bypasses the guard — benchmarks/tests only.

Factor annealing: with ``min_factor`` set, the prune threshold tightens as
calibration improves — a linear map from validation RMSE to the effective
factor, ``factor`` (loose) at the guard limit down to ``min_factor``
(aggressive) at RMSE 0 — so a freshly-trusted surrogate prunes timidly and
a well-calibrated one prunes hard. ``min_factor=None`` (default) keeps the
threshold fixed at ``factor``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_db import CostDB, featurize
from repro_torch.core.design_space import PlanPoint


@dataclass
class SurrogateGate:
    """Calibration-guarded pre-compile filter (see module docstring).
    ``factor`` is the loosest prune threshold as a multiple of the
    incumbent's measured ``bound_s``; ``min_factor`` (optional, must be in
    ``(1, factor]``) is the annealing target the threshold approaches as
    validation RMSE falls to 0; ``max_val_rmse`` is in decades of
    log10(bound_s). Fails safe: an untrained or badly-calibrated surrogate
    leaves the gate inactive and every candidate passes through to
    evaluation."""

    cost_model: object  # CostModel (typed loosely: any predict/validation_error)
    factor: float = 4.0
    min_factor: Optional[float] = None
    max_val_rmse: float = 0.35   # decades of log10(bound_s)
    min_val_points: int = 4
    require_calibration: bool = True

    last_rmse: float = field(default=float("nan"), init=False)
    last_val_n: int = field(default=0, init=False)
    last_scope: str = field(default="global", init=False)  # cell | global
    pruned_total: int = field(default=0, init=False)
    _active: bool = field(default=False, init=False)
    _annealed: Optional[float] = field(default=None, init=False)

    def __post_init__(self):
        """Reject an annealing target outside ``(1, factor]``."""
        if self.min_factor is not None and not (1.0 < self.min_factor
                                                <= self.factor):
            raise ValueError(f"min_factor must be in (1, factor={self.factor}"
                             f"], got {self.min_factor}")

    @property
    def active(self) -> bool:
        """Whether the last :meth:`calibrate` call armed the gate."""
        return self._active

    @property
    def effective_factor(self) -> float:
        """The prune threshold currently in force: the annealed factor from
        the last calibration when ``min_factor`` is set and the gate is
        active, else the configured ``factor``.

        Part of the gate **protocol contract**: the evaluator reads this
        property (no ``getattr`` fallback) when recording why a candidate
        was pruned, so every gate implementation — subclasses like
        :class:`~repro.search.ladder.PromotionLadder` included — must keep
        it equal to the threshold ``prune_verdicts`` actually applies."""
        return self.factor if self._annealed is None else self._annealed

    def calibrate(self, db: CostDB, *, arch: Optional[str] = None,
                  shape: Optional[str] = None,
                  mesh: Optional[str] = None) -> bool:
        """(Re)measure held-out validation error; enable/disable the gate
        and anneal the effective factor. With ``arch``/``shape`` given, the
        cell-local validation split is preferred whenever it holds at least
        ``min_val_points`` rows (``last_scope`` records which one decided);
        without them, or for a data-poor cell, the global split guards."""
        cm = self.cost_model
        if cm is None or not getattr(cm, "trained", False):
            self._active, self._annealed = False, None
            return False
        if not self.require_calibration:
            # guard bypassed (benchmarks/tests) — but annealing can still
            # track whatever validation error IS measurable, so
            # --gate-min-factor has an effect on the bypass path too
            self._active = True
            rmse, n = cm.validation_error(db)
            self.last_rmse, self.last_val_n, self.last_scope = rmse, n, "global"
            self._annealed = self._anneal(rmse)
            return True
        rmse, n, scope = float("nan"), 0, "global"
        # cheap pre-check off the incremental key index: a cell with fewer
        # measured designs than min_val_points cannot have enough held-out
        # rows, so skip the full cell-local validation scan entirely
        if (arch is not None and shape is not None
                and len(db.keys(arch, shape, include_pruned=False))
                >= self.min_val_points):
            c_rmse, c_n = cm.validation_error(db, arch=arch, shape=shape,
                                              mesh=mesh)
            if c_n >= self.min_val_points:
                rmse, n, scope = c_rmse, c_n, "cell"
        if scope == "global":
            rmse, n = cm.validation_error(db)
        self.last_rmse, self.last_val_n, self.last_scope = rmse, n, scope
        self._active = bool(n >= self.min_val_points and rmse <= self.max_val_rmse)
        self._annealed = self._anneal(rmse) if self._active else None
        return self._active

    def _anneal(self, rmse: float) -> Optional[float]:
        """The annealed threshold for a validation RMSE: a linear map from
        ``factor`` (at ``max_val_rmse`` or worse) down to ``min_factor``
        (at RMSE 0). ``None`` — meaning "use ``factor`` unchanged" — when
        annealing is off or the RMSE is unmeasurable (NaN)."""
        if self.min_factor is None or rmse != rmse:
            return None
        frac = min(max(rmse / self.max_val_rmse, 0.0), 1.0)
        return self.min_factor + (self.factor - self.min_factor) * frac

    def prune_verdicts(self, points: Sequence[PlanPoint], workload: dict,
                       incumbent_bound: Optional[float],
                       ) -> List[Optional[Tuple[float, float]]]:
        """Per-point verdict: ``None`` = evaluate; ``(predicted_bound_s,
        p_feasible)`` = prune (prediction beyond :attr:`effective_factor` x
        the incumbent). Inactive gate / no incumbent = all pass."""
        if not self._active or incumbent_bound is None or not points:
            return [None] * len(points)
        threshold = self.effective_factor * incumbent_bound
        feats = np.stack([featurize(dict(p.dims), workload) for p in points])
        b, pf = self.cost_model.predict(feats)
        out: List[Optional[Tuple[float, float]]] = []
        for bi, pfi in zip(b, pf):
            pred = float(10.0 ** float(bi))
            out.append((pred, float(pfi)) if pred > threshold else None)
        self.pruned_total += sum(v is not None for v in out)
        return out
