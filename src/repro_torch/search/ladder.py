"""Multi-fidelity promotion ladder: surrogate → evaluation → measured.

Counterpart of ``repro/search/ladder.py``, copied. For a kernel cell of
the port, tier 1 is a launch of the Hopper kernel held against the oracle
with the resource model's bound, and tier 2 times real launches with CUDA
events (``launch/measure.py``).

Three tiers, each an order of magnitude more expensive than the last:

* **tier 0 — surrogate** (free): the learned :class:`CostModel` predicts
  log10(bound) per candidate; the inherited :class:`SurrogateGate` logic
  prunes hopeless designs before they cost anything.
* **tier 1 — evaluation**: the survivor runs and is checked, and the
  resource model gives its bound (cached, content-addressed).
* **tier 2 — measured**: only leaderboard *heads* are promoted and timed;
  the time lands in the cost DB as a ``fidelity="measured"`` row.

:meth:`PromotionLadder.calibrate` folds prediction-vs-measured error
(offset-corrected, see ``CostModel.measured_calibration``) into the factor
annealing, so agreement with measured times *tightens* tier-0 pruning.

The two decision functions — which heads to promote, which duplicate
measured row is canonical — are module-level **pure functions**: same
inputs, same promotions, on every replay. They live in
``repro_torch.core.promotion`` and are re-exported here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.promotion import plan_promotions, select_measured_row
from repro_torch.search.gate import SurrogateGate

__all__ = ["PromotionLadder", "plan_promotions", "select_measured_row"]


@dataclass
class PromotionLadder(SurrogateGate):
    """A :class:`SurrogateGate` whose annealing also listens to tier-2.

    Inherits the whole gate protocol (``calibrate`` / ``prune_verdicts`` /
    ``effective_factor`` / ``active``) so the evaluator and DSE loop use it
    unchanged. The one behavioural extension: once at least
    ``min_measured_points`` measured rows exist, the offset-corrected
    prediction-vs-measured RMSE joins the annealing signal — the effective
    factor anneals on the *better* (smaller) of validation RMSE and
    measured RMSE, and only ever moves the threshold tighter than the
    validation-only gate would. Wall-clock agreement is strictly stronger
    evidence than held-out-bound agreement, never weaker: a noisy measured
    RMSE cannot loosen a gate the validation split already earned."""

    min_measured_points: int = 3

    last_measured_rmse: float = field(default=float("nan"), init=False)
    last_measured_n: int = field(default=0, init=False)
    measured_offset: float = field(default=float("nan"), init=False)

    def calibrate(self, db, *, arch: Optional[str] = None,
                  shape: Optional[str] = None,
                  mesh: Optional[str] = None) -> bool:
        """Run the inherited validation-split calibration, then fold in the
        measured-row calibration (see class docstring). ``last_measured_*``
        and ``measured_offset`` always reflect the latest scan, whether or
        not they moved the threshold."""
        active = super().calibrate(db, arch=arch, shape=shape, mesh=mesh)
        cm = self.cost_model
        if cm is None or not getattr(cm, "trained", False):
            return active
        m_rmse, m_n, m_off = cm.measured_calibration(db, arch=arch,
                                                     shape=shape, mesh=mesh)
        self.last_measured_rmse = m_rmse
        self.last_measured_n = m_n
        self.measured_offset = m_off
        if not active or m_n < self.min_measured_points or m_rmse != m_rmse:
            return active
        v_rmse = self.last_rmse
        joint = m_rmse if v_rmse != v_rmse else min(v_rmse, m_rmse)
        cand = self._anneal(joint)
        if cand is not None and (self._annealed is None
                                 or cand < self._annealed):
            self._annealed = cand
        return active
