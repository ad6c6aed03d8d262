"""The SECDA-DSE iterative loop (paper Fig. 1):

    search strategies propose    ─┐  (greedy / LLM stack / annealing /
                                  ├─> surrogate gate ─> Evaluation module
    Ensemble budget allocation   ─┘        │             (dry-run 'simulation')
          ▲                                ▼
          │   RAG over cost DB    cost-model DB  ──>  LoRA fine-tuning
          └────────────────────────────────┘

``DSELoop`` is pure orchestration: seed the expert design, let the pluggable
:class:`~repro_torch.search.base.SearchStrategy` propose candidates, dedupe against
the DB's key index, surrogate-rank, pass the batch through the optional
:class:`~repro_torch.search.gate.SurrogateGate` (predicted-hopeless candidates are
recorded as ``pruned`` data points instead of compiled), batch-evaluate the
survivors, feed every result — positive AND negative — back to the strategy
and the DB, and periodically (LoRA-)fine-tune the surrogate.

The default strategy is an :class:`~repro_torch.search.ensemble.Ensemble` of
``GreedyNeighborhood`` + ``LLMGuided`` — the paper's two interchangeable
proposal engines sharing one evaluation loop. ``--strategy`` on the CLIs
swaps in annealing, evolutionary, or the full four-member bandit ensemble.

The optional human gate (``approve_fn``) mirrors §3.2.2's human-in-the-loop;
the default auto-approves (the paper's stated end state once the DB grows).
Each iteration's ranked budget is submitted as ONE ``evaluate_batch`` call:
cache hits return instantly, the rest fan out over the evaluator's process
pool.

Counterpart of ``repro/core/loop.py``, copied. The evaluator's
``mesh_shape`` (axis name -> size) sizes the plan template, as the
reference reads its jax mesh's shape, and ``LoopReport.finetunes`` keeps
each fine-tune's result for the caller's report.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.core.cost_db import CostDB, DataPoint, workload_features
from repro_torch.core.cost_model import CostModel
from repro_torch.core.design_space import PlanPoint, PlanTemplate, baseline_point
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.llm_stack import LLMStack
from repro_torch.core.mcp import Registry, build_registry
from repro_torch.search import (Candidate, Ensemble, GreedyNeighborhood, LLMGuided,
                          SearchState, SearchStrategy, SurrogateGate,
                          select_candidates)


@dataclass
class LoopReport:
    arch: str
    shape: str
    iterations: List[Dict] = field(default_factory=list)
    best: Optional[DataPoint] = None
    baseline: Optional[DataPoint] = None
    finetunes: List[Dict] = field(default_factory=list)  # each fine-tune's result

    def improvement(self) -> float:
        if not (self.best and self.baseline):
            return 1.0
        b0 = self.baseline.metrics.get("bound_s")
        b1 = self.best.metrics.get("bound_s")
        return (b1 / b0) if (b0 and b1) else 1.0


@dataclass
class DSELoop:
    evaluator: Evaluator
    db: CostDB
    llm_stack: LLMStack
    cost_model: Optional[CostModel] = None
    registry: Optional[Registry] = None
    approve_fn: Optional[Callable[[DataPoint], bool]] = None  # human gate
    pool_size: int = 2  # incumbent diversity pool
    finetune_every: int = 2
    strategy: Optional[SearchStrategy] = None  # None -> greedy+LLM ensemble
    gate: Optional[SurrogateGate] = None  # surrogate-gated evaluation

    def __post_init__(self):
        if self.registry is None:
            self.registry = build_registry(
                evaluator=self.evaluator, db=self.db,
                llm_stack=self.llm_stack, cost_model=self.cost_model)

    def _default_strategy(self) -> SearchStrategy:
        return Ensemble([GreedyNeighborhood(), LLMGuided(self.llm_stack)])

    # ------------------------------------------------------------------
    def run(self, arch: str, shape: str, *, iterations: int = 4,
            eval_budget: int = 3, seed_point: Optional[PlanPoint] = None,
            verbose: bool = True,
            heartbeat: Optional[Callable[[Dict], None]] = None) -> LoopReport:
        """Run the loop for one cell and return its :class:`LoopReport`.

        ``heartbeat``, when given, is called with a small progress dict —
        ``{"iteration", "phase", "evaluated", "compiled", "pruned",
        "cache_hits", "best_bound"}`` — after the baseline evaluation
        (iteration 0), after every proposal round (``phase="proposed"``),
        after every completed ``evaluate_batch`` (``phase="evaluated"``),
        and at the end of every iteration (``phase="iteration"``).
        Campaigns use it to refresh their ``progress.json`` at
        iteration/batch granularity: no supervisor-visible gap ever spans
        more than one slow step (one LLM proposal round, one evaluation
        batch, or one observe+fine-tune tail), which is what lets a hang
        timeout sit far below one cell's wall time; the callback must be
        cheap and must not raise."""
        cfg = get_config(arch)
        cell = SHAPE_BY_NAME[shape]
        template = PlanTemplate(cfg, cell, self.evaluator.mesh_shape)
        wl = workload_features(cfg, cell)
        report = LoopReport(arch=arch, shape=shape)
        # strategies carry per-cell state (walker position, population,
        # bandit credit) — a loop bound to one is single-cell; campaigns
        # construct a fresh strategy per cell
        strategy = self.strategy or self._default_strategy()

        def log(msg):
            if verbose:
                print(f"[dse {arch}/{shape}] {msg}", flush=True)

        # iteration 0: the expert initial design (paper: DSE takes an
        # accelerator design with pre-defined parameters as its input)
        seed = seed_point or baseline_point(cell, template)
        t0 = time.time()
        cache = self.evaluator.cache
        base_hits0 = cache.hits if cache is not None else 0
        base_compiles0 = self.evaluator.compile_count
        base_dp = self.registry.call("simulate", arch=arch, shape=shape,
                                     point=dict(seed.dims), iteration=0,
                                     source="expert")
        report.baseline = base_dp
        if heartbeat is not None:
            heartbeat({"iteration": 0, "phase": "baseline", "evaluated": 1,
                       "compiled": self.evaluator.compile_count - base_compiles0,
                       "pruned": 0,
                       "cache_hits": (cache.hits - base_hits0)
                       if cache is not None else 0,
                       "best_bound": base_dp.metrics.get("bound_s")})
        log(f"baseline: {base_dp.status} bound={base_dp.metrics.get('bound_s')}s "
            f"dom={base_dp.metrics.get('dominant')} ({time.time()-t0:.0f}s)")

        pool: List[DataPoint] = [base_dp]
        for it in range(1, iterations + 1):
            incumbent = _best_of(pool) or base_dp
            state = SearchState(
                arch=arch, shape=shape, cfg=cfg, cell=cell, template=template,
                db=self.db, iteration=it, budget=eval_budget,
                incumbent=incumbent, pool=list(pool),
                cost_model=self.cost_model, workload=wl,
                mesh=self.evaluator.mesh_name)

            # --- propose: the pluggable strategy decides where to look ---
            cands = strategy.propose(state)
            ranked = select_candidates(state, cands)
            log(f"iter {it}: {len(cands)} proposed -> {len(ranked)} selected "
                f"({_source_counts(ranked)})")
            if heartbeat is not None:
                # propose can be slow (a real LLM call) — beat before the
                # batch so no single supervisor gap spans propose AND eval
                heartbeat({"iteration": it, "phase": "proposed",
                           "evaluated": 0, "compiled": 0, "pruned": 0,
                           "cache_hits": 0,
                           "best_bound": (incumbent.metrics.get("bound_s")
                                          if incumbent else None)})

            # --- gate + batch-evaluate ---
            if self.gate is not None:
                self.gate.calibrate(self.db, arch=arch, shape=shape,
                                    mesh=self.evaluator.mesh_name)
            hits0 = cache.hits if cache is not None else 0
            compiles0 = self.evaluator.compile_count
            pruned0 = self.evaluator.pruned_count
            new_dps = self.evaluator.evaluate_batch(
                arch, shape, [c.point for c in ranked],
                source=[c.source for c in ranked], iteration=it,
                gate=self.gate,
                incumbent_bound=(incumbent.metrics.get("bound_s")
                                 if incumbent.status == "ok" else None))
            if heartbeat is not None:
                # batch done: refresh the supervisor heartbeat before the
                # (possibly slow) observe/fine-tune tail of the iteration
                heartbeat({"iteration": it, "phase": "evaluated",
                           "evaluated": len(new_dps),
                           "compiled": self.evaluator.compile_count - compiles0,
                           "pruned": self.evaluator.pruned_count - pruned0,
                           "cache_hits": (cache.hits - hits0)
                           if cache is not None else 0,
                           "best_bound": (incumbent.metrics.get("bound_s")
                                          if incumbent else None)})
            for dp in new_dps:
                if (self.approve_fn is not None and dp.status == "ok"
                        and not self.approve_fn(dp)):
                    dp.status = "rejected"
                    dp.reason = "human-in-the-loop veto"
                log(f"  {dp.status:10s} bound={dp.metrics.get('bound_s')} "
                    f"dom={dp.metrics.get('dominant')} mem="
                    f"{dp.metrics.get('per_device_gib', float('nan')):.1f}GiB "
                    f"{_delta_str(dp, incumbent)}")
            # a design the gate pruned in an earlier iteration stays
            # proposable (it was never measured) but isn't re-recorded —
            # one pruned row per design, however often it is re-predicted
            prior_pruned = (self.db.keys(arch, shape)
                            - self.db.keys(arch, shape, include_pruned=False))
            self.db.append_many([
                dp for dp in new_dps
                if not (dp.status == "pruned"
                        and dp.point.get("__key__") in prior_pruned)])

            # --- observe: every result, positive AND negative, feeds back ---
            strategy.observe(new_dps)
            pool = _select_pool(pool + new_dps, self.pool_size)

            # --- periodic surrogate (LoRA) fine-tuning on the grown DB ---
            if self.cost_model is not None and it % self.finetune_every == 0:
                r = self.registry.call("finetune_cost_model")
                report.finetunes.append(dict(r))
                log("  " + _finetune_msg(r))

            entry = {
                "iteration": it,
                "evaluated": len(new_dps),
                "compiled": self.evaluator.compile_count - compiles0,
                "pruned": self.evaluator.pruned_count - pruned0,
                "cache_hits": (cache.hits - hits0) if cache is not None else 0,
                "sources": _source_counts(ranked),
                "allocation": (dict(strategy.credit)
                               if isinstance(strategy, Ensemble) else None),
                "best_bound": (_best_of(pool).metrics.get("bound_s")
                               if _best_of(pool) else None),
            }
            report.iterations.append(entry)
            if heartbeat is not None:
                heartbeat({**entry, "phase": "iteration"})

        report.best = _best_of(pool) or self.db.best(arch, shape)
        if report.best:
            log(f"best: bound={report.best.metrics.get('bound_s')}s "
                f"({report.improvement():.2%} of baseline) "
                f"plan={ {k: v for k, v in report.best.point.items() if k != '__key__'} }")
        return report

def _finetune_msg(r: Dict) -> str:
    """NaN/None-safe fine-tune log line (a None loss used to TypeError in an
    eagerly-evaluated f-string ternary)."""
    loss = r.get("loss")
    if isinstance(loss, (int, float)) and loss == loss:  # not None, not NaN
        return f"cost model: {r['status']} loss={loss:.4f}"
    return f"cost model: {r['status']} loss=n/a"


def _source_counts(cands: Sequence[Candidate]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in cands:
        out[c.source] = out.get(c.source, 0) + 1
    return out


def _best_of(pool: Sequence[DataPoint]) -> Optional[DataPoint]:
    ok = [d for d in pool if d.status == "ok" and d.metrics.get("bound_s")]
    return min(ok, key=lambda d: d.metrics["bound_s"]) if ok else None


def _select_pool(dps: Sequence[DataPoint], k: int) -> List[DataPoint]:
    ok = sorted((d for d in dps if d.status == "ok" and d.metrics.get("bound_s")),
                key=lambda d: d.metrics["bound_s"])
    # diversity: keep the best k-1 plus the most-different remaining design
    return list(ok[:k]) if len(ok) <= k else list(ok[: k - 1]) + [ok[-1]]


def _delta_str(dp: DataPoint, incumbent: DataPoint) -> str:
    a, b = dp.metrics.get("bound_s"), incumbent.metrics.get("bound_s")
    if not (a and b):
        return ""
    changed = {k: v for k, v in dp.point.items()
               if k != "__key__" and incumbent.point.get(k) != v}
    return f"x{a/b:.3f} vs incumbent (changed {changed})"
