"""DSE Explorer (paper §3.1) — compatibility facade over the search package.

The greedy candidate-generation policy that used to live here is now
:class:`~repro_torch.search.greedy.GreedyNeighborhood`; ``Explorer`` keeps the
historical one-call API (generate -> dedupe -> rank -> batch-evaluate ->
record) for scripts and notebooks that drive exploration without a
``DSELoop``. Dedupe uses the cost DB's cached per-cell key index
(``CostDB.keys``) instead of rescanning ``db.query(arch, shape)`` on every
call — O(batch) per iteration, not O(DB).

Counterpart of ``repro/core/explorer.py``, copied.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.core.cost_db import CostDB, DataPoint, workload_features
from repro_torch.core.cost_model import CostModel
from repro_torch.core.design_space import PlanPoint, PlanTemplate
from repro_torch.core.evaluator import Evaluator
from repro_torch.search.base import Candidate, SearchState, select_candidates


@dataclass
class Explorer:
    evaluator: Evaluator
    db: CostDB
    cost_model: Optional[CostModel] = None
    seed: int = 0
    # exploration diversity (paper §3.2.2): evaluate a few random template
    # points alongside the greedy neighborhood to avoid local optima
    n_random: int = 1

    def explore(self, arch: str, shape: str, seeds: Sequence[PlanPoint],
                *, budget: int = 4, iteration: int = 0,
                extra_candidates: Sequence[PlanPoint] = ()) -> List[DataPoint]:
        """Evaluate up to ``budget`` new candidates derived from ``seeds``."""
        cfg = get_config(arch)
        cell = SHAPE_BY_NAME[shape]
        template = PlanTemplate(cfg, cell, self.evaluator.mesh_shape)
        rng = random.Random(self.seed + iteration)

        cands: List[Candidate] = [Candidate(p, "llm") for p in extra_candidates]
        for seed in seeds:
            cands += [Candidate(p, "explorer") for p in template.neighbors(seed)]
        cands += [Candidate(p, "explorer")
                  for p in template.random_points(rng, self.n_random)]

        state = SearchState(arch=arch, shape=shape, cfg=cfg, cell=cell,
                            template=template, db=self.db, iteration=iteration,
                            budget=budget, incumbent=None,
                            cost_model=self.cost_model,
                            workload=workload_features(cfg, cell))
        # shared pipeline: key-index dedupe + in-batch dedupe + rank + budget
        ranked = select_candidates(state, cands)

        # the whole ranked budget goes down as ONE batch: cache hits return
        # instantly and the remaining compiles share the evaluator's pool
        out = self.evaluator.evaluate_batch(arch, shape,
                                            [c.point for c in ranked],
                                            source=[c.source for c in ranked],
                                            iteration=iteration)
        self.db.append_many(out)
        return out
