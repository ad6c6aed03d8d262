"""One kernel cell's search loop: autotune a Hopper kernel's tiles.

Counterpart of ``repro/launch/kernel_cell.py::_explore_kernel_cell``. A
*kernel cell* is ``(kernel, shape)``, encoded into the CostDB columns as
``arch="kernel:<name>"`` / ``shape=<shape name>``. The loop mirrors the
reference's: seed the shipped-default tile config, the strategy proposes,
dedupe/rank/truncate, evaluate (kernel launch, correctness gate against
the oracle, Hopper resource-model bound), observe, and fit the surrogate
every second iteration. With a surrogate gate, each iteration calibrates
it on the DB and its pruned candidates land as ``pruned`` rows, one per
design.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.design_space import KernelTemplate, baseline_kernel_point
from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME, kernel_workload
from repro_torch.search import SearchState, select_candidates

#: kernels are single-device — the mesh column every kernel row carries
KERNEL_MESH_NAME = "dev1"

#: strategies ported for kernel cells
KERNEL_STRATEGY_CHOICES = ("greedy", "anneal", "evolve", "ensemble")


def _explore_kernel_cell(arch: str, shape: str, *, evaluator, db, cost_model,
                         strategy, iterations: int, budget: int,
                         seed: int, gate=None, heartbeat=None,
                         log=print) -> Dict:
    """The per-cell search loop. Returns the report dict (``baseline`` /
    ``best`` / ``iterations`` / ``improvement``) in the reference's shape."""
    kshape = KERNEL_SHAPE_BY_NAME[shape]
    template = KernelTemplate(kshape, evaluator.device)
    wl = kernel_workload(kshape)
    cache = evaluator.cache

    def beat(info):
        if heartbeat is not None:
            heartbeat(info)

    def dp_summary(dp):
        if dp is None or dp.status != "ok":
            return None
        return {"point": {k: v for k, v in sorted(dp.point.items())
                          if k != "__key__"},
                "bound_s": dp.metrics.get("bound_s"),
                "max_abs_err": dp.metrics.get("max_abs_err")}

    # iteration 0: the shipped-default tile config is the expert seed
    seed_point = baseline_kernel_point(kshape, template)
    compiles_b = evaluator.compile_count
    hits_b = cache.hits if cache is not None else 0
    base_dp = evaluator.evaluate_batch(arch, shape, [seed_point],
                                       source="expert", iteration=0)[0]
    db.append(base_dp)
    beat({"iteration": 0, "phase": "baseline", "evaluated": 1,
          "compiled": evaluator.compile_count - compiles_b, "pruned": 0,
          "cache_hits": (cache.hits - hits_b) if cache is not None else 0,
          "best_bound": base_dp.metrics.get("bound_s")})
    log(f"{arch}/{shape}: baseline {base_dp.status} "
        f"bound={base_dp.metrics.get('bound_s')} "
        f"err={base_dp.metrics.get('max_abs_err')}")

    iters: List[Dict] = []
    incumbent = base_dp if base_dp.status == "ok" else None
    for it in range(1, iterations + 1):
        state = SearchState(
            arch=arch, shape=shape, cfg=None, cell=kshape, template=template,
            db=db, iteration=it, budget=budget,
            incumbent=incumbent or base_dp, pool=[incumbent or base_dp],
            cost_model=cost_model, workload=wl, mesh=evaluator.mesh_name)
        cands = strategy.propose(state)
        ranked = select_candidates(state, cands)
        beat({"iteration": it, "phase": "proposed", "evaluated": 0,
              "compiled": 0, "pruned": 0, "cache_hits": 0,
              "best_bound": (incumbent.metrics.get("bound_s")
                             if incumbent else None)})
        if gate is not None:
            gate.calibrate(db, arch=arch, shape=shape,
                           mesh=evaluator.mesh_name)
        hits0 = cache.hits if cache is not None else 0
        compiles_i = evaluator.compile_count
        pruned_i = evaluator.pruned_count
        new_dps = evaluator.evaluate_batch(
            arch, shape, [c.point for c in ranked],
            source=[c.source for c in ranked], iteration=it, gate=gate,
            incumbent_bound=(incumbent.metrics.get("bound_s")
                             if incumbent is not None else None))
        # one pruned row per design, however often it is re-predicted
        prior_pruned = (db.keys(arch, shape)
                        - db.keys(arch, shape, include_pruned=False))
        db.append_many([dp for dp in new_dps
                        if not (dp.status == "pruned"
                                and dp.point.get("__key__") in prior_pruned)])
        strategy.observe(new_dps)
        ok_dps = [d for d in new_dps
                  if d.status == "ok" and d.metrics.get("bound_s")]
        cands_pool = ok_dps + ([incumbent] if incumbent is not None else [])
        incumbent = (min(cands_pool, key=lambda d: d.metrics["bound_s"])
                     if cands_pool else None)
        # periodic surrogate fit on the grown DB (pretrain no-ops < 4 rows)
        if cost_model is not None and it % 2 == 0:
            cost_model.pretrain(db)
        entry = {
            "iteration": it,
            "evaluated": len(new_dps),
            "compiled": evaluator.compile_count - compiles_i,
            "pruned": evaluator.pruned_count - pruned_i,
            "cache_hits": (cache.hits - hits0) if cache is not None else 0,
            "best_bound": (incumbent.metrics.get("bound_s")
                           if incumbent else None),
        }
        iters.append(entry)
        beat({**entry, "phase": "iteration"})

    best = incumbent or db.best(arch, shape, mesh=evaluator.mesh_name)
    b0 = base_dp.metrics.get("bound_s") if base_dp.status == "ok" else None
    b1 = best.metrics.get("bound_s") if best is not None else None
    return {
        "arch": arch, "shape": shape,
        "baseline": dp_summary(base_dp),
        "best": dp_summary(best),
        "iterations": iters,
        # best/baseline bound ratio, 1.0 when either side is missing
        "improvement": (b1 / b0) if (b0 and b1) else 1.0,
    }
