"""Kernel-cell search loop and kernel campaigns: autotune the Hopper kernels.

Counterpart of ``repro/launch/kernel_cell.py``. A *kernel cell* is
``(kernel, shape)``, encoded into the CostDB/queue/report columns as
``arch="kernel:<name>"`` / ``shape=<shape name>``, so CellQueue leases,
``merge_db``, leaderboards, resume-from-reports and progress heartbeats
all work unchanged.

The per-cell loop (:func:`_explore_kernel_cell`) mirrors the reference's:
seed the shipped-default tile config, the strategy proposes,
dedupe/rank/truncate, evaluate (kernel launch, correctness gate against
the oracle, Hopper resource-model bound), observe, and fit the surrogate
every second iteration. With a surrogate gate, each iteration calibrates
it on the DB and its pruned candidates land as ``pruned`` rows, one per
design.

:func:`run_kernel_campaign` drives that loop over a ``(kernel, shape)``
grid (``--space kernels`` on ``repro_torch.launch.campaign``): one DB,
one evaluation cache and one surrogate for every cell, so the gate
calibrates on the campaign's rows. Outputs under ``--out``:
``cost_db.jsonl``, ``reports/``, ``leaderboard.json``, ``progress.json``
and ``BENCH_kernels.json`` (per-cell tuned-vs-default bound and the
correctness-gate audit: candidates checked / rejected).
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_db import CostDB, featurize
from repro_torch.core.device import resolve_device
from repro_torch.core.eval_cache import DryRunCache
from repro_torch.core.kernel_space import (CI_KERNEL_SHAPES, KERNEL_NAMES,
                                           KERNEL_SHAPE_BY_NAME, kernel_arch,
                                           kernel_workload, parse_kernel_arch)
from repro_torch.core.promotion import plan_front_promotions, plan_promotions
from repro_torch.launch.campaign import (_injected_crash_hook,
                                         build_leaderboard, cell_report_path,
                                         read_progress, validate_gate_args,
                                         validate_measure_args,
                                         validate_objective_args,
                                         write_progress)
from repro_torch.launch.ioutil import write_json_atomic
from repro_torch.launch.scheduler import CellQueue, sanitize_owner

# The evaluator, the surrogate, the strategies and the tile template import
# torch, so the two functions that run cells import them: the grid helpers
# below serve torch-free supervisors too (the service daemon).

__all__ = [
    "KERNEL_MESH_NAME", "KERNEL_STRATEGY_CHOICES", "kernel_grid_cells",
    "resolve_kernel_grid", "run_kernel_campaign",
]

#: kernels are single-device — the mesh column every kernel row carries
KERNEL_MESH_NAME = "dev1"

#: design-space-agnostic strategies only (llm/transfer are plan-coupled)
KERNEL_STRATEGY_CHOICES = ("greedy", "anneal", "evolve", "ensemble")


def resolve_kernel_grid(kernels: str, shapes: str) -> Tuple[List[str], List[str]]:
    """Expand ``--archs`` / ``--shapes`` strings (comma-separated ids or the
    literal ``all``) into validated kernel / kernel-shape name lists.
    ``all`` shapes means every CI shape of the selected kernels (the
    reference's registry); full-width shapes are named explicitly. Raises
    ``ValueError`` naming every unknown id."""
    kernel_list = list(KERNEL_NAMES) if kernels == "all" else kernels.split(",")
    unknown = [k for k in kernel_list if k not in KERNEL_NAMES]
    if shapes == "all":
        shape_list = [s.name for s in CI_KERNEL_SHAPES
                      if s.kernel in kernel_list]
    else:
        shape_list = shapes.split(",")
        unknown += [s for s in shape_list if s not in KERNEL_SHAPE_BY_NAME]
    if unknown:
        raise ValueError(f"unknown kernel/shape: {unknown}")
    return kernel_list, shape_list


def kernel_grid_cells(kernels: Sequence[str], shapes: Sequence[str],
                      shard: Optional[Tuple[int, int]] = None,
                      ) -> List[Tuple[str, str]]:
    """The kernel campaign's (arch, shape) work list: every named shape
    paired with its own kernel (never a cross product across kernels),
    arch-encoded as ``kernel:<name>``, in sorted order so every shard and
    the queue seeding agree on cell numbering; ``shard=(i, n)`` keeps cells
    ``i::n``. Disjoint and exhaustive across shards."""
    cells = sorted({(kernel_arch(KERNEL_SHAPE_BY_NAME[s].kernel), s)
                    for s in shapes
                    if KERNEL_SHAPE_BY_NAME[s].kernel in kernels})
    if shard is None:
        return cells
    i, n = shard
    if not (0 <= i < n):
        raise ValueError(f"shard index {i} outside 0..{n - 1}")
    return cells[i::n]


def _correctness_stats(db, cells: Sequence[Dict]) -> Dict[str, int]:
    """The correctness-gate audit over a campaign's cells: how many
    candidates were checked against the ref.py oracle and how many were
    rejected (``infeasible`` rows whose reason names the gate)."""
    checked = rejected = 0
    for c in cells:
        for d in db.query(c["arch"], c["shape"], mesh=c["mesh"]):
            if d.fidelity == "measured":
                continue
            if "max_abs_err" in d.metrics:
                checked += 1
            if (d.status == "infeasible"
                    and str(d.reason).startswith("correctness gate")):
                rejected += 1
    return {"checked": checked, "rejected": rejected}


def run_kernel_campaign(kernels: Sequence[str], shapes: Sequence[str], *,
                        out_dir: Path | str, iterations: int = 2,
                        budget: int = 3, strategy: str = "ensemble",
                        gate_factor: Optional[float] = None,
                        gate_min_factor: Optional[float] = None,
                        measure_top_k: int = 0, measure_runs: int = 3,
                        measure_budget: Optional[int] = None,
                        objective: str = "bound_s",
                        db=None, resume: bool = True,
                        shard: Optional[Tuple[int, int]] = None,
                        queue: Optional[Path | str] = None,
                        queue_owner: Optional[str] = None,
                        queue_lease_s: float = 300.0,
                        queue_poll_s: float = 0.5,
                        seed: int = 0, verbose: bool = True,
                        device: str = "cuda") -> Dict:
    """Run (or resume) a kernel campaign over the ``(kernel, shape)`` grid —
    a static ``shard=(i, n)`` slice or (``queue=DIR``) whatever cells this
    worker wins from the shared
    :class:`~repro_torch.launch.scheduler.CellQueue` — and return the
    summary dict (with the gate's final state under ``"gate"`` when one
    ran). Resumable from per-cell reports, heartbeats in ``progress.json``
    (every beat renews the current lease), shared content-addressed caches
    in queue mode, one-shot crash hook at cell boundaries, atomic JSON
    artifacts throughout. ``device`` is ``cuda`` (the Hopper kernels; an
    error without a card) or ``cpu`` (their plain versions)."""
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.design_space import PlanPoint
    from repro_torch.core.evaluator import KernelEvaluator
    from repro_torch.kernels import ops
    from repro_torch.search import PromotionLadder, SurrogateGate, make_strategy

    if queue is not None and shard is not None:
        raise ValueError("--queue and --shard are mutually exclusive: the "
                         "queue replaces the static grid cut")
    if queue is not None and queue_poll_s <= 0:
        raise ValueError(f"queue_poll_s must be > 0 (got {queue_poll_s}): "
                         "0 busy-spins the idle-wait loop")
    if strategy not in KERNEL_STRATEGY_CHOICES:
        raise ValueError(
            f"--space kernels supports strategies {KERNEL_STRATEGY_CHOICES} "
            f"(got {strategy!r}); llm/transfer variants are plan-coupled")
    gate_err = validate_gate_args(gate_factor, gate_min_factor)
    if gate_err:
        raise ValueError(gate_err)
    measure_err = validate_measure_args(measure_top_k, measure_runs,
                                        measure_budget)
    if measure_err:
        raise ValueError(measure_err)
    objective_err = validate_objective_args(objective)
    if objective_err:
        raise ValueError(objective_err)

    torch_device = str(resolve_device(device))

    mesh_name = KERNEL_MESH_NAME
    out_dir = Path(out_dir)
    (out_dir / "reports").mkdir(parents=True, exist_ok=True)
    db = db or CostDB(out_dir / "cost_db.jsonl")
    q = CellQueue(queue, lease_s=queue_lease_s) if queue is not None else None
    owner = (sanitize_owner(queue_owner or f"pid{os.getpid()}")
             if q is not None else None)
    cache = (DryRunCache(q.cache_dir) if q is not None
             else DryRunCache.beside(db.path))
    measured_cache = DryRunCache(q.measured_dir if q is not None
                                 else Path(db.path).parent / "measured_cache")
    # the caches key records by backend (``KernelEvaluator.cache_mesh``),
    # so a CPU run's verdicts never replay on the card
    evaluator = KernelEvaluator(mesh_name=mesh_name, torch_device=torch_device,
                                cache=cache, measured_cache=measured_cache,
                                measure_runs=measure_runs)
    cost_model = CostModel.create(in_dim=featurize({}, {}).shape[0])
    gate_cls = PromotionLadder if measure_top_k > 0 else SurrogateGate
    gate = (gate_cls(cost_model, factor=gate_factor,
                     min_factor=gate_min_factor)
            if gate_factor is not None else None)

    def log(msg):
        if verbose:
            print(f"[kernel-campaign {mesh_name}] {msg}", flush=True)

    t0 = time.time()
    cells = kernel_grid_cells(kernels, shapes, shard) if q is None else []
    if q is not None:
        seeded = q.seed(kernel_grid_cells(kernels, shapes), mesh=mesh_name)
        if seeded:
            log(f"queue {q.root}: seeded {seeded} cell ticket(s)")
    cell_rows: List[Dict] = []
    cell_best: List[Dict] = []
    counts = {"ran": 0, "resumed": 0, "unsupported": 0}
    qstats = {"stolen": 0}
    mstate = {"budget_left": measure_budget}
    current_ticket: List[Optional[object]] = [None]

    prior_hb = read_progress(out_dir)
    evals0 = db.count()
    compiles0 = evaluator.compile_count
    pruned0 = evaluator.pruned_count
    compiles_prior = int(prior_hb.get("compiles_total", 0) or 0)
    pruned_prior = int(prior_hb.get("pruned_total", 0) or 0)
    cells_total = q.total() if q is not None else len(cells)

    def progress(status: str, *, cell: Optional[str] = None,
                 iteration: Optional[int] = None,
                 iter_stats: Optional[Dict] = None) -> None:
        # same heartbeat payload contract as the plan campaign: the
        # orchestrator's hang detection and aggregation read it unchanged;
        # every beat doubles as a lease renewal
        if q is not None and current_ticket[0] is not None:
            try:
                q.renew(current_ticket[0])
            except OSError:
                pass
        top = sorted((r for r in cell_best if r["bound_s"] is not None),
                     key=lambda r: r["bound_s"])[:5]
        compiles = evaluator.compile_count - compiles0
        pruned = evaluator.pruned_count - pruned0
        evals = db.count()
        payload = {
            "pid": os.getpid(), "mesh": mesh_name, "space": "kernels",
            "shard": f"{shard[0]}/{shard[1]}" if shard else None,
            "status": status,
            "cells_total": cells_total, "cells_done": len(cell_rows),
            **counts,
            "cell_in_progress": cell, "iteration": iteration,
            "evaluations": evals - evals0,
            "compiles": compiles, "pruned": pruned,
            "measured": evaluator.measured_count,
            "measured_replayed": evaluator.measured_replayed,
            "evaluations_total": evals,
            "compiles_total": compiles_prior + compiles,
            "pruned_total": pruned_prior + pruned,
            # this process's kernel launches, per kernel and per route (the
            # port's own fields: a supervisor sums its workers' with them)
            "kernel_launches": ops.launch_counts(),
            "kernel_route_launches": ops.route_launch_counts(),
            "best": top, "ts": round(time.time(), 3)}
        if q is not None:
            payload["queue"] = {**q.counts(), "owner": owner,
                                "stolen": qstats["stolen"]}
        if iter_stats:
            payload.update({f"iter_{k}": iter_stats.get(k) for k in
                            ("evaluated", "compiled", "pruned", "cache_hits",
                             "phase")})
        write_progress(out_dir, payload)

    def promote_heads(arch: str, shape: str) -> None:
        """Tier-2 promotion for one finished kernel cell (same dedupe and
        shared-cache replay semantics as the plan campaign; the correctness
        gate runs again on the executed output)."""
        if measure_top_k <= 0:
            return
        measured_keys = {d.point.get("__key__")
                         for d in db.measured_rows(arch, shape,
                                                   mesh=mesh_name)}
        if objective == "pareto":
            front = db.front(arch, shape, k=measure_top_k, mesh=mesh_name)
            promos = plan_front_promotions(front, measured_keys,
                                           top_k=measure_top_k,
                                           budget_left=mstate["budget_left"])
        else:
            heads = db.winners(arch, shape, k=measure_top_k, mesh=mesh_name)
            promos = plan_promotions(heads, measured_keys,
                                     top_k=measure_top_k,
                                     budget_left=mstate["budget_left"])
        for head in promos:
            progress("measuring", cell=f"{arch}/{shape}")
            point = PlanPoint(dims={k: v for k, v in head.point.items()
                                    if k != "__key__"})
            dp = evaluator.measure(arch, shape, point,
                                   modeled_bound_s=head.metrics.get("bound_s"))
            db.append(dp)
            if mstate["budget_left"] is not None:
                mstate["budget_left"] -= 1
            if dp.status == "ok":
                log(f"{arch}/{shape}: measured {point.key()} = "
                    f"{dp.metrics['measured_us']:.0f}us "
                    f"[{dp.metrics.get('backend')}]")
            else:
                log(f"{arch}/{shape}: measurement of {point.key()} -> "
                    f"{dp.status}: {dp.reason}")

    def note_cell(arch: str, shape: str) -> None:
        best = db.best(arch, shape, mesh=mesh_name)
        cell_best.append({"cell": f"{arch}/{shape}",
                          "bound_s": best.metrics.get("bound_s")
                          if best else None})
        progress("running")
        _injected_crash_hook(len(cell_rows))

    def process_cell(arch: str, shape: str) -> str:
        """Run/resume one kernel cell (reports, counters, heartbeat);
        returns the cell status — shared by the static and queue drive
        loops, mirroring the plan campaign's ``process_cell``."""
        rpath = cell_report_path(out_dir, arch, shape, mesh_name)
        prior = None
        if resume and rpath.exists():
            try:
                prior = json.loads(rpath.read_text())
            except json.JSONDecodeError:
                log(f"{arch}/{shape}: unreadable report — re-running cell")
        if prior is not None:
            counts["resumed"] += 1
            cell_rows.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                              "status": "resumed",
                              "improvement": prior.get("improvement")})
            log(f"{arch}/{shape}: resumed (report exists)")
            promote_heads(arch, shape)
            note_cell(arch, shape)
            return "resumed"

        t_cell = time.time()
        report = _explore_kernel_cell(
            arch, shape, evaluator=evaluator, db=db, cost_model=cost_model,
            gate=gate, strategy=make_strategy(strategy, seed=seed,
                                              objective=objective),
            iterations=iterations, budget=budget, seed=seed,
            heartbeat=lambda info: progress(
                "running", cell=f"{arch}/{shape}",
                iteration=info.get("iteration"), iter_stats=info),
            log=log)
        report["status"] = "complete"
        report["wall_s"] = round(time.time() - t_cell, 1)
        write_json_atomic(rpath, report)
        counts["ran"] += 1
        cell_rows.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                          "status": "complete",
                          "improvement": report["improvement"]})
        log(f"{arch}/{shape}: done in {report['wall_s']}s "
            f"(improvement {report['improvement']:.2%}, "
            f"cache {cache.stats()})")
        promote_heads(arch, shape)
        note_cell(arch, shape)
        return "complete"

    progress("starting")
    if q is None:
        for arch, shape in cells:
            process_cell(arch, shape)
    else:
        while True:
            ticket = q.acquire(owner)
            if ticket is None:
                if q.drained():
                    break
                progress("waiting")
                time.sleep(queue_poll_s)
                continue
            current_ticket[0] = ticket
            log(f"{ticket.cell}: leased (attempt {ticket.attempt})")
            status = process_cell(ticket.arch, ticket.shape)
            current_ticket[0] = None
            if not q.complete(ticket, status=status):
                qstats["stolen"] += 1
                log(f"{ticket.cell}: lease lost before completion "
                    f"(stolen/reclaimed) — results kept, merge dedupes")

    cell_rows.sort(key=lambda c: (c["arch"], c["shape"], c["mesh"]))
    leaderboard = build_leaderboard(db, cell_rows, objective=objective)
    lb_path = write_json_atomic(out_dir / "leaderboard.json", leaderboard)

    def _num(x):
        return None if x is None or x != x else x

    bench_cells = []
    for c in cell_rows:
        try:
            rep = json.loads(cell_report_path(out_dir, c["arch"], c["shape"],
                                              mesh_name).read_text())
        except (OSError, json.JSONDecodeError):
            rep = {}
        default = rep.get("baseline") or {}
        best = rep.get("best") or {}
        bench_cells.append({
            "cell": f"{c['arch']}/{c['shape']}",
            "kernel": parse_kernel_arch(c["arch"]),
            "status": c["status"],
            "default_point": default.get("point"),
            "default_bound_s": _num(default.get("bound_s")),
            "tuned_point": best.get("point"),
            "tuned_bound_s": _num(best.get("bound_s")),
            "improvement": _num(c.get("improvement")),
            "incumbent_by_iteration": [_num(it.get("best_bound"))
                                       for it in rep.get("iterations") or []],
        })
    bench = {
        "schema": "kernels-v1",
        "mesh": mesh_name,
        "strategy": strategy,
        "measure_top_k": measure_top_k,
        "correctness": _correctness_stats(db, cell_rows),
        "tiers": {
            "surrogate_pruned": evaluator.pruned_count - pruned0,
            "dryrun_compiles": evaluator.compile_count - compiles0,
            "dryrun_cache": cache.stats(),
            "measured": evaluator.measured_count,
            "measured_replayed": evaluator.measured_replayed,
        },
        "cells": bench_cells,
    }
    bench_path = write_json_atomic(out_dir / "BENCH_kernels.json", bench)

    evals = db.count()
    summary = {
        "mesh": mesh_name, "space": "kernels", "cells": len(cell_rows),
        **counts,
        "shard": f"{shard[0]}/{shard[1]}" if shard else None,
        "queue": str(q.root) if q is not None else None,
        "queue_owner": owner,
        "stolen": qstats["stolen"] if q is not None else None,
        "strategy": strategy,
        "objective": objective,
        "wall_s": round(time.time() - t0, 1),
        "evaluations": evals - evals0,
        "compiles": evaluator.compile_count - compiles0,
        "pruned": evaluator.pruned_count - pruned0,
        "measured": evaluator.measured_count,
        "measured_replayed": evaluator.measured_replayed,
        "measure_top_k": measure_top_k,
        "evaluations_total": evals,
        "compiles_total": compiles_prior + evaluator.compile_count - compiles0,
        "pruned_total": pruned_prior + evaluator.pruned_count - pruned0,
        "correctness": _correctness_stats(db, cell_rows),
        "cache": cache.stats(),
        "leaderboard": str(lb_path),
        "bench": str(bench_path),
    }
    if gate is not None:
        summary["gate"] = {"active": gate.active, "pruned": gate.pruned_total,
                           "val_rmse": gate.last_rmse, "n": gate.last_val_n,
                           "last_scope": gate.last_scope}
    progress("done")
    log(f"summary: {summary}")
    return summary


def _explore_kernel_cell(arch: str, shape: str, *, evaluator, db, cost_model,
                         strategy, iterations: int, budget: int,
                         seed: int, gate=None, heartbeat=None,
                         log=print) -> Dict:
    """The per-cell search loop. Returns the report dict (``baseline`` /
    ``best`` / ``iterations`` / ``improvement``) in the reference's shape."""
    from repro_torch.core.design_space import KernelTemplate, baseline_kernel_point
    from repro_torch.search import SearchState, select_candidates

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
