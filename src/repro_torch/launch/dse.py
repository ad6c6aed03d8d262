"""SECDA-DSE loop launcher for one cell: a plan cell on the fake mesh,
with its heads measured on the H100, or one kernel cell on the H100.

Counterpart of ``repro/launch/dse.py``.

``--space plans`` (the default) runs the loop of ``core/loop.py`` for one
(arch x shape) cell on the ``--mesh`` (16x16 ``pod``, 2x16x16
``multipod``, 2x4 ``small``): seed the expert baseline, let the strategy
propose (by default the ensemble of greedy, the LLM member, anneal and
evolve; ``--llm`` picks the LLM client), gate, dry-run the survivors on the
fake mesh over ``--workers`` spawned processes, append every row, observe,
and LoRA-fine-tune the surrogate every second iteration. With
``--measure-top-k K`` the K best heads then run on one card at the largest
power-of-two batch that fits it (``Evaluator.measure``). ``--approve``
asks on the terminal before a design is accepted.

``--space kernels`` tunes one kernel's tile config (``--arch`` is the
kernel name, ``--shape`` a ``KERNEL_SHAPES`` name; ``--mesh`` is
ignored): seed the shipped-default tile, the strategy proposes, the
surrogate gate (``--gate-factor``) prunes those it predicts too slow, each
survivor launches the Hopper kernel with its tile sizes and is held
against the oracle on the card (the correctness gate) and ranked on the
Hopper resource model's bound, and the measured tier times the best heads
on the card. ``--objective pareto`` ranks the cell's designs by
objective-vector dominance: the ensemble gains its weight-armed members,
the measured tier promotes the front in front order, and the report
carries the front.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.dse --space plans \
        --arch qwen3-0.6b --shape decode_32k --mesh small --iterations 2 \
        --budget 4 --workers 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dse --space kernels \
        --arch ssd_scan --shape ssd_mamba2_780m_b8_s4096_bf16 \
        --strategy ensemble --gate-factor 3.0 --measure-top-k 2

``--device`` is where measurements (plans) or kernels run: ``cuda`` by
default, and without a card that is an error; ``cpu`` runs on the CPU
only when asked (the kernels' plain versions). The plan dry runs need no
device.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch.configs import ARCH_NAMES, SHAPES
from repro_torch.core.kernel_space import KERNEL_NAMES, KERNEL_SHAPES
from repro_torch.launch.campaign import (OBJECTIVE_CHOICES, STRATEGY_CHOICES,
                                         build_leaderboard, validate_gate_args,
                                         validate_measure_args)
from repro_torch.launch.kernel_cell import KERNEL_STRATEGY_CHOICES


def build_parser() -> argparse.ArgumentParser:
    """The single-cell DSE CLI surface, importable cheaply."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dse")
    ap.add_argument("--space", default="plans", choices=["plans", "kernels"],
                    help="design space: 'plans' tunes a sharding plan for "
                         "one arch x shape cell; 'kernels' tunes one kernel's "
                         "tile config (--arch is the kernel name, --shape a "
                         "KERNEL_SHAPES name; --mesh ignored)")
    ap.add_argument("--arch", required=True,
                    choices=list(ARCH_NAMES) + list(KERNEL_NAMES))
    ap.add_argument("--shape", required=True,
                    choices=[s.name for s in SHAPES]
                    + [s.name for s in KERNEL_SHAPES])
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--budget", type=int, default=3, help="evaluations per iteration")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "small"])
    ap.add_argument("--db", default="artifacts/dse/cost_db.jsonl")
    ap.add_argument("--workers", type=int, default=1,
                    help="parallel dry-run processes (1 = in-process)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the content-addressed evaluation caches")
    ap.add_argument("--approve", action="store_true",
                    help="human-in-the-loop: confirm each accepted design")
    ap.add_argument("--llm", default="mock", choices=["mock", "ollama"])
    ap.add_argument("--strategy", default="ensemble",
                    choices=list(STRATEGY_CHOICES),
                    help="search strategy (see repro_torch.search)")
    ap.add_argument("--objective", default="bound_s",
                    choices=list(OBJECTIVE_CHOICES),
                    help="ranking mode: scalar bound_s (default) or "
                         "multi-objective pareto: the strategy scalarizes "
                         "along weight arms and tier-2 promotions walk the "
                         "dominance front instead of the scalar head")
    ap.add_argument("--gate-factor", type=float, default=None,
                    help="enable the surrogate gate: prune candidates whose "
                         "predicted bound is > FACTOR x the incumbent "
                         "(must be > 1)")
    ap.add_argument("--gate-min-factor", type=float, default=None,
                    help="anneal the gate's prune threshold from "
                         "--gate-factor down toward this as the surrogate's "
                         "validation RMSE improves (must be in "
                         "(1, gate-factor]; requires --gate-factor)")
    ap.add_argument("--measure-top-k", type=int, default=0, metavar="K",
                    help="after the loop, run and time the cell's K best "
                         "designs on one device (0 = off); measured rows "
                         "land in the cost DB with fidelity=measured")
    ap.add_argument("--measure-runs", type=int, default=3, metavar="N",
                    help="timed runs per measurement (min reported)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default): measure plans and run kernels on "
                         "the card; 'cpu': on the CPU (the kernels' plain "
                         "versions)")
    ap.add_argument("--report", default=None, help="write the loop report JSON here")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """CLI entry: run one cell end to end and return its report. Exits 2
    on bad arguments; raises when ``cuda`` is asked for and there is no
    card."""
    ap = build_parser()
    args = ap.parse_args(argv)
    measure_err = validate_measure_args(args.measure_top_k, args.measure_runs,
                                        None)
    if measure_err:
        ap.error(measure_err)
    gate_err = validate_gate_args(args.gate_factor, args.gate_min_factor)
    if gate_err:
        ap.error(gate_err)
    if args.space == "kernels":
        return _run_kernel_cell(ap, args)
    if args.arch not in ARCH_NAMES:
        ap.error(f"--arch {args.arch!r} is a kernel name; pass "
                 f"--space kernels to tune it")
    if args.shape not in {s.name for s in SHAPES}:
        ap.error(f"--shape {args.shape!r} is a kernel shape; pass "
                 f"--space kernels to tune it")
    return _run_plan_cell(args)


def _run_plan_cell(args) -> Dict:
    """``--space plans``: the DSE loop over one plan cell, then the
    measured tier on its heads; returns the report (the reference's keys,
    plus what the loop did: rows by status and source, the LLM member's
    proposals, the gate, the surrogate's fine-tunes, the measured heads,
    dry runs traced and wall times)."""
    from repro_torch.core.cost_db import CostDB, featurize
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.design_space import PlanPoint
    from repro_torch.core.device import resolve_device
    from repro_torch.core.eval_cache import DryRunCache
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.llm_client import MockLLM, OllamaClient
    from repro_torch.core.llm_stack import LLMStack
    from repro_torch.core.loop import DSELoop
    from repro_torch.core.promotion import (plan_front_promotions,
                                            plan_promotions)
    from repro_torch.core.rag import CodeIndex
    from repro_torch.launch.ioutil import write_json_atomic
    from repro_torch.search import (LLMGuided, PromotionLadder, SurrogateGate,
                                    make_strategy)

    device = resolve_device(args.device)
    t_start = time.perf_counter()
    db = CostDB(args.db)
    client = MockLLM() if args.llm == "mock" else OllamaClient()
    code_index = CodeIndex(roots=[Path(__file__).resolve().parents[1]]).build()
    stack = LLMStack(client=client, db=db, code_index=code_index)
    cost_model = CostModel.create(in_dim=featurize({}, {}).shape[0])

    approve = None
    if args.approve:
        def approve(dp):
            ans = input(f"accept design bound={dp.metrics.get('bound_s')}s? [Y/n] ")
            return ans.strip().lower() not in ("n", "no")

    cache = None if args.no_cache else DryRunCache.beside(db.path)
    measured_cache = (None if args.no_cache else
                      DryRunCache(Path(db.path).parent / "measured_cache"))
    evaluator = Evaluator(mesh=args.mesh, torch_device=str(device), cache=cache,
                          max_workers=max(args.workers, 1),
                          measured_cache=measured_cache,
                          measure_runs=args.measure_runs)
    mesh_name = evaluator.mesh_name
    gate_cls = PromotionLadder if args.measure_top_k > 0 else SurrogateGate
    gate = (gate_cls(cost_model, factor=args.gate_factor,
                     min_factor=args.gate_min_factor)
            if args.gate_factor is not None else None)
    strategy = make_strategy(args.strategy, llm_stack=stack, objective=args.objective)
    loop = DSELoop(evaluator=evaluator, db=db, llm_stack=stack,
                   cost_model=cost_model, approve_fn=approve,
                   strategy=strategy, gate=gate)
    try:
        report = loop.run(args.arch, args.shape, iterations=args.iterations,
                          eval_budget=args.budget)
    finally:
        evaluator.close()  # one dry-run pool served every iteration
    loop_s = time.perf_counter() - t_start
    out: Dict = {
        "arch": report.arch, "shape": report.shape, "mesh": mesh_name,
        "baseline": report.baseline.__dict__ if report.baseline else None,
        "best": report.best.__dict__ if report.best else None,
        "iterations": report.iterations,
        "improvement": report.improvement(),
    }
    if cache is not None:
        print(f"dry-run cache: {cache.stats()}")
    print(f"dry runs: {evaluator.compile_count} traced in {evaluator.dryrun_s:.1f} s "
          f"(loop {loop_s:.1f} s)")
    if gate is not None:
        out["gate"] = {"active": gate.active, "pruned": gate.pruned_total,
                       "val_rmse": gate.last_rmse, "n": gate.last_val_n}
        print(f"surrogate gate: active={gate.active} pruned={gate.pruned_total} "
              f"val_rmse={gate.last_rmse:.3f} (n={gate.last_val_n})")
    members = getattr(strategy, "members", [strategy])
    llm = [m for m in members if isinstance(m, LLMGuided)]
    if llm:
        out["llm"] = {"client": client.name,
                      "valid": sum(m.n_valid for m in llm),
                      "rejected": sum(m.n_rejected for m in llm)}
        print(f"llm member ({client.name}): {out['llm']['valid']} valid proposals, "
              f"{out['llm']['rejected']} rejected")
    out["finetunes"] = report.finetunes

    measured = []
    if args.measure_top_k > 0:
        measured_keys = {d.point.get("__key__") for d in
                         db.measured_rows(args.arch, args.shape, mesh=mesh_name)}
        if args.objective == "pareto":
            front = db.front(args.arch, args.shape, k=args.measure_top_k,
                             mesh=mesh_name)
            promos = plan_front_promotions(front, measured_keys,
                                           top_k=args.measure_top_k)
        else:
            heads = db.winners(args.arch, args.shape, k=args.measure_top_k,
                               mesh=mesh_name)
            promos = plan_promotions(heads, measured_keys,
                                     top_k=args.measure_top_k)
        for head in promos:
            point = PlanPoint(dims={k: v for k, v in head.point.items()
                                    if k != "__key__"})
            bound = head.metrics.get("bound_s")
            dp = evaluator.measure(args.arch, args.shape, point, modeled_bound_s=bound)
            db.append(dp)
            m = dp.metrics
            entry = {"point": point.key(), "status": dp.status, "reason": dp.reason,
                     "bound_s": bound}
            if dp.status == "ok":
                entry.update({k: m[k] for k in ("measured_s", "backend", "device_name",
                                                "reduced", "peak_bytes",
                                                "bound_s_1x1", "per_device_bytes_1x1")},
                             share_of_1x1_bound=m["bound_s_1x1"] / m["measured_s"])
                print(f"measured {point.key()}: {m['measured_s'] * 1e3:.3f} ms on "
                      f"{m['backend']} ({m['device_name']}), reduced {m['reduced']}, "
                      f"peak {m['peak_bytes']} B, {entry['share_of_1x1_bound']:.1%} of "
                      f"the 1x1 bound {m['bound_s_1x1'] * 1e3:.3f} ms (modelled on "
                      f"{mesh_name}: {bound * 1e3:.3f} ms)")
            else:
                print(f"measurement of {point.key()} -> {dp.status}: {dp.reason}")
            measured.append(entry)
        print(f"measured tier: {evaluator.measured_count} timed, "
              f"{evaluator.measured_replayed} replayed from cache")
    out["measured"] = measured

    rows = db.query(args.arch, args.shape, mesh=mesh_name)
    rows += [d for d in db.query(args.arch, args.shape) if d.mesh == "-"]  # llm rejects
    by_status: Dict[str, int] = {}
    by_source: Dict[str, int] = {}
    for d in rows:
        by_status[d.status] = by_status.get(d.status, 0) + 1
        by_source[d.source] = by_source.get(d.source, 0) + 1
    out.update(rows_by_status=by_status, rows_by_source=by_source,
               compiles=evaluator.compile_count, dryrun_s=evaluator.dryrun_s,
               measured_timed=evaluator.measured_count,
               measured_replayed=evaluator.measured_replayed,
               loop_s=loop_s, wall_s=time.perf_counter() - t_start)
    print(f"rows: {by_status} by source {by_source}")
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        write_json_atomic(Path(args.report), out)
        print(f"report -> {args.report}")
    return out


def _run_kernel_cell(ap, args) -> Dict:
    """``--space kernels``: run one kernel cell end to end and return its
    report (with the gate's final state under ``"gate"`` when one ran)."""
    if args.arch not in KERNEL_NAMES:
        ap.error(f"--space kernels needs a kernel name for --arch "
                 f"(one of {KERNEL_NAMES}), got {args.arch!r}")
    if args.strategy not in KERNEL_STRATEGY_CHOICES:
        ap.error(f"--space kernels supports --strategy "
                 f"{KERNEL_STRATEGY_CHOICES}; llm/transfer variants are "
                 f"plan-coupled (got {args.strategy!r})")
    from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME, kernel_arch

    kshape = KERNEL_SHAPE_BY_NAME.get(args.shape)
    if kshape is None or kshape.kernel != args.arch:
        ours = tuple(s.name for s in KERNEL_SHAPES if s.kernel == args.arch)
        ap.error(f"--shape must name a {args.arch} kernel shape "
                 f"(one of {ours}), got {args.shape!r}")

    from repro_torch.core.cost_db import CostDB, featurize
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.design_space import PlanPoint
    from repro_torch.core.device import resolve_device
    from repro_torch.core.eval_cache import DryRunCache
    from repro_torch.core.evaluator import KernelEvaluator
    from repro_torch.core.promotion import (plan_front_promotions,
                                            plan_promotions)
    from repro_torch.launch.kernel_cell import (KERNEL_MESH_NAME,
                                                _explore_kernel_cell)
    from repro_torch.search import (PromotionLadder, SurrogateGate,
                                    make_strategy)

    device = resolve_device(args.device)
    arch = kernel_arch(args.arch)
    db = CostDB(args.db)
    cache = None if args.no_cache else DryRunCache.beside(db.path)
    measured_cache = (None if args.no_cache else
                      DryRunCache(Path(db.path).parent / "measured_cache"))
    evaluator = KernelEvaluator(mesh_name=KERNEL_MESH_NAME,
                                torch_device=str(device), cache=cache,
                                measured_cache=measured_cache,
                                measure_runs=args.measure_runs)
    cost_model = CostModel.create(in_dim=featurize({}, {}).shape[0])
    gate_cls = PromotionLadder if args.measure_top_k > 0 else SurrogateGate
    gate = (gate_cls(cost_model, factor=args.gate_factor,
                     min_factor=args.gate_min_factor)
            if args.gate_factor is not None else None)
    report = _explore_kernel_cell(
        arch, args.shape, evaluator=evaluator, db=db, cost_model=cost_model,
        gate=gate, strategy=make_strategy(args.strategy,
                                          objective=args.objective),
        iterations=args.iterations, budget=args.budget, seed=0)
    if cache is not None:
        print(f"evaluation cache: {cache.stats()}")
    if gate is not None:
        report["gate"] = {"active": gate.active, "pruned": gate.pruned_total,
                          "val_rmse": gate.last_rmse, "n": gate.last_val_n}
        print(f"surrogate gate: active={gate.active} "
              f"pruned={gate.pruned_total} "
              f"val_rmse={gate.last_rmse:.3f} (n={gate.last_val_n})")

    if args.measure_top_k > 0:
        measured_keys = {d.point.get("__key__") for d in
                         db.measured_rows(arch, args.shape,
                                          mesh=KERNEL_MESH_NAME)}
        if args.objective == "pareto":
            front = db.front(arch, args.shape, k=args.measure_top_k,
                             mesh=KERNEL_MESH_NAME)
            promos = plan_front_promotions(front, measured_keys,
                                           top_k=args.measure_top_k)
        else:
            heads = db.winners(arch, args.shape, k=args.measure_top_k,
                               mesh=KERNEL_MESH_NAME)
            promos = plan_promotions(heads, measured_keys,
                                     top_k=args.measure_top_k)
        for head in promos:
            point = PlanPoint(dims={k: v for k, v in head.point.items()
                                    if k != "__key__"})
            dp = evaluator.measure(arch, args.shape, point,
                                   modeled_bound_s=head.metrics.get("bound_s"))
            db.append(dp)
            if dp.status == "ok":
                print(f"measured {point.key()} {dict(point.dims)}: "
                      f"{dp.metrics['measured_us']:.1f}us (modelled "
                      f"{head.metrics['bound_s'] * 1e6:.1f}us) "
                      f"[{dp.metrics['backend']}: {dp.metrics['device_name']}]")
            else:
                print(f"measurement of {point.key()} -> {dp.status}: "
                      f"{dp.reason}")
        print(f"measured tier: {evaluator.measured_count} timed, "
              f"{evaluator.measured_replayed} replayed from cache")

    if args.objective == "pareto":
        # the cell's rank-0 designs in front order, as the leaderboard
        # serializes them
        cell = {"arch": arch, "shape": args.shape, "mesh": KERNEL_MESH_NAME,
                "status": "complete", "improvement": report["improvement"]}
        report["front"] = build_leaderboard(db, [cell],
                                            objective="pareto")[0]["front"]
        print(f"pareto front: {len(report['front'])} design(s)")

    if args.report:
        from repro_torch.launch.ioutil import write_json_atomic

        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        write_json_atomic(Path(args.report), report)
        print(f"report -> {args.report}")
    return report


if __name__ == "__main__":
    main()
