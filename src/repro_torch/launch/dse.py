"""SECDA-DSE loop launcher for one kernel cell, on the H100.

Counterpart of the ``--space kernels`` path of ``repro/launch/dse.py``.
One cell runs end to end: seed the shipped-default tile, the strategy
(by default the ensemble of greedy, anneal and evolve) proposes
candidates, the surrogate gate (``--gate-factor``) prunes those it
predicts too slow, each survivor launches the Hopper kernel with its tile
sizes and is held against the oracle on the card (the correctness gate)
and ranked on the Hopper resource model's bound, rows go to the
``CostDB``, the surrogate is fitted, and the promotion ladder's measured
tier times the best heads on the card.

Example:
    PYTHONPATH=src python -m repro_torch.launch.dse --space kernels \\
        --arch ssd_scan --shape ssd_mamba2_780m_b8_s4096_bf16 \\
        --strategy ensemble --gate-factor 3.0 --measure-top-k 2

``--objective pareto`` ranks the cell's designs by objective-vector
dominance (``bound_s``, ``vmem_util``, ``flops_util``): the ensemble gains
its weight-armed members, the measured tier promotes the front in front
order, and the report carries the front.

``--device cpu`` runs the kernels' plain versions on the CPU instead; the
default is ``cuda``, and without a card that is an error.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch.core.kernel_space import KERNEL_NAMES, KERNEL_SHAPES
from repro_torch.launch.campaign import (OBJECTIVE_CHOICES, build_leaderboard,
                                         validate_gate_args,
                                         validate_measure_args)
from repro_torch.launch.kernel_cell import KERNEL_STRATEGY_CHOICES


def build_parser() -> argparse.ArgumentParser:
    """The single-cell DSE CLI surface, importable cheaply."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dse")
    ap.add_argument("--space", default="kernels", choices=["kernels"],
                    help="design space: 'kernels' tunes one kernel's tile "
                         "config (--arch is the kernel name, --shape a "
                         "KERNEL_SHAPES name); the plan space is not yet "
                         "ported")
    ap.add_argument("--arch", required=True, choices=list(KERNEL_NAMES))
    ap.add_argument("--shape", required=True,
                    choices=[s.name for s in KERNEL_SHAPES])
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--budget", type=int, default=3, help="evaluations per iteration")
    ap.add_argument("--db", default="artifacts/dse/cost_db.jsonl")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the content-addressed evaluation cache")
    ap.add_argument("--strategy", default="ensemble",
                    choices=list(KERNEL_STRATEGY_CHOICES),
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
                    help="after the loop, launch and time the cell's K best "
                         "designs on the card (0 = off); measured rows land "
                         "in the cost DB with fidelity=measured")
    ap.add_argument("--measure-runs", type=int, default=3, metavar="N",
                    help="timed launches per measurement (min reported)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) runs the Hopper kernels; 'cpu' "
                         "runs their plain versions")
    ap.add_argument("--report", default=None, help="write the loop report JSON here")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """CLI entry: run one kernel cell end to end and return its report
    (with the gate's final state under ``"gate"`` when one ran). Exits 2 on
    bad arguments; raises when ``cuda`` is asked for and there is no card."""
    ap = build_parser()
    args = ap.parse_args(argv)
    measure_err = validate_measure_args(args.measure_top_k, args.measure_runs,
                                        None)
    if measure_err:
        ap.error(measure_err)
    gate_err = validate_gate_args(args.gate_factor, args.gate_min_factor)
    if gate_err:
        ap.error(gate_err)
    from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME, kernel_arch

    kshape = KERNEL_SHAPE_BY_NAME[args.shape]
    if kshape.kernel != args.arch:
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
