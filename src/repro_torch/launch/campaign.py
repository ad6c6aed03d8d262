"""Kernel campaigns: tune many kernel cells into one cost DB.

Counterpart of the ``--space kernels`` half of ``repro/launch/campaign.py``
and the campaign meshes (the plan grid and ``run_campaign`` wait for the
plan loop).
The helpers here are copied from the reference and shared by
``launch/kernel_cell.py`` (which runs the campaign), ``launch/dse.py`` and
``launch/merge_db.py``: the per-cell report path, the leaderboard, the CLI
validators, the progress heartbeat and the crash hook.

Quickstart (``--device cpu`` runs the kernels' plain versions; the default
is ``cuda``, and without a card that is an error):

    PYTHONPATH=src python -m repro_torch.launch.campaign --space kernels \\
        --archs vecmul,rmsnorm --shapes all --iterations 2 --budget 3 \\
        --device cpu --out artifacts/kernels

    # interrupted? same command again: completed cells are skipped, the
    # shared evaluation cache makes re-entered cells near-instant

``--shapes all`` means every CI shape of the chosen kernels (as in the
reference); full-width shapes are named explicitly. Search policy, gate
and ladder flags are the single-cell CLI's (``--strategy``,
``--gate-factor``, ``--gate-min-factor``, ``--measure-top-k``), plus
``--measure-budget`` (campaign-wide cap on measured runs) and
``--objective {bound_s,pareto}`` (leaderboard ranking: the scalar bound,
or each cell's non-dominated front, with front promotions and the
weight-armed ensemble).

Scale-out: ``--shard i/n`` runs cells ``i::n`` of the sorted grid, and
``--queue DIR`` pulls cells from a crash-safe lease queue
(``repro_torch.launch.scheduler``) shared by every worker, which also
share the queue's evaluation and measured caches. Either way the shard
directories fold into one with ``python -m repro_torch.launch.merge_db``.

Outputs under --out: ``cost_db.jsonl``, ``dryrun_cache/``,
``measured_cache/`` (both in the queue dir in queue mode),
``reports/{arch}__{shape}__{mesh}.json``, ``leaderboard.json``,
``BENCH_kernels.json`` and ``progress.json`` (the heartbeat, atomically
replaced at every iteration and cell boundary; every beat renews the
worker's lease in queue mode).

Test hook (ignored when unset): ``REPRO_CAMPAIGN_CRASH_TOKEN`` names a
file; once it exists and ``REPRO_CAMPAIGN_CRASH_AFTER_CELLS`` (default 1)
cells finished, the file is unlinked and the process dies with
``os._exit(86)`` at a cell boundary.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.launch.ioutil import write_json_atomic

__all__ = [
    "OBJECTIVE_CHOICES", "build_leaderboard", "build_parser",
    "cell_report_path", "main", "make_campaign_mesh", "parse_shard",
    "read_progress",
    "validate_gate_args", "validate_measure_args", "validate_objective_args",
    "write_progress",
]

PROGRESS_FILE = "progress.json"
#: leaderboard ranking modes: the scalar bound, or the dominance-ranked
#: multi-objective front
OBJECTIVE_CHOICES = ("bound_s", "pareto")


def make_campaign_mesh(name: str, device: str = "cuda"):
    """The mesh for a ``--mesh`` choice; returns ``(mesh, mesh_name)``.
    ``tiny`` (1x1, on ``device``) is the measured tier's; the others live
    on a fake process group (``launch/mesh.py``)."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    if name == "pod":
        return make_production_mesh(), "pod16x16"
    if name == "multipod":
        return make_production_mesh(multi_pod=True), "multipod2x16x16"
    if name == "tiny":
        return make_mesh((1, 1), ("data", "model"), device), "tiny1x1"
    return make_mesh((2, 4), ("data", "model")), "small2x4"


def cell_report_path(out_dir: Path, arch: str, shape: str, mesh_name: str) -> Path:
    """Canonical per-cell report location: ``reports/{arch}__{shape}__{mesh}.json``
    under the campaign dir (``merge_db`` parses cells back out of the name)."""
    return Path(out_dir) / "reports" / f"{arch}__{shape}__{mesh_name}.json"


def build_leaderboard(db, cell_rows: Sequence[Dict],
                      objective: str = "bound_s") -> List[Dict]:
    """Rank completed cells by their best achieved bound (fastest first);
    cells with no feasible design sink to the bottom with their failure
    mode preserved. Cells with tier-2 rows report ``measured_us`` (and the
    backend that produced it) alongside the modelled bound, preferring
    the measurement of the cell's best design; ranking stays on the bound.

    ``objective="pareto"`` ranks each cell's designs by objective-vector
    dominance instead (``CostDB.pareto``): the representative design
    becomes the deterministic front head, and every row gains
    ``objective`` / ``front`` (the rank-0 non-dominated set, each entry
    ``{point, objectives, crowding}`` with boundary ``inf`` crowding
    serialized as null) / ``front_size``. The default scalar mode adds no
    keys."""
    from repro_torch.core.promotion import select_measured_row

    err = validate_objective_args(objective)
    if err:
        raise ValueError(err)
    pareto = objective == "pareto"
    rows = []
    for c in cell_rows:
        front = []
        if pareto:
            ranked = db.pareto(c["arch"], c["shape"], mesh=c["mesh"])
            front = [(d, crowd, objs) for d, rank, crowd, objs in ranked
                     if rank == 0]
            best = ranked[0][0] if ranked else None
        else:
            best = db.best(c["arch"], c["shape"], mesh=c["mesh"])
        feasible = best is not None
        if best is None:
            # negative datapoints still rank: the fastest *infeasible* design
            # tells the reader how far off the budget this cell is
            cands = [d for d in db.query(c["arch"], c["shape"], mesh=c["mesh"])
                     if d.metrics.get("bound_s")]
            best = (min(cands, key=lambda d: d.metrics["bound_s"])
                    if cands else None)
        row = {
            "arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
            "status": c["status"],
            "feasible": feasible if best is not None else None,
            # evaluated designs only: gate-pruned rows are predictions and
            # tier-2 rows re-time an already-counted design
            "n_points": sum(d.status != "pruned" and d.fidelity != "measured"
                            for d in
                            db.query(c["arch"], c["shape"], mesh=c["mesh"])),
            "improvement": c.get("improvement"),
            "bound_s": None, "mfu_at_bound": None, "dominant": None,
            "per_device_gib": None, "best_point": None,
            "measured_us": None, "measured_backend": None,
        }
        if best is not None:
            row.update(
                bound_s=best.metrics.get("bound_s"),
                mfu_at_bound=best.metrics.get("mfu_at_bound"),
                dominant=best.metrics.get("dominant"),
                per_device_gib=best.metrics.get("per_device_gib"),
                # sorted: identical serialization whether the DB is the live
                # in-memory one or re-read from JSONL (to_json sorts keys),
                # so a sharded run + merge_db reproduces this byte-for-byte
                best_point={k: v for k, v in sorted(best.point.items())
                            if k != "__key__"},
            )
        if pareto:
            row["objective"] = "pareto"
            # rank-0 entries in deterministic front order; inf crowding
            # (boundary points) serializes as null, so the file stays
            # strict JSON
            row["front"] = [
                {"point": {k: v for k, v in sorted(d.point.items())
                           if k != "__key__"},
                 "objectives": {k: objs[k] for k in sorted(objs)},
                 "crowding": (None if crowd == float("inf") else crowd)}
                for d, crowd, objs in front]
            row["front_size"] = len(row["front"])
        measured = [d for d in db.measured_rows(c["arch"], c["shape"],
                                                mesh=c["mesh"])
                    if d.status == "ok"]
        if best is not None:
            of_best = [d for d in measured
                       if d.point.get("__key__") == best.point.get("__key__")]
            measured = of_best or measured
        m = select_measured_row(measured)
        if m is not None:
            row.update(measured_us=m.metrics.get("measured_us"),
                       measured_backend=m.metrics.get("backend"))
        rows.append(row)
    rows.sort(key=lambda r: (r["bound_s"] is None, r["feasible"] is not True,
                             r["bound_s"] if r["bound_s"] is not None else 0.0))
    return rows


def validate_gate_args(gate_factor: Optional[float],
                       gate_min_factor: Optional[float]) -> Optional[str]:
    """The one place the surrogate-gate CLI constraints live (returns an
    error string, or ``None`` when valid): shared by the campaign and dse
    CLIs and by ``run_kernel_campaign``'s API validation, so they never
    drift from each other or from ``SurrogateGate.__post_init__``."""
    if gate_factor is not None and gate_factor <= 1.0:
        return (f"gate-factor must be > 1 (got {gate_factor}): the gate "
                "prunes candidates predicted SLOWER than factor x the "
                "incumbent")
    if gate_min_factor is not None:
        if gate_factor is None:
            return ("gate-min-factor requires gate-factor (annealing "
                    "tightens the gate's threshold; there is no gate "
                    "without a factor)")
        if not (1.0 < gate_min_factor <= gate_factor):
            return (f"gate-min-factor must be in (1, {gate_factor}], "
                    f"got {gate_min_factor}")
    return None


def validate_measure_args(measure_top_k: int, measure_runs: int,
                          measure_budget: Optional[int]) -> Optional[str]:
    """The measured-tier CLI constraints (an error string, or ``None`` when
    valid), mirroring :func:`validate_gate_args`."""
    if measure_top_k < 0:
        return f"measure-top-k must be >= 0, got {measure_top_k}"
    if measure_runs < 1:
        return f"measure-runs must be >= 1, got {measure_runs}"
    if measure_budget is not None:
        if measure_top_k <= 0:
            return ("measure-budget requires measure-top-k > 0: the budget "
                    "caps tier-2 promotions, and there are none without a "
                    "top-k")
        if measure_budget < 0:
            return f"measure-budget must be >= 0, got {measure_budget}"
    return None


def validate_objective_args(objective: str) -> Optional[str]:
    """The objective-mode constraint (an error string, or ``None`` when
    valid), mirroring :func:`validate_gate_args`."""
    if objective not in OBJECTIVE_CHOICES:
        return (f"objective must be one of {OBJECTIVE_CHOICES}, "
                f"got {objective!r}")
    return None


def write_progress(out_dir: Path, payload: Dict) -> Path:
    """Atomically replace ``progress.json`` under ``out_dir`` (see
    :func:`write_json_atomic`) so a concurrently-polling supervisor never
    reads a torn heartbeat. Returns the progress path."""
    return write_json_atomic(Path(out_dir) / PROGRESS_FILE, payload)


def read_progress(out_dir: Path) -> Dict:
    """Best-effort read of a shard's ``progress.json``: returns ``{}`` for a
    missing, torn, or mid-replace file ('no news', never a crash)."""
    try:
        return json.loads((Path(out_dir) / PROGRESS_FILE).read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def _injected_crash_hook(cells_done: int) -> None:
    """Test-only one-shot fault injection (see module docstring): when the
    ``REPRO_CAMPAIGN_CRASH_TOKEN`` file exists and ``cells_done`` reached
    ``REPRO_CAMPAIGN_CRASH_AFTER_CELLS`` (default 1), unlink the token and
    die abruptly (``os._exit(86)``, no summary, no cleanup) at a cell
    boundary. The unlink disarms the fault, so a restart of the same
    command runs clean."""
    token = os.environ.get("REPRO_CAMPAIGN_CRASH_TOKEN")
    if not token:
        return
    after = int(os.environ.get("REPRO_CAMPAIGN_CRASH_AFTER_CELLS", "1"))
    p = Path(token)
    if cells_done >= after and p.exists():
        p.unlink()
        os._exit(86)


def build_parser() -> argparse.ArgumentParser:
    """The campaign CLI surface, importable cheaply."""
    from repro_torch.launch.kernel_cell import KERNEL_STRATEGY_CHOICES

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.campaign")
    ap.add_argument("--space", default="kernels", choices=["kernels"],
                    help="design space: 'kernels' tunes kernel tile configs "
                         "(--archs are kernel names, --shapes KERNEL_SHAPES "
                         "names); the plan space is not yet ported")
    ap.add_argument("--archs", default="all",
                    help="comma-separated kernel names, or 'all'")
    ap.add_argument("--shapes", default="all",
                    help="comma-separated kernel shape names, or 'all' "
                         "(every CI shape of the chosen kernels)")
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--budget", type=int, default=3,
                    help="evaluations per loop iteration")
    ap.add_argument("--out", default="artifacts/kernels")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells even if their reports exist")
    ap.add_argument("--strategy", default="ensemble",
                    choices=list(KERNEL_STRATEGY_CHOICES),
                    help="search strategy per cell (fresh instance each cell)")
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
                    help="promotion ladder tier 2: after each cell, launch "
                         "and time its K best designs on the card (0 = off)")
    ap.add_argument("--measure-runs", type=int, default=3, metavar="N",
                    help="timed launches per measurement (min reported)")
    ap.add_argument("--measure-budget", type=int, default=None, metavar="M",
                    help="campaign-wide cap on tier-2 measurements "
                         "(default: unlimited; requires --measure-top-k)")
    ap.add_argument("--objective", default="bound_s",
                    choices=list(OBJECTIVE_CHOICES),
                    help="leaderboard ranking: 'bound_s' keeps the scalar "
                         "bound; 'pareto' ranks each cell's designs by "
                         "objective-vector dominance, emits the front per "
                         "cell, promotes the measured tier along the front, "
                         "and arms the ensemble with weight arms")
    ap.add_argument("--shard", default=None, metavar="I/N",
                    help="run only cells i, i+n, i+2n, ... of the sorted "
                         "grid (merge shards with repro_torch.launch.merge_db)")
    ap.add_argument("--queue", default=None, metavar="DIR",
                    help="pull cells from the crash-safe lease queue at DIR "
                         "instead of a static grid slice (seeds the queue "
                         "idempotently; mutually exclusive with --shard)")
    ap.add_argument("--queue-owner", default=None, metavar="NAME",
                    help="lease owner id for --queue (default: pid<PID>)")
    ap.add_argument("--queue-lease-s", type=float, default=300.0,
                    help="lease length in seconds for --queue; renewed on "
                         "every heartbeat")
    ap.add_argument("--queue-poll-s", type=float, default=0.5,
                    help="seconds between queue polls while idle-waiting "
                         "for other owners' leased cells")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cuda' (default) runs the Hopper kernels; 'cpu' "
                         "runs their plain versions")
    return ap


def parse_shard(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse an ``i/n`` shard spec into ``(i, n)``; ``None``/empty passes
    through. Raises ``ValueError`` on malformed specs or ``i`` outside
    ``0..n-1``."""
    if not spec:
        return None
    try:
        i, n = (int(x) for x in spec.split("/"))
    except ValueError:
        raise ValueError(f"shard spec must look like i/n, got {spec!r}")
    if not (0 <= i < n):
        raise ValueError(f"shard index must satisfy 0 <= i < n, got {spec}")
    return (i, n)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """CLI entry: validate the arguments and the grid, then run (or resume)
    the kernel campaign; returns its summary. Exits 2 on bad arguments;
    raises when ``cuda`` is asked for and there is no card."""
    ap = build_parser()
    args = ap.parse_args(argv)
    gate_err = validate_gate_args(args.gate_factor, args.gate_min_factor)
    if gate_err:
        ap.error(gate_err)
    measure_err = validate_measure_args(args.measure_top_k, args.measure_runs,
                                        args.measure_budget)
    if measure_err:
        ap.error(measure_err)
    if args.queue and args.shard:
        ap.error("--queue and --shard are mutually exclusive")
    if args.queue_lease_s <= 0:
        ap.error(f"--queue-lease-s must be > 0, got {args.queue_lease_s}")
    if args.queue_poll_s <= 0:
        ap.error(f"--queue-poll-s must be > 0, got {args.queue_poll_s}")
    try:
        shard = parse_shard(args.shard)
    except ValueError as e:
        ap.error(str(e))
    from repro_torch.launch import kernel_cell

    try:
        kernel_list, shape_list = kernel_cell.resolve_kernel_grid(
            args.archs, args.shapes)
    except ValueError as e:
        ap.error(str(e))
    return kernel_cell.run_kernel_campaign(
        kernel_list, shape_list, out_dir=args.out,
        iterations=args.iterations, budget=args.budget,
        strategy=args.strategy, gate_factor=args.gate_factor,
        gate_min_factor=args.gate_min_factor,
        measure_top_k=args.measure_top_k, measure_runs=args.measure_runs,
        measure_budget=args.measure_budget, objective=args.objective,
        shard=shard, queue=args.queue, queue_owner=args.queue_owner,
        queue_lease_s=args.queue_lease_s, queue_poll_s=args.queue_poll_s,
        resume=not args.force, device=args.device)


if __name__ == "__main__":
    main()
