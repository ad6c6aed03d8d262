"""Multi-workload DSE campaigns: plan cells and kernel cells.

Counterpart of ``repro/launch/campaign.py``. ``--space plans`` (the
default) sweeps an ``arch x shape`` grid of plan loops on one ``--mesh``
(:func:`run_campaign`); ``--space kernels`` tunes kernel cells
(``launch/kernel_cell.py::run_kernel_campaign``). Either way the cells
share one cost DB (so the surrogate and RAG retrieval learn across
workloads), one content-addressed evaluation cache (a design re-proposed
in another cell is never traced or launched again) and one measured
cache; every cell writes a report, a rerun of the same command resumes
from them, and the campaign ends with a leaderboard ranking each cell's
best design. The campaign meshes live in ``launch/mesh.py``.

Quickstart (``--device`` is where the measured tier and the kernels run:
``cuda`` by default, and without a card that is an error; ``cpu`` runs on
the CPU only when asked; the plan dry runs need no device):

    PYTHONPATH=src python -m repro_torch.launch.campaign \\
        --archs qwen3-0.6b,stablelm-3b --shapes train_4k,decode_32k \\
        --mesh small --iterations 2 --budget 3 --workers 2 --device cpu \\
        --out artifacts/campaign

    PYTHONPATH=src python -m repro_torch.launch.campaign --space kernels \\
        --archs vecmul,rmsnorm --shapes all --device cpu --out artifacts/kernels

    # interrupted? same command again: completed cells are skipped, the
    # shared caches make re-entered cells near-instant

Each plan cell runs ``core/loop.py``'s loop with a fresh strategy
(``--strategy``, default the ensemble of greedy, the LLM member, anneal
and evolve; ``--llm`` picks the client); its dry runs trace on the fake
mesh over ``--workers`` spawned processes. ``--gate-factor`` prunes
candidates the surrogate predicts too slow (``--gate-min-factor`` anneals
it), ``--measure-top-k K`` times each cell's K best heads on one device
(the promotion ladder; ``--measure-budget`` caps it campaign-wide), and
``--objective pareto`` ranks by dominance, reports each cell's front and
promotes along it. A cell ``cell_supported`` refuses gets an
``unsupported`` report with its reason. For kernel cells ``--archs`` are
kernel names and ``--shapes`` kernel shape names (``all`` means every CI
shape of the chosen kernels; untouched defaults mean the whole kernel
grid), and ``--mesh``, ``--workers`` and ``--llm`` are ignored.

Scale-out: ``--shard i/n`` runs cells ``i::n`` of the sorted grid, and
``--queue DIR`` pulls cells from a crash-safe lease queue
(``repro_torch.launch.scheduler``) shared by every worker, which also
share the queue's evaluation and measured caches. Either way the shard
directories fold into one with ``python -m repro_torch.launch.merge_db``,
and ``python -m repro_torch.launch.orchestrator`` spawns, supervises and
merges the shards in one command. With the deterministic mock LLM and a
transfer-free strategy the merge reproduces a single process's
``leaderboard.json`` byte for byte.

Outputs under --out: ``cost_db.jsonl``, ``dryrun_cache/``,
``measured_cache/`` (both in the queue dir in queue mode),
``reports/{arch}__{shape}__{mesh}.json``, ``leaderboard.json``,
``BENCH_ladder.json`` (plans: the ladder's tiers, the gate's calibration
and each cell's incumbent by iteration) or ``BENCH_kernels.json``, and
``progress.json``: the heartbeat, atomically replaced at every proposal
round, evaluation batch, iteration and cell boundary. Its ``evaluations``
/ ``compiles`` / ``pruned`` count this attempt's work only, the
``*_total`` keys every attempt's; ``cell_in_progress`` and ``iteration``
place the work mid-cell; in queue mode it gains a ``queue`` sub-dict,
``status`` ``waiting`` marks an idle worker, and every beat renews the
worker's lease.

Test hooks (environment variables, ignored when unset):
``REPRO_CAMPAIGN_PRELUDE`` names a Python file that ``main()`` executes
before anything else (tests shrink configs this way in shard
subprocesses; spawned dry-run workers get the shrunken config in their
payload); ``REPRO_CAMPAIGN_CRASH_TOKEN`` names a file: once it exists and
``REPRO_CAMPAIGN_CRASH_AFTER_CELLS`` (default 1) cells finished, the file
is unlinked and the process dies with ``os._exit(86)`` at a cell boundary.

The module imports no torch at import time: the orchestrator reads its
grid helpers and validators.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.launch.ioutil import write_json_atomic
from repro_torch.launch.mesh import (CAMPAIGN_MESHES, campaign_mesh_shape,
                                     make_campaign_mesh)
from repro_torch.launch.scheduler import CellQueue, sanitize_owner

__all__ = [
    "CAMPAIGN_MESHES", "MESH_CHOICES", "OBJECTIVE_CHOICES",
    "STRATEGY_CHOICES", "build_leaderboard", "build_parser",
    "campaign_mesh_shape", "cell_report_path", "main", "make_campaign_mesh",
    "parse_shard", "read_progress", "resolve_grid", "run_campaign",
    "shard_cells", "validate_gate_args", "validate_measure_args",
    "validate_objective_args", "write_json_atomic", "write_progress",
]

PROGRESS_FILE = "progress.json"
MESH_CHOICES = tuple(CAMPAIGN_MESHES)
STRATEGY_CHOICES = ("greedy", "llm", "anneal", "evolve", "transfer",
                    "ensemble", "ensemble+transfer")
#: leaderboard ranking modes: the scalar bound, or the dominance-ranked
#: multi-objective front
OBJECTIVE_CHOICES = ("bound_s", "pareto")
DEVICE_CHOICES = ("cuda", "cpu")


def cell_report_path(out_dir: Path, arch: str, shape: str, mesh_name: str) -> Path:
    """Canonical per-cell report location: ``reports/{arch}__{shape}__{mesh}.json``
    under the campaign dir (``merge_db`` parses cells back out of the name)."""
    return Path(out_dir) / "reports" / f"{arch}__{shape}__{mesh_name}.json"


def resolve_grid(archs: str, shapes: str) -> Tuple[List[str], List[str]]:
    """Expand the CLI ``--archs`` / ``--shapes`` strings (comma-separated ids
    or the literal ``all``) into validated name lists. Raises ``ValueError``
    naming every unknown id; shared by the campaign and orchestrator
    CLIs."""
    from repro_torch.configs import ARCH_NAMES, SHAPES

    arch_list = list(ARCH_NAMES) if archs == "all" else archs.split(",")
    shape_list = ([s.name for s in SHAPES] if shapes == "all"
                  else shapes.split(","))
    unknown = [a for a in arch_list if a not in ARCH_NAMES]
    unknown += [s for s in shape_list if s not in {c.name for c in SHAPES}]
    if unknown:
        raise ValueError(f"unknown arch/shape: {unknown}")
    return arch_list, shape_list


def shard_cells(archs: Sequence[str], shapes: Sequence[str],
                shard: Optional[Tuple[int, int]] = None,
                ) -> List[Tuple[str, str]]:
    """The campaign's (arch, shape) work list: the full grid in sorted order
    (so every shard agrees on cell numbering), optionally keeping only cells
    whose index ``% n == i`` for ``shard=(i, n)``. Disjoint and exhaustive:
    the union over all shards is exactly the unsharded list."""
    cells = sorted({(a, s) for a in archs for s in shapes})
    if shard is None:
        return cells
    i, n = shard
    if not (0 <= i < n):
        raise ValueError(f"shard index {i} outside 0..{n - 1}")
    return cells[i::n]


def _cell_report(report) -> Dict:
    return {
        "arch": report.arch, "shape": report.shape,
        "baseline": report.baseline.__dict__ if report.baseline else None,
        "best": report.best.__dict__ if report.best else None,
        "iterations": report.iterations,
        "improvement": report.improvement(),
    }


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
    error string, or ``None`` when valid): shared by the campaign, dse and
    orchestrator CLIs and by the campaigns' API validation, so they never
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


def run_campaign(archs: Sequence[str], shapes: Sequence[str],
                 mesh: Optional[str], mesh_name: Optional[str] = None, *,
                 out_dir: Path | str, iterations: int = 2, budget: int = 3,
                 workers: int = 1, llm_client=None, db=None, resume: bool = True,
                 strategy: str = "ensemble", gate_factor: Optional[float] = None,
                 gate_min_factor: Optional[float] = None,
                 measure_top_k: int = 0, measure_runs: int = 3,
                 measure_budget: Optional[int] = None,
                 objective: str = "bound_s",
                 shard: Optional[Tuple[int, int]] = None,
                 queue: Optional[Path | str] = None,
                 queue_owner: Optional[str] = None,
                 queue_lease_s: float = 300.0, queue_poll_s: float = 0.5,
                 verbose: bool = True, device: str = "cuda") -> Dict:
    """Run (or resume) the plan grid — one deterministic ``shard=(i, n)``
    slice of it, or (``queue=DIR``) whatever cells this worker wins from
    the shared :class:`~repro_torch.launch.scheduler.CellQueue` — on the
    ``mesh`` choice (``tiny``, ``small``, ``pod``, ``multipod``; its name,
    such as ``pod16x16``, unless ``mesh_name`` is given) and return the
    campaign summary. Each cell gets a *fresh* search strategy; the cost
    DB, the caches, the surrogate and the :class:`Evaluator` (its dry-run
    workers, its measured tier on ``device``) are shared across cells. In
    queue mode the dry-run and measured caches live in the queue dir, so a
    re-leased or stolen cell replays its dry runs and timings; leases are
    renewed on every heartbeat and a lease lost mid-cell is surrendered
    (the local results stand and the merge dedupes). ``device`` is
    ``cuda`` (an error without a card) or ``cpu``."""
    if queue is not None and shard is not None:
        raise ValueError("--queue and --shard are mutually exclusive: the "
                         "queue replaces the static grid cut")
    if queue is not None and queue_poll_s <= 0:
        raise ValueError(f"queue_poll_s must be > 0 (got {queue_poll_s}): "
                         "0 busy-spins the idle-wait loop")
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

    from repro_torch.configs import SHAPE_BY_NAME, get_config
    from repro_torch.core.cost_db import CostDB, featurize
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.design_space import PlanPoint
    from repro_torch.core.device import resolve_device
    from repro_torch.core.eval_cache import DryRunCache
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.llm_client import MockLLM
    from repro_torch.core.llm_stack import LLMStack
    from repro_torch.core.loop import DSELoop
    from repro_torch.core.promotion import (plan_front_promotions,
                                            plan_promotions)
    from repro_torch.models import model as M
    from repro_torch.search import (PromotionLadder, SurrogateGate,
                                    make_strategy)

    torch_device = str(resolve_device(device))
    out_dir = Path(out_dir)
    (out_dir / "reports").mkdir(parents=True, exist_ok=True)
    db = db or CostDB(out_dir / "cost_db.jsonl")
    q = CellQueue(queue, lease_s=queue_lease_s) if queue is not None else None
    owner = (sanitize_owner(queue_owner or f"pid{os.getpid()}")
             if q is not None else None)
    # queue mode shares the caches across every worker: a stolen cell's
    # dry runs and timings replay (exactly-once measurement per design)
    cache = (DryRunCache(q.cache_dir) if q is not None
             else DryRunCache.beside(db.path))
    measured_cache = DryRunCache(q.measured_dir if q is not None
                                 else Path(db.path).parent / "measured_cache")
    evaluator = Evaluator(mesh=mesh, mesh_name=mesh_name or "",
                          torch_device=torch_device, cache=cache,
                          max_workers=max(workers, 1),
                          artifact_dir=str(out_dir / "dryrun"),
                          measured_cache=measured_cache,
                          measure_runs=measure_runs)
    mesh_name = evaluator.mesh_name
    stack = LLMStack(client=llm_client or MockLLM(), db=db)
    cost_model = CostModel.create(in_dim=featurize({}, {}).shape[0])
    # with the measured tier on, the gate is the full promotion ladder
    gate_cls = PromotionLadder if measure_top_k > 0 else SurrogateGate
    gate = (gate_cls(cost_model, factor=gate_factor,
                     min_factor=gate_min_factor)
            if gate_factor is not None else None)

    def log(msg):
        if verbose:
            print(f"[campaign {mesh_name}] {msg}", flush=True)

    t0 = time.time()
    cells = shard_cells(archs, shapes, shard) if q is None else []
    if q is not None:
        # idempotent: n identical commands seed the same queue race-free
        seeded = q.seed(shard_cells(archs, shapes), mesh=mesh_name)
        if seeded:
            log(f"queue {q.root}: seeded {seeded} cell ticket(s)")
    cell_rows: List[Dict] = []
    cell_best: List[Dict] = []  # {"cell": "arch/shape", "bound_s": float|None}
    counts = {"ran": 0, "resumed": 0, "unsupported": 0}
    qstats = {"stolen": 0}
    mstate = {"budget_left": measure_budget}  # campaign-wide tier-2 budget
    current_ticket: List[Optional[object]] = [None]  # the lease being worked

    # run-local counter baselines: the DB file and the prior heartbeat's
    # totals persist across restarts; the heartbeat reports this attempt's
    # deltas and keeps the cumulative view under *_total
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
            "pid": os.getpid(), "mesh": mesh_name,
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
            "best": top, "ts": round(time.time(), 3)}
        if q is not None:
            payload["queue"] = {**q.counts(), "owner": owner,
                                "stolen": qstats["stolen"]}
        if iter_stats:
            payload.update({f"iter_{k}": iter_stats.get(k) for k in
                            ("evaluated", "compiled", "pruned", "cache_hits",
                             "phase")})
        write_progress(out_dir, payload)

    def cell_heartbeat(arch: str, shape: str):
        """The per-iteration heartbeat threaded into ``DSELoop.run``."""
        cell = f"{arch}/{shape}"

        def beat(info: Dict) -> None:
            progress("running", cell=cell, iteration=info.get("iteration"),
                     iter_stats=info)
        return beat

    def promote_heads(arch: str, shape: str) -> None:
        """Tier-2 promotion for one finished cell: measure its (up to)
        ``measure_top_k`` best designs, complete and resumed cells alike
        (on resume the DB's measured rows dedupe the promotions to nothing;
        on a stolen cell the shared measured cache replays the timings).
        Under ``objective="pareto"`` the heads come in front order."""
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
                us = dp.metrics["measured_us"]
                bound = head.metrics.get("bound_s")
                vs = (f" (bound {bound * 1e6:.0f}us)" if bound else "")
                log(f"{arch}/{shape}: measured {point.key()} = "
                    f"{us:.0f}us{vs} [{dp.metrics.get('backend')}]")
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
        """Run/resume/skip one cell and record it (reports, counters,
        heartbeat); returns the cell status — shared by the static-grid
        and queue drive loops. The crash hook inside ``note_cell`` fires
        before the queue ticket is completed, so an injected kill always
        lands mid-lease."""
        rpath = cell_report_path(out_dir, arch, shape, mesh_name)
        prior = None
        if resume and rpath.exists():
            try:
                prior = json.loads(rpath.read_text())
            except json.JSONDecodeError:
                # a torn report means the cell never finished: re-run it
                log(f"{arch}/{shape}: unreadable report — re-running cell")
        if prior is not None:
            status = ("resumed" if prior.get("status") != "unsupported"
                      else "unsupported")
            counts[status] += 1
            cell_rows.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                              "status": status,
                              "improvement": prior.get("improvement")})
            log(f"{arch}/{shape}: resumed (report exists)")
            if status == "resumed":
                # heads may still be unmeasured (the prior attempt died
                # between the report and its promotions, or top-k grew)
                promote_heads(arch, shape)
            note_cell(arch, shape)
            return status

        supported, why = M.cell_supported(get_config(arch), SHAPE_BY_NAME[shape])
        if not supported:
            write_json_atomic(rpath,
                              {"arch": arch, "shape": shape,
                               "status": "unsupported", "reason": why})
            counts["unsupported"] += 1
            cell_rows.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                              "status": "unsupported", "improvement": None})
            log(f"{arch}/{shape}: unsupported ({why})")
            note_cell(arch, shape)
            return "unsupported"

        t_cell = time.time()
        loop = DSELoop(evaluator=evaluator, db=db, llm_stack=stack,
                       cost_model=cost_model, gate=gate,
                       strategy=make_strategy(strategy, llm_stack=stack,
                                              objective=objective))
        report = loop.run(arch, shape, iterations=iterations,
                          eval_budget=budget, verbose=verbose,
                          heartbeat=cell_heartbeat(arch, shape))
        out = _cell_report(report)
        out["status"] = "complete"
        out["wall_s"] = round(time.time() - t_cell, 1)
        # atomic: a kill mid-write must never leave a torn report
        write_json_atomic(rpath, out)
        counts["ran"] += 1
        cell_rows.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                          "status": "complete",
                          "improvement": report.improvement()})
        log(f"{arch}/{shape}: done in {out['wall_s']}s "
            f"(improvement {report.improvement():.2%}, "
            f"cache {cache.stats()})")
        promote_heads(arch, shape)
        note_cell(arch, shape)
        return "complete"

    progress("starting")
    try:
        if q is None:
            for arch, shape in cells:
                process_cell(arch, shape)
        else:
            # queue drive: win a lease, work it, complete it; keep polling
            # while other owners still hold leases, exit only when drained
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
    finally:
        evaluator.close()  # the dry-run pool lives for the whole campaign

    # sorted rows: the order merge_db reconstructs from the report files
    cell_rows.sort(key=lambda c: (c["arch"], c["shape"], c["mesh"]))
    leaderboard = build_leaderboard(db, cell_rows, objective=objective)
    lb_path = write_json_atomic(out_dir / "leaderboard.json", leaderboard)

    # the auditable ladder trajectory, written unconditionally; NaN becomes
    # null so the file stays strict JSON
    def _num(x):
        return None if x is None or x != x else x

    ladder_cells = []
    for c in cell_rows:
        try:
            rep = json.loads(cell_report_path(out_dir, c["arch"], c["shape"],
                                              mesh_name).read_text())
        except (OSError, json.JSONDecodeError):
            rep = {}
        ladder_cells.append({
            "cell": f"{c['arch']}/{c['shape']}",
            "status": c["status"],
            "incumbent_by_iteration": [_num(it.get("best_bound"))
                                       for it in rep.get("iterations") or []],
        })
    bench = {
        "schema": "ladder-v1",
        "mesh": mesh_name,
        "strategy": strategy,
        "measure_top_k": measure_top_k,
        "measure_budget": measure_budget,
        "tiers": {
            "surrogate_pruned": evaluator.pruned_count - pruned0,
            "dryrun_compiles": evaluator.compile_count - compiles0,
            "dryrun_cache": cache.stats(),
            "measured": evaluator.measured_count,
            "measured_replayed": evaluator.measured_replayed,
        },
        "calibration": {
            "val_rmse": _num(gate.last_rmse) if gate else None,
            "val_n": gate.last_val_n if gate else None,
            "measured_rmse": (_num(getattr(gate, "last_measured_rmse", None))
                              if gate else None),
            "measured_n": (getattr(gate, "last_measured_n", None)
                           if gate else None),
            "measured_offset": (_num(getattr(gate, "measured_offset", None))
                                if gate else None),
            "effective_factor": gate.effective_factor if gate else None,
            "gate_active": gate.active if gate else None,
        },
        "cells": ladder_cells,
    }
    bench_path = write_json_atomic(out_dir / "BENCH_ladder.json", bench)

    evals = db.count()
    summary = {
        "mesh": mesh_name, "cells": len(cell_rows), **counts,
        "shard": f"{shard[0]}/{shard[1]}" if shard else None,
        "queue": str(q.root) if q is not None else None,
        "queue_owner": owner,
        "stolen": qstats["stolen"] if q is not None else None,
        "strategy": strategy,
        "objective": objective,
        "wall_s": round(time.time() - t0, 1),
        # run-local work vs cumulative totals, as in the heartbeat
        "evaluations": evals - evals0,
        "compiles": evaluator.compile_count - compiles0,
        "pruned": evaluator.pruned_count - pruned0,
        "measured": evaluator.measured_count,
        "measured_replayed": evaluator.measured_replayed,
        "measure_top_k": measure_top_k,
        "evaluations_total": evals,
        "compiles_total": compiles_prior + evaluator.compile_count - compiles0,
        "pruned_total": pruned_prior + evaluator.pruned_count - pruned0,
        "cache": cache.stats(),
        "leaderboard": str(lb_path),
        "bench": str(bench_path),
    }
    progress("done")
    log(f"summary: {summary}")
    return summary


def build_parser() -> argparse.ArgumentParser:
    """The campaign CLI surface, importable without torch (the orchestrator
    replays it)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.campaign",
        description="parallel, cached, resumable multi-workload DSE campaign")
    ap.add_argument("--space", default="plans", choices=["plans", "kernels"],
                    help="design space: 'plans' tunes sharding plans over the "
                         "arch x shape grid; 'kernels' tunes kernel tile "
                         "configs (--archs become kernel names, --shapes "
                         "KERNEL_SHAPES names, --mesh, --workers and --llm "
                         "are ignored)")
    ap.add_argument("--archs", default="qwen3-0.6b,stablelm-3b",
                    help="comma-separated arch ids, or 'all' "
                         "(--space kernels: kernel names; the default means "
                         "all of them)")
    ap.add_argument("--shapes", default="train_4k,decode_32k",
                    help="comma-separated shape cells, or 'all' "
                         "(--space kernels: kernel shape names; 'all' or the "
                         "default means every CI shape of the chosen kernels)")
    ap.add_argument("--mesh", default="small", choices=list(MESH_CHOICES))
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--budget", type=int, default=3,
                    help="evaluations per loop iteration")
    ap.add_argument("--workers", type=int, default=2,
                    help="parallel dry-run processes")
    ap.add_argument("--out", default="artifacts/campaign")
    ap.add_argument("--llm", default="mock", choices=["mock", "ollama"])
    ap.add_argument("--force", action="store_true",
                    help="re-run cells even if their reports exist")
    ap.add_argument("--strategy", default="ensemble",
                    choices=list(STRATEGY_CHOICES),
                    help="search strategy per cell (fresh instance each "
                         "cell); *transfer variants seed cells from similar "
                         "finished cells in the shared DB")
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
                    help="promotion ladder tier 2: after each cell, run and "
                         "time its K best designs on --device (0 = off)")
    ap.add_argument("--measure-runs", type=int, default=3, metavar="N",
                    help="timed runs per measurement (min reported)")
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
                         "grid (merge shards with repro_torch.launch.merge_db, "
                         "or let repro_torch.launch.orchestrator drive it all)")
    ap.add_argument("--queue", default=None, metavar="DIR",
                    help="pull cells from the crash-safe lease queue at DIR "
                         "instead of a static grid slice (seeds the queue "
                         "idempotently; mutually exclusive with --shard)")
    ap.add_argument("--queue-owner", default=None, metavar="NAME",
                    help="lease owner id for --queue (default: pid<PID>); "
                         "the orchestrator passes shard<i>")
    ap.add_argument("--queue-lease-s", type=float, default=300.0,
                    help="lease length in seconds for --queue; renewed on "
                         "every heartbeat")
    ap.add_argument("--queue-poll-s", type=float, default=0.5,
                    help="seconds between queue polls while idle-waiting "
                         "for other owners' leased cells")
    ap.add_argument("--device", default="cuda", choices=list(DEVICE_CHOICES),
                    help="'cuda' (default): the measured tier and the "
                         "kernels run on the card; 'cpu': on the CPU (the "
                         "kernels' plain versions)")
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
    """CLI entry: run the optional test prelude, validate the arguments and
    the grid, then run (or resume) the campaign; returns its summary.
    Exits 2 on bad arguments; raises when ``cuda`` is asked for and there
    is no card."""
    ap = build_parser()
    args = ap.parse_args(argv)

    prelude = os.environ.get("REPRO_CAMPAIGN_PRELUDE")
    if prelude:
        src = Path(prelude).read_text()
        exec(compile(src, prelude, "exec"), {"__name__": "__repro_prelude__"})

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
    common = dict(out_dir=args.out, iterations=args.iterations,
                  budget=args.budget, strategy=args.strategy,
                  gate_factor=args.gate_factor,
                  gate_min_factor=args.gate_min_factor,
                  measure_top_k=args.measure_top_k,
                  measure_runs=args.measure_runs,
                  measure_budget=args.measure_budget,
                  objective=args.objective, shard=shard, queue=args.queue,
                  queue_owner=args.queue_owner,
                  queue_lease_s=args.queue_lease_s,
                  queue_poll_s=args.queue_poll_s, resume=not args.force,
                  device=args.device)
    if args.space == "kernels":
        from repro_torch.launch import kernel_cell

        # the plan-grid defaults are meaningless kernel ids: untouched
        # --archs/--shapes mean the whole kernel grid
        kernels = ("all" if args.archs == ap.get_default("archs")
                   else args.archs)
        kshapes = ("all" if args.shapes == ap.get_default("shapes")
                   else args.shapes)
        if args.strategy not in kernel_cell.KERNEL_STRATEGY_CHOICES:
            ap.error(f"--space kernels supports --strategy "
                     f"{kernel_cell.KERNEL_STRATEGY_CHOICES}; llm/transfer "
                     f"variants are plan-coupled (got {args.strategy!r})")
        try:
            kernel_list, shape_list = kernel_cell.resolve_kernel_grid(
                kernels, kshapes)
        except ValueError as e:
            ap.error(str(e))
        return kernel_cell.run_kernel_campaign(kernel_list, shape_list,
                                               **common)

    try:
        archs, shapes = resolve_grid(args.archs, args.shapes)
    except ValueError as e:
        ap.error(str(e))
    llm_client = None
    if args.llm == "ollama":
        from repro_torch.core.llm_client import OllamaClient

        llm_client = OllamaClient()
    return run_campaign(archs, shapes, args.mesh, out_dir=common.pop("out_dir"),
                        workers=args.workers, llm_client=llm_client, **common)


if __name__ == "__main__":
    main()
