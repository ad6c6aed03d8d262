"""Self-orchestrating sharded DSE campaigns: one command, n supervised shards.

Counterpart of ``repro/launch/orchestrator.py``. Replaces the manual quickstart workflow (run n ``campaign --shard i/n``
processes by hand, then ``merge_db``) with a supervisor that owns the whole
lifecycle:

* **spawn** — dispatches the n shard campaigns (``python -m
  repro_torch.launch.campaign --shard i/n``) through a pluggable
  :class:`~repro_torch.launch.executors.ShardExecutor`: local subprocesses by
  default (``--executor local``), remote hosts over ssh (``--executor ssh
  --hosts h0,h1,...``), or the ssh code path with a local transport
  (``--executor loopback``, CI/tests); each shard gets its own log file and
  output dir ``OUT/shards/shard{i}``;
* **monitor** — polls every shard's atomically-replaced ``progress.json``
  heartbeat and streams an aggregated live leaderboard to stdout. The
  campaign refreshes the heartbeat after **every proposal round, evaluation
  batch, and loop iteration**, not just at cell boundaries, so hang
  detection stays sharp even when one cell takes hours;
* **heal** — a shard that exits nonzero, or whose heartbeat goes stale for
  ``--hang-timeout`` seconds, is killed (whole process group, local or
  remote) and relaunched with the same command. Campaign resume semantics
  make the restart cheap and safe: completed cells are skipped via their
  report files, and the shard's content-addressed dry-run cache replays any
  dry runs the crashed attempt already paid for — no cell is evaluated
  twice. A shard that crashes more than ``--max-restarts`` times fails the
  run (every other shard is terminated, nothing is merged);
* **merge** — on success, each shard dir is collected to this machine
  (a no-op for local shards, an rsync for ssh ones) and folded into
  ``--out`` via ``repro_torch.launch.merge_db`` (dedup by design identity,
  earliest record wins), so the single invocation ends with the same
  byte-stable ``leaderboard.json`` the manual shard+merge flow produces —
  whichever executor ran the shards;
* **schedule** (``--queue``) — instead of cutting the grid statically
  (``--shard i/n``), seed a crash-safe file-backed cell queue
  (``repro_torch.launch.scheduler``) under ``OUT/queue/`` and let every shard
  pull its next cell under a heartbeat-renewed lease. The orchestrator is
  the scheduler: it releases a crashed shard's leases immediately on
  restart (no waiting out the deadline), and it **steals** — when a leased
  cell's age exceeds ``--steal-factor`` x the fleet's median completed-cell
  duration (and at least ``--steal-min-s``) while another shard sits idle,
  the lease is expired back to pending so the idle shard picks it up;
  the slow shard's in-flight work is surrendered gracefully and every
  dry run it already paid for replays from the queue-shared dry-run cache.
  The merged leaderboard stays byte-identical to the static shard+merge
  flow on the same grid — steals and kills included.

Quickstart (the whole campaign, supervised, one command):

    PYTHONPATH=src python -m repro_torch.launch.orchestrator \\
        --archs all --shapes all --shards 2 --out artifacts/run

    # dynamic cell queue + work stealing instead of a static grid cut
    PYTHONPATH=src python -m repro_torch.launch.orchestrator \\
        --archs all --shapes all --shards 2 --queue --out artifacts/run

Fault injection (tests/CI): ``--inject-kill I:K`` arms a one-shot crash in
shard I after K completed cells — the shard dies abruptly at a cell boundary
(exit code 86, via the campaign's ``REPRO_CAMPAIGN_CRASH_TOKEN`` hook) and
the supervisor must restart it. Because the crash lands between cells, the
healed run's merged leaderboard is byte-identical to an uninterrupted one
(``tests/test_torch_orchestrator.py``). The token is a local file, so
injection works with the ``local`` and ``loopback`` executors (a real ssh
shard never sees it).

Cards: ``--device cuda`` (the default) measures heads on a card. The local
executor gives shard ``i`` card ``i mod n`` of the machine's ``n``, and
``--measure-top-k > 0`` with more local shards than cards is refused: two
shards measuring on one card would each size their batch to 90% of its
memory, and time each other's work. With ``--measure-top-k 0`` the shards
only dry-run, on the host, and any number may run.

Pure supervision — this module never imports torch (``--space kernels``
aside: the kernel shape registry holds torch dtypes), so ``--help`` and
the monitoring loop stay instant whatever the shards are tracing.
"""
from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.launch.campaign import (DEVICE_CHOICES, MESH_CHOICES,
                                         OBJECTIVE_CHOICES, STRATEGY_CHOICES,
                                         resolve_grid, shard_cells,
                                         validate_gate_args,
                                         validate_measure_args,
                                         validate_objective_args)
from repro_torch.launch.executors import (EXECUTOR_CHOICES,
                                          LocalProcessExecutor, ShardExecutor,
                                          ShardProc, make_executor,
                                          visible_cards)
from repro_torch.launch.ioutil import write_json_atomic
from repro_torch.launch.scheduler import CellQueue

CRASH_TOKEN_FILE = ".crash_token"
QUEUE_DIR = "queue"


def child_env() -> Dict[str, str]:
    """The shard subprocess environment: the supervisor's env with this
    checkout's ``src`` prepended to PYTHONPATH, so ``python -m
    repro_torch.launch.campaign`` resolves the same code the supervisor runs
    (ssh-dispatched shards get a remote-checkout PYTHONPATH instead, see
    ``SSHExecutor._forward_env``)."""
    import os

    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    prior = env.get("PYTHONPATH")
    env["PYTHONPATH"] = src + (os.pathsep + prior if prior else "")
    return env


def shard_dirs_for(out_dir: Path, shards: int) -> List[Path]:
    """The canonical per-shard output dirs: ``OUT/shards/shard{i}`` —
    deliberately *inside* ``--out`` but distinct from it, satisfying
    ``merge_db``'s out-must-not-alias-a-shard rule."""
    return [Path(out_dir) / "shards" / f"shard{i}" for i in range(shards)]


def build_shard_cmd(i: int, shards: int, shard_dir: Path, *, archs: str,
                    shapes: str, mesh: str, iterations: int, budget: int,
                    workers: int, strategy: str,
                    gate_factor: Optional[float],
                    gate_min_factor: Optional[float] = None, llm: str,
                    measure_top_k: int = 0, measure_runs: int = 3,
                    measure_budget: Optional[int] = None,
                    queue_dir: Optional[Path] = None,
                    queue_lease_s: float = 300.0,
                    space: str = "plans",
                    objective: str = "bound_s",
                    device: str = "cuda") -> List[str]:
    """The exact ``repro_torch.launch.campaign`` argv for shard ``i`` of
    ``shards`` — one place, so supervisor restarts always replay the
    original command (campaign resume makes that idempotent). With
    ``queue_dir`` the shard pulls cells from the queue as owner
    ``shard{i}`` instead of taking the static ``--shard i/n`` slice.
    Remote executors rewrite only the interpreter and the ``--out`` value
    (the queue path must be a shared filesystem when shards run
    remotely)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.campaign",
           "--archs", archs, "--shapes", shapes, "--mesh", mesh,
           "--iterations", str(iterations), "--budget", str(budget),
           "--workers", str(workers), "--strategy", strategy,
           "--llm", llm, "--out", str(shard_dir), "--device", device]
    if space != "plans":
        # appended only for non-default values, as the reference does
        cmd += ["--space", space]
    if objective != "bound_s":
        cmd += ["--objective", objective]
    if queue_dir is not None:
        # absolute: the queue is the shards' rendezvous, and remote
        # executors assume one shared-filesystem path on every host
        cmd += ["--queue", str(Path(queue_dir).resolve()),
                "--queue-owner", f"shard{i}",
                "--queue-lease-s", str(queue_lease_s)]
    else:
        cmd += ["--shard", f"{i}/{shards}"]
    if gate_factor is not None:
        cmd += ["--gate-factor", str(gate_factor)]
    if gate_min_factor is not None:
        cmd += ["--gate-min-factor", str(gate_min_factor)]
    if measure_top_k > 0:
        cmd += ["--measure-top-k", str(measure_top_k),
                "--measure-runs", str(measure_runs)]
        if measure_budget is not None:
            cmd += ["--measure-budget", str(measure_budget)]
    return cmd


def parse_inject_kill(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse an ``--inject-kill I:K`` spec into ``(shard_index,
    after_cells)``; ``None`` passes through. Raises ``ValueError`` on
    malformed specs or non-positive K."""
    if not spec:
        return None
    try:
        i, k = (int(x) for x in spec.split(":"))
    except ValueError:
        raise ValueError(f"--inject-kill must look like I:K, got {spec!r}")
    if i < 0 or k < 1:
        raise ValueError(f"--inject-kill needs I >= 0 and K >= 1, got {spec}")
    return (i, k)


def aggregate_best(shard_states: Sequence[ShardProc], k: int = 5) -> List[Dict]:
    """Fold the shards' heartbeat leaderboards into one: the ``k`` fastest
    cells (bound_s seconds, ascending) across every shard's last
    ``progress.json``. Purely cosmetic/streaming — the authoritative
    leaderboard is rebuilt from the merged DB at the end."""
    rows = [r for s in shard_states
            for r in s.last_payload.get("best", [])
            if r.get("bound_s") is not None]
    rows.sort(key=lambda r: (r["bound_s"], r.get("cell", "")))
    return rows[:k]


def _status_line(shard_states: Sequence[ShardProc]) -> str:
    """One-line aggregated view of every shard + the global incumbent.
    ``evals`` counts are *run-local* (this attempt's work, see the campaign
    heartbeat contract), so a restarted shard never appears to redo the
    work its resume skipped."""
    parts = []
    for s in shard_states:
        p = s.last_payload
        done, total = p.get("cells_done", 0), p.get("cells_total", "?")
        tag = ("failed" if s.failed else "done" if s.done else
               p.get("status", "starting"))
        cell = p.get("cell_in_progress")
        at = (f" @{cell}#{p.get('iteration')}" if cell else "")
        extra = f", {p.get('evaluations', 0)} evals" if p else ""
        restarts = f", restarts {s.restarts}" if s.restarts else ""
        parts.append(f"shard{s.index} {done}/{total} {tag}{at}{extra}{restarts}")
    best = aggregate_best(shard_states, k=1)
    if best:
        parts.append(f"best {best[0]['bound_s']:.4g}s ({best[0]['cell']})")
    return " | ".join(parts)


def validate_card_args(measure_top_k: int, device: str, executor: str,
                       shards: int, cards: Sequence[str]) -> Optional[str]:
    """The one-card-a-measuring-shard rule (an error string, or ``None``
    when valid): local shards that measure on ``cuda`` need a card each."""
    if (measure_top_k > 0 and device == "cuda" and executor == "local"
            and shards > len(cards)):
        return (f"--measure-top-k {measure_top_k} on cuda needs one card a "
                f"local shard, and {shards} shards would share "
                f"{len(cards)} card(s): each measurement sizes its batch to "
                f"90% of a card's memory and would time the other shards' "
                f"work; use --shards {max(len(cards), 1)} or fewer, or "
                f"--measure-top-k 0 (host-only dry runs, any number of "
                f"shards)")
    return None


def plan_steals(q: CellQueue, shard_states: Sequence[ShardProc], *,
                steal_factor: float, steal_min_s: float, max_steals: int,
                now: float) -> List:
    """The work-stealing rule: which leased cells should be expired back to
    pending *right now*. A cell is steal-eligible when

    * its lease age exceeds ``max(steal_min_s, steal_factor x median)``,
      where the median is over the fleet's completed-cell durations
      (``status == "complete"`` done tickets — resumed/unsupported cells
      finish in milliseconds and would poison the scale), and
    * it has been stolen fewer than ``max_steals`` times (a cell that is
      slow *everywhere* must not ping-pong forever), and
    * at least one *other* live shard is idle (heartbeat ``status ==
      "waiting"``) — stealing without a taker just burns the owner's work.

    At most one steal per idle shard per pass. Returns the tickets to
    steal (the caller performs the steal — and supplies ``now``, which is
    *required*: a pure decision function never consults the wall clock, so
    a recorded campaign replays byte-stably and the invariant linter's
    RPR003 rule holds; unit-testable without a fleet)."""
    durations = [d for t in q.tickets("done")
                 if t.status == "complete" and (d := t.duration())]
    if not durations:
        return []  # no completed cell yet: no scale to judge "slow" against
    durations.sort()
    med = durations[len(durations) // 2]
    threshold = max(steal_min_s, steal_factor * med)
    idle = {f"shard{s.index}" for s in shard_states
            if not s.done and not s.failed
            and s.last_payload.get("status") == "waiting"}
    if not idle:
        return []
    out = []
    for t in q.tickets("leased"):
        if t.owner in idle or t.steals >= max_steals:
            continue
        age = now - (t.leased_at if t.leased_at is not None else now)
        if age > threshold:
            out.append(t)
        if len(out) >= len(idle):
            break
    return out


def run_orchestrator(*, archs: str, shapes: str, shards: int,
                     out_dir: Path | str, mesh: str = "small",
                     iterations: int = 2, budget: int = 3, workers: int = 2,
                     strategy: str = "ensemble",
                     gate_factor: Optional[float] = None,
                     gate_min_factor: Optional[float] = None,
                     measure_top_k: int = 0, measure_runs: int = 3,
                     measure_budget: Optional[int] = None,
                     llm: str = "mock",
                     poll_interval: float = 1.0, hang_timeout: float = 300.0,
                     max_restarts: int = 2,
                     inject_kill: Optional[Tuple[int, int]] = None,
                     queue: bool = False, steal_factor: float = 4.0,
                     steal_min_s: float = 20.0, max_steals: int = 2,
                     queue_lease_s: float = 300.0,
                     executor: str = "local",
                     hosts: Optional[Sequence[str]] = None,
                     remote_root: Optional[str] = None,
                     remote_repo: Optional[str] = None,
                     remote_python: str = "python3",
                     space: str = "plans",
                     objective: str = "bound_s",
                     device: str = "cuda",
                     verbose: bool = True) -> Dict:
    """Run the full supervised campaign; returns the summary dict (also
    written to ``OUT/summary.json``).

    Dispatches ``shards`` campaign processes over the sorted arch x shape
    grid through the chosen :class:`~repro_torch.launch.executors.ShardExecutor`,
    supervises them (crash/hang restart with resume, up to ``max_restarts``
    per shard), collects every shard dir local, and merges into ``out_dir``
    on success. ``hang_timeout`` is wall seconds without a heartbeat
    *change* — the campaign heartbeats after every proposal round,
    evaluation batch, and loop iteration, so the timeout must exceed the
    slowest single iteration *step* (one proposal round, one evaluation
    batch, or one fine-tune tail; budget a few extra seconds for the torch
    import before a fresh shard's first beat), never a whole cell. Raises
    ``RuntimeError`` when a shard exhausts its restart budget (remaining
    shards are terminated and nothing is merged — the shard dirs stay
    resumable) and ``ValueError`` on inconsistent arguments (unknown grid
    ids, ssh without hosts, ``--inject-kill`` with a remote executor, more
    local shards than cards when they measure on ``cuda``).
    Determinism: with the mock LLM and a transfer-free strategy the merged
    leaderboard is byte-identical to the manual shard+merge flow — kills or
    not (injected crashes land at cell boundaries; resume skips completed
    cells), whichever executor ran the shards, and static cut or dynamic
    ``queue=True`` cell queue (steals included: a stolen cell's results
    dedupe at merge).

    Queue mode (``queue=True``) seeds ``OUT/queue/`` from the grid before
    any shard spawns, releases a crashed/hung shard's leases immediately on
    restart, and runs the steal rule (:func:`plan_steals`) every poll."""
    if space == "kernels":  # fail fast, and seed the queue from the same grid
        from repro_torch.launch.kernel_cell import (KERNEL_STRATEGY_CHOICES,
                                              resolve_kernel_grid)

        if strategy not in KERNEL_STRATEGY_CHOICES:
            raise ValueError(
                f"--space kernels supports strategies "
                f"{KERNEL_STRATEGY_CHOICES} (got {strategy!r})")
        grid_archs, grid_shapes = resolve_kernel_grid(archs, shapes)
    else:
        grid_archs, grid_shapes = resolve_grid(archs, shapes)
    objective_err = validate_objective_args(objective)
    if objective_err:
        raise ValueError(objective_err)
    if shards < 1:
        raise ValueError(f"need shards >= 1, got {shards}")
    if inject_kill is not None and not (0 <= inject_kill[0] < shards):
        raise ValueError(f"--inject-kill shard {inject_kill[0]} outside "
                         f"0..{shards - 1}")
    if inject_kill is not None and executor == "ssh":
        raise ValueError("--inject-kill arms a local token file; it is "
                         "supported with --executor local or loopback only")
    if queue and executor == "ssh" and remote_root is not None:
        raise ValueError("--queue needs every shard to see the queue dir at "
                         "the same path (shared filesystem); --remote-root "
                         "relocates shard dirs, so the two cannot combine — "
                         "drop --remote-root or use --executor "
                         "local|loopback")
    if device not in DEVICE_CHOICES:
        raise ValueError(f"device must be one of {DEVICE_CHOICES}, "
                         f"got {device!r}")
    ex: ShardExecutor = make_executor(
        executor, hosts=hosts, remote_root=remote_root,
        remote_repo=remote_repo, remote_python=remote_python)
    if isinstance(ex, LocalProcessExecutor):
        card_err = validate_card_args(measure_top_k, device, executor,
                                      shards, ex.cards)
        if card_err:
            raise ValueError(card_err)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def log(msg: str) -> None:
        if verbose:
            print(f"[orchestrator] {msg}", flush=True)

    q: Optional[CellQueue] = None
    if queue:
        q = CellQueue(out_dir / QUEUE_DIR, lease_s=queue_lease_s)
        if space == "kernels":
            from repro_torch.launch.kernel_cell import (KERNEL_MESH_NAME,
                                                  kernel_grid_cells)

            # same cells + mesh tag the shard campaigns seed with, so the
            # supervisor's seeding stays an idempotent no-op for them
            cells, seed_mesh = (kernel_grid_cells(grid_archs, grid_shapes),
                                KERNEL_MESH_NAME)
        else:
            cells, seed_mesh = shard_cells(grid_archs, grid_shapes), mesh
        seeded = q.seed(cells, mesh=seed_mesh)
        c = q.counts()
        log(f"queue {q.root}: seeded {seeded} ticket(s) "
            f"({c['done']} already done, {c['pending']} pending)")

    states: List[ShardProc] = []
    for i, sd in enumerate(shard_dirs_for(out_dir, shards)):
        env = child_env()
        # the shard's fleet position, for test preludes that slow exactly
        # one shard (REPRO_ prefix ⇒ forwarded by the remote executors too)
        env["REPRO_SHARD_INDEX"] = str(i)
        if inject_kill is not None and inject_kill[0] == i:
            sd.mkdir(parents=True, exist_ok=True)
            token = sd / CRASH_TOKEN_FILE
            token.write_text("armed")
            env["REPRO_CAMPAIGN_CRASH_TOKEN"] = str(token)
            env["REPRO_CAMPAIGN_CRASH_AFTER_CELLS"] = str(inject_kill[1])
            log(f"shard{i}: armed one-shot crash after "
                f"{inject_kill[1]} cell(s)")
        cmd = build_shard_cmd(i, shards, sd, archs=archs, shapes=shapes,
                              mesh=mesh, iterations=iterations, budget=budget,
                              workers=workers, strategy=strategy,
                              gate_factor=gate_factor,
                              gate_min_factor=gate_min_factor, llm=llm,
                              measure_top_k=measure_top_k,
                              measure_runs=measure_runs,
                              measure_budget=measure_budget,
                              queue_dir=q.root if q is not None else None,
                              queue_lease_s=queue_lease_s, space=space,
                              objective=objective, device=device)
        states.append(ShardProc(index=i, out_dir=sd, cmd=cmd, env=env))

    t0 = time.time()
    total_restarts = 0
    steals = 0
    lease_reclaims = 0
    last_line = ""
    try:
        for s in states:
            ex.spawn(s)
            log(f"shard{s.index}: pid {s.proc.pid} [{ex.name}] -> {s.out_dir}")

        while not all(s.done or s.failed for s in states):
            time.sleep(poll_interval)
            for s in states:
                if s.done or s.failed:
                    continue
                payload = ex.read_heartbeat(s)
                # per-shard clock, stamped AFTER the (possibly slow, e.g.
                # ssh) heartbeat fetch: a stalled transport on one shard
                # must never age another shard's hang clock
                now = time.time()
                if payload and payload != s.last_payload:
                    s.last_payload = payload
                    s.last_beat = now
                rc = ex.poll(s)
                crashed = rc is not None and rc != 0
                hung = rc is None and (now - s.last_beat) > hang_timeout
                if rc == 0:
                    s.done = True
                    s.close_log()
                    # one final read: the shard's last heartbeat ("done",
                    # full counts) may have landed after this poll's read
                    s.last_payload = ex.read_heartbeat(s) or s.last_payload
                    log(f"shard{s.index}: completed "
                        f"({s.last_payload.get('cells_done', '?')} cells)")
                elif crashed or hung:
                    # unconditional: a crashed leader can leave pool workers
                    # mid-compile just like a hung one; no-op once reaped
                    ex.signal(s, signal.SIGKILL)
                    if hung:
                        s.proc.wait()
                    s.close_log()
                    why = (f"no heartbeat for {hang_timeout:.0f}s" if hung
                           else f"exit code {rc}")
                    if s.restarts >= max_restarts:
                        # fail fast: terminating the healthy shards (finally
                        # block) beats burning hours on a run that can no
                        # longer merge
                        s.failed = True
                        log(f"shard{s.index}: {why}; restart budget "
                            f"({max_restarts}) exhausted — giving up "
                            f"(log: {s.log_path})")
                        raise RuntimeError(
                            f"shard {s.index} failed after {max_restarts} "
                            f"restart(s) ({why}); shard dirs under "
                            f"{out_dir / 'shards'} remain resumable "
                            f"(re-run the same command)")
                    s.restarts += 1
                    total_restarts += 1
                    if q is not None:
                        # the owner is known-dead: reclaim its leases now
                        # instead of waiting out their deadlines
                        released = q.release_owner(f"shard{s.index}")
                        lease_reclaims += len(released)
                        for t in released:
                            log(f"shard{s.index}: released lease on "
                                f"{t.cell} (attempt {t.attempt})")
                    log(f"shard{s.index}: {why}; restarting with resume "
                        f"(attempt {s.restarts + 1})")
                    ex.spawn(s)
            if q is not None:
                # scheduler pass: deadline reclaims (belt and braces — the
                # shards' acquirers reclaim too) and the steal rule
                for t in q.reclaim_expired():
                    lease_reclaims += 1
                    log(f"queue: lease on {t.cell} expired — reclaimed "
                        f"(attempt {t.attempt})")
                for t in plan_steals(q, states, steal_factor=steal_factor,
                                     steal_min_s=steal_min_s,
                                     max_steals=max_steals, now=time.time()):
                    if q.steal(t) is not None:
                        steals += 1
                        log(f"queue: stole {t.cell} from {t.owner} "
                            f"(lease age beat the fleet median; "
                            f"steal #{t.steals + 1} for this cell)")
            line = _status_line(states)
            if line != last_line:
                last_line = line
                log(line)
    finally:
        for s in states:
            if s.proc is not None and s.proc.poll() is None:
                ex.signal(s, signal.SIGTERM)
                try:
                    s.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    ex.signal(s, signal.SIGKILL)
                    s.proc.wait()
            s.close_log()

    for s in states:
        ex.collect(s)

    from repro_torch.launch.merge_db import merge

    merged = merge([s.out_dir for s in states], out_dir, verbose=verbose,
                   extra_cache_dirs=([q.cache_dir, q.measured_dir]
                                     if q is not None else None),
                   objective=objective)
    queue_cells = q.counts() if q is not None else None
    summary = {
        "out": str(out_dir),
        "shards": shards,
        "objective": objective,
        "device": device,
        "executor": ex.name,
        "hosts": list(hosts) if hosts else None,
        # queue mode counts DONE tickets, not the sum of shard-local
        # cells_done: a stolen cell is worked by two shards but is one cell
        "cells": (queue_cells["done"] if queue_cells is not None else
                  sum(s.last_payload.get("cells_done", 0) for s in states)),
        "restarts": total_restarts,
        "restarts_per_shard": {f"shard{s.index}": s.restarts for s in states},
        "queue": str(q.root) if q is not None else None,
        "queue_cells": queue_cells,
        "steals": steals,
        "lease_reclaims": lease_reclaims,
        "max_lease_attempts": (max((t.attempt for t in q.tickets("done")),
                                   default=0) if q is not None else None),
        "evaluations": merged["datapoints"],
        "duplicates_dropped": merged["duplicates_dropped"],
        "best": aggregate_best(states),
        "wall_s": round(time.time() - t0, 1),
        "leaderboard": merged["leaderboard"],
    }
    write_json_atomic(out_dir / "summary.json", summary)
    log(f"summary: {summary}")
    return summary


def build_parser() -> argparse.ArgumentParser:
    """The orchestrator CLI surface, importable without torch."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.orchestrator",
        description="spawn, supervise, heal, and merge a sharded DSE "
                    "campaign in one command")
    ap.add_argument("--space", default="plans",
                    choices=["plans", "kernels"],
                    help="design space the shards explore (forwarded to "
                         "every shard): 'kernels' tunes kernel tile "
                         "configs — --archs become kernel names, --shapes "
                         "KERNEL_SHAPES names, --mesh is ignored")
    ap.add_argument("--archs", default="qwen3-0.6b,stablelm-3b",
                    help="comma-separated arch ids, or 'all' "
                         "(--space kernels: kernel names)")
    ap.add_argument("--shapes", default="train_4k,decode_32k",
                    help="comma-separated shape cells, or 'all' "
                         "(--space kernels: kernel shape names)")
    ap.add_argument("--shards", type=int, default=2,
                    help="number of campaign processes to dispatch")
    ap.add_argument("--out", default="artifacts/run",
                    help="merged campaign dir (shards live in OUT/shards/)")
    ap.add_argument("--mesh", default="small", choices=list(MESH_CHOICES))
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--budget", type=int, default=3,
                    help="evaluations per loop iteration")
    ap.add_argument("--workers", type=int, default=2,
                    help="parallel dry-run processes per shard")
    ap.add_argument("--strategy", default="ensemble",
                    choices=list(STRATEGY_CHOICES))
    ap.add_argument("--gate-factor", type=float, default=None,
                    help="surrogate gate factor, forwarded to every shard "
                         "(must be > 1)")
    ap.add_argument("--gate-min-factor", type=float, default=None,
                    help="anneal target for the gate factor, forwarded to "
                         "every shard (must be in (1, gate-factor]; "
                         "requires --gate-factor)")
    ap.add_argument("--measure-top-k", type=int, default=0, metavar="K",
                    help="promotion ladder tier 2, forwarded to every "
                         "shard: execute and time each cell's K best "
                         "designs (0 = off); measured rows merge "
                         "byte-stably and dedupe exactly-once via the "
                         "shared measured cache")
    ap.add_argument("--measure-runs", type=int, default=3, metavar="N",
                    help="timed executions per measurement, forwarded to "
                         "every shard (min reported)")
    ap.add_argument("--measure-budget", type=int, default=None, metavar="M",
                    help="per-shard cap on tier-2 measurements (requires "
                         "--measure-top-k)")
    ap.add_argument("--llm", default="mock", choices=["mock", "ollama"])
    ap.add_argument("--objective", default="bound_s",
                    choices=list(OBJECTIVE_CHOICES),
                    help="ranking mode, forwarded to every shard and to the "
                         "final merge: scalar bound_s heads (default, "
                         "byte-identical to pre-pareto leaderboards) or "
                         "dominance-ranked pareto fronts over the full "
                         "objective vector")
    ap.add_argument("--queue", action="store_true",
                    help="dynamic scheduling: seed a crash-safe cell queue "
                         "under OUT/queue/ and let shards pull leases from "
                         "it instead of taking static --shard i/n slices; "
                         "enables lease release on restart and work "
                         "stealing")
    ap.add_argument("--steal-factor", type=float, default=4.0,
                    help="steal a leased cell once its age exceeds this "
                         "multiple of the fleet's median completed-cell "
                         "duration (queue mode; also needs --steal-min-s "
                         "and an idle shard)")
    ap.add_argument("--steal-min-s", type=float, default=20.0,
                    help="never steal a lease younger than this many "
                         "seconds (queue mode)")
    ap.add_argument("--max-steals", type=int, default=2,
                    help="per-cell steal budget: a cell slow everywhere "
                         "must not ping-pong between shards forever "
                         "(queue mode)")
    ap.add_argument("--queue-lease-s", type=float, default=300.0,
                    help="lease length forwarded to every shard; renewed "
                         "each heartbeat, so it must exceed the slowest "
                         "single iteration step (queue mode)")
    ap.add_argument("--executor", default="local",
                    choices=list(EXECUTOR_CHOICES),
                    help="where shards run: local subprocesses, remote "
                         "hosts over ssh, or the ssh path with a local "
                         "transport (loopback; tests/CI)")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated ssh hosts for --executor ssh "
                         "(round-robin by shard index)")
    ap.add_argument("--remote-root", default=None,
                    help="shard output root on the remote host (default: "
                         "the same absolute path as the local shard dir)")
    ap.add_argument("--remote-repo", default=None,
                    help="repo checkout path on the remote host (default: "
                         "this checkout's path)")
    ap.add_argument("--remote-python", default="python3",
                    help="python interpreter on the remote host")
    ap.add_argument("--poll-interval", type=float, default=1.0,
                    help="seconds between supervisor polls")
    ap.add_argument("--hang-timeout", type=float, default=300.0,
                    help="seconds without a heartbeat change before a shard "
                         "is declared hung and restarted; the campaign "
                         "heartbeats every proposal round / evaluation "
                         "batch / iteration, so this must exceed the "
                         "slowest single step (never a whole cell)")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="crash/hang restarts allowed per shard before the "
                         "run fails")
    ap.add_argument("--device", default="cuda", choices=list(DEVICE_CHOICES),
                    help="forwarded to every shard: 'cuda' (default) "
                         "measures heads (and runs kernels) on a card, one "
                         "card a local shard; 'cpu' on the CPU")
    ap.add_argument("--inject-kill", default=None, metavar="I:K",
                    help="fault injection (tests/CI): crash shard I once "
                         "after K completed cells and let the supervisor "
                         "heal it (local/loopback executors only)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict]:
    """CLI entry: validate arguments and hand off to
    :func:`run_orchestrator`; returns its summary. Exits 2 on bad
    arguments, 1 when a shard exhausts its restart budget."""
    ap = build_parser()
    args = ap.parse_args(argv)
    gate_err = validate_gate_args(args.gate_factor, args.gate_min_factor)
    if gate_err:
        ap.error(gate_err)
    measure_err = validate_measure_args(args.measure_top_k, args.measure_runs,
                                        args.measure_budget)
    if measure_err:
        ap.error(measure_err)
    objective_err = validate_objective_args(args.objective)
    if objective_err:
        ap.error(objective_err)
    if args.shards < 1:
        ap.error(f"--shards must be >= 1, got {args.shards}")
    if args.executor == "ssh" and not args.hosts:
        ap.error("--executor ssh requires --hosts h0,h1,...")
    if args.queue and args.queue_lease_s <= 0:
        ap.error(f"--queue-lease-s must be > 0, got {args.queue_lease_s}")
    if args.executor == "local":
        card_err = validate_card_args(args.measure_top_k, args.device,
                                      args.executor, args.shards,
                                      visible_cards())
        if card_err:
            ap.error(card_err)
    try:
        inject = parse_inject_kill(args.inject_kill)
    except ValueError as e:
        ap.error(str(e))
    if args.space == "kernels":
        from repro_torch.launch.kernel_cell import (KERNEL_STRATEGY_CHOICES,
                                              resolve_kernel_grid)

        # the plan-grid defaults are meaningless kernel ids (same remap as
        # the campaign CLI): untouched --archs/--shapes mean the whole grid
        if args.archs == ap.get_default("archs"):
            args.archs = "all"
        if args.shapes == ap.get_default("shapes"):
            args.shapes = "all"
        if args.strategy not in KERNEL_STRATEGY_CHOICES:
            ap.error(f"--space kernels supports --strategy "
                     f"{KERNEL_STRATEGY_CHOICES}; llm/transfer variants "
                     f"are plan-coupled (got {args.strategy!r})")
        try:
            resolve_kernel_grid(args.archs, args.shapes)
        except ValueError as e:
            ap.error(str(e))
    else:
        try:
            resolve_grid(args.archs, args.shapes)
        except ValueError as e:
            ap.error(str(e))
    hosts = args.hosts.split(",") if args.hosts else None
    try:
        return run_orchestrator(archs=args.archs, shapes=args.shapes,
                                shards=args.shards, out_dir=args.out,
                                mesh=args.mesh, iterations=args.iterations,
                                budget=args.budget, workers=args.workers,
                                strategy=args.strategy, gate_factor=args.gate_factor,
                                gate_min_factor=args.gate_min_factor,
                                measure_top_k=args.measure_top_k,
                                measure_runs=args.measure_runs,
                                measure_budget=args.measure_budget,
                                llm=args.llm, poll_interval=args.poll_interval,
                                hang_timeout=args.hang_timeout,
                                max_restarts=args.max_restarts, inject_kill=inject,
                                queue=args.queue, steal_factor=args.steal_factor,
                                steal_min_s=args.steal_min_s,
                                max_steals=args.max_steals,
                                queue_lease_s=args.queue_lease_s,
                                executor=args.executor, hosts=hosts,
                                remote_root=args.remote_root,
                                remote_repo=args.remote_repo,
                                remote_python=args.remote_python,
                                space=args.space, objective=args.objective,
                                device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"[orchestrator] FAILED: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
