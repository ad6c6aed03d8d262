"""DSE-as-a-service: a tenant-aware control plane over :class:`CellQueue`.

Counterpart of ``repro/launch/service.py``. ``python -m
repro_torch.launch.service serve`` runs a long-lived, supervisor-side
daemon (torch-free and jax-free: torch exists only inside the campaign
worker subprocesses it spawns) that accepts exploration workloads over a
stdlib HTTP/JSON API and drives them to completion:

* **submission** — ``POST /submit`` with ``{tenant, arch, shape, mesh,
  space, strategy, objective, budget, priority, ...}`` seeds the cells
  into the tenant's own crash-safe ``CellQueue`` under the service root.
  A tenant's campaign profile (mesh/space/strategy/objective/budget/
  iterations/llm) is fixed by its first submission; conflicting later
  submissions are rejected with 409 so every worker replays one argv.
* **fair scheduling** — each scheduler tick snapshots the tenants
  (:func:`snapshot_tenants`) and asks the pure weighted round-robin
  policy in :mod:`repro_torch.core.fairshare` which tenants earn a worker;
  priorities weight the share, deficit credits carry across ticks, and
  per-tenant cell budgets (``max_cells``) stop grants once spent.
* **autoscaling + healing** — workers are ``repro_torch.launch.campaign
  --queue`` subprocesses supervised through the same
  :class:`~repro_torch.launch.executors.ShardExecutor` protocol the
  orchestrator uses: spawned on backlog, retired when the tenant queue
  drains (the campaign exits 0), SIGKILL + respawned with resume on
  crash or heartbeat silence, with the dead owner's leases released.
* **coalescing** — every tenant queue's ``dryrun_cache``/
  ``measured_cache`` is a symlink to one service-wide content-addressed
  cache, so the same design submitted by any number of tenants is
  evaluated exactly once fleet-wide and replays everywhere else.
* **results** — ``GET /tenants/<t>/leaderboard`` merges the tenant's
  worker dirs on demand (:func:`repro_torch.launch.merge_db.merge`) and
  streams the same byte-stable ``leaderboard.json`` the campaign CLI
  writes, scalar or Pareto depending on the tenant's objective.

**The card.** ``serve --device`` (``cuda``, the default, or ``cpu``) is
replayed into every worker's argv, as the orchestrator's
``build_shard_cmd`` does, and the local executor gives worker ``w<k>``
card ``k mod n`` of the machine's ``n``. Workers never pass
``--measure-top-k`` (the reference's argv does not), so they time
nothing: a plan tenant's workers dry-run on the host, and a kernel-space
tenant's run each candidate's Hopper kernel against its oracle on the
card, where two workers may share one card. The orchestrator's
one-card-a-measuring-shard rule (``orchestrator.validate_card_args``)
therefore has nothing to refuse here, and the service does not check it.
Kernel workers report their launches in their heartbeat
(``kernel_launches``, ``kernel_route_launches``), and ``/tenants/<t>``
lists them per worker.

Service root layout::

    ROOT/
      service.json                  control-plane state snapshot (atomic)
      endpoint.json                 bound host/port + daemon pid
      dryrun_cache/                 fleet-wide evaluation cache
      measured_cache/               fleet-wide tier-2 timing cache
      tenants/<t>/queue/            the tenant's CellQueue (caches symlink up)
      tenants/<t>/workers/w<k>/     one campaign --out dir per worker
      tenants/<t>/merged/           merge-on-read target for leaderboard GETs

The ``submit`` / ``status`` / ``leaderboard`` / ``shutdown`` subcommands
are thin stdlib-urllib clients for the same API.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fairshare import (TenantSnapshot, over_budget,
                                        plan_worker_grants)
from repro_torch.core.kernel_space import parse_kernel_arch
from repro_torch.launch.campaign import (DEVICE_CHOICES, MESH_CHOICES,
                                         OBJECTIVE_CHOICES, STRATEGY_CHOICES,
                                         resolve_grid, validate_objective_args)
from repro_torch.launch.executors import ShardExecutor, ShardProc, make_executor
from repro_torch.launch.ioutil import write_json_atomic
from repro_torch.launch.orchestrator import child_env
from repro_torch.launch.scheduler import CellQueue, sanitize_owner

STATE_FILE = "service.json"
ENDPOINT_FILE = "endpoint.json"
SHARED_CACHES = ("dryrun_cache", "measured_cache")

#: campaign-argv profile fields fixed per tenant by its first submission
PROFILE_FIELDS = ("mesh", "space", "strategy", "objective", "budget",
                  "iterations", "llm")
PROFILE_DEFAULTS = {"mesh": "small", "space": "plans",
                    "strategy": "ensemble", "objective": "bound_s",
                    "budget": 3, "iterations": 2, "llm": "mock"}

_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class SubmitError(Exception):
    """Invalid or conflicting submission; carries the HTTP status."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _resolve_cells(space: str, archs: str,
                   shapes: str) -> Tuple[List[Tuple[str, str]], str]:
    """Validated ``(cells, seed_mesh_tag)`` for a submission grid — the
    same expansion (and the same queue mesh tag) the campaign workers
    seed with, so the daemon's seeding is an idempotent superset of
    theirs. Raises ``ValueError`` for unknown ids."""
    if space == "kernels":
        from repro_torch.launch.kernel_cell import (KERNEL_MESH_NAME,
                                              kernel_grid_cells,
                                              resolve_kernel_grid)
        kernels, kshapes = resolve_kernel_grid(archs, shapes)
        return kernel_grid_cells(kernels, kshapes), KERNEL_MESH_NAME
    arch_list, shape_list = resolve_grid(archs, shapes)
    return [(a, s) for a in arch_list for s in shape_list], None


def snapshot_tenants(facts: Sequence[Dict[str, Any]], *, hang_timeout: float,
                     now: float) -> List[TenantSnapshot]:
    """Pure assembly of the fairshare policy input from per-tenant facts
    (``name``/``priority``/``backlog``/``workers``/``cells_done``/
    ``budget_cells``/``credit``/``worker_beats``). A tenant is *stalled* —
    earning no new workers — when it has workers but every one of them has
    been heartbeat-silent past ``hang_timeout`` (the healer is already
    dealing with them). Sorted by name so the grant order never depends on
    dict iteration order."""
    snaps = []
    for f in facts:
        beats = list(f.get("worker_beats") or [])
        stalled = bool(beats) and all((now - b) > hang_timeout
                                      for b in beats)
        snaps.append(TenantSnapshot(
            name=f["name"], priority=int(f.get("priority", 1)),
            backlog=int(f.get("backlog", 0)),
            workers=int(f.get("workers", 0)),
            cells_done=int(f.get("cells_done", 0)),
            budget_cells=f.get("budget_cells"),
            credit=float(f.get("credit", 0.0)), stalled=stalled))
    return sorted(snaps, key=lambda s: s.name)


@dataclass
class Worker:
    """One campaign worker: its queue-owner identity plus the ShardProc
    the executor supervises."""

    tenant: str
    wid: int
    owner: str
    shard: ShardProc

    @property
    def state(self) -> str:
        """``running`` / ``done`` (queue drained) / ``failed`` (restart
        budget exhausted)."""
        if self.shard.failed:
            return "failed"
        return "done" if self.shard.done else "running"


@dataclass
class Tenant:
    """Daemon-side tenant state: queue, fixed campaign profile, worker
    fleet (past and present), and fairness accounting."""

    name: str
    root: Path
    queue: CellQueue
    profile: Dict[str, Any]
    priority: int = 1
    max_cells: Optional[int] = None
    credit: float = 0.0
    seed_cell: Optional[Tuple[str, str]] = None
    next_wid: int = 0
    workers: List[Worker] = field(default_factory=list)
    submissions: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def active(self) -> List[Worker]:
        """Workers still running (the only ones the healer polls)."""
        return [w for w in self.workers if w.state == "running"]

    def worker_dirs(self) -> List[Path]:
        """Every worker dir holding results (past workers included — their
        rows are the tenant's history and must survive retirement)."""
        return [w.shard.out_dir for w in self.workers
                if (w.shard.out_dir / "cost_db.jsonl").exists()]


class ServiceDaemon:
    """The control plane: HTTP front end + scheduler/heal/autoscale loop.

    All mutable state is guarded by one lock; HTTP handler threads only
    take it for short reads and submission seeding, the tick holds it
    while polling workers."""

    def __init__(self, root: Path | str, *, host: str = "127.0.0.1",
                 port: int = 8731, max_workers: int = 2,
                 max_workers_per_tenant: int = 2, poll_interval: float = 0.5,
                 hang_timeout: float = 300.0, max_restarts: int = 2,
                 executor: str = "local", queue_lease_s: float = 60.0,
                 verbose: bool = True, device: str = "cuda"):
        self.root = Path(root).resolve()
        self.host, self.port = host, port
        self.max_workers = max_workers
        self.max_workers_per_tenant = max_workers_per_tenant
        self.poll_interval = poll_interval
        self.hang_timeout = hang_timeout
        self.max_restarts = max_restarts
        self.queue_lease_s = queue_lease_s
        self.verbose = verbose
        if device not in DEVICE_CHOICES:
            raise ValueError(f"device must be one of {DEVICE_CHOICES}, got {device!r}")
        self.device = device
        self.executor: ShardExecutor = make_executor(executor)
        self.root.mkdir(parents=True, exist_ok=True)
        for name in SHARED_CACHES:
            (self.root / name).mkdir(exist_ok=True)
        self.tenants: Dict[str, Tenant] = {}
        self.submission_seq = 0
        self.worker_seq = 0  # fleet-wide spawn counter (REPRO_SHARD_INDEX)
        self.stop = threading.Event()
        self._lock = threading.RLock()
        self._httpd: Optional[ThreadingHTTPServer] = None

    def log(self, msg: str) -> None:
        """Print one supervisor log line (suppressed by ``--quiet``)."""
        if self.verbose:
            print(f"[service] {msg}", flush=True)

    # -- tenancy -----------------------------------------------------------
    def _tenant_dir(self, name: str) -> Path:
        return self.root / "tenants" / name

    def _open_tenant(self, name: str, profile: Dict[str, Any],
                     priority: int, max_cells: Optional[int]) -> Tenant:
        tdir = self._tenant_dir(name)
        qroot = tdir / "queue"
        q = CellQueue(qroot, lease_s=self.queue_lease_s)
        for cache in SHARED_CACHES:
            link = qroot / cache
            if not link.is_symlink() and not link.exists():
                # relative symlink: the service root stays relocatable
                os.symlink(os.path.join("..", "..", "..", cache), link)
        t = Tenant(name=name, root=tdir, queue=q, profile=dict(profile),
                   priority=priority, max_cells=max_cells)
        self.tenants[name] = t
        self.log(f"tenant {name}: opened (priority {priority}, "
                 f"profile {profile})")
        return t

    def submit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Validate + seed one submission; returns the submission record.
        Raises :class:`SubmitError` with the HTTP code on bad input."""
        if not isinstance(payload, dict):
            raise SubmitError(400, "payload must be a JSON object")
        tenant = payload.get("tenant")
        if not isinstance(tenant, str) or not _TENANT_RE.match(tenant):
            raise SubmitError(400, "tenant must match "
                                   f"{_TENANT_RE.pattern!r}")
        archs = str(payload.get("arch") or payload.get("archs") or "")
        shapes = str(payload.get("shape") or payload.get("shapes") or "")
        if not archs or not shapes:
            raise SubmitError(400, "arch and shape are required")
        profile = {k: payload.get(k, PROFILE_DEFAULTS[k])
                   for k in PROFILE_FIELDS}
        err = self._validate_profile(profile)
        if err:
            raise SubmitError(400, err)
        try:
            cells, seed_mesh = _resolve_cells(profile["space"], archs,
                                              shapes)
        except ValueError as e:
            raise SubmitError(400, str(e))
        priority = payload.get("priority", 1)
        if not isinstance(priority, int) or priority < 1:
            raise SubmitError(400, "priority must be an integer >= 1")
        max_cells = payload.get("max_cells")
        if max_cells is not None and (not isinstance(max_cells, int)
                                      or max_cells < 1):
            raise SubmitError(400, "max_cells must be an integer >= 1")
        with self._lock:
            t = self.tenants.get(tenant)
            if t is None:
                t = self._open_tenant(tenant, profile, priority, max_cells)
            elif t.profile != profile:
                drift = {k: (t.profile[k], profile[k]) for k in PROFILE_FIELDS
                         if t.profile[k] != profile[k]}
                raise SubmitError(
                    409, f"tenant {tenant} profile is fixed by its first "
                         f"submission; conflicting fields: {drift}")
            if t.seed_cell is None:
                t.seed_cell = cells[0]
            seeded = t.queue.seed(
                cells, mesh=seed_mesh if seed_mesh else profile["mesh"])
            self.submission_seq += 1
            record = {"id": self.submission_seq, "tenant": tenant,
                      "cells": [list(c) for c in sorted(set(cells))],
                      "seeded": seeded, "ts": round(time.time(), 3)}
            t.submissions.append(record)
            self._persist()
        self.log(f"submit #{record['id']} tenant={tenant} "
                 f"cells={len(record['cells'])} new={seeded}")
        return record

    @staticmethod
    def _validate_profile(profile: Dict[str, Any]) -> Optional[str]:
        if profile["mesh"] not in MESH_CHOICES:
            return f"unknown mesh {profile['mesh']!r}"
        if profile["space"] not in ("plans", "kernels"):
            return f"unknown space {profile['space']!r}"
        if profile["space"] == "kernels":
            from repro_torch.launch.kernel_cell import KERNEL_STRATEGY_CHOICES
            if profile["strategy"] not in KERNEL_STRATEGY_CHOICES:
                return (f"space=kernels supports strategies "
                        f"{KERNEL_STRATEGY_CHOICES}")
        elif profile["strategy"] not in STRATEGY_CHOICES:
            return f"unknown strategy {profile['strategy']!r}"
        if profile["objective"] not in OBJECTIVE_CHOICES:
            return validate_objective_args(str(profile["objective"]))
        if profile["llm"] not in ("mock", "ollama"):
            return f"unknown llm {profile['llm']!r}"
        for k in ("budget", "iterations"):
            if not isinstance(profile[k], int) or profile[k] < 1:
                return f"{k} must be an integer >= 1"
        return None

    # -- workers -----------------------------------------------------------
    def _worker_cmd(self, t: Tenant, out_dir: Path, owner: str) -> List[str]:
        arch, shape = t.seed_cell
        p = t.profile
        if p["space"] == "kernels":
            # the queue's cells carry ``kernel:<name>``; the campaign CLI
            # takes the kernel's name (the reference passes the encoded
            # id, which its campaign refuses: its kernel tenants never run)
            arch = parse_kernel_arch(arch)
        cmd = [sys.executable, "-m", "repro_torch.launch.campaign",
               "--archs", arch, "--shapes", shape,
               "--mesh", p["mesh"], "--iterations", str(p["iterations"]),
               "--budget", str(p["budget"]), "--workers", "1",
               "--strategy", p["strategy"], "--llm", p["llm"],
               "--out", str(out_dir), "--device", self.device]
        if p["space"] != "plans":
            cmd += ["--space", p["space"]]
        if p["objective"] != "bound_s":
            cmd += ["--objective", p["objective"]]
        cmd += ["--queue", str(t.queue.root.resolve()),
                "--queue-owner", owner,
                "--queue-lease-s", str(self.queue_lease_s)]
        return cmd

    def _spawn_worker(self, name: str) -> None:
        t = self.tenants[name]
        wid = t.next_wid
        t.next_wid += 1
        owner = sanitize_owner(f"svc-{name}-w{wid}")
        out_dir = t.root / "workers" / f"w{wid}"
        env = child_env()
        # fleet position, for parity with the orchestrator (test preludes
        # that slow one worker key on it; REPRO_ ⇒ forwarded everywhere)
        env["REPRO_SHARD_INDEX"] = str(self.worker_seq)
        env["REPRO_SERVICE_TENANT"] = name
        self.worker_seq += 1
        shard = ShardProc(index=wid, out_dir=out_dir,
                          cmd=self._worker_cmd(t, out_dir, owner), env=env)
        self.executor.spawn(shard)
        t.workers.append(Worker(tenant=name, wid=wid, owner=owner,
                                shard=shard))
        self.log(f"tenant {name}: worker w{wid} pid {shard.proc.pid} "
                 f"-> {out_dir}")

    def _poll_workers(self, now: float) -> None:
        for t in self.tenants.values():
            for w in t.active:
                s = w.shard
                payload = self.executor.read_heartbeat(s)
                if payload and payload != s.last_payload:
                    s.last_payload = payload
                    s.last_beat = now
                rc = self.executor.poll(s)
                if rc == 0:
                    s.done = True
                    s.close_log()
                    self.executor.collect(s)
                    s.last_payload = (self.executor.read_heartbeat(s)
                                      or s.last_payload)
                    self.log(f"tenant {t.name}: worker w{w.wid} drained "
                             f"and retired")
                    continue
                crashed = rc is not None
                hung = rc is None and (now - s.last_beat) > self.hang_timeout
                if not (crashed or hung):
                    continue
                self.executor.signal(s, signal.SIGKILL)
                if hung and s.proc is not None:
                    s.proc.wait()
                s.close_log()
                released = t.queue.release_owner(w.owner)
                why = (f"no heartbeat for {self.hang_timeout:.0f}s" if hung
                       else f"exit code {rc}")
                if s.restarts >= self.max_restarts:
                    s.failed = True
                    self.log(f"tenant {t.name}: worker w{w.wid} {why}; "
                             f"restart budget exhausted "
                             f"(log: {s.log_path})")
                    continue
                s.restarts += 1
                self.log(f"tenant {t.name}: worker w{w.wid} {why}; "
                         f"released {len(released)} lease(s), restarting "
                         f"with resume (attempt {s.restarts + 1})")
                self.executor.spawn(s)

    def _tenant_facts(self, now: float) -> List[Dict[str, Any]]:
        facts = []
        for t in self.tenants.values():
            c = t.queue.counts()
            facts.append({
                "name": t.name, "priority": t.priority,
                "backlog": c["pending"] + c["leased"],
                "workers": len(t.active), "cells_done": c["done"],
                "budget_cells": t.max_cells, "credit": t.credit,
                "worker_beats": [w.shard.last_beat for w in t.active]})
        return facts

    def tick(self, now: Optional[float] = None) -> None:
        """One scheduler pass: poll/heal workers, reclaim dead leases,
        grant + spawn new workers per the fairshare policy, persist."""
        now = time.time() if now is None else now
        with self._lock:
            self._poll_workers(now)
            for t in self.tenants.values():
                for ticket in t.queue.reclaim_expired(now):
                    self.log(f"tenant {t.name}: lease on {ticket.cell} "
                             f"expired — reclaimed")
            snaps = snapshot_tenants(self._tenant_facts(now),
                                     hang_timeout=self.hang_timeout, now=now)
            free = self.max_workers - sum(len(t.active)
                                          for t in self.tenants.values())
            plan = plan_worker_grants(
                snaps, free,
                max_workers_per_tenant=self.max_workers_per_tenant)
            for name in plan.grants:
                self._spawn_worker(name)
            for s in snaps:
                self.tenants[s.name].credit = plan.credits[s.name]
            self._persist()

    # -- views -------------------------------------------------------------
    def healthz(self) -> Dict[str, Any]:
        """Liveness payload; ``torch_loaded`` proves the daemon stays
        supervisor-side (tests assert it is False)."""
        with self._lock:
            return {"ok": True, "torch_loaded": "torch" in sys.modules,
                    "tenants": len(self.tenants),
                    "workers_active": sum(len(t.active)
                                          for t in self.tenants.values()),
                    "pid": os.getpid()}

    def tenant_status(self, name: str) -> Optional[Dict[str, Any]]:
        """Full per-tenant view (queue counts, budget, workers,
        submissions) or ``None`` for an unknown tenant."""
        with self._lock:
            t = self.tenants.get(name)
            if t is None:
                return None
            counts = t.queue.counts()
            return {
                "tenant": name, "priority": t.priority,
                "profile": dict(t.profile), "queue": counts,
                "drained": t.queue.drained(),
                "max_cells": t.max_cells,
                "over_budget": over_budget(t.max_cells, counts["done"]),
                "credit": t.credit,
                "submissions": list(t.submissions),
                "workers": [{"wid": w.wid, "owner": w.owner,
                             "state": w.state,
                             "restarts": w.shard.restarts,
                             "cells_done": w.shard.last_payload.get(
                                 "cells_done"),
                             "compiles_total": w.shard.last_payload.get(
                                 "compiles_total"),
                             "kernel_launches": w.shard.last_payload.get(
                                 "kernel_launches"),
                             "kernel_route_launches": w.shard.last_payload.get(
                                 "kernel_route_launches"),
                             "out": str(w.shard.out_dir)}
                            for w in t.workers]}

    def tenants_index(self) -> Dict[str, Any]:
        """Summary of every tenant, sorted by name."""
        with self._lock:
            return {"tenants": {
                name: {"priority": t.priority,
                       "queue": t.queue.counts(),
                       "workers_active": len(t.active)}
                for name, t in sorted(self.tenants.items())}}

    def leaderboard_bytes(self, name: str) -> Optional[bytes]:
        """Merge-on-read: fold the tenant's worker dirs (and the shared
        caches) into ``tenants/<t>/merged`` and return the leaderboard
        bytes — the identical byte-stable artifact a standalone campaign
        writes. ``None`` when the tenant has no results yet."""
        from repro_torch.launch.merge_db import merge
        with self._lock:
            t = self.tenants.get(name)
            if t is None:
                return None
            dirs = t.worker_dirs()
            objective = t.profile["objective"]
            caches = [t.queue.cache_dir, t.queue.measured_dir]
            merged = t.root / "merged"
        if not dirs:
            return None
        merge(dirs, merged, verbose=False, extra_cache_dirs=caches,
              objective=objective)
        return (merged / "leaderboard.json").read_bytes()

    # -- persistence -------------------------------------------------------
    def _persist(self) -> None:
        state = {"root": str(self.root), "max_workers": self.max_workers,
                 "submission_seq": self.submission_seq,
                 "tenants": {}}
        for name, t in sorted(self.tenants.items()):
            state["tenants"][name] = {
                "priority": t.priority, "profile": t.profile,
                "max_cells": t.max_cells, "credit": t.credit,
                "seed_cell": list(t.seed_cell) if t.seed_cell else None,
                "next_wid": t.next_wid,
                "queue": t.queue.counts(),
                "submissions": t.submissions,
                "workers": [{"wid": w.wid, "owner": w.owner,
                             "state": w.state,
                             "restarts": w.shard.restarts,
                             "out": str(w.shard.out_dir)}
                            for w in t.workers]}
        write_json_atomic(self.root / STATE_FILE, state)

    def _restore(self) -> None:
        """Re-open tenants recorded by a previous daemon run (queues and
        worker results are already on disk; workers themselves are not
        adopted — the backlog simply earns fresh ones)."""
        path = self.root / STATE_FILE
        if not path.exists():
            return
        try:
            state = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return
        self.submission_seq = int(state.get("submission_seq", 0))
        for name, rec in (state.get("tenants") or {}).items():
            try:
                t = self._open_tenant(name, rec["profile"],
                                      int(rec.get("priority", 1)),
                                      rec.get("max_cells"))
            except (KeyError, TypeError, ValueError):
                continue
            t.credit = float(rec.get("credit", 0.0))
            t.next_wid = int(rec.get("next_wid", 0))
            seed = rec.get("seed_cell")
            t.seed_cell = tuple(seed) if seed else None
            t.submissions = list(rec.get("submissions") or [])
            # past workers come back as retired shards so their result
            # dirs keep feeding the tenant's merged leaderboard
            for w in rec.get("workers") or []:
                shard = ShardProc(index=int(w["wid"]),
                                  out_dir=Path(w["out"]), cmd=[], env={})
                shard.done = True
                t.workers.append(Worker(tenant=name, wid=int(w["wid"]),
                                        owner=w["owner"], shard=shard))

    # -- lifecycle ---------------------------------------------------------
    def _shutdown_workers(self) -> None:
        with self._lock:
            for t in self.tenants.values():
                for w in t.active:
                    self.executor.signal(w.shard, signal.SIGKILL)
                    if w.shard.proc is not None:
                        w.shard.proc.wait()
                    w.shard.close_log()
                    w.shard.failed = True
                    t.queue.release_owner(w.owner)
            self._persist()

    def run(self) -> None:
        """Serve until ``POST /shutdown`` (or SIGTERM/SIGINT): HTTP in
        handler threads, the scheduler tick on this one."""
        self._restore()
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        host, port = self._httpd.server_address[:2]
        write_json_atomic(self.root / ENDPOINT_FILE,
                          {"host": host, "port": port, "pid": os.getpid()})
        server_thread = threading.Thread(target=self._httpd.serve_forever,
                                         daemon=True)
        server_thread.start()
        self.log(f"listening on http://{host}:{port} (root {self.root})")
        try:
            while not self.stop.is_set():
                self.tick()
                self.stop.wait(self.poll_interval)
        finally:
            self._shutdown_workers()
            self._httpd.shutdown()
            server_thread.join(timeout=5)
            self.log("stopped")


def _make_handler(daemon: ServiceDaemon):
    """The HTTP request handler bound to one daemon instance."""

    class Handler(BaseHTTPRequestHandler):
        """Routes the service API onto the daemon's thread-safe views."""

        server_version = "repro-torch-dse-service/1.0"

        def log_message(self, fmt, *args):
            """Quiet: the daemon's own log lines carry the signal."""

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: Any) -> None:
            self._send(code, json.dumps(obj, indent=1,
                                        default=str).encode())

        def do_GET(self):
            """``/healthz`` | ``/tenants`` | ``/tenants/<t>`` |
            ``/tenants/<t>/leaderboard``."""
            path = self.path.rstrip("/") or "/"
            if path == "/healthz":
                return self._send_json(200, daemon.healthz())
            if path == "/tenants":
                return self._send_json(200, daemon.tenants_index())
            m = re.match(r"^/tenants/([^/]+)$", path)
            if m:
                status = daemon.tenant_status(m.group(1))
                if status is None:
                    return self._send_json(
                        404, {"error": f"unknown tenant {m.group(1)!r}"})
                return self._send_json(200, status)
            m = re.match(r"^/tenants/([^/]+)/leaderboard$", path)
            if m:
                try:
                    body = daemon.leaderboard_bytes(m.group(1))
                except (OSError, ValueError) as e:
                    return self._send_json(500, {"error": str(e)})
                if body is None:
                    return self._send_json(
                        404, {"error": f"no results yet for "
                                       f"{m.group(1)!r}"})
                return self._send(200, body)
            self._send_json(404, {"error": f"no route for {path!r}"})

        def do_POST(self):
            """``/submit`` (workload grid) | ``/shutdown`` (clean stop)."""
            path = self.path.rstrip("/")
            if path == "/shutdown":
                daemon.stop.set()
                return self._send_json(200, {"ok": True,
                                             "stopping": True})
            if path == "/submit":
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(raw.decode() or "{}")
                except json.JSONDecodeError as e:
                    return self._send_json(400,
                                           {"error": f"bad JSON: {e}"})
                try:
                    record = daemon.submit(payload)
                except SubmitError as e:
                    return self._send_json(e.code, {"error": str(e)})
                return self._send_json(200, record)
            self._send_json(404, {"error": f"no route for {path!r}"})

    return Handler


# -- client ----------------------------------------------------------------
def _request(url: str, *, method: str = "GET",
             payload: Optional[Dict] = None) -> Tuple[int, bytes]:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _client_payload(args: argparse.Namespace) -> Dict[str, Any]:
    payload: Dict[str, Any] = {
        "tenant": args.tenant, "arch": args.archs, "shape": args.shapes,
        "mesh": args.mesh, "space": args.space, "strategy": args.strategy,
        "objective": args.objective, "budget": args.budget,
        "iterations": args.iterations, "llm": args.llm,
        "priority": args.priority}
    if args.max_cells is not None:
        payload["max_cells"] = args.max_cells
    return payload


def build_parser() -> argparse.ArgumentParser:
    """CLI: ``serve`` (daemon) + ``submit``/``status``/``leaderboard``/
    ``shutdown`` clients. Importable so ``scripts/check_quickstart.py``
    can parse documented commands without booting anything."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.service",
        description="tenant-aware DSE control plane over CellQueue")
    sub = ap.add_subparsers(dest="command", required=True)

    serve = sub.add_parser("serve", help="run the control-plane daemon")
    serve.add_argument("--root", required=True,
                       help="service root (state, queues, shared caches)")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8731,
                       help="0 picks a free port (written to "
                            "endpoint.json)")
    serve.add_argument("--max-workers", type=int, default=2,
                       help="fleet-wide campaign worker pool size")
    serve.add_argument("--max-workers-per-tenant", type=int, default=2)
    serve.add_argument("--poll-interval", type=float, default=0.5)
    serve.add_argument("--hang-timeout", type=float, default=300.0,
                       help="seconds without a heartbeat change before a "
                            "worker is killed + respawned with resume")
    serve.add_argument("--max-restarts", type=int, default=2)
    serve.add_argument("--executor", default="local",
                       choices=["local", "loopback"],
                       help="ShardExecutor backend for workers")
    serve.add_argument("--queue-lease-s", type=float, default=60.0)
    serve.add_argument("--device", default="cuda", choices=list(DEVICE_CHOICES),
                       help="replayed into every worker's campaign argv: "
                            "kernel tenants run their candidates on the card "
                            "(default) or, when asked, the CPU")
    serve.add_argument("--quiet", action="store_true")

    def add_url(p):
        p.add_argument("--url", default="http://127.0.0.1:8731",
                       help="daemon base URL")

    submit = sub.add_parser("submit", help="submit a workload grid")
    add_url(submit)
    submit.add_argument("--tenant", required=True)
    submit.add_argument("--archs", required=True,
                        help="comma-separated arch ids (or 'all')")
    submit.add_argument("--shapes", required=True,
                        help="comma-separated shape ids (or 'all')")
    submit.add_argument("--mesh", default=PROFILE_DEFAULTS["mesh"],
                        choices=list(MESH_CHOICES))
    submit.add_argument("--space", default=PROFILE_DEFAULTS["space"],
                        choices=["plans", "kernels"])
    submit.add_argument("--strategy", default=PROFILE_DEFAULTS["strategy"])
    submit.add_argument("--objective", default=PROFILE_DEFAULTS["objective"],
                        choices=list(OBJECTIVE_CHOICES))
    submit.add_argument("--budget", type=int,
                        default=PROFILE_DEFAULTS["budget"])
    submit.add_argument("--iterations", type=int,
                        default=PROFILE_DEFAULTS["iterations"])
    submit.add_argument("--llm", default=PROFILE_DEFAULTS["llm"],
                        choices=["mock", "ollama"])
    submit.add_argument("--priority", type=int, default=1)
    submit.add_argument("--max-cells", type=int, default=None,
                        help="per-tenant cell budget (scheduling stops "
                             "once this many cells completed)")

    status = sub.add_parser("status", help="tenant/fleet status")
    add_url(status)
    status.add_argument("--tenant", default=None)

    lb = sub.add_parser("leaderboard",
                        help="stream a tenant's merged leaderboard")
    add_url(lb)
    lb.add_argument("--tenant", required=True)
    lb.add_argument("--out", default="-",
                    help="output file ('-' = stdout)")

    shutdown = sub.add_parser("shutdown", help="stop the daemon cleanly")
    add_url(shutdown)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Entry point: run the daemon or one client subcommand."""
    args = build_parser().parse_args(argv)
    if args.command == "serve":
        daemon = ServiceDaemon(
            args.root, host=args.host, port=args.port,
            max_workers=args.max_workers,
            max_workers_per_tenant=args.max_workers_per_tenant,
            poll_interval=args.poll_interval,
            hang_timeout=args.hang_timeout,
            max_restarts=args.max_restarts, executor=args.executor,
            queue_lease_s=args.queue_lease_s, verbose=not args.quiet,
            device=args.device)
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: daemon.stop.set())
        daemon.run()
        return 0
    if args.command == "submit":
        code, body = _request(args.url + "/submit", method="POST",
                              payload=_client_payload(args))
        print(body.decode().rstrip())
        return 0 if code == 200 else 1
    if args.command == "status":
        path = ("/tenants" if args.tenant is None
                else f"/tenants/{args.tenant}")
        code, body = _request(args.url + path)
        print(body.decode().rstrip())
        return 0 if code == 200 else 1
    if args.command == "leaderboard":
        code, body = _request(
            args.url + f"/tenants/{args.tenant}/leaderboard")
        if code != 200:
            print(body.decode().rstrip(), file=sys.stderr)
            return 1
        if args.out == "-":
            sys.stdout.buffer.write(body)
        else:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_bytes(body)
        return 0
    code, body = _request(args.url + "/shutdown", method="POST")
    print(body.decode().rstrip())
    return 0 if code == 200 else 1


if __name__ == "__main__":
    sys.exit(main())
