"""Queue-protocol race explorer — a bounded model checker for CellQueue.

Counterpart of ``repro/analysis/race.py``, copied, driving the port's
``repro_torch.launch.scheduler.CellQueue`` (itself a copy of the
reference's, so every scenario explores the same schedules).

``CellQueue``'s crash-safety argument is that every state transition is a
single atomic rename, so no interleaving of concurrent owners can fork a
ticket into two states, lose it, or complete it twice. This module checks
that argument *mechanically* against the real implementation:

* :class:`MemFS` implements the :class:`~repro_torch.launch.scheduler.LocalFS`
  seam in memory, with every primitive (rename / link / unlink / glob /
  read / rewrite…) instrumented as one **atomic step** that yields to a
  scheduler before executing;
* :class:`TurnScheduler` runs each queue operation in its own thread and
  grants exactly one atomic step at a time, so an interleaving *is* a
  sequence of (operation, step) choices;
* :func:`explore` enumerates interleavings exhaustively (DFS over the
  schedule tree by prefix replay — the standard stateless-model-checking
  construction) up to a bounded branching depth and schedule budget;
* after **every** atomic step the one-state-per-ticket invariant is
  checked against the in-memory tree; at the end of every schedule,
  ticket conservation plus the scenario's own exactly-once assertions.

On a violation the failing schedule is shrunk (shortest failing prefix,
then greedy context-switch reduction) and printed step by step — the
counterexample reads as "alice renamed pending/X, then bob's write
resurrected it". The shipped scenarios (two contending acquirers,
acquire vs reclaim, complete vs steal, renew vs steal, release vs
complete, two-cell contention) pass exhaustively; the deliberately
broken :class:`BrokenCellQueue` (check-then-act acquire) exists to prove
the explorer still has teeth — ``--broken`` demands a counterexample.

Determinism: operations receive explicit ``now=`` timestamps and MemFS
stamps mtimes from a logical clock, so a schedule replays identically —
which both the DFS (prefix replay) and the minimizer rely on.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.race            # all scenarios
    PYTHONPATH=src python -m repro_torch.analysis.race --broken   # self-test

Stdlib-only; a full sweep is a few thousand sub-millisecond replays and
finishes in seconds — cheap enough for every CI run.
"""
from __future__ import annotations

import argparse
import fnmatch
import posixpath
import sys
import threading
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.launch.scheduler import (LEASE_INFIX, CellQueue, LocalFS,
                                          Ticket, sanitize_owner)

QUEUE_ROOT = "Q"
#: the single "current time" every scenario op runs at; MemFS logical
#: clocks start here so modelled mtimes and op timestamps share a domain
NOW = 100.0


class SchedulerAbort(BaseException):
    """Raised inside an op thread when the run is being torn down (a
    violation was already found); BaseException so ops' own ``except
    Exception`` handling can never swallow it."""


# ---------------------------------------------------------------------------
# MemFS: the LocalFS seam, in memory, one gated atomic step per primitive
# ---------------------------------------------------------------------------

class MemFS(LocalFS):
    """In-memory :class:`LocalFS` with a scheduler gate before every
    primitive. Semantics mirror the POSIX behavior the queue relies on:
    ``rename`` is atomic and fails with ``FileNotFoundError`` for a lost
    race, ``link`` is exclusive-create, ``rmdir`` refuses non-empty
    directories, mtimes come from a logical clock (monotonic per
    mutation) so lease-expiry fallbacks are schedule-deterministic."""

    #: logical-clock increment per mutation — small against any lease_s
    #: so modelled mtimes stay in the same time domain as the explicit
    #: ``now=`` values the scenario ops pass (a fresh rewrite must look
    #: *fresh* to the mtime-fallback deadline, exactly as on a real fs)
    TICK = 1e-3

    def __init__(self, clock: float = 0.0):
        self.files: Dict[str, str] = {}
        self.dirs: set = set()
        self.mtimes: Dict[str, float] = {}
        self.clock = float(clock)
        self.scheduler: Optional["TurnScheduler"] = None

    # -- plumbing -----------------------------------------------------------

    @staticmethod
    def _key(path) -> str:
        return posixpath.normpath(str(path))

    def _gate(self, label: str) -> None:
        sched = self.scheduler
        if sched is not None:
            sched.maybe_gate(label)

    def _tick(self) -> float:
        self.clock += self.TICK
        return self.clock

    # -- primitives (each: one gate, then one atomic mutation/observation) --

    def mkdirs(self, path) -> None:
        self._gate(f"mkdirs {path}")
        parts = self._key(path).split("/")
        for i in range(1, len(parts) + 1):
            self.dirs.add("/".join(parts[:i]))

    def mkdir_exclusive(self, path) -> None:
        self._gate(f"mkdir_exclusive {path}")
        k = self._key(path)
        if k in self.dirs or k in self.files:
            raise FileExistsError(k)
        self.dirs.add(k)
        self.mtimes[k] = self._tick()

    def rmdir(self, path) -> None:
        self._gate(f"rmdir {path}")
        k = self._key(path)
        if k not in self.dirs:
            raise FileNotFoundError(k)
        if any(p != k and (p.startswith(k + "/"))
               for p in list(self.files) + list(self.dirs)):
            raise OSError(39, "directory not empty", k)  # ENOTEMPTY
        self.dirs.discard(k)

    def glob(self, dir_path, pattern: str) -> List[Path]:
        self._gate(f"glob {dir_path}/{pattern}")
        d = self._key(dir_path)
        names = set()
        for k in list(self.files) + list(self.dirs):
            if posixpath.dirname(k) == d:
                names.add(posixpath.basename(k))
        return sorted(Path(d) / n for n in names
                      if fnmatch.fnmatchcase(n, pattern))

    def exists(self, path) -> bool:
        self._gate(f"exists {path}")
        k = self._key(path)
        return k in self.files or k in self.dirs

    def rename(self, src, dst) -> None:
        self._gate(f"rename {src} -> {dst}")
        s, d = self._key(src), self._key(dst)
        if s not in self.files:
            raise FileNotFoundError(s)
        self.files[d] = self.files.pop(s)
        self.mtimes[d] = self.mtimes.pop(s)  # rename preserves mtime

    def link(self, src, dst) -> None:
        self._gate(f"link {src} -> {dst}")
        s, d = self._key(src), self._key(dst)
        if s not in self.files:
            raise FileNotFoundError(s)
        if d in self.files:
            raise FileExistsError(d)
        self.files[d] = self.files[s]
        self.mtimes[d] = self.mtimes[s]

    def unlink(self, path, missing_ok: bool = False) -> None:
        self._gate(f"unlink {path}")
        k = self._key(path)
        if k not in self.files:
            if missing_ok:
                return
            raise FileNotFoundError(k)
        del self.files[k]
        self.mtimes.pop(k, None)

    def read_text(self, path) -> str:
        self._gate(f"read {path}")
        k = self._key(path)
        if k not in self.files:
            raise FileNotFoundError(k)
        return self.files[k]

    def write_text(self, path, text: str) -> None:
        self._gate(f"write {path}")
        k = self._key(path)
        self.files[k] = text
        self.mtimes[k] = self._tick()

    def replace(self, src, dst) -> None:
        self._gate(f"replace {src} -> {dst}")
        s, d = self._key(src), self._key(dst)
        if s not in self.files:
            raise FileNotFoundError(s)
        self.files[d] = self.files.pop(s)
        self.mtimes[d] = self.mtimes.pop(s)

    def rewrite_nocreate(self, path, text: str) -> bool:
        self._gate(f"rewrite {path}")
        k = self._key(path)
        if k not in self.files:
            return False
        self.files[k] = text
        self.mtimes[k] = self._tick()
        return True

    def mtime(self, path) -> float:
        self._gate(f"mtime {path}")
        k = self._key(path)
        if k not in self.mtimes:
            raise FileNotFoundError(k)
        return self.mtimes[k]


# ---------------------------------------------------------------------------
# Per-step invariant: one state per ticket
# ---------------------------------------------------------------------------

def ticket_locations(fs: MemFS, root: str = QUEUE_ROOT) -> Dict[str, List[str]]:
    """Map ticket base name -> every queue location currently holding it
    (``pending/X.json``, ``leased/X.json.lease-O``, ``done/X.json``);
    tmp debris and foreign files are ignored, as the queue itself does."""
    locs: Dict[str, List[str]] = {}
    for k in fs.files:
        rel = posixpath.relpath(k, root)
        if rel.startswith(".."):
            continue
        parts = rel.split("/")
        if len(parts) != 2 or parts[0] not in ("pending", "leased", "done"):
            continue
        name = parts[1]
        if ".tmp" in name:
            continue
        base = name.rsplit(LEASE_INFIX, 1)[0] if parts[0] == "leased" \
            else name
        if not base.endswith(".json"):
            continue
        locs.setdefault(base, []).append(rel)
    return locs


def one_state_per_ticket(fs: MemFS, root: str = QUEUE_ROOT) -> Optional[str]:
    """The protocol's core safety property, checkable after every atomic
    step: no ticket may ever exist in two queue locations at once."""
    for base, places in sorted(ticket_locations(fs, root).items()):
        if len(places) > 1:
            return (f"one-state-per-ticket violated: {base} exists at "
                    f"{places}")
    return None


# ---------------------------------------------------------------------------
# TurnScheduler: one atomic step at a time, under one schedule
# ---------------------------------------------------------------------------

class TurnScheduler:
    """Runs each operation in a thread and grants one MemFS primitive at
    a time. Between steps every live thread is parked at its gate, so the
    ``enabled`` set at each decision point is exactly the unfinished ops
    — deterministic, which prefix-replay DFS requires."""

    WAIT_S = 10.0  # a stuck run is a bug in the run itself

    def __init__(self, op_names: Sequence[str]):
        self.cv = threading.Condition()
        self.names = list(op_names)
        self.by_ident: Dict[int, str] = {}
        self.waiting: Dict[str, str] = {}   # name -> label of next step
        self.finished: set = set()
        self.granted: Optional[str] = None
        self.abort = False

    # -- worker side --------------------------------------------------------

    def maybe_gate(self, label: str) -> None:
        """Called by MemFS before each primitive. Unregistered threads
        (setup / final checks on the main thread) pass straight through."""
        name = self.by_ident.get(threading.get_ident())
        if name is None:
            return
        with self.cv:
            self.waiting[name] = label
            self.cv.notify_all()
            while self.granted != name:
                if self.abort:
                    self.waiting.pop(name, None)
                    self.cv.notify_all()
                    raise SchedulerAbort()
                if not self.cv.wait(self.WAIT_S):
                    raise RuntimeError(f"op {name} starved at gate")
            self.granted = None
            self.waiting.pop(name, None)
            self.cv.notify_all()
        # returning = executing the one granted primitive

    def _worker(self, name: str, fn: Callable, results: Dict,
                errors: Dict) -> None:
        with self.cv:
            # self-registration: the ident only exists once the thread
            # runs, and the first fs primitive must already be gated
            self.by_ident[threading.get_ident()] = name
        try:
            results[name] = fn()
        except SchedulerAbort:
            pass
        except BaseException as e:  # an escaping exception IS a finding
            errors[name] = e
        finally:
            with self.cv:
                self.finished.add(name)
                self.waiting.pop(name, None)
                self.cv.notify_all()

    # -- scheduling side ----------------------------------------------------

    def _wait_quiescent(self) -> None:
        with self.cv:
            while self.granted is not None or (
                    len(self.waiting) + len(self.finished) < len(self.names)):
                if not self.cv.wait(self.WAIT_S):
                    raise RuntimeError(
                        f"scheduler stalled: waiting={list(self.waiting)} "
                        f"finished={sorted(self.finished)}")

    def _grant(self, name: str) -> None:
        with self.cv:
            self.granted = name
            self.cv.notify_all()

    def _teardown(self, threads: List[threading.Thread]) -> None:
        with self.cv:
            self.abort = True
            self.cv.notify_all()
        for t in threads:
            t.join(self.WAIT_S)

    def run(self, ops: Sequence[Tuple[str, Callable]],
            choices: Sequence[str],
            step_check: Callable[[], Optional[str]]) -> "RunResult":
        """Execute one schedule: follow ``choices`` while they name
        enabled ops (infeasible entries are skipped — the minimizer
        exploits this tolerance), then default to the first enabled op.
        ``step_check`` runs after every atomic step; the first violation
        aborts the run."""
        results: Dict[str, object] = {}
        errors: Dict[str, BaseException] = {}
        threads = [threading.Thread(target=self._worker,
                                    args=(name, fn, results, errors),
                                    daemon=True)
                   for name, fn in ops]
        for t in threads:
            t.start()
        queue = deque(choices)
        trace: List[Tuple[str, str, Tuple[str, ...]]] = []
        violation: Optional[str] = None
        while True:
            self._wait_quiescent()
            violation = step_check()
            if violation:
                break
            enabled = sorted(self.waiting)
            if not enabled:
                break  # every op ran to completion
            chosen = None
            while queue and chosen is None:
                c = queue.popleft()
                if c in enabled:
                    chosen = c
            if chosen is None:
                chosen = enabled[0]
            trace.append((chosen, self.waiting[chosen], tuple(enabled)))
            self._grant(chosen)
        self._teardown(threads)
        if violation is None and errors:
            name, e = sorted(errors.items())[0]
            violation = f"op {name} raised {type(e).__name__}: {e}"
        return RunResult(trace=trace, results=results, violation=violation)


@dataclass
class RunResult:
    """One executed schedule: the decision trace (chosen op, the atomic
    step it took, the enabled set), per-op return values, and the first
    invariant violation (None for a clean run)."""
    trace: List[Tuple[str, str, Tuple[str, ...]]]
    results: Dict[str, object]
    violation: Optional[str]

    @property
    def choices(self) -> List[str]:
        return [c for c, _, _ in self.trace]

    def render_schedule(self) -> str:
        lines = []
        for i, (chosen, label, enabled) in enumerate(self.trace, 1):
            mark = "" if len(enabled) == 1 else \
                f"   (enabled: {', '.join(enabled)})"
            lines.append(f"  step {i:>2}: {chosen:<10} {label}{mark}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Scenarios: real CellQueue operations under contention
# ---------------------------------------------------------------------------

def _copy(t: Ticket) -> Ticket:
    """Each op gets its own Ticket object — concurrent owners never
    share in-process state, only the filesystem."""
    return Ticket.from_json(t.to_json())


def _queues(fs: MemFS, n: int, lease_s: float = 100.0,
            queue_cls: type = CellQueue) -> List[CellQueue]:
    return [queue_cls(QUEUE_ROOT, lease_s=lease_s, fs=fs) for _ in range(n)]


@dataclass
class Built:
    """A scenario instance ready to run: the shared MemFS, the named
    concurrent operations, and the end-state assertion."""
    fs: MemFS
    ops: List[Tuple[str, Callable]]
    final_check: Callable[[Dict[str, object]], Optional[str]]
    initial_tickets: set = field(default_factory=set)


def _finish_build(fs: MemFS, ops, final_check) -> Built:
    return Built(fs=fs, ops=ops, final_check=final_check,
                 initial_tickets=set(ticket_locations(fs)))


def _scn_two_acquirers(queue_cls: type = CellQueue) -> Built:
    """Two owners race ``acquire`` for a single pending ticket: exactly
    one may win the claim rename; the loser gets None."""
    fs = MemFS(clock=NOW)
    q0, q1, q2 = _queues(fs, 3, queue_cls=queue_cls)
    q0.seed([("mxu", "s0")])

    def final(results):
        winners = [r for r in results.values() if r is not None]
        if len(winners) != 1:
            return f"expected exactly one acquire winner, got {len(winners)}"
        c = q0.counts()
        if c != {"pending": 0, "leased": 1, "done": 0}:
            return f"unexpected end state {c}"
        return None

    return _finish_build(fs, [
        ("alice", lambda: q1.acquire("alice", now=NOW)),
        ("bob", lambda: q2.acquire("bob", now=NOW)),
    ], final)


def _scn_acquire_vs_reclaim(queue_cls: type = CellQueue) -> Built:
    """An acquirer races an explicit ``reclaim_expired`` over one expired
    lease: the ticket must end in exactly one of pending/leased, never
    duplicated or lost."""
    fs = MemFS(clock=NOW)
    q0, q1, q2 = _queues(fs, 3, lease_s=50.0, queue_cls=queue_cls)
    q0.seed([("mxu", "s0")])
    assert q0.acquire("old_owner", now=0.0) is not None  # expires at 50

    def final(results):
        c = q0.counts()
        if c["done"] != 0 or c["pending"] + c["leased"] != 1:
            return f"unexpected end state {c}"
        if results.get("new_owner") is not None and c["leased"] != 1:
            return "acquire returned a ticket but nothing is leased"
        return None

    return _finish_build(fs, [
        ("new_owner", lambda: q1.acquire("new_owner", now=NOW)),
        ("reclaimer", lambda: q2.reclaim_expired(now=NOW)),
    ], final)


def _scn_complete_vs_steal(queue_cls: type = CellQueue) -> Built:
    """The owner's ``complete`` races a supervisor ``steal`` of the same
    live lease: the rename CAS lets exactly one side win — completion
    credit is granted exactly once or the ticket is back up for grabs."""
    fs = MemFS(clock=NOW)
    q0, q1, q2 = _queues(fs, 3, queue_cls=queue_cls)
    q0.seed([("mxu", "s0")])
    t = q0.acquire("alice", now=10.0)
    assert t is not None

    def final(results):
        completed = results.get("alice") is True
        stolen = results.get("stealer") is not None
        if completed == stolen:
            return (f"exactly-once violated: complete={completed} "
                    f"steal={stolen}")
        c = q0.counts()
        want = ({"pending": 0, "leased": 0, "done": 1} if completed
                else {"pending": 1, "leased": 0, "done": 0})
        if c != want:
            return f"end state {c} does not match winner (want {want})"
        return None

    return _finish_build(fs, [
        ("alice", lambda: q1.complete(_copy(t), now=NOW)),
        ("stealer", lambda: q2.steal(_copy(t), now=NOW)),
    ], final)


def _scn_renew_vs_steal(queue_cls: type = CellQueue) -> Built:
    """A heartbeat ``renew`` races a ``steal``: the steal's rename always
    wins eventually, and the renew — a never-creating rewrite — must not
    resurrect the lease it lost."""
    fs = MemFS(clock=NOW)
    q0, q1, q2 = _queues(fs, 3, queue_cls=queue_cls)
    q0.seed([("mxu", "s0")])
    t = q0.acquire("alice", now=10.0)
    assert t is not None

    def final(results):
        if results.get("stealer") is None:
            return "steal of a live lease unexpectedly failed"
        c = q0.counts()
        if c != {"pending": 1, "leased": 0, "done": 0}:
            return f"stolen ticket not solely pending: {c}"
        return None

    return _finish_build(fs, [
        ("alice", lambda: q1.renew(_copy(t), now=NOW)),
        ("stealer", lambda: q2.steal(_copy(t), now=NOW)),
    ], final)


def _scn_release_vs_complete(queue_cls: type = CellQueue) -> Built:
    """The supervisor's crash-path ``release_owner`` races the (not
    actually dead) owner's ``complete``: exactly one transition wins."""
    fs = MemFS(clock=NOW)
    q0, q1, q2 = _queues(fs, 3, queue_cls=queue_cls)
    q0.seed([("mxu", "s0")])
    t = q0.acquire("alice", now=10.0)
    assert t is not None

    def final(results):
        completed = results.get("alice") is True
        released = len(results.get("supervisor") or []) == 1
        if completed == released:
            return (f"exactly-once violated: complete={completed} "
                    f"release={released}")
        c = q0.counts()
        want = ({"pending": 0, "leased": 0, "done": 1} if completed
                else {"pending": 1, "leased": 0, "done": 0})
        if c != want:
            return f"end state {c} does not match winner (want {want})"
        return None

    return _finish_build(fs, [
        ("alice", lambda: q1.complete(_copy(t), now=NOW)),
        ("supervisor", lambda: q2.release_owner("alice", now=NOW)),
    ], final)


def _scn_two_cells(queue_cls: type = CellQueue) -> Built:
    """Two owners drain a two-ticket queue: both must come away with a
    (distinct) cell regardless of interleaving — losing a rename race
    means trying the next ticket, not giving up."""
    fs = MemFS(clock=NOW)
    q0, q1, q2 = _queues(fs, 3, queue_cls=queue_cls)
    q0.seed([("mxu", "s0"), ("vec", "s1")])

    def final(results):
        a, b = results.get("alice"), results.get("bob")
        if a is None or b is None:
            return f"an owner came away empty: alice={a} bob={b}"
        if (a.arch, a.shape) == (b.arch, b.shape):
            return f"both owners leased the same cell {a.cell}"
        c = q0.counts()
        if c != {"pending": 0, "leased": 2, "done": 0}:
            return f"unexpected end state {c}"
        return None

    return _finish_build(fs, [
        ("alice", lambda: q1.acquire("alice", now=NOW)),
        ("bob", lambda: q2.acquire("bob", now=NOW)),
    ], final)


SCENARIOS: Dict[str, Callable[..., Built]] = {
    "two_acquirers": _scn_two_acquirers,
    "acquire_vs_reclaim": _scn_acquire_vs_reclaim,
    "complete_vs_steal": _scn_complete_vs_steal,
    "renew_vs_steal": _scn_renew_vs_steal,
    "release_vs_complete": _scn_release_vs_complete,
    "two_cells": _scn_two_cells,
}


# ---------------------------------------------------------------------------
# The deliberately broken variant (explorer self-test)
# ---------------------------------------------------------------------------

class BrokenCellQueue(CellQueue):
    """``CellQueue`` with the textbook bug the real protocol exists to
    prevent: ``acquire`` is check-then-act — read the pending ticket,
    *create* the lease file, then unlink pending — three steps where the
    real code has one atomic rename. Two claimants interleaved between
    the read and the unlink both manufacture leases, putting one ticket
    in two states. Exists so tests and ``--broken`` can prove the
    explorer actually catches protocol violations."""

    def acquire(self, owner: str, now: Optional[float] = None,
                ) -> Optional[Ticket]:
        owner = sanitize_owner(owner)
        now = 0.0 if now is None else now
        for f in self._fs.glob(self._state_dir("pending"), "*.json"):
            if not self._fs.exists(f):
                continue
            try:
                text = self._fs.read_text(f)
            except OSError:
                continue
            target = self._lease_path(f.name, owner)
            # BUG: creates the lease while pending/ still holds the file
            self._fs.write_text(target, text)
            self._fs.unlink(f, missing_ok=True)
            try:
                t = Ticket.from_json(text)
            except Exception:
                t = Ticket(*self._cell_of(f.name))
            t.attempt += 1
            t.owner, t.leased_at = owner, now
            t.deadline = now + self.lease_s
            self._rewrite_existing(target, t)
            return t
        return None


# ---------------------------------------------------------------------------
# Exploration: DFS over the schedule tree by prefix replay
# ---------------------------------------------------------------------------

def run_once(build: Callable[[], Built],
             choices: Sequence[str]) -> RunResult:
    """Build a fresh scenario instance and execute one schedule. The
    per-step check is the one-state-per-ticket invariant; the final
    checks add ticket conservation and the scenario's own assertions."""
    b = build()
    sched = TurnScheduler([name for name, _ in b.ops])
    b.fs.scheduler = sched  # setup above ran ungated
    res = sched.run(b.ops, choices, lambda: one_state_per_ticket(b.fs))
    b.fs.scheduler = None
    if res.violation is None:
        now_tickets = set(ticket_locations(b.fs))
        if now_tickets != b.initial_tickets:
            res.violation = (
                "ticket conservation violated: started with "
                f"{sorted(b.initial_tickets)}, ended with "
                f"{sorted(now_tickets)}")
    if res.violation is None:
        res.violation = b.final_check(res.results)
    return res


@dataclass
class ExploreResult:
    """Outcome of exhaustively exploring one scenario."""
    scenario: str
    schedules: int
    max_decisions: int
    counterexample: Optional[RunResult] = None

    @property
    def ok(self) -> bool:
        return self.counterexample is None


def explore(build: Callable[[], Built], *, max_depth: int = 24,
            max_schedules: int = 5000, scenario: str = "") -> ExploreResult:
    """Enumerate interleavings depth-first: run a schedule prefix (default
    continuation: first enabled op), then branch on every alternative
    choice at every decision point past the prefix, up to ``max_depth``
    decisions deep. With a branching horizon past the longest trace this
    is *exhaustive*; the budget caps runaway scenarios."""
    stack: List[Tuple[str, ...]] = [()]
    seen = 0
    longest = 0
    while stack and seen < max_schedules:
        prefix = stack.pop()
        res = run_once(build, list(prefix))
        seen += 1
        longest = max(longest, len(res.trace))
        if res.violation is not None:
            return ExploreResult(scenario, seen, longest, res)
        for i in range(len(prefix), min(len(res.trace), max_depth)):
            chosen, _, enabled = res.trace[i]
            for alt in enabled:
                if alt != chosen:
                    stack.append(tuple(res.choices[:i]) + (alt,))
    return ExploreResult(scenario, seen, longest)


def _switches(choices: Sequence[str]) -> int:
    return sum(1 for a, b in zip(choices, choices[1:]) if a != b)


def minimize(build: Callable[[], Built],
             choices: Sequence[str]) -> RunResult:
    """Shrink a failing schedule: (1) shortest failing prefix — the
    default continuation past the prefix is deterministic, so a linear
    scan finds the earliest decision that seals the violation; (2) greedy
    context-switch reduction — try extending each op's run over the next
    decision and keep every variant that still fails with fewer
    switches. Best-effort, bounded; returns the final failing run."""
    best = list(choices)
    for k in range(len(best) + 1):
        r = run_once(build, best[:k])
        if r.violation is not None:
            best = best[:k]
            break
    budget = 200
    improved = True
    while improved and budget > 0:
        improved = False
        for i in range(1, len(best)):
            if best[i] == best[i - 1]:
                continue
            cand = best[:i] + [best[i - 1]] + best[i + 1:]
            if _switches(cand) >= _switches(best):
                continue
            budget -= 1
            if run_once(build, cand).violation is not None:
                best = cand
                improved = True
                break
    final = run_once(build, best)
    assert final.violation is not None, "minimizer lost the violation"
    return final


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    """The race-explorer CLI surface (the README's fenced commands are
    parsed with it by the tests, to keep them honest)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.race",
        description="bounded model checker for the CellQueue protocol: "
                    "exhaustively interleaves concurrent queue ops over "
                    "an in-memory fs and checks the one-state-per-ticket"
                    ", conservation, and exactly-once invariants")
    ap.add_argument("--scenario", action="append", default=None,
                    choices=sorted(SCENARIOS),
                    help="scenario(s) to explore (default: all)")
    ap.add_argument("--max-depth", type=int, default=24,
                    help="branching horizon in scheduling decisions "
                         "(default: 24 — past every shipped trace, i.e. "
                         "exhaustive)")
    ap.add_argument("--max-schedules", type=int, default=5000,
                    help="schedule budget per scenario (default: 5000)")
    ap.add_argument("--broken", action="store_true",
                    help="self-test: run the deliberately broken "
                         "check-then-act queue and DEMAND a "
                         "counterexample (exit 1 if none found)")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and exit")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        for name, fn in sorted(SCENARIOS.items()):
            doc = (fn.__doc__ or "").strip().split("\n")[0]
            print(f"{name:<22} {doc}")
        return 0
    names = args.scenario or sorted(SCENARIOS)
    queue_cls = BrokenCellQueue if args.broken else CellQueue
    if args.broken:
        names = [n for n in names if "acquirers" in n or "cells" in n]
    failures = 0
    found_counterexample = False
    for name in names:
        factory = SCENARIOS[name]
        build = lambda f=factory: f(queue_cls=queue_cls)
        res = explore(build, max_depth=args.max_depth,
                      max_schedules=args.max_schedules, scenario=name)
        if res.ok:
            print(f"race: {name}: OK — {res.schedules} schedules "
                  f"explored exhaustively (longest trace "
                  f"{res.max_decisions} decisions)")
            continue
        found_counterexample = True
        failures += 1
        mini = minimize(build, res.counterexample.choices)
        print(f"race: {name}: VIOLATION after {res.schedules} schedules")
        print(f"  {mini.violation}")
        print("  minimal counterexample schedule "
              f"({_switches(mini.choices)} context switches):")
        print(mini.render_schedule())
    if args.broken:
        if found_counterexample:
            print("race: --broken self-test passed: the explorer caught "
                  "the check-then-act bug")
            return 0
        print("race: --broken self-test FAILED: no counterexample found "
              "for a queue that is known-broken")
        return 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
