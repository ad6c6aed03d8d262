"""Crash-safe, file-backed cell queue with leases — the work-stealing substrate.

Counterpart of ``repro/launch/scheduler.py``, copied: the same on-disk
layout, ticket JSON and lease filenames, so either package's workers can
read the other's queue.

Static ``--shard i/n`` partitioning makes the campaign's wall-clock the
slowest shard's wall-clock: one slow host drags the run while fast shards
sit idle. :class:`CellQueue` replaces the static cut with a *dynamic* queue:
every ``(arch, shape)`` cell is a **ticket** (one JSON file) that moves
through three state directories under the queue root,

    pending/{arch}__{shape}.json            up for grabs
    leased/{arch}__{shape}.json.lease-OWNER owned, deadline-bounded
    done/{arch}__{shape}.json               finished (status recorded)

and every state transition is a single atomic ``os.rename`` on one file, so

* a ticket is in exactly one state at any instant, even under SIGKILL —
  there is no multi-file transaction to tear;
* two contending claimants cannot both win: POSIX ``rename`` succeeds for
  exactly one of them (the loser sees ``ENOENT`` and moves on);
* the lease *owner* is encoded in the leased **filename**, so completing a
  ticket (``rename leased/X.lease-me -> done/X``) is a compare-and-swap:
  if the lease was stolen or re-leased meanwhile, the rename fails and
  :meth:`CellQueue.complete` reports the loss instead of clobbering the
  new owner's claim.

Ticket content (JSON, sorted keys) carries the audit trail: ``attempt``
(number of leases ever granted — a re-leased ticket shows ``attempt >= 2``),
``steals`` (forced lease expiries), ``owner`` / ``leased_at`` / ``deadline``
while leased, and ``status`` / ``done_at`` once finished. Content rewrites
happen *after* the state-claiming rename and are **never-creating**
in-place writes (``O_WRONLY`` without ``O_CREAT``): a writer that lost a
rename race in the meantime — a renewal racing a steal, an acquirer racing
a reclaim — cannot resurrect the file it no longer owns, so one cell can
never exist in two states. A crash between rename and rewrite (or a reader
catching the in-place write torn) leaves a ticket whose filename (state +
owner) is right and whose content is stale/unreadable — readers fall back
to file mtime for the deadline, so such a ticket is reclaimed like any
other expired lease.

Lease semantics: a lease carries a ``deadline`` (``leased_at + lease_s``,
refreshed by :meth:`CellQueue.renew` — campaigns renew on every heartbeat).
A leased ticket past its deadline is presumed orphaned (owner crashed or
lost) and any caller of :meth:`CellQueue.reclaim_expired` — acquirers do it
automatically — moves it back to ``pending``. A supervisor that *knows* an
owner died (nonzero exit) calls :meth:`CellQueue.release_owner` to reclaim
immediately instead of waiting out the deadline, and a supervisor that
decides an owner is too slow calls :meth:`CellQueue.steal` — same
transition, but counted on the ticket so post-mortems can tell a crash
reclaim from a rebalancing steal.

Shared across owners: the queue root also hosts the content-addressed
dry-run cache (:attr:`CellQueue.cache_dir`). Queue-mode campaigns point
their evaluator at it, so when a stolen cell is re-run by another shard
every compile the first owner already paid for replays as a cache hit —
completed work is never redone, only re-read.

Every file-system touch goes through an injectable :class:`QueueFS` seam
(:class:`LocalFS` by default — plain stdlib calls). The seam exists for the
``repro_torch.analysis.race`` model checker, which substitutes an instrumented in-memory filesystem and exhaustively explores
interleavings of the queue protocol's atomic steps; production behavior is
byte-identical to the direct stdlib calls the seam replaced.

Pure stdlib file manipulation, safe anywhere.
"""
from __future__ import annotations

import json
import os
import re
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PENDING, LEASED, DONE = "pending", "leased", "done"
STATES = (PENDING, LEASED, DONE)
LEASE_INFIX = ".lease-"
# no dots: an owner containing ".tmp" would make its lease files look like
# atomic-write debris and vanish from every directory scan
_OWNER_RE = re.compile(r"[^A-Za-z0-9_-]+")
_TMP_RE = re.compile(r"\.tmp\d+$")


def sanitize_owner(owner: str) -> str:
    """Make an owner id filename-safe (it is embedded in lease filenames;
    dots are excluded so an owner can never collide with the ``.tmp<pid>``
    atomic-write suffix); raises ``ValueError`` for an owner that
    sanitizes to nothing."""
    clean = _OWNER_RE.sub("_", owner)
    if not clean:
        raise ValueError(f"owner {owner!r} has no filename-safe characters")
    return clean


class LocalFS:
    """The queue's filesystem primitives, one thin method per atomic step.

    :class:`CellQueue` performs **every** disk touch through one of these
    methods so that the race explorer (``repro_torch.analysis.race``) can
    swap in an instrumented in-memory implementation and schedule the protocol's
    atomic steps one at a time. Each method is a single stdlib call (plus
    the error contract noted in its docstring) — there is deliberately no
    logic here, because anything above the primitives would run *between*
    atomic steps and escape the model checker.
    """

    def mkdirs(self, path: Path) -> None:
        """``mkdir -p``: create ``path`` and parents, exist_ok."""
        Path(path).mkdir(parents=True, exist_ok=True)

    def mkdir_exclusive(self, path: Path) -> None:
        """Atomic lock-style create; raises ``FileExistsError`` when held."""
        os.mkdir(path)

    def rmdir(self, path: Path) -> None:
        """Remove an empty directory; raises ``OSError`` when gone/nonempty."""
        os.rmdir(path)

    def glob(self, dir_path: Path, pattern: str) -> List[Path]:
        """Sorted shell-glob match of ``pattern`` within ``dir_path``
        (non-recursive); an unreadable/missing directory yields ``[]``."""
        return sorted(Path(dir_path).glob(pattern))

    def exists(self, path: Path) -> bool:
        """Whether ``path`` currently exists."""
        return Path(path).exists()

    def rename(self, src: Path, dst: Path) -> None:
        """The protocol's atomic state transition; raises
        ``FileNotFoundError`` when ``src`` is gone (the caller lost the
        race) and silently replaces an existing ``dst``."""
        os.rename(src, dst)

    def link(self, src: Path, dst: Path) -> None:
        """Exclusive hard-link create; raises ``FileExistsError`` when
        ``dst`` exists (the seeding race loser's signal)."""
        os.link(src, dst)

    def unlink(self, path: Path, missing_ok: bool = False) -> None:
        """Remove a file; ``missing_ok`` swallows only ENOENT."""
        Path(path).unlink(missing_ok=missing_ok)

    def read_text(self, path: Path) -> str:
        """Read a file's content; raises ``OSError`` when missing."""
        return Path(path).read_text()

    def write_text(self, path: Path, text: str) -> None:
        """Create-or-truncate write — legal ONLY for private ``.tmp`` paths
        that a later :meth:`link`/:meth:`replace` publishes (the invariant
        linter's RPR005 rule enforces exactly that)."""
        Path(path).write_text(text)

    def replace(self, src: Path, dst: Path) -> None:
        """Atomic clobbering rename (``os.replace``): publish a tmp file."""
        os.replace(src, dst)

    def rewrite_nocreate(self, path: Path, text: str) -> bool:
        """In-place content rewrite of a file that must ALREADY exist:
        ``O_WRONLY`` **without** ``O_CREAT``, so a writer that lost a
        state-rename race cannot resurrect the file. Returns ``False``
        (touching nothing) when ``path`` does not exist. Not atomic — the
        queue's readers tolerate torn content by falling back to mtime."""
        try:
            fd = os.open(path, os.O_WRONLY)  # no O_CREAT, by design
        except FileNotFoundError:
            return False
        try:
            os.ftruncate(fd, 0)
            os.write(fd, text.encode())
        finally:
            os.close(fd)
        return True

    def mtime(self, path: Path) -> float:
        """``st_mtime`` of ``path``; raises ``OSError`` when gone."""
        return Path(path).stat().st_mtime


@dataclass
class Ticket:
    """One cell's queue state: identity (``arch``/``shape``/``mesh``), the
    lease audit trail (``attempt`` = leases ever granted, ``steals`` =
    forced expiries), the live lease (``owner``/``leased_at``/``deadline``,
    ``None`` unless leased), and the outcome (``status``/``done_at``, set
    on completion). Serialized with sorted keys so ticket files are
    byte-stable for a given state."""

    arch: str
    shape: str
    mesh: Optional[str] = None
    attempt: int = 0
    steals: int = 0
    owner: Optional[str] = None
    leased_at: Optional[float] = None
    deadline: Optional[float] = None
    status: Optional[str] = None
    done_at: Optional[float] = None

    @property
    def cell(self) -> str:
        """The human-readable cell id, ``"arch/shape"``."""
        return f"{self.arch}/{self.shape}"

    @property
    def file_name(self) -> str:
        """Canonical ticket file name in ``pending/`` and ``done/``."""
        return f"{self.arch}__{self.shape}.json"

    def duration(self) -> Optional[float]:
        """Wall seconds the finishing lease held the ticket (``done_at -
        leased_at``), or ``None`` when either timestamp is missing."""
        if self.done_at is None or self.leased_at is None:
            return None
        return max(self.done_at - self.leased_at, 0.0)

    def to_json(self) -> str:
        """Sorted-key JSON serialization (one ticket file's content)."""
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Ticket":
        """Parse a ticket file's content; raises on malformed JSON."""
        return cls(**json.loads(text))


class CellQueue:
    """The file-backed lease queue (see module docstring). One instance per
    process is cheap — all state lives on disk; concurrent instances over
    the same root coordinate purely through atomic renames."""

    def __init__(self, root: Path | str, *, lease_s: float = 300.0,
                 fs: Optional[LocalFS] = None):
        """Open (creating if needed) the queue at ``root``. ``lease_s`` is
        the lease length this instance grants/renews — it never rewrites
        other owners' deadlines. ``fs`` substitutes the filesystem seam
        (default: the real local filesystem) — the race explorer injects an
        instrumented in-memory one."""
        self.root = Path(root)
        if lease_s <= 0:
            raise ValueError(f"lease_s must be > 0, got {lease_s}")
        self.lease_s = float(lease_s)
        self._fs = fs if fs is not None else LocalFS()
        for state in STATES:
            self._fs.mkdirs(self.root / state)

    # -- layout ------------------------------------------------------------
    @property
    def cache_dir(self) -> Path:
        """The shared content-addressed dry-run cache directory: every
        owner points its evaluator here, so a stolen cell's compiles
        replay instead of re-running."""
        return self.root / "dryrun_cache"

    @property
    def measured_dir(self) -> Path:
        """The shared content-addressed *measured-timing* cache (promotion
        ladder tier 2), beside :attr:`cache_dir`: a re-leased or stolen
        cell replays its recorded wall clocks instead of re-timing, which
        is what makes measurement exactly-once per design across owners."""
        return self.root / "measured_cache"

    def _state_dir(self, state: str) -> Path:
        return self.root / state

    def _lease_path(self, file_name: str, owner: str) -> Path:
        return self.root / LEASED / f"{file_name}{LEASE_INFIX}{owner}"

    @staticmethod
    def _split_lease_name(name: str) -> Optional[Tuple[str, str]]:
        """``(ticket_file_name, owner)`` from a leased filename, or ``None``
        for a foreign file (tmp debris etc.)."""
        if LEASE_INFIX not in name:
            return None
        file_name, owner = name.rsplit(LEASE_INFIX, 1)
        if not file_name.endswith(".json") or not owner:
            return None
        return file_name, owner

    def _read(self, path: Path) -> Optional[Ticket]:
        """Best-effort ticket read; ``None`` for a missing/torn file."""
        try:
            return Ticket.from_json(self._fs.read_text(path))
        except (OSError, json.JSONDecodeError, TypeError):
            return None

    def _write(self, path: Path, ticket: Ticket) -> None:
        """Atomic content write for a path this caller may CREATE (seeding
        only): tmp file + ``os.replace``. The tmp name is pid-qualified so
        concurrent writers never collide."""
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        self._fs.write_text(tmp, ticket.to_json())
        self._fs.replace(tmp, path)

    def _rewrite_existing(self, path: Path, ticket: Ticket) -> bool:
        """Rewrite the content of a ticket file that must ALREADY exist;
        returns False (touching nothing) when it does not. Every content
        update that follows a state-claiming rename — and every lease
        renewal — goes through this, because a create-if-missing write
        (tmp + replace) would *resurrect* a file whose state rename this
        writer lost a race for, putting one cell in two states at once.
        The in-place write is not atomic, but a reader catching it torn
        treats the ticket as content-less and falls back to file mtime —
        which this write just refreshed — so the lease semantics hold."""
        return self._fs.rewrite_nocreate(path, ticket.to_json())

    # -- seeding -----------------------------------------------------------
    def seed(self, cells: Sequence[Tuple[str, str]],
             mesh: Optional[str] = None) -> int:
        """Create a pending ticket per ``(arch, shape)`` cell; idempotent —
        cells whose ticket already exists in *any* state are left alone, so
        re-seeding a half-finished queue (supervisor restart, a late
        cooperating worker) never resurrects claimed or completed work.
        Concurrent seeders are serialized by a lock directory, each cell
        is existence-checked immediately before its create, and the create
        itself is an exclusive hard-link (never a clobbering replace) — so
        a seeder racing an acquire/steal on the same cell loses the race
        instead of forking the ticket into two states. Returns the number
        of tickets created."""
        created = 0
        with self._seed_lock():
            for arch, shape in sorted(set(cells)):
                t = Ticket(arch=arch, shape=shape, mesh=mesh)
                if self._ticket_exists(t.file_name):
                    continue
                dst = self.root / PENDING / t.file_name
                tmp = dst.with_name(f"{dst.name}.tmp{os.getpid()}")
                self._fs.write_text(tmp, t.to_json())
                try:
                    # exclusive: EEXIST if anyone beat us
                    self._fs.link(tmp, dst)
                    created += 1
                except FileExistsError:
                    pass
                finally:
                    self._fs.unlink(tmp, missing_ok=True)
        return created

    def _ticket_exists(self, file_name: str) -> bool:
        """Whether ``file_name`` currently exists in any state directory
        (the leased check matches any owner's lease of it). Checks follow
        the ticket's *movement order* — pending, leased, done — so a
        forward rename racing this check (an acquire's pending->leased, a
        completion's leased->done) is always caught in either its source
        or its destination; a confirming second scan narrows the backward
        (steal/reclaim, leased->pending) race to a double coincidence."""
        def scan() -> bool:
            return (self._fs.exists(self.root / PENDING / file_name)
                    or bool(self._fs.glob(self._state_dir(LEASED),
                                          f"{file_name}{LEASE_INFIX}*"))
                    or self._fs.exists(self.root / DONE / file_name))
        return scan() or scan()

    @contextmanager
    def _seed_lock(self, timeout: float = 60.0):
        """Mutual exclusion between seeders: an atomically-created lock
        directory, broken when its mtime says the holder died mid-seed
        (seeding a full grid takes milliseconds, so ``timeout`` is
        generous). Raises ``TimeoutError`` if the lock never frees."""
        lock = self.root / "seed.lock"
        deadline = time.time() + 2 * timeout
        while True:
            try:
                self._fs.mkdir_exclusive(lock)
                break
            except FileExistsError:
                try:
                    if time.time() - self._fs.mtime(lock) > timeout:
                        self._fs.rmdir(lock)  # stale: holder died mid-seed
                        continue
                except OSError:
                    continue  # lock vanished or not yet stat-able: retry
                if time.time() > deadline:
                    raise TimeoutError(f"seed lock {lock} never freed")
                time.sleep(0.05)
        try:
            yield
        finally:
            try:
                self._fs.rmdir(lock)
            except OSError:
                pass

    # -- introspection -----------------------------------------------------
    def tickets(self, state: Optional[str] = None) -> List[Ticket]:
        """Tickets in ``state`` (or all states), sorted by cell identity.
        Leased tickets whose content rewrite was lost to a crash still
        report their owner (recovered from the lease filename)."""
        states = [state] if state else list(STATES)
        out: List[Ticket] = []
        for s in states:
            for f in self._fs.glob(self._state_dir(s), "*.json*"):
                if _TMP_RE.search(f.name):
                    continue
                if s == LEASED:
                    parsed = self._split_lease_name(f.name)
                    if parsed is None:
                        continue
                t = self._read(f)
                if t is None:
                    continue
                if s == LEASED and t.owner is None:
                    # crash between claim-rename and content rewrite: the
                    # filename is the authoritative owner record
                    t.owner = parsed[1]
                out.append(t)
        out.sort(key=lambda t: (t.arch, t.shape))
        return out

    def counts(self) -> Dict[str, int]:
        """``{"pending": n, "leased": n, "done": n}`` — one directory scan
        each; cheap enough for per-heartbeat calls on campaign-sized
        queues."""
        return {s: sum(1 for f in self._fs.glob(self._state_dir(s), "*.json*")
                       if not _TMP_RE.search(f.name)) for s in STATES}

    def total(self) -> int:
        """Total tickets across all states (the campaign's cell universe)."""
        return sum(self.counts().values())

    def drained(self) -> bool:
        """True when nothing is pending or leased — every cell is done, so
        queue-mode workers can exit."""
        c = self.counts()
        return c[PENDING] == 0 and c[LEASED] == 0

    # -- the lease lifecycle -----------------------------------------------
    def acquire(self, owner: str, now: Optional[float] = None,
                ) -> Optional[Ticket]:
        """Claim the first available pending ticket for ``owner`` (cells in
        sorted order, so contending workers drain the grid front-to-back).
        Reclaims expired leases first. Returns the leased ticket — its
        ``attempt`` already incremented and deadline stamped — or ``None``
        when nothing is pending (the queue may still have cells leased to
        other owners; poll :meth:`drained` to decide whether to wait)."""
        owner = sanitize_owner(owner)
        now = time.time() if now is None else now
        self.reclaim_expired(now)
        for f in self._fs.glob(self._state_dir(PENDING), "*.json"):
            target = self._lease_path(f.name, owner)
            try:
                self._fs.rename(f, target)
            except FileNotFoundError:
                continue  # another owner won this ticket; try the next
            t = self._read(target) or Ticket(*self._cell_of(f.name))
            t.attempt += 1
            t.owner, t.leased_at = owner, now
            t.deadline = now + self.lease_s
            t.status, t.done_at = None, None
            if not self._rewrite_existing(target, t):
                continue  # claim stolen/reclaimed in the rename window
            return t
        return None

    def renew(self, ticket: Ticket, now: Optional[float] = None) -> bool:
        """Push the lease deadline out another ``lease_s`` seconds; returns
        False (without touching anything) when ``ticket``'s lease is gone —
        stolen, reclaimed, or completed — which the owner should treat as
        'stop expecting to complete this cell'. Never creates the lease
        file: a renewal racing a steal must not resurrect the lease."""
        now = time.time() if now is None else now
        ticket.deadline = now + self.lease_s
        return self._rewrite_existing(
            self._lease_path(ticket.file_name, ticket.owner or ""), ticket)

    def complete(self, ticket: Ticket, status: str = "complete",
                 now: Optional[float] = None) -> bool:
        """Finish ``ticket``: atomically move *this owner's* lease to
        ``done/`` and record the outcome. Returns False when the lease no
        longer exists under this owner (stolen or reclaimed) — the caller's
        local results are still valid (the merge dedupes), but the queue's
        completion credit went elsewhere."""
        now = time.time() if now is None else now
        src = self._lease_path(ticket.file_name, ticket.owner or "")
        dst = self.root / DONE / ticket.file_name
        try:
            self._fs.rename(src, dst)
        except FileNotFoundError:
            return False
        ticket.status, ticket.done_at = status, now
        ticket.deadline = None
        self._rewrite_existing(dst, ticket)  # done files never move again
        return True

    # -- reclaiming and stealing -------------------------------------------
    def _expire_lease(self, lease_file: Path, *, steal: bool,
                      now: float) -> Optional[Ticket]:
        """Move one leased ticket back to pending (the shared tail of
        reclaim/release/steal): the claim is the atomic rename; the content
        rewrite clears the lease and, for a steal, bumps ``steals``.
        Returns the pending ticket, or ``None`` when the rename lost a race
        (the owner completed, or another reclaimer got there first)."""
        parsed = self._split_lease_name(lease_file.name)
        if parsed is None:
            return None
        file_name, owner = parsed
        t = self._read(lease_file)
        dst = self.root / PENDING / file_name
        try:
            self._fs.rename(lease_file, dst)
        except FileNotFoundError:
            return None
        if t is None:
            t = Ticket(*self._cell_of(file_name), attempt=1)
        if steal:
            t.steals += 1
        t.owner, t.leased_at, t.deadline = None, None, None
        t.status, t.done_at = None, None
        # no-create: if an acquirer claimed the pending file in this
        # window, rewriting would fork the ticket into two states (the
        # steal/reclaim accounting for this instant is forfeited instead)
        self._rewrite_existing(dst, t)
        return t

    def reclaim_expired(self, now: Optional[float] = None) -> List[Ticket]:
        """Move every leased ticket whose deadline has passed back to
        ``pending`` (presumed-orphaned lease — see module docstring; a
        content-less lease falls back to file mtime + this queue's
        ``lease_s``). Returns the reclaimed tickets."""
        now = time.time() if now is None else now
        out = []
        for f in self._fs.glob(self._state_dir(LEASED), "*.json*"):
            if ".tmp" in f.name:
                continue
            t = self._read(f)
            deadline = t.deadline if t is not None else None
            if deadline is None:
                try:
                    deadline = self._fs.mtime(f) + self.lease_s
                except OSError:
                    continue
            if now > deadline:
                r = self._expire_lease(f, steal=False, now=now)
                if r is not None:
                    out.append(r)
        return out

    def release_owner(self, owner: str, now: Optional[float] = None,
                      ) -> List[Ticket]:
        """Immediately reclaim every lease held by ``owner`` — the
        supervisor's move when it *knows* the owner died (nonzero exit /
        hang kill) and waiting out the deadline would idle the fleet.
        Returns the released tickets."""
        owner = sanitize_owner(owner)
        now = time.time() if now is None else now
        out = []
        for f in self._fs.glob(self._state_dir(LEASED),
                               f"*{LEASE_INFIX}{owner}"):
            r = self._expire_lease(f, steal=False, now=now)
            if r is not None:
                out.append(r)
        return out

    def steal(self, ticket: Ticket, now: Optional[float] = None,
              ) -> Optional[Ticket]:
        """Forcibly expire ``ticket``'s current lease (work rebalancing: the
        owner is alive but far behind the fleet — see the orchestrator's
        steal rule). The ticket returns to ``pending`` with ``steals``
        bumped, ready for an idle owner to acquire; the slow owner's
        eventual :meth:`complete` will return False. Returns the pending
        ticket, or ``None`` when the owner completed first (steal lost the
        race — that is the correct outcome, not an error)."""
        now = time.time() if now is None else now
        if ticket.owner is None:
            return None
        return self._expire_lease(
            self._lease_path(ticket.file_name, ticket.owner),
            steal=True, now=now)

    @staticmethod
    def _cell_of(file_name: str) -> Tuple[str, str]:
        """``(arch, shape)`` parsed back out of a ticket file name."""
        stem = file_name[:-len(".json")]
        arch, _, shape = stem.partition("__")
        return arch, shape
