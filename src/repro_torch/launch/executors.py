"""Pluggable shard-executor backends for the campaign orchestrator.

Counterpart of ``repro/launch/executors.py``. ``run_orchestrator``
supervises n shard subprocesses but does not care *where* they run. This
module owns the shard lifecycle behind the :class:`ShardExecutor`
protocol — ``spawn`` / ``poll`` / ``read_heartbeat`` / ``signal`` /
``collect`` — so the healing and merge logic in
``repro_torch.launch.orchestrator`` stays executor-agnostic:

* :class:`LocalProcessExecutor` — each shard is a local ``python -m
  repro_torch.launch.campaign`` subprocess in its own session/process
  group (so a kill reaches the dry-run pool workers too), heartbeats read
  from the shard dir's ``progress.json``. Shard ``i`` sees one card,
  ``i mod n`` of the ``n`` this machine shows (``CUDA_VISIBLE_DEVICES``;
  the cards are counted with ``nvidia-smi``, not torch), so shards that
  measure never share one;
* :class:`SSHExecutor` — the same campaign argv dispatched to a remote host
  over ``ssh``: the remote process group is tracked via a ``shard.pid`` file,
  heartbeats are fetched by ``cat``-ing the remote ``progress.json``, and the
  remote shard dir is rsync'd back into ``OUT/shards/shard{i}`` before the
  merge, so ``merge_db`` never knows the shard ran elsewhere. Requires: the
  repo checked out on every host (``remote_repo``, default: this checkout's
  path), passwordless ssh, and ``rsync`` on both ends. Exit codes propagate
  through ssh, so crash detection is identical to the local backend;
* :class:`LoopbackExecutor` — SSHExecutor with its transport stubbed to
  local ``/bin/sh`` (and the copy-back to ``cp``): every remote-dispatch code
  path — command templating, pid-file group kill, heartbeat fetch, collect —
  runs on this machine with no network, so the tests exercise the ssh seam.

Selected by ``--executor local|ssh|loopback`` (+ ``--hosts h0,h1,...``) on
``repro_torch.launch.orchestrator``. Pure supervision: never imports torch.
"""
from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Protocol, Sequence

from repro_torch.launch.campaign import read_progress

PID_FILE = "shard.pid"
#: env vars forwarded into remote shard processes (the test hooks);
#: everything else stays host-local
FORWARD_ENV_PREFIXES = ("REPRO_",)


def visible_cards() -> List[str]:
    """The CUDA cards this process may hand out, as ``CUDA_VISIBLE_DEVICES``
    entries: that variable's own list when it is set, else one index per
    line of ``nvidia-smi -L``; empty on a machine without cards. Counted
    without torch, so the supervisor stays light."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if r.returncode != 0:
        return []
    n = sum(line.startswith("GPU ") for line in r.stdout.splitlines())
    return [str(i) for i in range(n)]


@dataclass
class ShardProc:
    """Supervisor-side state for one shard: its launch command, local output
    dir, the live local process handle (the campaign itself, or the ssh
    client driving a remote one), restart count, and the last heartbeat
    payload/time used for hang detection. Lifecycle behavior lives in the
    :class:`ShardExecutor` that owns the shard."""

    index: int
    out_dir: Path
    cmd: List[str]
    env: Dict[str, str]
    proc: Optional[subprocess.Popen] = None
    log_handle: Optional[object] = None
    restarts: int = 0
    done: bool = False
    failed: bool = False
    last_beat: float = field(default_factory=time.time)
    last_payload: Dict = field(default_factory=dict)

    @property
    def log_path(self) -> Path:
        """The shard's combined stdout+stderr log (appended across restarts,
        so post-mortems see every attempt; for remote shards this captures
        the ssh client's view of the remote output)."""
        return self.out_dir / "shard.log"

    def spawn_local(self, argv: List[str]) -> None:
        """(Re)launch ``argv`` as a local subprocess, appending to the log
        file. The child leads its own session/process group so
        :meth:`signal_group` reaches its evaluator pool workers too."""
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.log_handle = self.log_path.open("ab")
        self.proc = subprocess.Popen(argv, stdout=self.log_handle,
                                     stderr=subprocess.STDOUT, env=self.env,
                                     start_new_session=True)
        self.last_beat = time.time()

    def signal_group(self, sig: int) -> None:
        """Deliver ``sig`` to the local process group (the campaign process
        AND its spawned compile-pool workers — killing only the leader would
        orphan workers that keep burning CPU against the restarted attempt).
        Falls back to signalling the leader alone if the group is already
        gone; a fully-reaped shard is a no-op."""
        if self.proc is None:
            return
        try:
            os.killpg(self.proc.pid, sig)  # pgid == pid (start_new_session)
        except (ProcessLookupError, PermissionError):
            try:
                self.proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass

    def close_log(self) -> None:
        """Close the log handle (idempotent)."""
        if self.log_handle is not None:
            self.log_handle.close()
            self.log_handle = None


class ShardExecutor(Protocol):
    """Where and how shard campaigns run. ``run_orchestrator`` drives the
    whole heal/merge contract through these five calls, so a backend only
    has to answer: start the shard, is it alive, what does its heartbeat
    say, kill it (and its process group), and bring its output dir local."""

    name: str

    def spawn(self, shard: ShardProc) -> None:
        """(Re)launch the shard; must reset its heartbeat clock."""
        ...

    def poll(self, shard: ShardProc) -> Optional[int]:
        """Exit code if the shard finished, else ``None`` (still running)."""
        ...

    def read_heartbeat(self, shard: ShardProc) -> Dict:
        """Best-effort read of the shard's live ``progress.json`` payload;
        ``{}`` means no news (missing/torn/unreachable), never a crash."""
        ...

    def signal(self, shard: ShardProc, sig: int) -> None:
        """Deliver ``sig`` to the shard's whole process group, wherever it
        runs; a no-op for an already-reaped shard."""
        ...

    def collect(self, shard: ShardProc) -> None:
        """Make the shard's output dir available at ``shard.out_dir`` on
        this machine (no-op when it already is) so ``merge_db`` can fold it
        in without knowing the backend."""
        ...


@dataclass
class LocalProcessExecutor:
    """Shards as local subprocesses (own session per shard, process-group
    kill, heartbeat file read straight from the shard dir), shard ``i`` on
    card ``cards[i % len(cards)]``. ``cards`` defaults to
    :func:`visible_cards`; with none, the shards see what the supervisor
    sees."""

    name: str = "local"
    cards: Optional[List[str]] = None

    def __post_init__(self):
        """Count the cards once, when the executor is made."""
        if self.cards is None:
            self.cards = visible_cards()

    def spawn(self, shard: ShardProc) -> None:
        """Launch the shard's campaign argv locally (fresh attempt appends
        to the same log), on its own card when there are any."""
        if self.cards:
            shard.env = {**shard.env, "CUDA_VISIBLE_DEVICES":
                         self.cards[shard.index % len(self.cards)]}
        shard.spawn_local(shard.cmd)

    def poll(self, shard: ShardProc) -> Optional[int]:
        """Local ``Popen.poll``."""
        return shard.proc.poll() if shard.proc is not None else None

    def read_heartbeat(self, shard: ShardProc) -> Dict:
        """Read ``progress.json`` from the local shard dir."""
        return read_progress(shard.out_dir)

    def signal(self, shard: ShardProc, sig: int) -> None:
        """Process-group kill (see :meth:`ShardProc.signal_group`)."""
        shard.signal_group(sig)

    def collect(self, shard: ShardProc) -> None:
        """No-op: the shard already ran in ``shard.out_dir``."""


@dataclass
class SSHExecutor:
    """Shards dispatched to remote hosts over ssh (see module docstring).

    Host assignment is round-robin over ``hosts`` by shard index. The remote
    shard dir is ``{remote_root}/shard{i}`` when ``remote_root`` is set,
    else the *same absolute path* as the local shard dir (the shared-FS /
    identical-layout convention). The remote command writes the campaign's
    pid (a ``setsid`` session leader) to ``shard.pid`` so :meth:`signal`
    can kill the whole remote process group; ssh propagates the campaign's
    exit code, so :meth:`poll` is just the local client's ``Popen.poll``.
    Restart-with-resume works unchanged: the remote dir persists between
    attempts, so completed cells skip and cached compiles replay."""

    hosts: Sequence[str]
    remote_root: Optional[str] = None
    remote_repo: Optional[str] = None  # default: this checkout's path
    python: str = "python3"
    ssh_options: Sequence[str] = ("-o", "BatchMode=yes",
                                  "-o", "ConnectTimeout=5")
    transport_timeout: float = 5.0  # seconds per heartbeat/kill round-trip;
    #   heartbeat fetches run serially in the supervisor poll loop, so one
    #   dead host must not stall the other shards' hang clocks for long
    name: str = "ssh"
    #: whether the "remote" command actually runs on this machine (the
    #: loopback subclass): local transports may combine a relocated
    #: remote_root with a campaign --queue path, genuinely remote ones
    #: may not (the queue must sit at one shared-filesystem path)
    transport_is_local: bool = False

    def __post_init__(self):
        """Validate hosts and default the remote repo to this checkout."""
        if not self.hosts:
            raise ValueError("SSHExecutor needs at least one host "
                             "(--hosts h0,h1,...)")
        if self.remote_repo is None:
            self.remote_repo = str(Path(__file__).resolve().parents[3])

    # -- transport seam (LoopbackExecutor overrides exactly these two) -----
    def _transport_argv(self, host: str, command: str) -> List[str]:
        """The local argv that runs ``command`` in a shell on ``host``."""
        return ["ssh", *self.ssh_options, host, command]

    def _copy_back_argv(self, host: str, remote_dir: str,
                        local_dir: str) -> List[str]:
        """The local argv that mirrors ``host:remote_dir`` into
        ``local_dir`` (trailing-slash rsync semantics: contents, not the
        dir itself)."""
        return ["rsync", "-a", f"{host}:{remote_dir}/", f"{local_dir}/"]

    # ----------------------------------------------------------------------
    def host_for(self, shard: ShardProc) -> str:
        """Round-robin host assignment, stable across restarts."""
        return self.hosts[shard.index % len(self.hosts)]

    def remote_dir(self, shard: ShardProc) -> str:
        """The shard's output dir on its host (see class docstring)."""
        if self.remote_root:
            return f"{self.remote_root.rstrip('/')}/shard{shard.index}"
        return str(Path(shard.out_dir).resolve())

    def _forward_env(self, shard: ShardProc) -> Dict[str, str]:
        """The env slice shipped to the remote process: the test hooks
        (``REPRO_*``; their values must be valid on the remote host) plus a
        PYTHONPATH pointing at the remote checkout."""
        env = {k: v for k, v in shard.env.items()
               if k.startswith(FORWARD_ENV_PREFIXES)}
        env["PYTHONPATH"] = f"{self.remote_repo}/src"
        return env

    def remote_command(self, shard: ShardProc) -> str:
        """The one-line shell command ssh runs on the host: create the shard
        dir, kill any stale process group from a previous attempt (a
        restart may follow a :meth:`signal` whose transport round-trip was
        lost — two campaigns must never share a shard dir), then ``setsid
        -w`` the campaign (pid recorded to ``shard.pid``, ``exec`` so pid
        == session/group leader, ``-w`` so the exit code propagates back
        through ssh) with the shard's argv re-targeted at the remote
        python and remote ``--out`` dir."""
        rdir = self.remote_dir(shard)
        qdir = shlex.quote(rdir)
        argv = list(shard.cmd)
        argv[0] = self.python
        argv[argv.index("--out") + 1] = rdir
        if ("--queue" in argv and self.remote_root
                and not self.transport_is_local):
            # --out relocates per-host, but the lease queue is the shards'
            # rendezvous: it must resolve to ONE shared-filesystem path
            # everywhere, which remote_root relocation cannot guarantee
            raise RuntimeError(
                f"shard{shard.index}: campaign --queue cannot combine with "
                f"remote_root={self.remote_root!r} on a remote transport — "
                f"the queue dir must be one shared path on every host")
        env = " ".join(f"{k}={shlex.quote(v)}"
                       for k, v in sorted(self._forward_env(shard).items()))
        inner = (f"echo $$ > {qdir}/{PID_FILE}; "
                 f"exec env {env} {shlex.join(argv)}")
        # no `--` before the negative pgid: dash's builtin kill rejects it
        stale = (f"if [ -f {qdir}/{PID_FILE} ]; then "
                 f"kill -9 \"-$(cat {qdir}/{PID_FILE})\" 2>/dev/null "
                 f"|| true; fi")
        return (f"mkdir -p {qdir} && {stale} && "
                f"exec setsid -w bash -c {shlex.quote(inner)}")

    def _run_transport(self, shard: ShardProc, command: str,
                       ) -> Optional[subprocess.CompletedProcess]:
        """Run a short remote command (heartbeat fetch, kill); ``None`` on
        timeout/transport failure — the caller treats that as no news."""
        try:
            return subprocess.run(
                self._transport_argv(self.host_for(shard), command),
                capture_output=True, text=True,
                timeout=self.transport_timeout)
        except (subprocess.TimeoutExpired, OSError):
            return None

    # -- ShardExecutor protocol --------------------------------------------
    def spawn(self, shard: ShardProc) -> None:
        """Launch the ssh client driving the remote campaign; its combined
        output (the remote stdout+stderr) appends to the local shard log."""
        shard.spawn_local(
            self._transport_argv(self.host_for(shard),
                                 self.remote_command(shard)))

    def poll(self, shard: ShardProc) -> Optional[int]:
        """Local client ``poll`` — ssh exits with the remote exit code."""
        return shard.proc.poll() if shard.proc is not None else None

    def read_heartbeat(self, shard: ShardProc) -> Dict:
        """Fetch and parse the remote ``progress.json``; ``{}`` for a
        missing/torn file or an unreachable host (no news, never a crash)."""
        r = self._run_transport(
            shard, f"cat {shlex.quote(self.remote_dir(shard))}/progress.json")
        if r is None or r.returncode != 0:
            return {}
        try:
            return json.loads(r.stdout)
        except json.JSONDecodeError:
            return {}

    def signal(self, shard: ShardProc, sig: int) -> None:
        """Kill the remote process group via the recorded ``shard.pid``
        (session leader ⇒ pgid == pid), then the local ssh client's group —
        both best-effort, so a dead host or reaped client is a no-op."""
        pid_file = f"{shlex.quote(self.remote_dir(shard))}/{PID_FILE}"
        # no `--` before the negative pgid: dash's builtin kill rejects it
        self._run_transport(
            shard, f"kill -{int(sig)} \"-$(cat {pid_file})\" 2>/dev/null")
        shard.signal_group(sig)

    def collect(self, shard: ShardProc) -> None:
        """Mirror the remote shard dir into the local ``shard.out_dir`` so
        the merge (and post-mortems) read local files only. Skipped when
        the two are already the same path on this machine; raises
        ``RuntimeError`` when the copy-back fails (a merge over a missing
        shard would silently drop its cells)."""
        rdir = self.remote_dir(shard)
        if self._is_local_alias(shard, rdir):
            return
        shard.out_dir.mkdir(parents=True, exist_ok=True)
        argv = self._copy_back_argv(self.host_for(shard), rdir,
                                    str(shard.out_dir))
        r = subprocess.run(argv, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"shard{shard.index}: collect failed ({shlex.join(argv)}): "
                f"{(r.stderr or r.stdout).strip()}")

    def _is_local_alias(self, shard: ShardProc, rdir: str) -> bool:
        """Whether the remote dir IS the local shard dir (loopback with no
        ``remote_root``: copying a dir onto itself would be destructive)."""
        return False  # a genuinely remote path never aliases a local one


@dataclass
class LoopbackExecutor(SSHExecutor):
    """:class:`SSHExecutor` with the network stubbed out — the "remote"
    command runs under local ``/bin/sh`` and the copy-back is a local
    ``cp -a``, everything else (command templating, pid-file group kill,
    heartbeat fetch, collect-before-merge) is the real ssh code path. This
    is the executor CI runs so the remote-dispatch seam cannot rot between
    PRs; it is also a correct single-machine backend in its own right."""

    hosts: Sequence[str] = ("loopback",)
    python: str = sys.executable
    name: str = "loopback"
    transport_is_local: bool = True

    def _transport_argv(self, host: str, command: str) -> List[str]:
        """Run the would-be-remote shell command locally."""
        return ["/bin/sh", "-c", command]

    def _copy_back_argv(self, host: str, remote_dir: str,
                        local_dir: str) -> List[str]:
        """Local ``cp -a`` with rsync's contents-into-dir semantics."""
        return ["/bin/sh", "-c",
                f"cp -a {shlex.quote(remote_dir)}/. {shlex.quote(local_dir)}/"]

    def _is_local_alias(self, shard: ShardProc, rdir: str) -> bool:
        """With no ``remote_root`` the shard already ran in its local dir."""
        return Path(rdir).resolve() == Path(shard.out_dir).resolve()


EXECUTOR_CHOICES = ("local", "ssh", "loopback")


def make_executor(kind: str, *, hosts: Optional[Sequence[str]] = None,
                  remote_root: Optional[str] = None,
                  remote_repo: Optional[str] = None,
                  remote_python: str = "python3") -> ShardExecutor:
    """Build the shard executor for an ``--executor`` choice. ``ssh``
    requires ``hosts``; ``local`` ignores every remote option; ``loopback``
    defaults its single pseudo-host and this interpreter. Raises
    ``ValueError`` on an unknown kind or a host-less ssh request."""
    if kind == "local":
        return LocalProcessExecutor()
    if kind == "ssh":
        return SSHExecutor(hosts=list(hosts or []), remote_root=remote_root,
                           remote_repo=remote_repo, python=remote_python)
    if kind == "loopback":
        return LoopbackExecutor(remote_root=remote_root,
                                remote_repo=remote_repo)
    raise ValueError(
        f"unknown executor {kind!r}; choose from {EXECUTOR_CHOICES}")
