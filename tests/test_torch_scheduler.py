"""repro_torch's CellQueue against the reference's: a scripted sequence of
seed / acquire / renew / complete / steal / reclaim / release with explicit
clocks leaves the same tree of ticket files (names and JSON content) under
both packages; and the port's own copies of the reference's safety
properties: two workers never share a ticket, a steal racing a complete
lands exactly once, torn tickets recover from their file name, and random
operation sequences keep one state per ticket."""
import json
import threading

import pytest

from _hypothesis_compat import given, settings, strategies as st
from repro.launch.scheduler import CellQueue as JCellQueue
from repro_torch.launch.scheduler import (DONE, LEASED, PENDING, CellQueue,
                                          sanitize_owner)

CELLS = [("a1", "s1"), ("a1", "s2"), ("a2", "s1"), ("a2", "s2")]


def make_queue(tmp_path, lease_s=60.0, cells=CELLS):
    q = CellQueue(tmp_path / "queue", lease_s=lease_s)
    q.seed(cells, mesh="dev1")
    return q


def _tree(root):
    """Every ticket file under the queue's state dirs: name -> parsed JSON."""
    out = {}
    for state in (PENDING, LEASED, DONE):
        for f in sorted((root / state).iterdir()):
            out[f"{state}/{f.name}"] = json.loads(f.read_text())
    return out


def _script(q):
    """One scripted run over a queue (either package's): returns what each
    call said, in order, with the ticket tree at three points."""
    said = [q.seed(CELLS, mesh="dev1"), q.seed(CELLS + [("z9", "s9")], mesh="dev1")]
    t0 = q.acquire("w0", now=100.0)
    t1 = q.acquire("shard 1/2", now=101.0)
    t2 = q.acquire("w.tmp2", now=102.0)
    said += [(t.cell, t.owner, t.attempt) for t in (t0, t1, t2)]
    said.append(q.renew(t0, now=130.0))
    said.append(q.complete(t0, status="complete", now=140.0))
    said.append(q.complete(t0, now=141.0))  # twice: the lease is gone
    s = q.steal(t1, now=150.0)
    said.append((s.cell, s.steals, s.owner))
    said.append(q.complete(t1, now=151.0))  # the steal won
    said.append(_tree(q.root))
    said.append([t.cell for t in q.reclaim_expired(now=161.0)])  # t2 runs to 162
    said.append([t.cell for t in q.reclaim_expired(now=163.0)])
    t3 = q.acquire("w1", now=170.0)
    t4 = q.acquire("w1", now=171.0)
    said += [(t.cell, t.attempt, t.steals) for t in (t3, t4)]
    said.append(_tree(q.root))
    said.append([t.cell for t in q.release_owner("w1", now=180.0)])
    said.append(_tree(q.root))
    while (t := q.acquire("finisher", now=190.0)) is not None:
        said.append((t.cell, t.attempt))
        said.append(q.complete(t, status="complete", now=200.0))
    said.append((q.counts(), q.total(), q.drained()))
    return said


def test_scripted_operations_leave_the_reference_ticket_tree(tmp_path):
    q = CellQueue(tmp_path / "port", lease_s=60.0)
    jq = JCellQueue(tmp_path / "ref", lease_s=60.0)
    assert _script(q) == _script(jq)
    tree, jtree = _tree(q.root), _tree(jq.root)
    assert tree == jtree and len(tree) == len(CELLS) + 1
    assert all(name.startswith(f"{DONE}/") for name in tree)
    # the shared caches sit where the reference's do
    assert (q.cache_dir.relative_to(q.root), q.measured_dir.relative_to(q.root)) == \
        (jq.cache_dir.relative_to(jq.root), jq.measured_dir.relative_to(jq.root))


def test_lease_file_names_carry_the_owner_as_the_reference_does(tmp_path):
    q = CellQueue(tmp_path / "port", lease_s=60.0)
    jq = JCellQueue(tmp_path / "ref", lease_s=60.0)
    for queue in (q, jq):
        queue.seed(CELLS, mesh="dev1")
        queue.acquire("shard 0/2", now=5.0)
        queue.acquire("w.tmp", now=6.0)
    assert _tree(q.root) == _tree(jq.root)
    assert sorted(f.name for f in (q.root / LEASED).iterdir()) == [
        "a1__s1.json.lease-shard_0_2", "a1__s2.json.lease-w_tmp"]
    assert sanitize_owner("w.tmp1") == "w_tmp1"
    with pytest.raises(ValueError):
        sanitize_owner("")


# ---------------------------------------------------------------------------
# the reference's safety properties, on the port's queue
# ---------------------------------------------------------------------------
def test_two_workers_never_share_a_ticket(tmp_path):
    q = make_queue(tmp_path)
    got = {"w0": [], "w1": []}

    def drain(owner):
        mine = CellQueue(q.root)  # own instance, like a separate process
        while (t := mine.acquire(owner)) is not None:
            got[owner].append(t.cell)
            mine.complete(t)

    threads = [threading.Thread(target=drain, args=(o,)) for o in got]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    claimed = got["w0"] + got["w1"]
    assert sorted(claimed) == sorted(f"{a}/{s}" for a, s in CELLS)
    assert len(claimed) == len(set(claimed))  # exactly-once
    assert q.drained()


def test_steal_vs_complete_race_is_exactly_once(tmp_path):
    """Whoever renames first wins; the loser sees the lease gone."""
    q = make_queue(tmp_path, cells=[("a1", "s1")])
    t = q.acquire("slow")
    assert q.complete(t)          # owner finishes first...
    assert q.steal(t) is None     # ...so the steal loses, loudly
    assert q.counts() == {"pending": 0, "leased": 0, "done": 1}

    q2 = make_queue(tmp_path / "b", cells=[("a1", "s1")])
    t2 = q2.acquire("slow")
    assert q2.steal(t2) is not None  # steal first...
    assert not q2.complete(t2)       # ...so the owner's complete loses
    assert q2.counts() == {"pending": 1, "leased": 0, "done": 0}


def test_torn_ticket_files_recover_from_their_filename(tmp_path):
    q = make_queue(tmp_path)
    (q.root / PENDING / "a1__s1.json").write_text('{"arch": ')  # torn
    assert len(q.tickets()) == 3  # listings skip the unreadable one
    t = q.acquire("w0")
    # ...but acquire recovers it: the filename is the identity
    assert t.cell == "a1/s1" and t.attempt == 1
    assert q.complete(t)
    # tmp debris from atomic writes is never parsed as a ticket
    (q.root / PENDING / "a2__s9.json.tmp999").write_text("{}")
    assert len(q.tickets(PENDING)) == 3


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from(["acquire", "complete", "steal",
                                               "release", "reclaim"]),
                              st.integers(0, 2)),
                    min_size=1, max_size=40))
def test_random_op_sequences_hold_invariants(tmp_path_factory, ops):
    """Any interleaving of queue operations keeps every cell in exactly one
    state, never loses or duplicates a ticket, and only grows the
    attempt/steal counters."""
    q = CellQueue(tmp_path_factory.mktemp("qprop") / "q", lease_s=1000.0)
    q.seed(CELLS)
    owners = ["w0", "w1", "w2"]
    held = {o: [] for o in owners}
    clock = 0.0

    def check():
        c = q.counts()
        assert sum(c.values()) == len(CELLS), c
        names = [t.file_name for t in q.tickets()]
        assert sorted(names) == sorted(set(names))  # one state per cell
        for t in q.tickets():
            assert t.attempt >= 0 and t.steals >= 0

    for op, i in ops:
        clock += 1.0
        o = owners[i]
        if op == "acquire":
            t = q.acquire(o, now=clock)
            if t is not None:
                held[o].append(t)
        elif op == "complete" and held[o]:
            q.complete(held[o].pop(), now=clock)
        elif op == "steal" and held[o]:
            q.steal(held[o].pop(0), now=clock)
        elif op == "release":
            q.release_owner(o, now=clock)
            held[o].clear()
        elif op == "reclaim":
            q.reclaim_expired(now=clock)
        check()

    # drain to done from any intermediate state: the queue always converges
    for ts in held.values():
        for t in ts:
            q.complete(t, now=clock)
    while (t := q.acquire("finisher", now=clock)) is not None:
        q.complete(t, now=clock)
    assert q.drained()
    assert q.counts() == {"pending": 0, "leased": 0, "done": len(CELLS)}
    for t in q.tickets(DONE):
        assert t.status == "complete" and t.attempt >= 1
