"""Request batching for serving (continuous-batching style).

Counterpart of ``repro/serve/batcher.py``. Requests arrive with prompts of
varying length; the batcher packs up to ``max_batch`` active sequences,
pads prompts for a shared prefill, then decodes in lock-step, retiring
finished sequences and admitting queued ones into freed slots. Admission
mid-decode prefills the admitted group on its own (so survivors' caches
are untouched) and copies the new rows into the freed batch slots of the
live cache, in place; decode then continues lock-step over the refreshed
batch. Each row keeps its own length (the cache's ``len`` is ``[batch]``),
and decode attention masks each row by it, so spliced rows and survivors
sit at different positions in one step.

``run`` works under ``torch.inference_mode()``: the caches are written in
place by the steps and by the splice. Greedy ``argmax`` runs on the
params' device; one host copy of the chosen tokens is made per step.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [len] int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    t_submit: float = field(default_factory=time.time)
    t_done: Optional[float] = None


def _splice_rows(cache: Any, sub: Any, rows: Sequence[int]) -> Any:
    """Write ``sub``'s batch rows into ``cache`` at batch indices ``rows``,
    in place; returns ``cache``.

    Cache leaves put the batch axis in different positions (dense k/v are
    ``[layers, batch, ...]`` while ``len`` is ``[batch]``), so the axis is
    recovered per leaf as the first dimension where the full-batch and
    sub-batch shapes disagree. Callers must ensure the sub-batch is strictly
    smaller than the full batch (equal sizes mean "replace the cache").
    """
    def put(full, part):
        if isinstance(full, dict):
            for k in full:
                put(full[k], part[k])
            return
        axis = next(a for a, (m, s) in enumerate(zip(full.shape, part.shape)) if m != s)
        ids = torch.as_tensor(list(rows), dtype=torch.long, device=full.device)
        full.index_copy_(axis, ids, part)

    put(cache, sub)
    return cache


@dataclass
class Batcher:
    cfg: Any
    params: Any
    prefill_step: Callable
    decode_step: Callable
    init_cache: Callable  # (batch_size, max_len) -> cache, on the params' device
    max_batch: int = 4
    max_len: int = 256
    eos: int = -1  # synthetic: no real EOS; stop at max_new

    queue: "collections.deque[Request]" = field(default_factory=collections.deque)
    stats: Dict[str, float] = field(default_factory=dict)
    _next_rid: int = 0

    @property
    def device(self) -> torch.device:
        """Where the params live; caches and tokens go there too."""
        return next(iter(self.params.values())).device

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> Request:
        req = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                      max_new=max_new)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def _prefill_group(self, group: List[Request]) -> Tuple[Any, np.ndarray]:
        """Left-pad + prefill ``group`` as one batch; returns (cache, first
        sampled token per row)."""
        b = len(group)
        plen = max(len(r.prompt) for r in group)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(group):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        dev = self.device
        cache = self.init_cache(b, self.max_len)
        logits, cache = self.prefill_step(
            self.params, {"tokens": torch.from_numpy(toks).to(dev)}, cache)
        # a writable host copy: slots mutate cur in place as they retire
        cur = torch.argmax(logits[:, -1], -1).to(torch.int32).cpu().numpy().copy()
        return cache, cur

    @staticmethod
    def _take(queue: "collections.deque[Request]", n: int) -> List[Request]:
        return [queue.popleft() for _ in range(min(n, len(queue)))]

    def _note_token(self, r: Request, tok: int, finished: List[Request]) -> bool:
        """Record one sampled token; retire the request the moment it hits
        ``max_new``/EOS, stamping ``t_done`` at actual completion. Returns
        True when the request retired."""
        r.out.append(tok)
        if len(r.out) >= r.max_new or tok == self.eos:
            r.done, r.t_done = True, time.time()
            finished.append(r)
            return True
        return False

    def run(self) -> List[Request]:
        with torch.inference_mode():
            return self._run()

    def _run(self) -> List[Request]:
        finished: List[Request] = []
        n_decode_steps = 0
        n_prefills = 0
        dev = self.device
        t0 = time.time()
        while self.queue:
            batch = self._take(self.queue, self.max_batch)
            b = len(batch)
            slots: List[Request] = list(batch)
            cache, cur = self._prefill_group(batch)
            n_prefills += 1
            active = np.ones(b, bool)
            for i, r in enumerate(batch):
                if self._note_token(r, int(cur[i]), finished):
                    active[i] = False
            while active.any():
                free = [i for i in range(b) if not active[i]]
                if free and self.queue:
                    admit = self._take(self.queue, len(free))
                    sub_cache, sub_cur = self._prefill_group(admit)
                    n_prefills += 1
                    rows = free[: len(admit)]
                    cache = (sub_cache if len(admit) == b
                             else _splice_rows(cache, sub_cache, rows))
                    for j, (row, r) in enumerate(zip(rows, admit)):
                        slots[row] = r
                        cur[row] = sub_cur[j]
                        active[row] = not self._note_token(r, int(sub_cur[j]), finished)
                    if not active.any():
                        continue
                logits, cache = self.decode_step(
                    self.params, {"tokens": torch.from_numpy(cur[:, None].copy()).to(dev)},
                    cache)
                nxt = torch.argmax(logits[:, -1], -1).to(torch.int32).cpu().numpy()
                n_decode_steps += 1
                for i in range(b):
                    if active[i]:
                        cur[i] = nxt[i]
                        if self._note_token(slots[i], int(nxt[i]), finished):
                            active[i] = False
        dt = time.time() - t0
        ntok = sum(len(r.out) for r in finished)
        self.stats = {"requests": len(finished), "tokens": ntok,
                      "wall_s": dt, "tok_per_s": ntok / dt if dt else 0.0,
                      "decode_steps": n_decode_steps,
                      "prefills": n_prefills}
        return finished
