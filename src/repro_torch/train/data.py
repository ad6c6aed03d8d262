"""Deterministic synthetic token pipeline with background prefetch.

Counterpart of ``repro/train/data.py``, copied: the same seed gives the
same batches byte for byte in both packages. Data is generated from a
seeded Zipf-ish unigram mixture with injected n-gram structure (so tiny models actually *learn* and the loss curve is a
meaningful end-to-end signal), sharded by host (``host_id``/``n_hosts`` — the
straggler-rebalance hook re-maps this), and prefetched on a worker thread.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Order-2 Markov chain with a Zipf marginal — learnable structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        self._zipf = 1.0 / np.arange(1, v + 1) ** 1.1
        self._zipf /= self._zipf.sum()
        # sparse bigram successor table: each token prefers a few successors
        self._succ = rng.integers(0, v, size=(min(v, 4096), 4))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        assert c.global_batch % c.n_hosts == 0
        b_local = c.global_batch // c.n_hosts
        rng = np.random.default_rng((c.seed, step, c.host_id))
        toks = np.empty((b_local, c.seq_len + 1), np.int32)
        cur = rng.choice(c.vocab, size=b_local, p=self._zipf)
        toks[:, 0] = cur
        for t in range(1, c.seq_len + 1):
            follow = rng.random(b_local) < 0.8
            succ_rows = self._succ[cur % self._succ.shape[0]]
            pick = succ_rows[np.arange(b_local), rng.integers(0, 4, b_local)]
            fresh = rng.choice(c.vocab, size=b_local, p=self._zipf)
            cur = np.where(follow, pick, fresh).astype(np.int32)
            toks[:, t] = cur
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch of the next ``depth`` batches."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def next(self) -> Dict[str, np.ndarray]:
        step, batch = self.q.get()
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
