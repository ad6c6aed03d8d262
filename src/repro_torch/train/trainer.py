"""Fault-tolerant training loop.

Counterpart of ``repro/train/trainer.py``:

* periodic checkpoints (atomic; resume is bit-exact),
* step-level fault handling: a failing step (injected through
  ``fault_hook`` in tests) or a non-finite loss restores the latest
  checkpoint and replays, up to ``max_retries``,
* a straggler watchdog: an EMA of step wall time flags outliers and calls
  the rebalance hook.

Each history entry holds the step's device time (``dt``: the step from its
launch until its loss is on the host) apart from the host time that made
and moved its batch (``data_s``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.data import SyntheticLM


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "artifacts/ckpt"
    max_retries: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0  # flag steps slower than factor x EMA
    ema_alpha: float = 0.2


@dataclass
class Trainer:
    cfg: Any  # ArchConfig
    plan: Any  # ShardingPlan
    step_fn: Callable  # (state, batch) -> (state, metrics)
    state: Any
    data: SyntheticLM
    tcfg: TrainerConfig = field(default_factory=TrainerConfig)
    fault_hook: Optional[Callable[[int], None]] = None  # raises to inject faults
    rebalance_hook: Optional[Callable[[int], None]] = None
    device: Any = "cpu"
    history: List[Dict[str, float]] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)

    def run(self, start_step: int = 0) -> Dict[str, Any]:
        t = self.tcfg
        step = start_step
        retries = 0
        ema = None
        last_ckpt = start_step
        if start_step == 0:
            ckpt_mod.save_checkpoint(t.ckpt_dir, 0, self.state)

        n_timed = 0
        while step < t.total_steps:
            t_data = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(step).items()}
            data_s = time.perf_counter() - t_data
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
            except Exception as e:  # noqa: BLE001 — any step fault is retryable
                retries += 1
                if retries > t.max_retries:
                    raise RuntimeError(
                        f"step {step} failed {retries} times; giving up") from e
                restore = ckpt_mod.latest_step(t.ckpt_dir)
                self.state, step, _ = ckpt_mod.restore_checkpoint(
                    t.ckpt_dir, self.state, step=restore)
                print(f"[trainer] fault at step: {e!r} -> restored step {step}, "
                      f"retry {retries}/{t.max_retries}", flush=True)
                continue

            dt = time.perf_counter() - t0
            n_timed += 1
            if n_timed == 1:
                pass  # the first step includes warm-up, never in the EMA
            elif ema is None:
                ema = dt
            else:
                if dt > t.straggler_factor * ema:
                    self.stragglers.append(step)
                    if self.rebalance_hook is not None:
                        self.rebalance_hook(step)
                ema = (1 - t.ema_alpha) * ema + t.ema_alpha * dt

            self.history.append({"step": step, "loss": loss, "dt": dt, "data_s": data_s})
            if step % t.log_every == 0:
                print(f"[trainer] step {step:5d} loss {loss:.4f} {dt*1e3:.0f}ms "
                      f"(data {data_s*1e3:.0f}ms)", flush=True)
            step += 1
            retries = 0
            if step - last_ckpt >= t.ckpt_every:
                ckpt_mod.save_checkpoint(t.ckpt_dir, step, self.state)
                last_ckpt = step

        ckpt_mod.save_checkpoint(t.ckpt_dir, step, self.state)
        return {"final_step": step, "history": self.history,
                "stragglers": self.stragglers}
