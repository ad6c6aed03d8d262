"""How close the measured tier's batch fit comes to the card, plan by plan.

For qwen3-0.6b ``train_4k`` at full width, the baseline plan and one
change of each train dimension that acts on one card (``remat``,
``loss_chunk``, ``microbatches``, ``opt_int8``, ``zero1``,
``grad_compress``, ``attn_impl``) go through ``Evaluator.measure`` on the
card: the 1x1 dry run fits the largest power-of-two batch whose modelled
bytes stay within ``launch.measure.FIT_SHARE`` of the H100's memory, the
step runs there once after a warm call, and the card's peak allocation is
read. Each plan prints one JSON line: the batch, the modelled bytes and
the card's peak at that batch and their ratio, and the step's time (or
the error row, an out-of-memory one among them), with the card's name and
power limit.

    PYTHONPATH=src python3 scripts/plan_fit_probe.py

Needs one card; about four minutes.
"""
from __future__ import annotations

import json
import subprocess
import tempfile
import time

import torch

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.core.design_space import PlanPoint, PlanTemplate, baseline_point
from repro_torch.core.evaluator import Evaluator

VARIANTS = ({}, {"remat": "dots"}, {"remat": "none"}, {"loss_chunk": 1024},
            {"microbatches": 2}, {"opt_int8": True}, {"zero1": False},
            {"grad_compress": "int8"}, {"attn_impl": "tri"})


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("plan_fit_probe: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    arch, shape = "qwen3-0.6b", "train_4k"
    cfg, cell = get_config(arch), SHAPE_BY_NAME[shape]
    with tempfile.TemporaryDirectory() as td:
        ev = Evaluator(mesh="pod", torch_device="cuda", artifact_dir=td, measure_runs=1)
        base = baseline_point(cell, PlanTemplate(cfg, cell, ev.mesh_shape))
        for change in VARIANTS:
            t = time.perf_counter()
            dp = ev.measure(arch, shape, PlanPoint(dims={**base.dims, **change}))
            m = dp.metrics
            print(json.dumps({
                "plan": change or "baseline", "status": dp.status, "reason": dp.reason[:200],
                "reduced": m.get("reduced"), "modelled_bytes": m.get("per_device_bytes_1x1"),
                "peak_bytes": m.get("peak_bytes"),
                "modelled_over_peak": (m["per_device_bytes_1x1"] / m["peak_bytes"]
                                       if dp.status == "ok" else None),
                "measured_s": m.get("measured_s"),
                "wall_s": round(time.perf_counter() - t, 1), "card": card}), flush=True)


if __name__ == "__main__":
    main()
