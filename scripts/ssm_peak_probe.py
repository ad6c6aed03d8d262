"""Where mamba2-780m ``long_500k``'s bytes on the card go, beside the dry run.

The measured tier's step for mamba2-780m ``long_500k`` (batch 1, full
width, baseline plan) on one card, in a fresh process: the bytes the card
holds once the step's inputs are made (params, cache, batch), the peak over
a warm call and a timed one, and the largest blocks alive at that peak
from the CUDA caching allocator's history, each with the line of the port
that allocated it; beside the 1x1 dry run's argument, temp and output bytes
(``core.step_analysis.StepCounter``). Then mamba2-780m ``prefill_32k`` at
batch 8 (one timed run) and the ``long_500k`` step again in the same
process, as phase 8 of ``chip_smoke.py`` runs them, with the bytes the
process held on the card just before. Each part prints one JSON line with
the card's name and power limit.

    PYTHONPATH=src python3 scripts/ssm_peak_probe.py

Needs one card; about a minute.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.launch import dryrun, measure
from repro_torch.launch.mesh import make_campaign_mesh

ARCH = "mamba2-780m"


def _peak_blocks(snapshot, k: int = 12):
    """The ``k`` largest blocks alive when the allocator's history peaks,
    with the innermost frame of the port that allocated each."""
    live, total, best, at_peak = {}, 0, -1, {}
    for ev in snapshot.get("device_traces", [[]])[0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > best:
                best, at_peak = total, dict(live)
        elif ev["action"] in ("free_requested", "free_completed") and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    out = []
    for ev in sorted(at_peak.values(), key=lambda e: -e["size"])[:k]:
        frames = [f for f in ev.get("frames", []) if "repro_torch" in f.get("filename", "")]
        where = (f"{frames[0]['filename'].split('repro_torch/')[-1]}:{frames[0]['line']}"
                 if frames else "?")
        out.append({"bytes": ev["size"], "where": where})
    return {"history_peak_bytes": best, "largest": out}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssm_peak_probe: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cfg = get_config(ARCH)
    cell = SHAPE_BY_NAME["long_500k"]
    with tempfile.TemporaryDirectory() as td:
        plan = dryrun.baseline_plan(cfg, cell)
        tiny_cpu, name = make_campaign_mesh("tiny", "cpu")
        rec = dryrun.run_cell(ARCH, "long_500k", tiny_cpu, name, plan, Path(td), cfg=cfg,
                              cell=cell)
        mem = rec["memory"]
        mesh, name = make_campaign_mesh("tiny", "cuda")
        before = torch.cuda.memory_allocated()
        call, _ = measure.zero_step(ARCH, "long_500k", mesh, plan, cfg=cfg, cell=cell)
        inputs = torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(max_entries=200000, stacks="python")
        call()
        torch.cuda.synchronize()
        warm_peak = torch.cuda.max_memory_allocated()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        blocks = _peak_blocks(torch.cuda.memory._snapshot())
        torch.cuda.memory._record_memory_history(enabled=None)
        print(json.dumps({
            "part": "fresh process", "cell": f"{ARCH}/long_500k",
            "dryrun_argument_bytes": mem["argument_bytes"],
            "dryrun_temp_bytes": mem["temp_bytes"], "dryrun_output_bytes": mem["output_bytes"],
            "dryrun_alias_bytes": mem["alias_bytes"],
            "dryrun_per_device_bytes": mem["per_device_bytes"],
            "allocated_before_inputs": before, "inputs_bytes": inputs,
            "peak_warm": warm_peak, "peak": peak,
            "peak_over_modelled": peak / mem["per_device_bytes"],
            "reserved": torch.cuda.memory_reserved(), **blocks, "card": card}), flush=True)
        del call
        torch.cuda.empty_cache()

        # phase 8's order: mamba2 prefill_32k first, then long_500k
        pcell = dataclasses.replace(SHAPE_BY_NAME["prefill_32k"], global_batch=8)
        prec = measure.measure_cell(ARCH, "prefill_32k", mesh, name,
                                    dryrun.baseline_plan(cfg, pcell), runs=1, cfg=cfg,
                                    cell=pcell)
        del prec
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        lrec = measure.measure_cell(ARCH, "long_500k", mesh, name, plan, runs=3, cfg=cfg,
                                    cell=cell)
        print(json.dumps({
            "part": "after prefill_32k", "cell": f"{ARCH}/long_500k",
            "status": lrec["status"], "allocated_before": held,
            "peak": lrec.get("peak_bytes"),
            "peak_less_held": (lrec["peak_bytes"] - held) if lrec["status"] == "ok" else None,
            "dryrun_per_device_bytes": mem["per_device_bytes"],
            "measured_s": lrec.get("measured_s"), "card": card}), flush=True)


if __name__ == "__main__":
    main()
