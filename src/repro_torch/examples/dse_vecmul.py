"""Paper §4 on the H100: natural-language spec -> the port's vecmul kernel.

Counterpart of ``examples/dse_vecmul.py``. The paper's Appendix prompt
(verbatim) goes through the LLM Stack; the mock LLM turns it into the
element-wise vecmul design. The port's hand-written kernel
(``kernels/csrc/vecmul.cu``, through ``kernels.ops.vecmul``) runs the
design's block size on the card, and its output is checked against the
``kernels/ref.py`` oracle (the 'simulation' stage). The Hopper resource
model prints the analogs of the paper's Tables 1-2, and a sweep over block
sizes goes into a cost DB, infeasible blocks as negative data points, as
the full loop records them.

    PYTHONPATH=src python -m repro_torch.examples.dse_vecmul [--device cpu]

The default device is the card (``cuda``); without one that is an error.
``--device cpu`` runs the kernel's plain version instead.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

# the paper's Appendix prompt, verbatim
APPENDIX_PROMPT = """\
I would like to create a hardware accelerator design. The accelerator should
be able to take two input vectors: X and Y, both of length L. The accelerator
should perform an element-wise multiplication operation and produce an output
vector Z. The accelerator has two AXI-Stream based interfaces for loading X
and Y data into custom X and Y buffers. The accelerator should also have a
fixed length parameter L. Once the data is loaded, the accelerator should
execute the element-wise multiplication in parallel and store the results in
buffer Z within the compute module. The loading should be performed using a
load module. Finally, the results should be written back to main memory using
a store module that outputs via an AXI-Stream interface. Create the
accelerator description using SystemC and SECDA. The compute module should be
capable of performing L operations in parallel."""

#: the vector length and the seed of its inputs (the reference's L)
L = 4096
SEED = 0
#: the block sizes of the sweep (the reference's), the 'compute unit
#: dimension'; blocks above the card's 1024 threads per CTA are infeasible
SWEEP_BLOCKS = (128, 512, 1024, 4096, 1 << 20, 1 << 25)


def run(device: str = "cuda", *, db_path: Optional[Path] = None,
        verbose: bool = True) -> Dict[str, Any]:
    """The demo end to end on ``device``; returns the design, the
    transcript, the check against the oracle (``max_abs_err``, which must
    be 0: a product of two f32 values rounds the same on both sides), the
    resource model's numbers at the design's block, the sweep's rows and
    its best feasible block. ``db_path`` is where the sweep's cost DB goes
    (a temporary directory when None). Raises when the LLM's design is not
    vecmul or the kernel disagrees with the oracle."""
    from repro_torch.core.cost_db import CostDB, DataPoint
    from repro_torch.core.device import H100_SXM, resolve_device
    from repro_torch.core.llm_client import MockLLM
    from repro_torch.core.llm_stack import LLMStack
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.resource_model import vecmul_resources

    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    stack = LLMStack(client=MockLLM())
    design, transcript = stack.generate_accelerator(APPENDIX_PROMPT, length=L)
    say("=== LLM transcript (CoT) ===")
    say(transcript.split("FINAL ANSWER:")[0])
    say("=== generated design ===")
    say(json.dumps(design, indent=2))
    if not design or design.get("kernel") != "vecmul":
        raise RuntimeError(f"spec translation failed: {design}")

    # ---- 'simulation' stage: the kernel on the device against the oracle ----
    block = design["parameters"]["block"]
    gen = torch.Generator().manual_seed(SEED)
    x, y = (torch.randn(L, generator=gen).to(dev) for _ in range(2))
    z = ops.vecmul(x, y, block=block)
    err = float((z - ref.vecmul_ref(x, y)).abs().max())
    if err != 0.0:
        raise RuntimeError(f"vecmul on {dev} disagrees with ref.py: max|err| {err}")
    say(f"\nfunctional check vs ref.py oracle on {dev}: OK (L={L}, block={block}, "
        f"max|err| {err})")

    # ---- Tables 1-2 analogs (the Hopper resource model) ----
    res = vecmul_resources(L, block, itemsize=4)
    say("\nTable 1 analog — latency:")
    say(f"  cycles per CTA ~ {res.est_cycles_per_block:.0f}")
    say(f"  total latency estimate: {res.est_latency_us:.3f} us "
        f"({res.est_latency_us * H100_SXM.clock_hz / 1e6:.0f} cycles "
        f"@{H100_SXM.clock_hz / 1e6:.0f}MHz)")
    say("Table 2 analog — resources:")
    say(f"  shared memory (BRAM analog): {res.vmem_bytes} B "
        f"({100 * res.vmem_util:.2f}% of {H100_SXM.smem_per_block // 1024} KiB a CTA); "
        f"{res.threads} threads a CTA (DSP analog), {res.blocks_per_sm} CTAs per SM, "
        f"16-byte aligned={res.vpu_aligned}")

    # ---- DSE over the block-size space (the 'compute unit dimension') ----
    say("\nDSE over block sizes (resource-model evaluated):")
    with tempfile.TemporaryDirectory() as td:
        db = CostDB(Path(db_path) if db_path is not None else Path(td) / "vecmul_db.jsonl")
        best = None
        sweep = []
        for blk in SWEEP_BLOCKS:
            r = vecmul_resources(L, min(blk, L) if blk <= L else blk, itemsize=4)
            status = "ok" if r.feasible else "infeasible"
            db.append(DataPoint(
                arch="vecmul", shape=f"L{L}", mesh="single-card",
                point={"block": blk}, status=status,
                metrics={"latency_us": r.est_latency_us,
                         "vmem_util": r.vmem_util, "threads": r.threads,
                         "workload": {"n_params": 0, "seq_len": L}},
                reason="" if r.feasible else "more threads than a CTA may have "
                                             "(negative datapoint)"))
            tag = "OK " if r.feasible else "REJ"
            say(f"  [{tag}] block={blk:>8}: latency={r.est_latency_us:8.3f}us "
                f"threads={r.threads}")
            sweep.append({"block": blk, "status": status, "latency_us": r.est_latency_us,
                          "threads": r.threads})
            if r.feasible and (best is None or r.est_latency_us < best[1]):
                best = (blk, r.est_latency_us)
        negatives = len(db.query(status="infeasible"))
        rows = len(db.all())
    say(f"best feasible block: {best[0]} ({best[1]:.3f} us); "
        f"{negatives} negative datapoints recorded")
    return {"design": design, "transcript": transcript, "device": str(dev),
            "block": block, "max_abs_err": err, "resources": res.to_dict(),
            "sweep": sweep, "rows": rows, "negatives": negatives,
            "best_block": best[0], "best_latency_us": best[1]}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.dse_vecmul")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) runs the kernel on the card; 'cpu' its "
                         "plain version")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
