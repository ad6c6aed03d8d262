"""Run the full SECDA-DSE loop over a workload's execution-plan space.

Counterpart of ``examples/dse_sharding.py``: the paper's Figure-1 loop on
the plan design space. Explorer permutations + LLM-Stack (RAG over the
port's ``sharding/`` sources + CoT) refinements, evaluated by the dry-run
'simulator' on the fake 2x4 mesh, recorded in the cost DB, with LoRA
fine-tuning of the surrogate.

    # reduced mesh (runs anywhere):
    PYTHONPATH=src python -m repro_torch.examples.dse_sharding [--device cpu]

    # production pod mesh:
    PYTHONPATH=src python -m repro_torch.launch.dse --space plans --arch llama3-8b \\
        --shape train_4k --mesh pod --iterations 4 --budget 3

``--device`` is the measured tier's (the card by default; an error without
one); this loop only dry-runs, on the host.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.dse_sharding")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the measured tier's device (default: the card)")
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--budget", type=int, default=2)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the loop on qwen3-0.6b ``decode_32k``; returns the designs
    evaluated, the negatives and the improvement over the expert
    baseline."""
    args = build_parser().parse_args(argv)
    from repro_torch.core.cost_db import CostDB, featurize
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.device import resolve_device
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.llm_client import MockLLM
    from repro_torch.core.llm_stack import LLMStack
    from repro_torch.core.loop import DSELoop
    from repro_torch.core.rag import CodeIndex

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        db = CostDB(Path(td) / "cost_db.jsonl")
        stack = LLMStack(
            client=MockLLM(), db=db,
            code_index=CodeIndex(roots=[Path(__file__).resolve().parents[1] / "sharding"]).build())
        evaluator = Evaluator(mesh="small", torch_device=str(dev), artifact_dir=td)
        loop = DSELoop(evaluator=evaluator, db=db, llm_stack=stack,
                       cost_model=CostModel.create(in_dim=featurize({}, {}).shape[0]))
        try:
            report = loop.run("qwen3-0.6b", "decode_32k", iterations=args.iterations,
                              eval_budget=args.budget)
        finally:
            evaluator.close()
        rows = db.all()
        negatives = len([d for d in rows if d.negative()])
        print(f"\nevaluated designs: {len(rows)} (negatives: {negatives})")
        print(f"improvement vs expert baseline: x{report.improvement():.3f}")
        return {"designs": len(rows), "negatives": negatives,
                "improvement": report.improvement()}


if __name__ == "__main__":
    main()
