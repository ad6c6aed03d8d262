"""Dry-run tier: model one plan cell on a (fake) mesh, with no device.

Counterpart of ``repro/launch/dryrun.py``. For an (architecture x
input-shape x mesh) cell it builds the train or serve step under the plan, traces it
once on fake tensors (sharded as DTensors on the fake mesh) under
``core.step_analysis.StepCounter``, and records per-device memory, FLOPs,
HBM bytes and collective bytes, and the H100 cluster's roofline terms,
into a JSON artifact with the reference's keys. It allocates no device
memory and runs no device: that is its nature, as the reference compiles
against fake host devices.

``lower_s`` holds the time the trace takes (building the sharded fake
inputs and running the step), ``compile_s`` the time of the analysis after
it. Memory per device: ``argument_bytes`` sums the local shards of the
parameters, the batch and the cache; ``output_bytes`` those of the logits
and the new cache; ``alias_bytes`` is the cache, which the step updates in
place (the reference donates it); ``temp_bytes`` is the peak of the step's
live allocations beyond its outputs (``StepCounter``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape prefill_32k --mesh pod
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, SHAPE_BY_NAME, get_config
from repro_torch.core.device import H100_CLUSTER, roofline_terms
from repro_torch.core.step_analysis import StepCounter
from repro_torch.launch.ioutil import write_json_atomic
from repro_torch.models import model as M
from repro_torch.serve import step as serve_step_mod
from repro_torch.sharding.plan import baseline_plan, is_sharded, shard_offset
from repro_torch.train import step as train_step_mod

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "port" / "dryrun"


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS per step: 6·N·D train, 2·N·D prefill, 2·N·B decode."""
    n = cfg.n_active_params()
    if cell.kind == "train":
        return 6.0 * n * cell.seq_len * cell.global_batch
    if cell.kind == "prefill":
        return 2.0 * n * cell.seq_len * cell.global_batch
    return 2.0 * n * cell.global_batch


# ---------------------------------------------------------------------------
# per-cell build
# ---------------------------------------------------------------------------
def build_cell(arch: str, shape_name: str, mesh, plan=None, *, cfg=None, cell=None,
               ctx=None):
    """Returns ``((step, inputs, placements), None)`` for one cell, or
    ``(None, reason)`` for an unsupported one.

    ``inputs`` holds meta-device stand-ins (global shapes): ``{"params",
    "batch", "cache"}`` for a serve cell, ``{"state", "batch"}`` (the train
    state: params, optimizer state, error feedback) for a train cell;
    ``placements`` mirrors it with the plan's placements on ``mesh``
    (``None`` on a one-device mesh). ``cfg``/``cell`` override the registry
    lookup (a reduced config, a cut batch); ``ctx`` overrides the step's
    plan hook (the dry run's counts its loops).
    """
    cfg = cfg if cfg is not None else get_config(arch)
    cell = cell if cell is not None else SHAPE_BY_NAME[shape_name]
    ok, why = M.cell_supported(cfg, cell)
    if not ok:
        return None, why
    plan = plan or baseline_plan(cfg, cell, multi_pod="pod" in mesh.mesh_dim_names)
    specs = M.input_specs(cfg, cell)
    sharded = is_sharded(mesh)
    if cell.kind == "train":
        state, logical = train_step_mod.abstract_train_state(cfg, plan)
        inputs = {"state": state, "batch": specs["batch"]}
        placements = None
        if sharded:
            placements = {"state": train_step_mod.state_specs(mesh, plan, state, logical),
                          "batch": plan.batch_specs(mesh, specs["batch"])}
        return (train_step_mod.make_train_step(cfg, plan, mesh, ctx=ctx), inputs,
                placements), None
    params, _ = M.abstract_params(cfg)
    inputs = {"params": params, "batch": specs["batch"], "cache": specs["cache"]}
    placements = None
    if sharded:
        pshard, bshard, cshard = serve_step_mod.serve_shardings(cfg, plan, mesh, specs)
        placements = {"params": pshard, "batch": bshard, "cache": cshard}
    make = (serve_step_mod.make_prefill_step if cell.kind == "prefill"
            else serve_step_mod.make_decode_step)
    return (make(cfg, plan, mesh, ctx=ctx), inputs, placements), None


def local_shape(mesh, placements, shape):
    """This rank's shard of a tensor of global ``shape``."""
    return tuple(shard_offset(mesh, placements, n, d)[1] for d, n in enumerate(shape))


def _fake_inputs(counter: StepCounter, mesh, inputs, placements):
    """Fake local shards of the (nested dict) ``inputs``, as DTensors on a
    sharded mesh."""
    from torch.distributed.tensor import DTensor

    dev = mesh.device_type

    def one(v, pl):
        if isinstance(v, dict):
            return {k: one(x, None if pl is None else pl[k]) for k, x in v.items()}
        if pl is None:
            return counter.empty(v.shape, v.dtype, dev)
        local = counter.empty(local_shape(mesh, pl, v.shape), v.dtype, dev)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=v.shape, stride=v.stride())

    return one(inputs, placements)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _local_bytes(tree) -> float:
    from torch.distributed.tensor import DTensor

    return float(sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
                     for t in _leaves(tree)))


def trace_cell(arch: str, shape_name: str, mesh, plan=None, *, cfg=None, cell=None,
               unroll: bool = False):
    """Trace one cell's step on fake inputs; returns ``(counter, memory)``
    (``memory`` holds ``argument_bytes``, ``output_bytes``, ``alias_bytes``
    and ``temp_bytes``), or ``(None, reason)`` for an unsupported cell."""
    cfg = cfg if cfg is not None else get_config(arch)
    cell = cell if cell is not None else SHAPE_BY_NAME[shape_name]
    counter = StepCounter(mesh, unroll=unroll)
    plan = plan or baseline_plan(cfg, cell, multi_pod="pod" in mesh.mesh_dim_names)
    train = cell.kind == "train"
    ctx = (plan.make_constrain(mesh) if train
           else serve_step_mod.make_ctx(cfg, plan, mesh, decode=cell.kind == "decode"))
    ctx.walk = counter.walk
    built, why = build_cell(arch, shape_name, mesh, plan, cfg=cfg, cell=cell, ctx=ctx)
    if built is None:
        return None, why
    step, inputs, placements = built
    from torch.distributed.tensor.experimental import implicit_replication

    with (torch.enable_grad() if train else torch.no_grad()), implicit_replication():
        args = _fake_inputs(counter, mesh, inputs, placements)
        arg_bytes = _local_bytes(args)
        with counter:
            if train:
                new_state, metrics = step(args["state"], args["batch"])
                alias = _local_bytes(args["state"])
                outs = [new_state, metrics]
            else:
                logits, new_cache = step(args["params"], args["batch"], args["cache"])
                # the whole cache: the step updates it in place (the
                # reference donates it and its outputs alias it)
                alias = _local_bytes(args["cache"])
                outs = [logits, new_cache]
        out_bytes = _local_bytes(outs)
        fresh_out = out_bytes - alias
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": max(counter.peak - fresh_out, 0.0), "alias_bytes": alias}
    return counter, memory


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, plan=None,
             artifact_dir: Path = ARTIFACT_DIR, *, cfg=None, cell=None):
    """Dry-run one cell: trace the step, take per-device memory, FLOPs,
    bytes and roofline terms, and write the JSON artifact.

    Never raises — an unsupported cell returns ``status="skipped"``, and
    any exception becomes a ``status="error"`` record with the truncated
    traceback, which callers leave retryable and uncached."""
    t0 = time.time()
    cfg = cfg if cfg is not None else get_config(arch)
    cell = cell if cell is not None else SHAPE_BY_NAME[shape_name]
    plan = plan or baseline_plan(cfg, cell, multi_pod="pod" in mesh.mesh_dim_names)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "n_devices": mesh.size(), "plan": plan.name, "device": H100_CLUSTER.name}
    try:
        counter, memory = trace_cell(arch, shape_name, mesh, plan, cfg=cfg, cell=cell)
        if counter is None:
            rec.update(status="skipped", reason=memory)
        else:
            t_low = time.time()
            hlo = counter.result()
            mf = model_flops(cfg, cell)
            terms = roofline_terms(
                flops=hlo["flops"], hbm_bytes=hlo["hbm_bytes"],
                wire_bytes=hlo["wire_bytes_by_link"]["nvlink"],
                nic_wire_bytes=hlo["wire_bytes_by_link"]["nic"], device=H100_CLUSTER)
            per_dev = (memory["argument_bytes"] + memory["temp_bytes"]
                       + memory["output_bytes"] - memory["alias_bytes"])
            rec.update(
                status="ok",
                lower_s=round(t_low - t0, 2),
                compile_s=round(time.time() - t_low, 2),
                memory={**memory, "code_bytes": 0, "per_device_bytes": per_dev,
                        "fits_hbm": bool(per_dev <= H100_CLUSTER.hbm_bytes)},
                xla_flops_once=hlo["dot_flops_once"],
                hlo=hlo,
                model_flops=mf,
                model_flops_per_dev=mf / mesh.size(),
                useful_flops_ratio=(mf / mesh.size()) / max(hlo["flops"], 1.0),
                roofline=terms.to_dict(),
            )
    except Exception as e:  # noqa: BLE001 — a failed cell is a negative datapoint
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    artifact_dir.mkdir(parents=True, exist_ok=True)
    write_json_atomic(artifact_dir / f"{arch}__{shape_name}__{mesh_name}.json", rec)
    return rec


def main(argv=None):
    """CLI entry: sweep the requested arch x shape x mesh grid, skipping
    cells whose ``ok``/``skipped`` artifacts already exist (``--force``
    recomputes). Exits 1 if any cell errored, 0 otherwise."""
    from repro_torch.launch.mesh import make_campaign_mesh

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape cell name or 'all'")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both", "small"])
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    artifact_dir = Path(args.out)

    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = {"pod": ["pod"], "multipod": ["multipod"], "both": ["pod", "multipod"],
              "small": ["small"]}[args.mesh]

    failures = 0
    for which in meshes:
        mesh, mesh_name = make_campaign_mesh(which)
        for arch in archs:
            for shape in shapes:
                out = artifact_dir / f"{arch}__{shape}__{mesh_name}.json"
                if out.exists() and not args.force:
                    rec = json.loads(out.read_text())
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"[cached] {arch} {shape} {mesh_name}: {rec['status']}")
                        continue
                rec = run_cell(arch, shape, mesh, mesh_name, artifact_dir=artifact_dir)
                if rec["status"] == "error":
                    failures += 1
                    print(f"[FAIL] {arch} {shape} {mesh_name}: {rec['error']}", flush=True)
                else:
                    extra = ""
                    if rec["status"] == "ok":
                        gb = rec["memory"]["per_device_bytes"] / 2**30
                        r = rec["roofline"]
                        extra = (f" flops/dev={rec['hlo']['flops']:.3e}"
                                 f" wire={rec['hlo']['wire_bytes_total']:.3e}B"
                                 f" mem/dev={gb:.2f}GiB fits_hbm={rec['memory']['fits_hbm']}"
                                 f" dom={r['dominant']} bound={r['bound_s']*1e3:.1f}ms"
                                 f" trace={rec['lower_s']}s")
                    print(f"[{rec['status']}] {arch} {shape} {mesh_name}{extra}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
