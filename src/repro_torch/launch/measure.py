"""Tier-2 measured execution: run a plan cell's step, or launch a kernel,
and time it.

Counterpart of ``repro/launch/measure.py``. One warm call (the first
launch builds and loads the kernel library; a plan step's first call
allocates its working set), then ``runs`` timed calls; the record reports
the **minimum**. On a card each timed call sits between two
``torch.cuda.Event`` records after a ``synchronize()``, so the time is the
device's, never the host's enqueue time. With ``device="cpu"`` the host
clock times the calls; the record's ``backend`` says which.

``measure_cell`` builds the same step as ``launch/dryrun.build_cell`` on a
one-device mesh (``tiny1x1``), with every input (parameters, batch, cache;
a train cell's state) as zeros on the mesh's device: the time of a dense
step does not depend on the data. A train cell's step is a whole one,
forward, backward and AdamW, fed its own new state. A cell too large for one card is measured with a cut global
batch (``cell=``; the CLI's ``--batch``). Neither function raises: a failed run is a
``status="error"`` record.

    PYTHONPATH=src python -m repro_torch.launch.measure --arch llama3-8b \
        --shape decode_32k --batch 8 --device cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch

DEFAULT_RUNS = 3

# process-local count of actual timed executions of plan cells
N_MEASUREMENTS = 0


def _time_call(fn, device: torch.device) -> float:
    """Seconds one call of ``fn`` takes on ``device``."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def _zeros(tree, dev):
    """Zeros of every meta leaf of a nested dict, on ``dev``."""
    if isinstance(tree, dict):
        return {k: _zeros(v, dev) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)


def zero_step(arch: str, shape_name: str, mesh, plan=None, *, cfg=None, cell=None):
    """``(call, None)``: ``call()`` runs one step of the cell, built as
    ``dryrun.build_cell`` builds it on the one-device ``mesh``, on inputs
    that are zeros on the mesh's device; or ``(None, reason)`` for a cell
    the port does not run. A serve step runs under ``torch.no_grad()``; a
    train step is a whole one (forward, backward, AdamW) that updates its
    zero-initialised state in place, so repeated calls keep its shapes."""
    from repro_torch.launch import dryrun

    if mesh.size() != 1:
        raise ValueError(f"the measured tier runs on one device, not {mesh.size()}")
    dev = torch.device(mesh.device_type)
    built, skip = dryrun.build_cell(arch, shape_name, mesh, plan, cfg=cfg, cell=cell)
    if built is None:
        return None, skip
    step, inputs, _ = built
    args = _zeros(inputs, dev)
    del inputs

    if "state" in args:
        def call():
            step(args["state"], args["batch"])
    else:
        def call():
            with torch.no_grad():
                step(args["params"], args["batch"], args["cache"])

    return call, None


def measure_cell(arch: str, shape_name: str, mesh, mesh_name: str,
                 plan=None, *, runs: int = DEFAULT_RUNS,
                 cfg=None, cell=None) -> Dict[str, Any]:
    """Run one cell's step on a one-device mesh and time it (see the module
    docstring).

    Returns a record with ``status`` ``ok`` (``measured_s`` = min over
    ``runs`` timed calls, ``times_s`` the full list, ``warm_s`` the first
    call, ``backend`` the mesh's device type, ``peak_bytes`` the card's
    peak allocation over the warm and timed calls, ``None`` on the CPU),
    ``skipped`` (unsupported cell), or ``error``.
    """
    global N_MEASUREMENTS
    if runs < 1:
        raise ValueError(f"runs must be >= 1, got {runs}")
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "fidelity": "measured",
                           "n": runs, "measured_at": round(t0, 3)}
    try:
        dev = torch.device(mesh.device_type)
        call, skip = zero_step(arch, shape_name, mesh, plan, cfg=cfg, cell=cell)
        if call is None:
            rec.update(status="skipped", reason=skip)
            return rec

        N_MEASUREMENTS += 1
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t_warm = time.perf_counter()
        call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        warm_s = time.perf_counter() - t_warm
        times = [_time_call(call, dev) for _ in range(runs)]
        rec.update(status="ok",
                   measured_s=min(times),
                   times_s=times,
                   warm_s=warm_s,
                   backend=dev.type,
                   device_name=(torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                   peak_bytes=(torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None))
    except Exception as e:  # noqa: BLE001 — a failed measurement is a negative datapoint
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


#: the share of the card's memory (``H100_SXM.hbm_bytes``) that a cut
#: cell's modelled bytes per device may fill: the dry run's peaks read up
#: to 2.1% under the card's (prefill 27.07 vs 27.65 GB; nine qwen3-0.6b
#: train plans within 1.3%, ``scripts/plan_fit_probe.py``; PERF.md §6)
FIT_SHARE = 0.9


def one_device_batch(arch: str, shape_name: str, plan, *, cfg, cell,
                     artifact_dir: Path, run_name: str) -> Dict[str, Any]:
    """The global batch at which ``plan`` runs the cell on one card: the
    largest power-of-two multiple of ``plan.microbatches`` (or the cell's
    own batch, when that fits) whose one-device dry run
    (``dryrun.run_cell`` on the CPU's 1x1 mesh: fake tensors, no device)
    models at most ``FIT_SHARE`` of the H100's memory per device.

    A dense cell's bytes are affine in the batch, so the dry runs at the
    first two batches fix the line and one at the chosen batch confirms
    it (halving while it does not). Returns ``status`` ``ok`` with
    ``batch``, that dry run's ``per_device_bytes``, ``bound_s`` and
    ``dominant``, and ``traced`` (batch -> modelled bytes); ``skipped``
    with the reason when even the first batch does not fit (or the cell is
    unsupported); or ``error`` when a dry run failed."""
    from repro_torch.core.device import H100_SXM
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_campaign_mesh

    limit = FIT_SHARE * H100_SXM.hbm_bytes
    mesh, _ = make_campaign_mesh("tiny", "cpu")
    recs: Dict[int, Dict[str, Any]] = {}

    def nbytes(b: int):
        """The modelled bytes per device at batch ``b``, or the failed record."""
        if b not in recs:
            recs[b] = dryrun.run_cell(arch, shape_name, mesh, f"{run_name}-b{b}", plan,
                                      artifact_dir, cfg=cfg,
                                      cell=dataclasses.replace(cell, global_batch=b))
        rec = recs[b]
        return rec["memory"]["per_device_bytes"] if rec["status"] == "ok" else rec

    full = cell.global_batch
    b0 = max(int(plan.microbatches), 1)
    if b0 > full:
        return {"status": "skipped", "reason": f"{b0} microbatches exceed the cell's "
                                               f"global batch {full}"}
    m0 = nbytes(b0)
    if isinstance(m0, dict):
        return {k: m0[k] for k in ("status", "reason", "error") if k in m0}
    if m0 > limit:
        return {"status": "skipped",
                "reason": (f"does not fit one card at global batch {b0}: "
                           f"{m0 / 1e9:.1f} GB modelled > {limit / 1e9:.1f} GB "
                           f"({FIT_SHARE:.0%} of {H100_SXM.hbm_bytes / 1e9:.0f} GB)")}
    b = b0
    if 2 * b0 <= full:
        m1 = nbytes(2 * b0)
        if isinstance(m1, dict):
            return {k: m1[k] for k in ("status", "reason", "error") if k in m1}
        slope = (m1 - m0) / b0
        while 2 * b <= full and m0 + slope * (2 * b - b0) <= limit:
            b *= 2
        if b != full and m0 + slope * (full - b0) <= limit:
            b = full
    while True:
        m = nbytes(b)
        if isinstance(m, dict):
            return {k: m[k] for k in ("status", "reason", "error") if k in m}
        if m <= limit or b == b0:
            break
        b = max(b // 2, b0)
    rec = recs[b]
    return {"status": "ok", "batch": b, "per_device_bytes": m,
            "bound_s": rec["roofline"]["bound_s"], "dominant": rec["roofline"]["dominant"],
            "traced": {str(k): (r["memory"]["per_device_bytes"] if r["status"] == "ok"
                                else None) for k, r in sorted(recs.items())}}


#: bf16 on the card against f32 on the CPU (``check_against_cpu``), as a
#: share of the largest |value| of the f32 result. bf16 alone departs from
#: f32 by about this much at the check's size: ``scripts/bf16_gap.py``
#: gives the reference's own gap and the port's.
MODEL_REL = 2e-2


def check_against_cpu(arch: str = "llama3-8b", *, n_layers: int = 2, tokens: int = 2048,
                      steps: int = 8, device: str = "cuda", seed: int = 0) -> Dict[str, Any]:
    """The dense model at full width, cut to ``n_layers``, with random
    weights from ``seed``: a ``tokens``-token prefill and ``steps`` decode
    steps in the config's dtype on ``device`` and in f32 on the CPU, on the
    same weights. Returns each step's max |logit error| / max |logit|
    (``logits``: the prefill's first), the cache's (``cache``), whether the
    device's logits were finite, both caches' lengths, and ``ok``: every
    error finite and below ``MODEL_REL``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params, _ = M.init_params(cfg, seed=seed, device=device)
    cpu = {k: v.float().cpu() for k, v in params.items()}
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (1, tokens + steps), generator=gen, dtype=torch.int32)

    def rel(want, got):
        want, got = want.float().cpu(), got.float().cpu()
        return float((want - got).abs().max() / want.abs().max())

    errs, finite = [], True
    with torch.no_grad():
        dl, dc = M.prefill_fn(cfg, params, {"tokens": tok[:, :tokens].to(device)},
                              M.init_cache(cfg, 1, tokens + steps, device=device))
        cl, cc = M.prefill_fn(cfg32, cpu, {"tokens": tok[:, :tokens]},
                              M.init_cache(cfg32, 1, tokens + steps))
        errs.append(rel(cl, dl))
        finite = finite and bool(torch.isfinite(dl.float()).all())
        for i in range(steps):
            nxt = tok[:, tokens + i:tokens + i + 1]
            dl, dc = M.decode_fn(cfg, params, {"tokens": nxt.to(device)}, dc)
            cl, cc = M.decode_fn(cfg32, cpu, {"tokens": nxt}, cc)
            errs.append(rel(cl, dl))
            finite = finite and bool(torch.isfinite(dl.float()).all())
    cache = max(rel(cc[k], dc[k]) for k in ("k", "v"))
    ok = finite and all(e < MODEL_REL for e in errs + [cache])
    return {"logits": errs, "cache": cache, "finite": finite, "ok": ok,
            "len": (dc["len"].tolist(), cc["len"].tolist()), "limit": MODEL_REL}


#: the train check's limit on each leaf: max |x(card) - x(CPU)| over max
#: |x(CPU)| for every gradient leaf, every dequantised int8 moment and
#: every new param. A leaf's gradient zeroed reads 1 and its sign flipped
#: reads 2; bf16 alone read at most 0.035 on an H100 at the check's size
#: (PERF.md §6).
TRAIN_LEAF_REL = 0.1


def check_train_against_cpu(cfg, *, n_layers: int = 2, tokens: int = 2048,
                            device: str = "cuda", seed: int = 0) -> Dict[str, Any]:
    """One train step of the dense model ``cfg`` (an ``ArchConfig``) cut to
    ``n_layers``, on one ``tokens``-token sequence, with random weights from
    ``seed``: in the config's dtype on ``device`` and in f32 on the CPU, on
    the same weights and batch, under the plan point the measured tier
    times llama3-8b at (``remat="full"``, int8 moments). The step is the
    train step's own parts, ``loss_fn``'s gradients then ``adamw_update``
    (warmup 1, so step 1 runs at the peak learning rate), so that the
    gradients can be compared too.

    Returns the loss's and the gradient norm's relative errors (``loss``,
    ``grad_norm``) and both sides' values; for each leaf of the gradients,
    of the moments m and v and of the new params, max |error| over the CPU
    leaf's max |value| (``leaves``: ``{"grad", "m", "v", "param"}`` ->
    ``{leaf: error}``) and the worst of each (``worst``: ``(leaf,
    error)``); whether the device's values were finite; and ``ok``: every
    error finite, the two scalars below ``MODEL_REL`` and each leaf below
    ``TRAIN_LEAF_REL``."""
    from repro_torch.models import model as M
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    plan = ShardingPlan(rules={}, remat="full", opt_int8=True, zero1=False)
    opt_cfg = opt_mod.AdamWConfig(warmup_steps=1)
    state, _ = step_mod.init_train_state(cfg, plan, seed=seed, device=device)
    cpu = step_mod._new_state({k: v.float().cpu() for k, v in state["params"].items()}, plan)
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (2, 1, tokens), generator=gen, dtype=torch.int32)
    batch = {"tokens": tok[0], "targets": tok[1]}

    def step(c, st, b):
        leaves = {k: p.detach().requires_grad_() for k, p in st["params"].items()}
        with torch.enable_grad():
            loss, _ = M.loss_fn(c, leaves, b, remat=plan.remat)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        _, _, om = opt_mod.adamw_update(opt_cfg, st["params"], grads, st["opt"])
        return {"loss": float(loss.detach()), "grad_norm": float(om["grad_norm"])}, grads

    dm, dgrads = step(cfg, state, {k: v.to(device) for k, v in batch.items()})
    cm, cgrads = step(cfg32, cpu, batch)
    out: Dict[str, Any] = {"finite": True, "limit": MODEL_REL, "leaf_limit": TRAIN_LEAF_REL}
    for k in ("loss", "grad_norm"):
        d, c = dm[k], cm[k]
        out[k] = abs(d - c) / abs(c)
        out[f"{k}_device"], out[f"{k}_cpu"] = d, c
        out["finite"] = out["finite"] and math.isfinite(d)

    def mom(st, part, k):
        q = st["opt"][part][k]
        return opt_mod._dq8(q["q"], q["s"], q["q"].shape)

    pairs = {"grad": lambda st, g, k: g[k],
             "m": lambda st, g, k: mom(st, "m", k),
             "v": lambda st, g, k: mom(st, "v", k),
             "param": lambda st, g, k: st["params"][k]}
    out["leaves"], out["worst"] = {}, {}
    for part, get in pairs.items():
        errs = {}
        for k in cgrads:
            want, got = get(cpu, cgrads, k), get(state, dgrads, k).float().cpu()
            out["finite"] = out["finite"] and bool(torch.isfinite(got).all())
            errs[k] = float((want - got).abs().max() / want.abs().max())
        out["leaves"][part] = errs
        out["worst"][part] = max(errs.items(), key=lambda kv: kv[1])
    out["ok"] = (out["finite"] and all(out[k] < MODEL_REL for k in ("loss", "grad_norm"))
                 and all(e < TRAIN_LEAF_REL for errs in out["leaves"].values()
                         for e in errs.values()))
    return out


def measure_kernel_cell(kshape, dims: Dict[str, Any], *,
                        device: torch.device | str = "cuda",
                        mesh_name: str = "dev1", runs: int = DEFAULT_RUNS,
                        seed: int = 0) -> Dict[str, Any]:
    """Launch the kernel with the candidate tile dims and time it (warm
    call, then min of ``runs``), then re-run the correctness gate on the
    warm output against the ``kernels.ref`` oracle.

    Returns ``status`` ``ok`` (correct within tolerance), ``incorrect``
    (the output is wrong; the caller makes it an ``infeasible`` row) or
    ``error``, with ``backend`` (``cuda`` or ``cpu``) and ``device_name``.
    """
    if runs < 1:
        raise ValueError(f"runs must be >= 1, got {runs}")
    from repro_torch.kernels import conformance

    t0 = time.time()
    rec: Dict[str, Any] = {"arch": f"kernel:{kshape.kernel}",
                           "shape": kshape.name, "mesh": mesh_name,
                           "fidelity": "measured", "n": runs,
                           "measured_at": round(t0, 3)}
    try:
        dev = torch.device(device)
        inputs = conformance.make_inputs(kshape, seed=seed, device=dev)
        outs = []

        def call():
            outs.append(conformance.run_candidate(kshape, dims, inputs))

        t_warm = time.perf_counter()
        call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        warm_s = time.perf_counter() - t_warm
        want = conformance.run_reference(kshape, dims, inputs)
        err = conformance.max_abs_error(outs[0], want)
        del want
        tol = conformance.tolerance(kshape.kernel, kshape.dtype)
        times = []
        for _ in range(runs):
            outs.clear()
            times.append(_time_call(call, dev))
        rec.update(status="ok" if err <= tol else "incorrect",
                   measured_s=min(times),
                   times_s=times,
                   warm_s=warm_s,
                   backend=dev.type,
                   device_name=(torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                   max_abs_err=err,
                   tol=tol)
    except Exception as e:  # noqa: BLE001 — a failed measurement is a negative datapoint
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def build_parser() -> argparse.ArgumentParser:
    """The measured-execution CLI surface."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.measure",
        description="measure one cell: run its step on one device and time "
                    "it (tier 2 of the promotion ladder)")
    ap.add_argument("--arch", required=True, help="arch id")
    ap.add_argument("--shape", required=True, help="shape cell name")
    ap.add_argument("--mesh", default="tiny", choices=["tiny"],
                    help="the one-device mesh (a larger mesh has no devices to run on)")
    ap.add_argument("--runs", type=int, default=DEFAULT_RUNS,
                    help="timed executions after the warm call; the "
                         "reported measured_s is their minimum")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, the CPU")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the cell's global batch to this many sequences: "
                         "no serve cell fits one card at its own batch (the "
                         "record lists the cut under 'reduced')")
    ap.add_argument("--out", default=None,
                    help="write the measurement record JSON here")
    return ap


def main(argv=None) -> None:
    """CLI entry: measure one (arch, shape) cell's baseline plan on the
    one-device mesh and print the record. Exits 1 on a failed measurement."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error(f"--runs must be >= 1, got {args.runs}")
    from repro_torch.configs import ARCH_NAMES, SHAPE_BY_NAME
    from repro_torch.core.device import resolve_device
    from repro_torch.launch.mesh import make_campaign_mesh

    if args.arch not in ARCH_NAMES:
        ap.error(f"unknown arch {args.arch!r}")
    if args.shape not in SHAPE_BY_NAME:
        ap.error(f"unknown shape {args.shape!r}")
    if args.batch is not None and args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    resolve_device(args.device)
    mesh, mesh_name = make_campaign_mesh(args.mesh, args.device)
    cell = SHAPE_BY_NAME[args.shape]
    cut = dataclasses.replace(cell, global_batch=args.batch) if args.batch else cell
    rec = measure_cell(args.arch, args.shape, mesh, mesh_name, runs=args.runs, cell=cut)
    if cut is not cell:
        rec["reduced"] = {"global_batch": [cell.global_batch, cut.global_batch]}
    print(json.dumps({k: v for k, v in rec.items() if k != "trace"},
                     indent=1, default=str))
    if args.out:
        from repro_torch.launch.ioutil import write_json_atomic

        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        write_json_atomic(Path(args.out), rec)
    if rec["status"] == "error":
        sys.exit(1)


if __name__ == "__main__":
    main()
