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
batch (``cell=``; the CLI's ``--batch``), and a model too large for it with
its depth cut (``cfg=``, the registry's config with fewer layers; the
record lists the cut under ``reduced``, ``{"n_layers": [full, cut]}``).
Neither function raises: a failed run is a ``status="error"`` record.

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
from typing import Any, Dict, Optional

DEFAULT_RUNS = 3

# process-local count of actual timed executions of plan cells
N_MEASUREMENTS = 0


def _time_call(fn, device: torch.device) -> float:
    """Seconds one call of ``fn`` takes on ``device``."""
    import torch

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
    import torch

    if isinstance(tree, dict):
        return {k: _zeros(v, dev) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)


def depth_cut(arch: str, cfg) -> Dict[str, Any]:
    """``{"n_layers": [full, cut]}`` (and ``n_enc_layers``) when ``cfg`` is
    the registry's ``arch`` with fewer layers, else ``{}``."""
    from repro_torch.configs import ARCH_NAMES, get_config

    if arch not in ARCH_NAMES:
        return {}
    full = get_config(arch)
    keys = ("n_layers", "n_enc_layers")
    if dataclasses.replace(cfg, **{k: getattr(full, k) for k in keys}) != full:
        return {}
    return {k: [getattr(full, k), getattr(cfg, k)] for k in keys
            if getattr(cfg, k) != getattr(full, k)}


def zero_step(arch: str, shape_name: str, mesh, plan=None, *, cfg=None, cell=None):
    """``(call, None)``: ``call()`` runs one step of the cell, built as
    ``dryrun.build_cell`` builds it on the one-device ``mesh``, on inputs
    that are zeros on the mesh's device; or ``(None, reason)`` for a cell
    the port does not run. A serve step runs under ``torch.no_grad()``; a
    train step is a whole one (forward, backward, AdamW) that updates its
    zero-initialised state in place, so repeated calls keep its shapes."""
    import torch
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
    import torch

    global N_MEASUREMENTS
    if runs < 1:
        raise ValueError(f"runs must be >= 1, got {runs}")
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "fidelity": "measured",
                           "n": runs, "measured_at": round(t0, 3)}
    if cfg is not None:
        rec["reduced"] = depth_cut(arch, cfg)
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


def _largest_fitting(candidates, nbytes, limit: float):
    """The largest of ``candidates`` (ascending, their modelled bytes rising
    with them) whose ``nbytes(c)`` is at most ``limit``, by bisection:
    ``(candidate, None)``; ``(None, None)`` when even the first does not
    fit; ``(None, record)`` when ``nbytes`` returned a failed dry run's
    record instead of bytes."""
    lo, hi = -1, len(candidates)  # candidates[lo] fits, candidates[hi] does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        m = nbytes(candidates[mid])
        if isinstance(m, dict):
            return None, m
        if m <= limit:
            lo = mid
        else:
            hi = mid
    return (candidates[lo] if lo >= 0 else None), None


def _fit_on_one_card(candidates, dry_run, what: str) -> Dict[str, Any]:
    """The largest of ``candidates`` whose one-device dry run
    (``dry_run(c)``, a ``dryrun.run_cell`` record) models at most
    ``FIT_SHARE`` of the H100's memory per device: ``status`` ``ok`` with
    ``value``, that dry run's ``per_device_bytes``, ``bound_s`` and
    ``dominant``, and ``traced`` (candidate -> modelled bytes); ``skipped``
    with the reason when even the first candidate does not fit; or the
    failed dry run's status."""
    from repro_torch.core.device import H100_SXM

    limit = FIT_SHARE * H100_SXM.hbm_bytes
    recs: Dict[int, Dict[str, Any]] = {}

    def nbytes(c: int):
        """The modelled bytes per device at ``c``, or the failed record."""
        if c not in recs:
            recs[c] = dry_run(c)
        rec = recs[c]
        return rec["memory"]["per_device_bytes"] if rec["status"] == "ok" else rec

    best, bad = _largest_fitting(candidates, nbytes, limit)
    if bad is not None:
        return {k: bad[k] for k in ("status", "reason", "error") if k in bad}
    if best is None:
        m0 = nbytes(candidates[0])
        return {"status": "skipped",
                "reason": (f"does not fit one card at {what} {candidates[0]}: "
                           f"{m0 / 1e9:.1f} GB modelled > {limit / 1e9:.1f} GB "
                           f"({FIT_SHARE:.0%} of {H100_SXM.hbm_bytes / 1e9:.0f} GB)")}
    rec = recs[best]
    return {"status": "ok", "value": best, "per_device_bytes": rec["memory"]["per_device_bytes"],
            "bound_s": rec["roofline"]["bound_s"], "dominant": rec["roofline"]["dominant"],
            "traced": {str(k): (r["memory"]["per_device_bytes"] if r["status"] == "ok"
                                else None) for k, r in sorted(recs.items())}}


def one_device_batch(arch: str, shape_name: str, plan, *, cfg, cell,
                     artifact_dir: Path, run_name: str) -> Dict[str, Any]:
    """The global batch at which ``plan`` runs the cell on one card: the
    largest of the power-of-two multiples of ``plan.microbatches`` up to
    the cell's own batch, and that batch itself, whose one-device dry run
    (``dryrun.run_cell`` on the CPU's 1x1 mesh: fake tensors, no device)
    models at most ``FIT_SHARE`` of the H100's memory per device
    (``_fit_on_one_card``, its ``value`` returned as ``batch``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_campaign_mesh

    full = cell.global_batch
    b0 = max(int(plan.microbatches), 1)
    if b0 > full:
        return {"status": "skipped", "reason": f"{b0} microbatches exceed the cell's "
                                               f"global batch {full}"}
    mesh, _ = make_campaign_mesh("tiny", "cpu")
    batches = sorted({b0 << k for k in range(full.bit_length()) if b0 << k <= full} | {full})
    fit = _fit_on_one_card(batches, lambda b: dryrun.run_cell(
        arch, shape_name, mesh, f"{run_name}-b{b}", plan, artifact_dir, cfg=cfg,
        cell=dataclasses.replace(cell, global_batch=b)), "global batch")
    if fit["status"] == "ok":
        fit["batch"] = fit.pop("value")
    return fit


def one_device_depth(arch: str, shape_name: str, *, artifact_dir: Path,
                     run_name: str, max_layers: Optional[int] = None) -> Dict[str, Any]:
    """The deepest cut of ``arch`` at full width (``cut_config``, in whole
    units: a layer, or a hybrid's group), at most ``max_layers`` deep where
    given, whose one-device dry run of the cell at global batch 1 under the
    baseline plan models at most ``FIT_SHARE`` of the H100's memory per
    device (``_fit_on_one_card``, its ``value`` returned as ``n_layers``)."""
    from repro_torch.configs import SHAPE_BY_NAME, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_campaign_mesh

    full = get_config(arch)
    unit = full.hybrid_attn_every or 1
    cell = dataclasses.replace(SHAPE_BY_NAME[shape_name], global_batch=1)
    mesh, _ = make_campaign_mesh("tiny", "cpu")
    top = full.n_layers if max_layers is None else min(full.n_layers, max_layers)
    fit = _fit_on_one_card(list(range(unit, top + 1, unit)), lambda n: dryrun.run_cell(
        arch, shape_name, mesh, f"{run_name}-l{n}", None, artifact_dir,
        cfg=cut_config(arch, n), cell=cell), "depth")
    if fit["status"] == "ok":
        fit["n_layers"] = fit.pop("value")
    return fit


#: bf16 on the card against f32 on the CPU, as a share of the largest
#: |value| of the f32 result: the model check's logits and cache
#: (``check_against_cpu``), the train check's loss and gradient norm. bf16
#: alone departs from f32 by about this much at the check's size
#: (``scripts/bf16_gap.py``: llama3-8b's reference 1.933%, the port 1.829%)
MODEL_REL = 2e-2
#: ``check_against_cpu``: the device's f32 run against the CPU's (TF32
#: off): summation order alone
F32_REL = 1e-3
#: ``check_against_cpu``: a model whose bf16 run on the device reads past
#: ``MODEL_REL`` is held to this multiple of the port's own bf16 gap on the
#: CPU instead (its bf16 run against its f32, same weights and inputs,
#: measured in the check): bf16 rounding alone reads about 1x of it
#: (0.83-1.09x on an H100, PERF.md §6), a fault of the device's bf16 path
#: more
BF16_GAP_FACTOR = 1.25


def cut_config(arch: str, n_layers: int):
    """The registry's ``arch`` at full width with ``n_layers`` layers (an
    encoder-decoder's encoder cut to the same; a hybrid's ``n_layers`` must
    hold whole groups of ``hybrid_attn_every`` Mamba layers, each with its
    use of the shared block)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.hybrid_attn_every and n_layers % cfg.hybrid_attn_every:
        raise ValueError(f"{arch} cuts to whole groups of {cfg.hybrid_attn_every} layers, "
                         f"not {n_layers}")
    cut = {"n_layers": n_layers}
    if cfg.enc_dec:
        cut["n_enc_layers"] = n_layers
    return dataclasses.replace(cfg, **cut)


def model_inputs(cfg, tokens: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """One sequence's CPU inputs: ``tokens`` int32 tokens, and a frontend
    stub's embeddings [1, F, 1024] (N(0, 1) f32) for vlm and audio."""
    import torch
    from repro_torch.models.transformer import FRONTEND_DIM

    out = {"tokens": torch.randint(0, cfg.vocab, (1, tokens), generator=gen,
                                   dtype=torch.int32)}
    if cfg.frontend:
        out["frontend"] = torch.randn((1, cfg.frontend_len, FRONTEND_DIM), generator=gen)
    return out


def _cache_leaves(cache, pre=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{pre}{k}.")
        else:
            yield f"{pre}{k}", v


def _serve_run(cfg, params, batch, tokens: int, steps: int, device):
    """A ``tokens``-token prefill then ``steps`` decode steps on ``device``:
    (each step's logits as f32 CPU tensors, the final cache, the MoE
    routing of every call)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.moe import record_routing

    prompt = {k: (v[:, :tokens] if k == "tokens" else v).to(device) for k, v in batch.items()}
    pre = cfg.frontend_len if cfg.family == "vlm" else 0
    out = []
    with torch.no_grad(), record_routing() as routes:
        lg, cache = M.prefill_fn(cfg, params, prompt,
                                 M.init_cache(cfg, 1, pre + tokens + steps, device=device))
        out.append(lg.float().cpu())
        for i in range(steps):
            nxt = batch["tokens"][:, tokens + i:tokens + i + 1].to(device)
            lg, cache = M.decode_fn(cfg, params, {"tokens": nxt}, cache)
            out.append(lg.float().cpu())
    return out, cache, list(routes)


def _run_errors(want, got) -> Dict[str, Any]:
    """Each step's max |logit error| over max |logit| of ``want`` (a
    ``_serve_run`` result; the prefill's first), each cache leaf's, and the
    worst of them."""
    def rel(w, g):
        w, g = w.float().cpu(), g.float().cpu()
        return float((w - g).abs().max() / w.abs().max())

    logits = [rel(w, g) for w, g in zip(want[0], got[0])]
    gleaves = dict(_cache_leaves(got[1]))
    cache = {k: rel(v, gleaves[k]) for k, v in _cache_leaves(want[1]) if not k.endswith("len")}
    return {"logits": logits, "cache": cache, "worst": max(logits + list(cache.values()))}


def check_against_cpu(arch: str = "llama3-8b", *, n_layers: int = 2, tokens: int = 2048,
                      steps: int = 8, device: str = "cuda", seed: int = 0) -> Dict[str, Any]:
    """The model at full width, cut to ``n_layers`` (``cut_config``), with
    random weights from ``seed`` (a LoRA's ``b`` halves, zero at init,
    random too, so that its path counts): a ``tokens``-token prefill (after
    a frontend's rows, or beside an encoder's frames) and ``steps`` decode
    steps, run on the same weights and inputs in the config's dtype and in
    f32 on ``device`` (TF32 off) and in f32 on the CPU. An error is max
    |error| over the CPU's f32 result's max |value|, for each step's logits
    and each cache leaf.

    Held: ``f32``, the device's f32 run, within ``F32_REL``; ``bf16``, the
    device's run in the config's dtype, within ``MODEL_REL``, or, where it
    reads past that, within ``BF16_GAP_FACTOR`` times ``gap``, the worst
    error of a fourth run, the CPU's own in that dtype. An MoE model's bf16
    run may send a near-tied token to another expert, which moves its
    logits past any rounding gap: its device run is held finite, ``bf16``
    gives the share of its (token, expert) top-k choices that the CPU's f32
    run did not make (``topk_differ``, of ``topk_pairs``). Returns ``f32``,
    ``bf16`` and ``gap`` where run (each ``{"logits", "cache", "worst"}``),
    ``limit`` (``{"f32", "bf16"}``), ``finite`` (every device run), the
    caches' lengths (device, CPU), ``dtype`` and ``ok``."""
    import torch
    from repro_torch.models import model as M

    cfg = cut_config(arch, n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    batch = model_inputs(cfg, tokens + steps, gen)
    params, _ = M.init_params(cfg, seed=seed, device=device)
    for k, v in params.items():
        if k.endswith("_lora_b"):
            v.copy_(0.02 * torch.randn(v.shape, generator=gen))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev_lo = _serve_run(cfg, params, batch, tokens, steps, device)
        dev32 = _serve_run(cfg32, {k: v.float() for k, v in params.items()}, batch, tokens,
                           steps, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu_lo = {k: v.cpu() for k, v in params.items()}
    del params
    cpu32 = _serve_run(cfg32, {k: v.float() for k, v in cpu_lo.items()}, batch, tokens,
                       steps, "cpu")
    finite = all(bool(torch.isfinite(x).all()) for run in (dev_lo, dev32) for x in run[0])
    out: Dict[str, Any] = {"f32": _run_errors(cpu32, dev32), "finite": finite,
                           "dtype": cfg.dtype}
    limit = {"f32": F32_REL}
    if cfg.moe is not None:
        pairs = diff = 0
        for a, b in zip(cpu32[2], dev_lo[2]):
            for ta, tb in zip(a.tolist(), b.tolist()):
                pairs += len(ta)
                diff += len(set(ta) - set(tb))
        out["bf16"] = {"topk_differ": diff / max(pairs, 1), "topk_pairs": pairs}
        bf16_ok = True
    else:
        out["bf16"] = _run_errors(cpu32, dev_lo)
        limit["bf16"] = MODEL_REL
        if out["bf16"]["worst"] >= MODEL_REL:
            out["gap"] = _run_errors(cpu32, _serve_run(cfg, cpu_lo, batch, tokens, steps, "cpu"))
            limit["bf16"] = max(MODEL_REL, BF16_GAP_FACTOR * out["gap"]["worst"])
        bf16_ok = out["bf16"]["worst"] < limit["bf16"]
    dleaves, cleaves = dict(_cache_leaves(dev_lo[1])), dict(_cache_leaves(cpu32[1]))
    out.update(limit=limit, len=((dleaves["len"].tolist(), cleaves["len"].tolist())
                                 if "len" in dleaves else None),
               ok=finite and out["f32"]["worst"] < F32_REL and bf16_ok)
    return out


#: the train check's limit on each leaf: max |x(card) - x(CPU)| over max
#: |x(CPU)| for every gradient leaf and every dequantised int8 moment, and
#: for every new param the same over its step's update (beyond the
#: rounding to the param's dtype). A leaf's gradient zeroed reads 1 and its
#: sign flipped reads 2, an update at twice the learning rate 1; bf16's
#: gradients read at most 0.035 on an H100 at the check's size (PERF.md §6).
TRAIN_LEAF_REL = 0.1


def _leaf_rel(want: torch.Tensor, got: torch.Tensor) -> float:
    """max |got - want| / max |want|: 0 where both are all zero (an int8
    moment of a leaf whose gradients are all below its quantum), infinite
    where only ``want`` is."""
    if not want.numel():
        return 0.0
    num, den = float((want - got).abs().max()), float(want.abs().max())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _update_rel(old: torch.Tensor, want: torch.Tensor, got: torch.Tensor) -> float:
    """A step's update, ``got - old`` (``got`` rounded to its dtype) against
    ``want - old`` (``want`` in f32): max |error| less half a unit in the
    last place of ``got`` 's dtype at ``want``, over max |want - old|."""
    import torch

    if not want.numel():
        return 0.0
    _, e = torch.frexp(want)
    half_ulp = torch.finfo(got.dtype).eps * torch.ldexp(torch.ones_like(want), e - 2)
    half_ulp.masked_fill_(want == 0, 0)
    num = float(((got.float() - want).abs() - half_ulp).clamp_(min=0).max())
    den = float((want - old).abs().max())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def check_train_against_cpu(cfg, *, n_layers: int = 2, tokens: int = 2048,
                            device: str = "cuda", seed: int = 0) -> Dict[str, Any]:
    """One train step of the model ``cfg`` (an ``ArchConfig``) cut to
    ``n_layers``, on one ``tokens``-token sequence, with random weights from
    ``seed``: in the config's dtype on ``device`` and in f32 on the CPU, on
    the same weights and batch, under the plan point the measured tier
    times llama3-8b at (``remat="full"``, int8 moments). The step is the
    train step's own parts, ``loss_fn``'s gradients then ``adamw_update``
    (warmup 1, so step 1 runs at the peak learning rate), so that the
    gradients can be compared too.

    The CPU computes its own loss and gradient, and runs AdamW on the
    device's gradient from the same state: step 1 moves each entry by about
    -lr * sign(g), so an update from the CPU's own gradient, whose sign can
    differ where it lies within rounding of zero, would not compare.

    Returns the loss's and the gradient norm's relative errors (``loss``,
    ``grad_norm``) and both sides' values; for each gradient leaf max
    |error| over the CPU leaf's max |value|; for each leaf of the moments m
    and v the same against the CPU's AdamW, and for each new param its
    update against that AdamW's (``_update_rel``); these as ``leaves``
    (``{"grad", "m", "v", "param"}`` -> ``{leaf: error}``) and the worst of
    each (``worst``: ``(leaf, error)``); whether the device's values were
    finite; and ``ok``: every error finite, the two scalars below
    ``MODEL_REL`` and each leaf below ``TRAIN_LEAF_REL``."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    plan = ShardingPlan(rules={}, remat="full", opt_int8=True, zero1=False)
    opt_cfg = opt_mod.AdamWConfig(warmup_steps=1)
    state, _ = step_mod.init_train_state(cfg, plan, seed=seed, device=device)
    # a copy: the device side updates its params in place
    init = {k: v.float().cpu().clone() for k, v in state["params"].items()}
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (2, 1, tokens), generator=gen, dtype=torch.int32)
    batch = {"tokens": tok[0], "targets": tok[1]}

    def grads_of(c, params, b):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss, _ = M.loss_fn(c, leaves, b, remat=plan.remat)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        return float(loss.detach()), grads

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # an f32 config runs in full f32
    try:
        dloss, dgrads = grads_of(cfg, state["params"],
                                 {k: v.to(device) for k, v in batch.items()})
        _, _, om = opt_mod.adamw_update(opt_cfg, state["params"], dgrads, state["opt"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    dm = {"loss": dloss, "grad_norm": float(om["grad_norm"])}
    cpu = step_mod._new_state({k: v.clone() for k, v in init.items()}, plan)
    opt_mod.adamw_update(opt_cfg, cpu["params"], {k: g.float().cpu() for k, g in dgrads.items()},
                         cpu["opt"])
    closs, cgrads = grads_of(cfg32, init, batch)
    cm = {"loss": closs, "grad_norm": float(opt_mod.grad_norm(cgrads))}
    out: Dict[str, Any] = {"finite": True, "limit": MODEL_REL, "leaf_limit": TRAIN_LEAF_REL}
    for k in ("loss", "grad_norm"):
        d, c = dm[k], cm[k]
        out[k] = abs(d - c) / abs(c)
        out[f"{k}_device"], out[f"{k}_cpu"] = d, c
        out["finite"] = out["finite"] and math.isfinite(d)

    dev = torch.device(device)

    def mom(st, part, k):
        q = st["opt"][part][k]
        return opt_mod._dq8(q["q"].to(dev), q["s"].to(dev), q["q"].shape)

    out["leaves"], out["worst"] = {}, {}
    for part in ("grad", "m", "v", "param"):
        errs = {}
        for k in cgrads:
            # both sides compared on the device (the CPU side's leaf moved
            # there): the passes over a full-width leaf are the card's
            if part == "param":
                got = state["params"][k]
                out["finite"] = out["finite"] and bool(torch.isfinite(got).all())
                errs[k] = _update_rel(init[k].to(dev), cpu["params"][k].to(dev), got)
                continue
            want = (cgrads[k] if part == "grad" else mom(cpu, part, k)).to(dev)
            got = (dgrads[k] if part == "grad" else mom(state, part, k)).float()
            out["finite"] = out["finite"] and bool(torch.isfinite(got).all())
            errs[k] = _leaf_rel(want, got)
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
    import torch

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
        rec["reduced"] = {**rec.get("reduced", {}),
                          "global_batch": [cell.global_batch, cut.global_batch]}
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
