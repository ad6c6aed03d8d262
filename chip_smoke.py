"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (the build needs
``nvcc``). Phases, each of which exits non-zero on failure:

1. the card (``nvidia-smi`` name and power limit, capability), the
   toolchain, and the kernels' build from ``src/repro_torch/kernels/csrc``;
2. every legal tile point of each CI shape, of an odd shape per kernel
   and of each full-width shape, through the kernel and through its plain
   torch version on the card: the points the Hopper resource model calls
   feasible must launch and agree row by row within
   ``conformance.PLAIN_REL`` of each row's largest value (for the SSD scan
   y and the final state, with and without an ``initial_state``, and the
   oracle gate at every feasible chunk), each through the route the
   resource model names (flash attention and the SSD scan: ``wgmma`` or
   ``fma``; rmsnorm: ``registers``, ``two-pass`` or ``scalar``), the
   others must be refused; then bf16 flash attention's card cases on both
   routes (``sq != sk``, ``q_offset`` of 64, 0 and -32, non-causal, odd
   K-tile walks, d = 64, 96 and 128, 256-row, 32-row and one-row query
   blocks), the bf16 SSD scan's on ``wgmma`` (every instantiated chunk and
   state size, with and without an initial state, five chunks of three
   heads) and rmsnorm at 8193 x 4096 on every path and ``block_rows``;
3. the main path, ``repro_torch.launch.dse`` once per kernel on its
   full-width shape (vecmul and rmsnorm: greedy, 2 iterations; flash
   attention and the SSD scan: the default ensemble with the surrogate
   gate, 3 iterations, the gate's factor 1.5 for flash attention, whose
   feasible tiles are modelled within 1.7x of each other, and 3.0 for the
   SSD scan; budget 3 and the 2 best measured by the
   promotion ladder for all): launch counts are set to 0 just before each
   run and read just after (flash attention and the SSD scan must have run
   on ``wgmma``, rmsnorm on ``registers``), rows must be gate-checked on
   the card and measured rows must say ``backend: cuda``, and the gate's
   state is printed (with 4-6 feasible points the gate's calibration guard
   never arms it here, so these cells do not show what it prunes); then
   with ``REPRO_KERNEL_INJECT_BAD`` naming the default point, that point
   must become an ``infeasible`` row;
3b. one kernel campaign (``repro_torch.launch.campaign``) over every CI
   shape and the four full-width shapes (10 cells, one cost DB): the
   ensemble with the surrogate gate at 3.0, 3 iterations, budget 3, the 2
   best of each cell measured. Launch counts are set to 0 just before it
   and read just after: every kernel must have launched, flash attention
   and the SSD scan on ``wgmma`` and rmsnorm on ``registers``, no row may
   be an ``error``, measured rows must say ``backend: cuda`` and
   ``BENCH_kernels.json`` must hold 10 cells; the campaign's record (wall
   time, rows by status, the correctness audit, the gate's state after the
   last cell) and each cell's leaderboard row are printed. The same command
   again must resume all 10 cells with no launch and no evaluation. Then
   one full-width ``dse --objective pareto`` cell on flash attention
   (ensemble, 3 iterations, the 2 leading front members measured), whose
   launches must all be on ``wgmma``; its front and measured members are
   printed;
4. at each full-width default point, the kernel's, the plain version's and
   (where one exists) one PyTorch library call's times from CUDA events,
   beside the roofline bound; then the flash kernel's time, TFLOP/s,
   shared memory, registers (model and compiler), CTAs per SM and route at
   every feasible full-width tile, rmsnorm's time, share of bound,
   ``F.rms_norm`` and the two-pass path's time on the same rows at every
   ``block_rows``, the SSD scan's at every chunk with its route, each
   launch's time from the profiler, registers and the resource model's
   estimate, the SSD scan's FMA route where the main path ran it, and the
   SSD scan at zamba2-2.7b's widths (80 heads of 64, d_state 64) on ``wgmma``,
   held against its plain version and timed;
5. plan cells, llama3-8b at full width (launch counts set to 0 before and
   read after: the plan path runs torch math and launches no kernel of
   the port): the dry run (``repro_torch.launch.dryrun``) of
   ``prefill_32k`` and ``decode_32k`` on the fake 16x16 mesh, each in a
   subprocess of its own, must write ``ok`` records with every reference
   key (bound, dominant term, GiB per device and ``fits_hbm`` printed);
   then the measured tier (``launch.measure.measure_cell``) times both
   cells on the card with the global batch cut to fit one card (prefill 32
   -> 1, decode 128 -> 8; the only cuts, listed as ``reduced``), beside
   the 1x1 dry run's bound for the same cut cell; then the model with 2
   layers at full width, a 2048-token prefill and 8 decode steps, on the
   card against f32 on the CPU on the same weights
   (``launch.measure.check_against_cpu``): in f32 within
   ``launch.measure.F32_REL`` of the largest |value| at every step and in
   every cache leaf, and in bf16 within ``launch.measure.MODEL_REL``;
6. train cells (launch counts set to 0 before and read after: the train
   path runs torch math and launches no kernel of the port), each part
   printing its result: (a) the dry run of llama3-8b ``train_4k`` on the
   fake 16x16 mesh (baseline plan, batch 256, in a subprocess on the host
   while the card works) must write an ``ok`` record with every reference
   key; (b) the measured tier times a whole llama3-8b train step
   (forward, backward under ``remat=full``, AdamW) at full width and depth
   on the card, the global batch cut 256 -> 1 and the plan point baseline
   + ``opt_int8`` (the baseline's f32 moments take 96.4 GB with the params
   and grads), beside the 1x1 dry run's bound for that cell; its peak must
   stay under the card's memory; (c) ``repro_torch.launch.train`` trains
   qwen3-0.6b at full width on the card (6 steps of 4 x 1024 tokens,
   checkpoints under the gitignored ``artifacts/``, deleted after), then
   restarts from its step-5 checkpoint, whose step must give the same loss
   bit for bit; every loss finite, step time printed apart from the
   host's data time; (d) one train step of
   llama3-8b at full width with 2 layers on 2048 tokens, under (b)'s
   ``remat=full`` and int8 moments, bf16 on the card against f32 on the
   CPU on the same weights: loss and gradient norm within
   ``launch.measure.MODEL_REL``, and every gradient leaf within
   ``launch.measure.TRAIN_LEAF_REL`` of the leaf's largest value, every
   int8 moment and every new param's update within it of those the CPU's
   AdamW makes from the card's gradient
   (``launch.measure.check_train_against_cpu``);
7. the plan loop (launch counts set to 0 before and read after: the loop
   runs torch math and launches no kernel of the port), each cell through
   ``repro_torch.launch.dse --space plans`` on the fake 16x16 mesh with the
   default ensemble (greedy, the mock LLM member, anneal, evolve), the
   surrogate gate at 3.0, iterations of 4 dry runs over 4 worker
   processes, and the best heads measured on the card at the largest
   power-of-two batch whose 1x1 dry run fits 90% of its memory (the cut
   listed as ``reduced``; a head the card then cannot hold is an ``error``
   row): llama3-8b ``decode_32k`` (2 iterations, 2 heads), then the same
   command from an empty DB beside the same caches, which must trace no
   dry run and time no head, then qwen3-0.6b ``train_4k`` (4 iterations,
   so that the surrogate's LoRA fine-tune runs; 1 head, 1 timed step).
   Each cell prints its baseline and best bound, rows by status and
   source, the LLM member's proposals, the gate, the surrogate's
   fine-tunes, each head's time, cut, peak bytes and share of
   its 1x1 bound, and the wall time of the loop and of its dry runs; a
   cell fails on any ``error`` row and on a head that is not ``ok`` on
   ``cuda``. Then the paper's §4 demo
   (``repro_torch.examples.dse_vecmul``): the mock LLM turns the Appendix
   prompt into the vecmul design, which runs on the card through the
   vecmul kernel (its launches are the "loop" path's) and must equal
   ``kernels/ref.py`` exactly;
8. the other model families (launch counts set to 0 before and read
   after: their path runs torch math and launches no kernel of the
   port): (a) the dry run of every (arch, shape) that ``cell_supported``
   admits for mixtral-8x7b, qwen3-moe-235b-a22b, llava-next-34b,
   mamba2-780m, zamba2-2.7b and seamless-m4t-medium on the fake 16x16
   mesh, 21 cells, one process an arch, all started together and tracing
   on the host while the card runs (c), each an ``ok`` record with every
   reference key, and mixtral ``decode_32k`` under ``expert_rule``
   ``expert_ffn`` and ``none`` besides the baseline's ``experts``; (b) one
   arch a family at full width, a 2048-token prefill (after llava's 2880
   frontend rows; beside seamless' 1024 frames) and 8 decode steps on the
   card against f32 on the CPU, same weights, zamba2's LoRA halves random
   (mamba2 at 2 layers, zamba2 at one group of 6 and the shared block,
   mixtral at 2, qwen3-moe at 1, llava at 1, seamless at 2 + 2), each as
   phase 5's check: f32 within ``F32_REL``, bf16 within ``MODEL_REL`` or,
   past it, within ``BF16_GAP_FACTOR`` times the CPU's own bf16 gap (llava's
   reference alone departs by 2.49%); MoE's bf16 run is held finite, with
   the share of its top-k choices that differ printed (a near-tied choice
   flips); (c) the measured
   tier (``measure_cell``: the min of 3 timed runs after a warm one, 1 for
   the steps of 8 s and more: mamba2 and seamless ``prefill_32k`` and
   llava's) at full width, the batch from
   ``one_device_batch`` and a depth from ``one_device_depth`` where the
   model does not fit (the cuts printed under ``reduced``), beside the
   1x1 dry run's bound and the bytes the process held on the card before
   the step: mamba2 ``prefill_32k`` and ``long_500k``, zamba2
   ``long_500k`` (9 K and V caches of 524288 positions), mixtral
   ``decode_32k``, llava ``prefill_32k`` and seamless ``prefill_32k``;
   (d) one train step on the card against the CPU
   (``check_train_against_cpu``): mamba2 at 2 layers on 2048 tokens in
   bf16 and mixtral at 1 layer on 256 in f32 (routing flips, as in (b)),
   the moments and each new param's update against the CPU's AdamW on the
   card's gradient;
   (e) 0 kernel launches on
   that path; then ``models/mamba2.ssd_chunked`` against the port's
   ``ssd_scan`` kernel at mamba2-780m widths on the same inputs within the
   kernel's tolerance, a launch counted apart;
9. plan campaigns (launch counts set to 0 before and read after: the
   campaign runs torch math and launches no kernel of the port): (a)
   ``repro_torch.launch.campaign --space plans --mesh pod`` over llama3-8b
   and mamba2-780m by ``decode_32k`` and ``long_500k`` (1 iteration, budget
   2, 4 dry-run workers, the best head of each cell measured on the card):
   3 cells ``complete`` and llama3-8b ``long_500k`` ``unsupported``, no
   ``error`` row, one ``ok`` head on ``cuda`` a complete cell with its cut
   under ``reduced``, 4 cells in ``BENCH_ladder.json``; the wall time, the
   dry runs and their seconds, rows by status and each cell's best bound
   beside its head are printed, and the time a pool of 2 spawned workers
   takes to import the dry run; (b) the same command again resumes every
   cell, with no dry run and no head timed; (c)
   ``repro_torch.launch.orchestrator --shards 2 --queue`` over the same grid
   on the host (``--measure-top-k 0 --device cpu``) merges to the same
   cells and statuses with no ``error`` row and each cell's best bound
   equal to (a)'s.

It prints a JSON line of per-kernel results (``route`` is ``cuda``;
``kernel_route`` names the kernel's own route or path; a second route that
the main path also launched has an entry of its own, ``<kernel>/<route>``),
``launches`` sums the main-path runs (phase 3, the campaign, the Pareto
cell, phase 7 and phase 9, each counted from 0; ``launches_by_path`` splits them), then the
card's name and power limit, and last ``{"ok": true, "device":
{...}}``. It imports nothing of jax or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "artifacts" / "chip_smoke"

#: the keys of the reference's dry-run record (``repro/launch/dryrun.py``)
DRYRUN_KEYS = {
    "": ("arch", "shape", "mesh", "n_devices", "plan", "status", "lower_s", "compile_s",
         "memory", "xla_flops_once", "hlo", "model_flops", "model_flops_per_dev",
         "useful_flops_ratio", "roofline", "wall_s"),
    "memory": ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "code_bytes", "per_device_bytes", "fits_hbm"),
    "hlo": ("dot_flops", "conv_flops", "hbm_bytes", "collect_bytes", "wire_bytes",
            "collective_bytes_total", "wire_bytes_total", "flops"),
    "roofline": ("compute_s", "memory_s", "collective_s", "dominant", "bound_s"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sh(*cmd: str) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        fail(f"{' '.join(cmd)} exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip()


def time_ms(fn, *, budget_s: float = 0.2, max_reps: int = 100) -> float:
    """Mean milliseconds per call from CUDA events, after two warm calls,
    over enough calls to fill about ``budget_s``."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = start.elapsed_time(end)
    reps = max(1, min(max_reps, int(budget_s * 1e3 / max(one, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ssd_bound(p, L: int, itemsize: int):
    """(bound_ms, bound_by) of the SSD scan at shape params ``p`` and chunk
    ``L``: the bytes it must move (x, dt, B, C read, y written, A read, the
    final state written) and the FLOPs the function needs (C.B^T and the
    intra-chunk products over the causal pairs, the chunk's own state and
    the inter-chunk term), each over the card's rate for its type."""
    from repro_torch.core.device import H100_SXM, peak_flops

    b, s, nh, dh, N = p["b"], p["s"], p["nh"], p["dh"], p["N"]
    n_chunks = b * s // L
    pairs = L * (L + 1) // 2  # (l, s) pairs with s <= l in a chunk
    flops = n_chunks * (2 * pairs * (N + nh * dh) + 4 * L * nh * dh * N)
    nbytes = (2 * b * s * nh * dh + b * s * nh + 2 * b * s * N) * itemsize \
        + nh * 4 + b * nh * dh * N * 4
    t_bytes = nbytes / H100_SXM.hbm_bw
    t_ops = flops / peak_flops(H100_SXM, "bfloat16" if itemsize == 2 else "float32")
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ssd_launch_split(run, reps: int = 3):
    """Milliseconds per call of each CUDA kernel an SSD scan call launches,
    from the profiler, as the mean over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = ("ssd_cumsum_kernel", "ssd_state_kernel", "ssd_intra_kernel", "ssd_wgmma_kernel")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                split[n] = split.get(n, 0.0) + e.device_time_total / reps / 1e3
    return split


def launches_of(path_counts, kernel: str, route: str):
    """(total, by path) launches of one kernel's route on the main path:
    for each path the route's count where the kernel has routes, else the
    kernel's own count. Phase 3 keeps one snapshot per kernel."""
    def one(counts, route_counts):
        mine = {k.split("/")[1]: n for k, n in route_counts.items()
                if k.startswith(kernel + "/")}
        return mine.get(route, 0) if mine else counts.get(kernel, 0)

    by = {}
    for path, snap in path_counts.items():
        by[path] = one(*snap[kernel]) if path == "dse" else one(*snap)
    return sum(by.values()), by


def kernel_space_route(shape, dims) -> str:
    """The kernel's own route at a tile: the resource model's for flash
    attention, rmsnorm and the SSD scan, the single kernel's design for
    vecmul."""
    from repro_torch.core.kernel_space import kernel_resources

    return kernel_resources(shape, dims).route or {"vecmul": "elementwise"}[shape.kernel]


def plan_cells(card: str) -> None:
    """Phase 5 (see the module docstring)."""
    import dataclasses

    import torch

    from repro_torch.configs import SHAPE_BY_NAME, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.campaign import make_campaign_mesh
    from repro_torch.launch.measure import MODEL_REL, check_against_cpu, measure_cell

    ops.reset_launch_counts()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = OUT / "dryrun"
    shapes = ("prefill_32k", "decode_32k")
    t = time.perf_counter()
    procs = {sh: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3-8b",
         "--shape", sh, "--mesh", "pod", "--force", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env) for sh in shapes}
    for sh, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"dry run llama3-8b {sh} pod16x16 exited {proc.returncode}: "
                 f"{stdout[-1000:]} {stderr[-2000:]}")
    print(f"plan dry runs: {time.perf_counter() - t:.1f} s for both cells, in parallel",
          flush=True)
    for sh in shapes:
        rec = json.loads((out / f"llama3-8b__{sh}__pod16x16.json").read_text())
        check_dryrun_record(rec, f"llama3-8b {sh}")
        print(f"plan dry run llama3-8b {sh} pod16x16 (256 fake cards, baseline plan): "
              f"{dryrun_line(rec)}", flush=True)

    # the measured tier on the card, beside the 1x1 dry run of the same cut cell
    cfg = get_config("llama3-8b")
    dmesh, _ = make_campaign_mesh("tiny", "cpu")
    mesh, name = make_campaign_mesh("tiny", "cuda")
    cuts = {"prefill_32k": 1, "decode_32k": 8}
    for sh in shapes:
        full = SHAPE_BY_NAME[sh]
        cell = dataclasses.replace(full, global_batch=cuts[sh])
        d = dryrun.run_cell("llama3-8b", sh, dmesh, name, cfg=cfg, cell=cell,
                            artifact_dir=OUT / "dryrun1x1")
        if d["status"] != "ok":
            fail(f"1x1 dry run llama3-8b {sh}: {d.get('error')}")
        rec = measure_cell("llama3-8b", sh, mesh, name, cfg=cfg, cell=cell, runs=3)
        if rec["status"] != "ok" or rec["backend"] != "cuda":
            fail(f"measured tier llama3-8b {sh}: {rec.get('error')} {rec.get('trace')}")
        bound = d["roofline"]["bound_s"]
        line = {"arch": "llama3-8b", "shape": sh, "mesh": name,
                "reduced": {"global_batch": [full.global_batch, cell.global_batch]},
                "measured_s": rec["measured_s"], "times_s": rec["times_s"],
                "warm_s": rec["warm_s"], "peak_bytes": rec["peak_bytes"],
                "dryrun_bound_s": bound, "dryrun_dominant": d["roofline"]["dominant"],
                "dryrun_flops": d["hlo"]["flops"], "dryrun_hbm_bytes": d["hlo"]["hbm_bytes"],
                "dryrun_per_device_bytes": d["memory"]["per_device_bytes"],
                "share_of_bound": bound / rec["measured_s"], "card": card}
        print("plan cell " + json.dumps(line), flush=True)
        torch.cuda.empty_cache()

    # the model on the card against the CPU in f32, same weights
    t = time.perf_counter()
    chk = check_against_cpu("llama3-8b", n_layers=2, tokens=2048, steps=8, device="cuda")
    if (not chk["ok"] or chk["bf16"]["worst"] >= MODEL_REL
            or chk["len"] != ([2048 + 8], [2048 + 8])):
        fail(f"llama3-8b 2 layers on the card vs f32 on the CPU (bf16 within {MODEL_REL}): "
             f"{chk}")
    print(f"plan model check: llama3-8b at full width, 2 layers, 2048-token prefill and 8 "
          f"decode steps on the card vs f32 on the CPU, same weights, max|err| / max|value| "
          f"over the logits and the cache: {model_check_line(chk)} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    if launched:
        fail(f"the plan path launched kernels of the port: {launched}")
    print("plan path: 0 kernel launches", flush=True)


def train_cells(card: str) -> None:
    """Phase 6 (see the module docstring)."""
    import dataclasses

    import torch

    from repro_torch.configs import SHAPE_BY_NAME, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.campaign import make_campaign_mesh
    from repro_torch.launch.measure import check_train_against_cpu, measure_cell
    from repro_torch.sharding.plan import baseline_plan

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    # (a) the production-mesh dry run, on the host while the card trains
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = OUT / "dryrun"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3-8b",
         "--shape", "train_4k", "--mesh", "pod", "--force", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    # (b) the measured tier: llama3-8b train_4k at full width and depth,
    # batch cut 256 -> 1, int8 moments, beside the 1x1 dry run of that cell
    cfg = get_config("llama3-8b")
    full = SHAPE_BY_NAME["train_4k"]
    cell = dataclasses.replace(full, global_batch=1)
    plan = dataclasses.replace(baseline_plan(cfg, cell), opt_int8=True)
    n = cfg.n_params()
    print(f"train cell plan: baseline + opt_int8 ({plan.to_dict()}); the baseline's f32 "
          f"moments are not run on one card: {n / 1e9:.2f} G params take "
          f"{n * (2 + 2 + 8) / 1e9:.1f} GB of bf16 params, bf16 grads and f32 m and v, "
          f"against the card's 80 GB", flush=True)
    dmesh, _ = make_campaign_mesh("tiny", "cpu")
    mesh, name = make_campaign_mesh("tiny", "cuda")
    d = dryrun.run_cell("llama3-8b", "train_4k", dmesh, name, plan, cfg=cfg, cell=cell,
                        artifact_dir=OUT / "dryrun1x1")
    if d["status"] != "ok":
        fail(f"1x1 dry run llama3-8b train_4k: {d.get('error')}")
    rec = measure_cell("llama3-8b", "train_4k", mesh, name, plan, cfg=cfg, cell=cell, runs=3)
    if rec["status"] != "ok" or rec["backend"] != "cuda":
        fail(f"measured tier llama3-8b train_4k: {rec.get('error')} {rec.get('trace')}")
    total = torch.cuda.get_device_properties(0).total_memory
    if not rec["peak_bytes"] < total:
        fail(f"llama3-8b train step peak {rec['peak_bytes']} B >= the card's {total} B")
    bound = d["roofline"]["bound_s"]
    line = {"arch": "llama3-8b", "shape": "train_4k", "mesh": name,
            "plan": {"name": plan.name, "remat": plan.remat, "opt_int8": plan.opt_int8,
                     "zero1": plan.zero1, "microbatches": plan.microbatches},
            "reduced": {"global_batch": [full.global_batch, cell.global_batch]},
            "measured_s": rec["measured_s"], "times_s": rec["times_s"],
            "warm_s": rec["warm_s"], "peak_bytes": rec["peak_bytes"],
            "card_bytes": total, "tokens_per_s": cell.seq_len / rec["measured_s"],
            "dryrun_bound_s": bound, "dryrun_dominant": d["roofline"]["dominant"],
            "dryrun_flops": d["hlo"]["flops"], "dryrun_hbm_bytes": d["hlo"]["hbm_bytes"],
            "dryrun_per_device_bytes": d["memory"]["per_device_bytes"],
            "share_of_bound": bound / rec["measured_s"], "card": card}
    print("train cell " + json.dumps(line), flush=True)
    del rec
    torch.cuda.empty_cache()

    # (c) the trainer through its entry point: qwen3-0.6b at full width on
    # the card, then a restart from a checkpoint, whose steps must replay
    # bit for bit
    ck = OUT / "train"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", "qwen3-0.6b", "--steps", "6", "--batch", "4", "--seq", "1024",
            "--ckpt", str(ck / "ckpt"), "--device", "cuda"]  # checkpoints at 0, 5, 6
    t = time.perf_counter()
    train_cli.main(argv + ["--history", str(ck / "first.json")])
    first = json.loads((ck / "first.json").read_text())
    train_cli.main(argv + ["--resume-step", "5", "--history", str(ck / "resumed.json")])
    resumed = json.loads((ck / "resumed.json").read_text())
    losses = [h["loss"] for h in first]
    if len(first) != 6 or not all(math.isfinite(x) for x in losses):
        fail(f"launch.train qwen3-0.6b: losses {losses}")
    if [h["loss"] for h in resumed] != losses[5:]:
        fail(f"launch.train qwen3-0.6b resumed from step 5: {[h['loss'] for h in resumed]} "
             f"!= {losses[5:]}")
    steps = [h["dt"] for h in first[1:]]
    shutil.rmtree(ck, ignore_errors=True)  # four checkpoints of 7 GB each
    print(f"trainer qwen3-0.6b (full width, batch 4 x 1024, f32 AdamW, via "
          f"repro_torch.launch.train): losses {losses}; resumed from step 5: step 5 "
          f"equal bit for bit; step time {min(steps) * 1e3:.1f}-{max(steps) * 1e3:.1f} ms "
          f"after the first ({first[0]['dt'] * 1e3:.1f} ms), host data time "
          f"{sum(h['data_s'] for h in first) / len(first) * 1e3:.1f} ms a batch "
          f"({time.perf_counter() - t:.1f} s) [{card}]", flush=True)
    torch.cuda.empty_cache()

    # (d) one train step in bf16 on the card against f32 on the CPU
    t = time.perf_counter()
    chk = check_train_against_cpu(cfg, n_layers=2, tokens=2048, device="cuda")
    if not chk["ok"]:
        fail(f"llama3-8b 2 layers train step, bf16 on the card vs f32 on the CPU: {chk}")
    worst = ", ".join(f"{part} {leaf} {e:.3g}" for part, (leaf, e) in chk["worst"].items())
    print(f"train check: llama3-8b at full width, 2 layers, one 2048-token step (remat full, "
          f"int8 moments), bf16 on the card vs f32 on the CPU, same weights: loss "
          f"{chk['loss_device']:.6g} vs {chk['loss_cpu']:.6g} (rel {chk['loss']:.3g}), grad "
          f"norm {chk['grad_norm_device']:.6g} vs {chk['grad_norm_cpu']:.6g} (rel "
          f"{chk['grad_norm']:.3g}), limit {chk['limit']}; worst leaf: {worst}, limit "
          f"{chk['leaf_limit']} ({time.perf_counter() - t:.1f} s)", flush=True)
    (OUT / "train_check.json").write_text(json.dumps(chk, indent=1))

    # (a) the dry run's record
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"dry run llama3-8b train_4k pod16x16 exited {proc.returncode}: "
             f"{stdout[-1000:]} {stderr[-2000:]}")
    rec = json.loads((out / "llama3-8b__train_4k__pod16x16.json").read_text())
    check_dryrun_record(rec, "llama3-8b train_4k")
    print(f"train dry run llama3-8b train_4k pod16x16 (256 fake cards, baseline plan, batch "
          f"256): {dryrun_line(rec)}", flush=True)

    # (e) the train path runs torch math
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    if launched:
        fail(f"the train path launched kernels of the port: {launched}")
    print(f"train path: 0 kernel launches; phase 6 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def plan_loop(card: str):
    """Phase 7 (see the module docstring); returns the launch and route
    counts of the phase (the §4 demo's vecmul)."""
    import torch

    from repro_torch.core.cost_db import CostDB
    from repro_torch.examples import dse_vecmul
    from repro_torch.kernels import ops
    from repro_torch.launch import dse

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    common = ["--space", "plans", "--mesh", "pod", "--strategy", "ensemble", "--llm", "mock",
              "--budget", "4", "--workers", "4", "--gate-factor", "3.0"]
    # the second cell runs 4 iterations: the surrogate is pre-trained at
    # the 2nd and LoRA-fine-tuned at the 4th
    cells = [("llama3-8b", "decode_32k", ["--iterations", "2", "--measure-top-k", "2"], True),
             ("qwen3-0.6b", "train_4k", ["--iterations", "4", "--measure-top-k", "1",
                                         "--measure-runs", "1"], False)]
    total = torch.cuda.get_device_properties(0).total_memory
    for arch, shape, extra, replay in cells:
        out = OUT / "loop" / f"{arch}__{shape}"
        shutil.rmtree(out, ignore_errors=True)
        argv = ["--arch", arch, "--shape", shape, *common, *extra,
                "--db", str(out / "cost_db.jsonl"), "--report", str(out / "report.json")]
        rep = dse.main(argv)
        errors = {d: n for d, n in rep["rows_by_status"].items() if d == "error"}
        if errors or rep["baseline"] is None or rep["best"] is None:
            rows = CostDB(out / "cost_db.jsonl").all()
            fail(f"plan loop {arch} {shape}: {errors}, baseline "
                 f"{rep['baseline'] and rep['baseline']['status']}: "
                 f"{[(d.point, d.fidelity, d.reason) for d in rows if d.status == 'error'][:2]}")
        heads = rep["measured"]
        bad = [m for m in heads if m["status"] != "ok" or m.get("backend") != "cuda"]
        if not heads or bad:
            fail(f"plan loop {arch} {shape}: measured heads must be ok on cuda: {heads}")
        for m in heads:
            if not m["peak_bytes"] < total:
                fail(f"plan loop {arch} {shape}: head peak {m['peak_bytes']} B >= {total} B")
        b0, b1 = rep["baseline"]["metrics"]["bound_s"], rep["best"]["metrics"]["bound_s"]
        print("plan loop " + json.dumps({
            "arch": arch, "shape": shape, "mesh": rep["mesh"], "baseline_bound_s": b0,
            "best_bound_s": b1, "improvement": rep["improvement"],
            "best_point": {k: v for k, v in rep["best"]["point"].items() if k != "__key__"},
            "rows_by_status": rep["rows_by_status"], "rows_by_source": rep["rows_by_source"],
            "llm": rep.get("llm"), "gate": rep.get("gate"), "finetunes": rep["finetunes"],
            "iterations": [{k: it[k] for k in ("iteration", "evaluated", "compiled", "pruned",
                                                "sources", "allocation", "best_bound")}
                           for it in rep["iterations"]],
            "dry_runs": rep["compiles"], "dryrun_s": rep["dryrun_s"], "loop_s": rep["loop_s"],
            "wall_s": rep["wall_s"], "card": card}), flush=True)
        for m in heads:
            print("plan loop head " + json.dumps({
                "arch": arch, "shape": shape, "point": m["point"],
                "measured_s": m["measured_s"], "reduced": m["reduced"],
                "peak_bytes": m["peak_bytes"], "bound_s_1x1": m["bound_s_1x1"],
                "per_device_bytes_1x1": m["per_device_bytes_1x1"],
                "share_of_1x1_bound": m["share_of_1x1_bound"], "bound_s_pod": m["bound_s"],
                "device_name": m["device_name"], "card": card}), flush=True)
        if replay:
            # the same command from an empty DB beside the same caches
            (out / "cost_db.jsonl").unlink()
            t = time.perf_counter()
            again = dse.main(argv)
            if again["compiles"] or again["measured_timed"] or \
                    again["measured_replayed"] != len(heads):
                fail(f"plan loop {arch} {shape} replay: {again['compiles']} dry runs, "
                     f"{again['measured_timed']} timed, {again['measured_replayed']} replayed")
            print(f"plan loop replay {arch} {shape}: 0 dry runs traced, measured tier: 0 "
                  f"timed, {again['measured_replayed']} replayed ({time.perf_counter() - t:.1f} "
                  f"s)", flush=True)
        torch.cuda.empty_cache()
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    if launched:
        fail(f"the plan loop launched kernels of the port: {launched}")
    print("plan loop: 0 kernel launches", flush=True)

    # the paper's §4 demo: the mock LLM's design on the card's vecmul kernel
    ops.reset_launch_counts()
    t = time.perf_counter()
    demo = dse_vecmul.run("cuda", db_path=OUT / "demo" / "vecmul_db.jsonl", verbose=False)
    counts, route_counts = ops.launch_counts(), ops.route_launch_counts()
    others = {k: n for k, n in counts.items() if n and k != "vecmul"}
    if counts["vecmul"] == 0 or others or demo["max_abs_err"] != 0.0:
        fail(f"§4 demo: launches {counts}, max|err| {demo['max_abs_err']}")
    print("demo " + json.dumps({
        "design": demo["design"]["parameters"], "kernel": demo["design"]["kernel"],
        "device": demo["device"], "max_abs_err_vs_ref": demo["max_abs_err"],
        "modelled_us": demo["resources"]["est_latency_us"],
        "threads": demo["resources"]["threads"], "sweep": demo["sweep"],
        "best_block": demo["best_block"], "negatives": demo["negatives"],
        "launches": counts["vecmul"], "s": round(time.perf_counter() - t, 2),
        "card": card}), flush=True)
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, route_counts


#: the five families beyond dense, one arch per family (and qwen3-moe)
FAMILY_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b", "llava-next-34b", "mamba2-780m",
                "zamba2-2.7b", "seamless-m4t-medium")


def dryrun_line(rec) -> str:
    """A dry-run record's bound, its terms, memory, FLOPs and wire bytes."""
    r, m, h = rec["roofline"], rec["memory"], rec["hlo"]
    return (f"bound {r['bound_s'] * 1e3:.3f} ms ({r['dominant']}; compute "
            f"{r['compute_s'] * 1e3:.3f}, memory {r['memory_s'] * 1e3:.3f}, collective "
            f"{r['collective_s'] * 1e3:.3f} ms), {m['per_device_bytes'] / 2**30:.3f} GiB per "
            f"device, fits_hbm {m['fits_hbm']}, {h['flops']:.4g} FLOP and "
            f"{h['wire_bytes_total']:.4g} wire bytes per device "
            f"{ {k: f'{v:.4g}' for k, v in h['wire_bytes'].items()} }, traced in "
            f"{rec['lower_s']} s")


def model_check_line(chk) -> str:
    """A model check's readings (``launch.measure.check_against_cpu``)."""
    f, b = chk["f32"], chk["bf16"]
    line = f"f32 on the card {f['worst']:.4g} (prefill {f['logits'][0]:.4g}; limit " \
           f"{chk['limit']['f32']})"
    if "topk_differ" in b:
        return line + (f"; bf16 on the card finite {chk['finite']}, "
                       f"{100 * b['topk_differ']:.3f}% of {b['topk_pairs']} top-k choices "
                       f"differ from the CPU's f32")
    gap = f", the CPU's own {chk['gap']['worst']:.4g}" if "gap" in chk else ""
    return line + (f"; {chk['dtype']} on the card {b['worst']:.4g} (prefill "
                   f"{b['logits'][0]:.4g}, cache {max(b['cache'].values()):.4g}){gap}, limit "
                   f"{chk['limit']['bf16']:.4g}")


def check_dryrun_record(rec, what: str) -> None:
    """Fail unless the record is ``ok`` with every key of the reference's."""
    for part, keys in DRYRUN_KEYS.items():
        have = rec[part] if part else rec
        missing = [k for k in keys if k not in have]
        if rec["status"] != "ok" or missing:
            fail(f"dry run {what}: status {rec['status']}, missing {part} keys {missing}: "
                 f"{rec.get('error')}")


def other_families(card: str) -> None:
    """Phase 8 (see the module docstring)."""
    import dataclasses

    import torch

    from repro_torch.configs import SHAPE_BY_NAME, SHAPES, get_config
    from repro_torch.core.design_space import PlanPoint, point_to_plan
    from repro_torch.core.kernel_space import KERNEL_SHAPE_BY_NAME
    from repro_torch.kernels import conformance, ops
    from repro_torch.launch import dryrun, measure
    from repro_torch.launch.campaign import make_campaign_mesh
    from repro_torch.models import mamba2, model as M

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    # (a) every supported cell's dry run on the fake 16x16 mesh, one process
    # an arch, all started together; they trace on the host while the card
    # runs (c)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = OUT / "dryrun_families"
    procs = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", "all",
         "--mesh", "pod", "--force", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for a in FAMILY_ARCHS}

    # (c) the measured tier at full width, beside each cut cell's 1x1 bound
    mesh, name = make_campaign_mesh("tiny", "cuda")
    fit_dir = OUT / "fit1x1_families"
    # the three steps of 8-31 s take one timed run after the warm one (the
    # others the min of 3), a cut that keeps the script within its limit
    cells = [("mamba2-780m", "prefill_32k", False, 1), ("mamba2-780m", "long_500k", False, 3),
             ("zamba2-2.7b", "long_500k", False, 3), ("mixtral-8x7b", "decode_32k", True, 3),
             ("llava-next-34b", "prefill_32k", True, 1),
             ("seamless-m4t-medium", "prefill_32k", False, 1)]
    for arch, shape, cut_depth, runs in cells:
        t = time.perf_counter()
        full_cell = SHAPE_BY_NAME[shape]
        cfg = get_config(arch)
        if cut_depth:
            depth = measure.one_device_depth(arch, shape, artifact_dir=fit_dir,
                                             run_name=f"{arch}-{shape}")
            if depth["status"] != "ok":
                fail(f"depth fit {arch} {shape}: {depth}")
            cfg = measure.cut_config(arch, depth["n_layers"])
        plan = dryrun.baseline_plan(cfg, full_cell)
        fit = measure.one_device_batch(arch, shape, plan, cfg=cfg, cell=full_cell,
                                       artifact_dir=fit_dir, run_name=f"{arch}-{shape}")
        if fit["status"] != "ok":
            fail(f"batch fit {arch} {shape}: {fit}")
        cell = dataclasses.replace(full_cell, global_batch=fit["batch"])
        # what the process holds on the card before the step's own tensors
        allocated_before = torch.cuda.memory_allocated()
        rec = measure.measure_cell(arch, shape, mesh, name, plan, cfg=cfg, cell=cell, runs=runs)
        if rec["status"] != "ok" or rec["backend"] != "cuda":
            fail(f"measured tier {arch} {shape}: {rec.get('error')} {rec.get('trace')}")
        reduced = dict(rec.get("reduced", {}))
        if cell.global_batch != full_cell.global_batch:
            reduced["global_batch"] = [full_cell.global_batch, cell.global_batch]
        if cut_depth and "n_layers" not in reduced:
            fail(f"measured tier {arch} {shape}: depth cut to {cfg.n_layers} not recorded")
        line = {"arch": arch, "shape": shape, "mesh": name, "reduced": reduced,
                "measured_s": rec["measured_s"], "times_s": rec["times_s"],
                "warm_s": rec["warm_s"], "peak_bytes": rec["peak_bytes"],
                "allocated_before": allocated_before,
                "peak_less_held": rec["peak_bytes"] - allocated_before, "runs": runs,
                "dryrun_bound_s": fit["bound_s"], "dryrun_dominant": fit["dominant"],
                "dryrun_per_device_bytes": fit["per_device_bytes"],
                "share_of_bound": fit["bound_s"] / rec["measured_s"], "card": card,
                "wall_s": round(time.perf_counter() - t, 1)}
        print("family cell " + json.dumps(line), flush=True)
        del rec
        torch.cuda.empty_cache()

    # (a) the records
    for a, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"dry runs {a} pod16x16 exited {proc.returncode}: {stdout[-1500:]} "
                 f"{stderr[-2000:]}")
    n_ok = 0
    for a in FAMILY_ARCHS:
        for c in SHAPES:
            ok, _ = M.cell_supported(get_config(a), c)
            if not ok:
                continue
            rec = json.loads((out / f"{a}__{c.name}__pod16x16.json").read_text())
            check_dryrun_record(rec, f"{a} {c.name}")
            n_ok += 1
            print(f"family dry run {a} {c.name} pod16x16 (256 fake cards, baseline plan): "
                  f"{dryrun_line(rec)}", flush=True)
    if n_ok != 21:
        fail(f"{n_ok} family dry runs, not 21")
    pod, pod_name = make_campaign_mesh("pod")
    cfg, cell = get_config("mixtral-8x7b"), SHAPE_BY_NAME["decode_32k"]
    for rule in ("expert_ffn", "none"):
        plan = point_to_plan(cfg, cell, PlanPoint({"expert_rule": rule}),
                             multi_pod="pod" in pod.mesh_dim_names, name=f"expert_rule={rule}")
        rec = dryrun.run_cell("mixtral-8x7b", "decode_32k", pod, pod_name, plan,
                              OUT / "dryrun_expert_rules")
        check_dryrun_record(rec, f"mixtral-8x7b decode_32k expert_rule={rule}")
        print(f"family dry run mixtral-8x7b decode_32k pod16x16 expert_rule={rule}: "
              f"{dryrun_line(rec)}", flush=True)
    print(f"family dry runs: {n_ok} cells and 2 expert rules ok "
          f"({time.perf_counter() - t_phase:.1f} s into phase 8)", flush=True)

    # (b) each family at full width on the card against f32 on the CPU
    # llava at 1 layer: its CPU side, f32 and the bf16 gap it needs past
    # MODEL_REL, took 80 of its 105 s at 2 layers
    checks = [("mamba2-780m", 2), ("zamba2-2.7b", 6), ("mixtral-8x7b", 2),
              ("qwen3-moe-235b-a22b", 1), ("llava-next-34b", 1), ("seamless-m4t-medium", 2)]
    for arch, n in checks:
        t = time.perf_counter()
        chk = measure.check_against_cpu(arch, n_layers=n, tokens=2048, steps=8, device="cuda")
        if not chk["ok"]:
            fail(f"{arch} {n} layers on the card vs f32 on the CPU: {chk}")
        print(f"family model check: {arch} at full width, {n} layers, 2048-token prefill "
              f"and 8 decode steps on the card vs f32 on the CPU, same weights, max|err| / "
              f"max|value| over the logits and the cache: {model_check_line(chk)} "
              f"({time.perf_counter() - t:.1f} s) [{card}]", flush=True)
        torch.cuda.empty_cache()

    # (d) the train step's gradients on the card against the CPU
    # mixtral's f32 CPU side takes 2.6 min at 2048 tokens: 256 are 4 groups
    # of 64 through the dispatch (512 took 86 s)
    for arch, n, tokens, dtype in (("mamba2-780m", 2, 2048, None),
                                   ("mixtral-8x7b", 1, 256, "float32")):
        t = time.perf_counter()
        cfg = get_config(arch) if dtype is None else dataclasses.replace(get_config(arch),
                                                                         dtype=dtype)
        chk = measure.check_train_against_cpu(cfg, n_layers=n, tokens=tokens, device="cuda")
        if not chk["ok"]:
            fail(f"{arch} {n} layers train step on the card vs the CPU: {chk}")
        worst = ", ".join(f"{part} {leaf} {e:.3g}" for part, (leaf, e) in chk["worst"].items())
        print(f"family train check: {arch} at full width, {n} layers, one {tokens}-token step "
              f"(remat full, int8 moments), {cfg.dtype} on the card vs f32 on the CPU: loss "
              f"rel {chk['loss']:.3g}, grad norm rel {chk['grad_norm']:.3g}; worst leaf: "
              f"{worst} (param: the update against the CPU's AdamW on the card's gradient), "
              f"limit {chk['leaf_limit']} ({time.perf_counter() - t:.1f} s) [{card}]",
              flush=True)
        torch.cuda.empty_cache()

    # (e) the plan path ran torch math only
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    if launched:
        fail(f"the other families' plan path launched kernels of the port: {launched}")
    print("family path: 0 kernel launches", flush=True)

    # the models' SSD (torch math) against the port's kernel at mamba2-780m
    # widths on the same inputs; this launch is a comparison, counted apart
    shape = KERNEL_SHAPE_BY_NAME["ssd_mamba2_780m_b8_s4096_bf16"]
    x, dt, A, B, C = conformance.make_inputs(shape, device="cuda")
    ops.reset_launch_counts()
    got = ops.ssd_scan(x, dt, A, B, C, chunk=256)
    n_launch = sum(ops.launch_counts().values())
    with torch.no_grad():
        want = mamba2.ssd_chunked(x, dt, A, B, C, 256)
    err = conformance.max_abs_error(got, want)
    tol = conformance.tolerance("ssd_scan", shape.dtype)
    if n_launch != 1 or not err <= tol:
        fail(f"SSD cross-check: models/mamba2.ssd_chunked vs the ssd_scan kernel at "
             f"{shape.params}: max|err| {err} (limit {tol}), {n_launch} launches")
    print(f"SSD cross-check: models/mamba2.ssd_chunked vs the ssd_scan kernel "
          f"({ops.route_launch_counts()}) at mamba2-780m widths {shape.params} {shape.dtype}: "
          f"max|err| {err:.4g} (y and final state; limit {tol}), {n_launch} launch, counted "
          f"apart from the path's", flush=True)
    ops.reset_launch_counts()
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s", flush=True)


#: phase 9's grid: a dense and an SSM arch, a decode cell each and the
#: 524288-token cell, which only the SSM arch supports
CAMPAIGN_GRID = ("llama3-8b,mamba2-780m", "decode_32k,long_500k")


def _spawned_import() -> int:
    """What a dry-run pool worker imports first (phase 9's spawn cost)."""
    import repro_torch.launch.dryrun  # noqa: F401

    return os.getpid()


def plan_campaign(card: str):
    """Phase 9 (see the module docstring); returns the launch and route
    counts of the phase (none)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from repro_torch.core.cost_db import CostDB
    from repro_torch.kernels import ops
    from repro_torch.launch import campaign

    t_phase = time.perf_counter()
    root = OUT / "campaign_plans"
    shutil.rmtree(root, ignore_errors=True)
    archs, shapes = CAMPAIGN_GRID
    argv = ["--space", "plans", "--mesh", "pod", "--archs", archs, "--shapes", shapes,
            "--iterations", "1", "--budget", "2", "--workers", "4", "--measure-top-k", "1",
            "--out", str(root / "campaign")]
    want = {("llama3-8b", "decode_32k"): "complete", ("llama3-8b", "long_500k"): "unsupported",
            ("mamba2-780m", "decode_32k"): "complete", ("mamba2-780m", "long_500k"): "complete"}
    ops.reset_launch_counts()

    # (a) the campaign, its heads measured on the card
    t = time.perf_counter()
    first = campaign.main(argv)
    wall = time.perf_counter() - t
    out = root / "campaign"
    lb = json.loads((out / "leaderboard.json").read_text())
    got = {(r["arch"], r["shape"]): r["status"] for r in lb}
    rows = CostDB(out / "cost_db.jsonl").all()
    by_status: dict = {}
    for d in rows:
        by_status[d.status] = by_status.get(d.status, 0) + 1
    if got != want or "error" in by_status:
        fail(f"plan campaign: cells {got} (want {want}), rows {by_status}: "
             f"{[d.reason for d in rows if d.status == 'error'][:2]}")
    measured = [d for d in rows if d.fidelity == "measured"]
    cells_measured = {(d.arch, d.shape) for d in measured}
    complete = {c for c, st in want.items() if st == "complete"}
    if (len(measured) != 3 or cells_measured != complete
            or any(d.status != "ok" or d.metrics["backend"] != "cuda" for d in measured)):
        fail(f"plan campaign: one head a complete cell, ok on cuda: "
             f"{[(d.arch, d.shape, d.status, d.metrics.get('backend'), d.reason) for d in measured]}")
    bench = json.loads((out / "BENCH_ladder.json").read_text())
    if len(bench["cells"]) != 4:
        fail(f"plan campaign: BENCH_ladder.json holds {len(bench['cells'])} cells, not 4")
    traced = [json.loads(f.read_text()) for f in (out / "dryrun").glob("*.json")]
    print("plan campaign " + json.dumps({
        "cells": {f"{a}/{sh}": st for (a, sh), st in sorted(got.items())},
        "wall_s": round(wall, 1), "dry_runs": first["compiles"],
        "dry_run_s_sum": round(sum(r.get("wall_s", 0.0) for r in traced), 1),
        "rows_by_status": by_status, "measured": first["measured"],
        "summary": {k: first[k] for k in ("ran", "resumed", "unsupported", "evaluations",
                                          "compiles", "measured", "cache")},
        "card": card}), flush=True)
    best = {}
    for r in lb:
        best[(r["arch"], r["shape"])] = r["bound_s"]
        if r["status"] != "complete":
            continue
        head = next(d for d in measured if (d.arch, d.shape) == (r["arch"], r["shape"]))
        m = head.metrics
        print("plan campaign head " + json.dumps({
            "cell": f"{r['arch']}/{r['shape']}", "best_bound_s_pod": r["bound_s"],
            "best_point": r["best_point"], "head_bound_s_pod": m.get("bound_s_modeled"),
            "measured_s": m["measured_s"], "reduced": m["reduced"],
            "bound_s_1x1": m["bound_s_1x1"],
            "share_of_1x1_bound": m["bound_s_1x1"] / m["measured_s"],
            "peak_bytes": m["peak_bytes"], "per_device_bytes_1x1": m["per_device_bytes_1x1"],
            "device_name": m["device_name"], "card": card}), flush=True)
    torch.cuda.empty_cache()

    # the pool's spawn cost: a fresh interpreter that imports the dry run, as
    # each batch's workers do
    t = time.perf_counter()
    with ProcessPoolExecutor(max_workers=2, mp_context=mp.get_context("spawn")) as pool:
        [f.result() for f in [pool.submit(_spawned_import) for _ in range(2)]]
    spawn_s = time.perf_counter() - t
    print(f"plan campaign: a pool of 2 spawned workers importing the dry run takes "
          f"{spawn_s:.1f} s; the campaign spawns one pool for its {first['ran']} batches (one "
          f"a complete cell; the baselines dry-run in the campaign's process)", flush=True)

    # (b) the same command again: every cell resumes
    t = time.perf_counter()
    again = campaign.main(argv)
    if (again["ran"], again["resumed"], again["unsupported"], again["compiles"],
            again["measured"]) != (0, 3, 1, 0, 0):
        fail(f"plan campaign resume: {again}")
    print(f"plan campaign resume: 3 cells resumed, 1 unsupported, 0 dry runs traced, 0 "
          f"heads timed ({time.perf_counter() - t:.1f} s)", flush=True)

    # (c) the orchestrator on the host: two queue-mode shards, no measured
    # tier, merged
    t = time.perf_counter()
    orch_out = root / "orchestrator"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.orchestrator", "--shards", "2", "--queue",
         "--mesh", "pod", "--archs", archs, "--shapes", shapes, "--iterations", "1",
         "--budget", "2", "--workers", "4", "--measure-top-k", "0", "--device", "cpu",
         "--poll-interval", "0.5", "--out", str(orch_out)],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=600)
    orch_wall = time.perf_counter() - t
    if r.returncode != 0:
        fail(f"orchestrator exited {r.returncode}: {r.stdout[-1500:]} {r.stderr[-1500:]}")
    olb = json.loads((orch_out / "leaderboard.json").read_text())
    osum = json.loads((orch_out / "summary.json").read_text())
    ogot = {(x["arch"], x["shape"]): x["status"] for x in olb}
    orows = CostDB(orch_out / "cost_db.jsonl").all()
    if ogot != want or any(d.status == "error" for d in orows):
        fail(f"orchestrator: cells {ogot} (want {want}), "
             f"{[d.reason for d in orows if d.status == 'error'][:2]}")
    pairs = {f"{x['arch']}/{x['shape']}": [best[(x["arch"], x["shape"])], x["bound_s"]]
             for x in olb}
    if any(a != b for a, b in pairs.values()):
        fail(f"orchestrator: best bounds differ from the campaign's: {pairs}")
    print("plan orchestrator " + json.dumps({
        "wall_s": round(orch_wall, 1), "shards": 2, "queue": osum["queue_cells"],
        "restarts": osum["restarts"], "steals": osum["steals"],
        "evaluations": osum["evaluations"],
        "best_bound_s_campaign_vs_orchestrator": pairs}), flush=True)

    counts, route_counts = ops.launch_counts(), ops.route_launch_counts()
    launched = {k: n for k, n in counts.items() if n}
    if launched:
        fail(f"the plan campaign launched kernels of the port: {launched}")
    print("plan campaign path: 0 kernel launches", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, route_counts


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.cost_db import CostDB
    from repro_torch.core.design_space import KernelTemplate, baseline_kernel_point
    from repro_torch.core.device import H100_SXM, peak_flops
    from repro_torch.core.kernel_space import (CI_KERNEL_SHAPES, KERNEL_SHAPE_BY_NAME,
                                               KernelShape, kernel_resources, tile_grid)
    from repro_torch.kernels import _build, conformance, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import vecmul as vm
    from repro_torch.kernels.resource_model import flash_attention_resources
    from repro_torch.launch import campaign, dse

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    print(f"card: {card}; capability {torch.cuda.get_device_capability(0)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(sh(_build.nvcc_path(), "--version").splitlines()[-1], flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_SECONDS:.2f} s)",
          flush=True)

    full = {"vecmul": "vec_16m_f32", "rmsnorm": "rms_llama3_8b_8kx4096_bf16",
            "flash_attention": "attn_llama3_8b_s4096_bf16",
            "ssd_scan": "ssd_mamba2_780m_b8_s4096_bf16"}
    modules = {"vecmul": vm, "rmsnorm": rn, "flash_attention": fa, "ssd_scan": ssd}

    # ---- phase 2: every legal tile point, kernel against plain version ----
    odd = [KernelShape("rms_odd_173x96_f32", "rmsnorm", {"rows": 173, "d": 96}, "float32"),
           KernelShape("vec_odd_5000_bf16", "vecmul", {"L": 5000}, "bfloat16"),
           KernelShape("ssd_odd_b2_s96_f32", "ssd_scan",
                       {"b": 2, "s": 96, "nh": 3, "dh": 24, "N": 40}, "float32")]
    shapes = [s for s in CI_KERNEL_SHAPES if s.kernel in full] + odd + \
        [KERNEL_SHAPE_BY_NAME[n] for n in full.values()]
    for shape in shapes:
        inputs = conformance.make_inputs(shape, device=dev)
        rel = conformance.PLAIN_REL[inputs[0].dtype]
        # the SSD scan also threads a carried state in: both ways, each point
        variants = [None]
        if shape.kernel == "ssd_scan":
            p = shape.params
            gen = torch.Generator(device=dev).manual_seed(0)
            variants.append(0.3 * torch.randn(p["b"], p["nh"], p["dh"], p["N"],
                                              generator=gen, device=dev))
        n_ok = n_refused = 0
        worst = None
        routes = {}
        for dims in tile_grid(shape):
            if not kernel_resources(shape, dims).feasible:
                try:
                    conformance.run_candidate(shape, dims, inputs)
                    torch.cuda.synchronize()
                except RuntimeError:
                    n_refused += 1
                    continue
                fail(f"{shape.name} {dims}: the model calls it infeasible, "
                     f"but the card launched it")
            res = kernel_resources(shape, dims)
            route_key = f"{shape.kernel}/{res.route}"
            for s0 in variants:
                before = _build.LAUNCHES[route_key]
                if s0 is None:
                    got = conformance.run_candidate(shape, dims, inputs)
                    want = conformance.run_plain(shape, dims, inputs)
                else:
                    got = ssd.ssd_scan_cuda(*inputs, chunk=dims["chunk"], initial_state=s0)
                    want = ssd.ssd_scan_plain(*inputs, chunk=dims["chunk"], initial_state=s0)
                agree = conformance.agree_with_plain(got, want)
                if not agree["passed"]:
                    fail(f"{shape.name} {dims} initial_state={s0 is not None}: "
                         f"kernel vs plain {agree}")
                if res.route and _build.LAUNCHES[route_key] != before + 1:
                    fail(f"{shape.name} {dims}: did not launch on route {res.route}")
                if res.route:
                    routes[res.route] = routes.get(res.route, 0) + 1
                if worst is None or agree["ratio"] > worst["ratio"]:
                    worst = agree
                n_ok += 1
        if shape.kernel == "ssd_scan":
            # the oracle gate (the exact sequential recurrence) at every
            # feasible chunk, on the same inputs, within the reference's
            # tolerance
            want = conformance.run_reference(shape, {}, inputs)
            gate = {}
            for dims in tile_grid(shape):
                if kernel_resources(shape, dims).feasible:
                    chk = conformance.check_candidate(shape, dims, inputs=inputs, want=want)
                    if not chk["passed"]:
                        fail(f"{shape.name} {dims}: oracle gate {chk}")
                    gate[dims["chunk"]] = f"{chk['max_abs_err']:.3g}"
            print(f"gate {shape.name}: every feasible chunk within "
                  f"{conformance.tolerance('ssd_scan', shape.dtype)} of the oracle, "
                  f"max|err| by chunk {gate}", flush=True)
            del want
        print(f"grid {shape.name}: {n_ok} feasible runs "
              f"({len(variants)} per point) agree with the plain "
              f"version row by row within {rel:.3g} of each row's max |out| "
              f"(worst row: err/limit {worst['ratio']:.3g}, limit {worst['limit']:.3g}; "
              f"max|err| {worst['max_abs_err']:.3g}; mean |out| {worst['mean_abs']:.3g}); "
              f"{n_refused} infeasible points refused; runs per route {routes}", flush=True)
        del inputs, variants

    # the bf16 flash cases on both routes: sq != sk, q_offset, non-causal,
    # odd K-tile walks (5 tiles of 64 against 2 stages) at d = 64 and 128 on
    # wgmma; d = 96, a 256-row tile and short query blocks (32 rows, one
    # row) on the FMA kernel
    n_ok = 0
    worst = 0.0
    routes = {}
    for d in (64, 96, 128):
        for sq, sk, q_offset, causal in [(128, 256, 0, True), (128, 320, 64, True),
                                         (128, 256, -32, True), (192, 320, 0, False),
                                         (256, 128, 0, True), (32, 256, 224, True),
                                         (1, 256, 255, True)]:
            gen = torch.Generator(device=dev).manual_seed(sq + sk + d)
            q, k, v = ((0.3 * torch.randn(2, s_, hh, d, generator=gen, device=dev)
                        ).to(torch.bfloat16) for s_, hh in ((sq, 4), (sk, 2), (sk, 2)))
            for bq in (64, 128, 256):
                for bk in fa.WGMMA_BLOCKS:
                    bq_, bk_ = min(bq, sq), min(bk, sk)
                    if sq % bq_ or sk % bk_ or (bq > sq and bq != 64) or not \
                            flash_attention_resources(2, sq, sk, 4, 2, d, bq_, bk_).feasible:
                        continue
                    kw = dict(causal=causal, block_q=bq, block_k=bk, q_offset=q_offset)
                    key = f"flash_attention/{fa.route(q.dtype, d, bq_, bk_)}"
                    before = _build.LAUNCHES[key]
                    agree = conformance.agree_with_plain(
                        fa.flash_attention_cuda(q, k, v, **kw),
                        fa.flash_attention_plain(q, k, v, **kw))
                    if not agree["passed"] or _build.LAUNCHES[key] != before + 1:
                        fail(f"flash bf16 d={d} sq={sq} sk={sk} {kw} on {key}: {agree}")
                    worst = max(worst, agree["ratio"])
                    routes[key] = routes.get(key, 0) + 1
                    n_ok += 1
    print(f"cases flash_attention bf16: {n_ok} runs (sq != sk, q_offset 64/0/-32, "
          f"non-causal, odd walks, d 64/96/128, block_q 256, 32 and 1 query rows) "
          f"agree with the plain version row by row (worst row err/limit {worst:.3g}); "
          f"runs per route {routes}", flush=True)
    # the bf16 SSD scan on its wgmma route at every instantiated (chunk, N),
    # with and without an initial state, over five chunks of three heads
    n_ok = 0
    worst = 0.0
    for chunk in ssd.WGMMA_CHUNKS:
        for N in ssd.WGMMA_N:
            shape = KernelShape("ssd_wgmma", "ssd_scan",
                                {"b": 1, "s": 5 * chunk, "nh": 3, "dh": 64, "N": N}, "bfloat16")
            x, dt, A, B, C = conformance.make_inputs(shape, device=dev)
            gen = torch.Generator(device=dev).manual_seed(chunk + N)
            for s0 in (None, 0.3 * torch.randn(1, 3, 64, N, generator=gen, device=dev)):
                before = _build.LAUNCHES["ssd_scan/wgmma"]
                agree = conformance.agree_with_plain(
                    ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=s0),
                    ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk, initial_state=s0))
                if not agree["passed"] or _build.LAUNCHES["ssd_scan/wgmma"] != before + 1:
                    fail(f"ssd bf16 chunk={chunk} N={N} initial_state={s0 is not None} "
                         f"on wgmma: {agree}")
                worst = max(worst, agree["ratio"])
                n_ok += 1
    print(f"cases ssd_scan bf16: {n_ok} runs (chunk 64/128/256 x N 64/128, with and "
          f"without initial_state, 5 chunks, 3 heads) agree with the plain version row by "
          f"row on wgmma (worst row err/limit {worst:.3g})", flush=True)
    # rmsnorm at an odd row count on every path and block_rows
    n_ok = 0
    worst = 0.0
    for rows, d, dtype in [(8193, 4096, torch.bfloat16), (8193, 6144, torch.bfloat16),
                           (301, 100, torch.bfloat16)]:
        gen = torch.Generator(device=dev).manual_seed(rows + d)
        x = (0.3 * torch.randn(rows, d, generator=gen, device=dev)).to(dtype)
        w = (0.3 * torch.randn(d, generator=gen, device=dev)).to(dtype)
        key = f"rmsnorm/{rn.path(d, x.element_size())}"
        for br in (32, 64, 128, 256):
            before = _build.LAUNCHES[key]
            agree = conformance.agree_with_plain(rn.rmsnorm_cuda(x, w, block_rows=br),
                                                 rn.rmsnorm_plain(x, w, block_rows=br))
            if not agree["passed"] or _build.LAUNCHES[key] != before + 1:
                fail(f"rmsnorm {rows}x{d} block_rows={br} on {key}: {agree}")
            worst = max(worst, agree["ratio"])
            n_ok += 1
    print(f"cases rmsnorm: {n_ok} runs (8193x4096 registers, 8193x6144 two-pass, "
          f"301x100 scalar; every block_rows) agree with the plain version row by row "
          f"(worst row err/limit {worst:.3g})", flush=True)

    # ---- phase 3: the main path, one DSE cell per kernel at full width ----
    search = {
        "vecmul": ["--strategy", "greedy", "--iterations", "2"],
        "rmsnorm": ["--strategy", "greedy", "--iterations", "2"],
        # the cell's eight feasible (wgmma) tiles are modelled within 1.7x
        # of each other: a factor of 3.0 could never prune there
        "flash_attention": ["--strategy", "ensemble", "--gate-factor", "1.5",
                            "--iterations", "3"],
        "ssd_scan": ["--strategy", "ensemble", "--gate-factor", "3.0",
                     "--iterations", "3"],
    }
    path_counts = {"dse": {}}  # path -> (launch counts, route counts)
    picks = {}
    for kernel, shape_name in full.items():
        db_dir = OUT / kernel
        shutil.rmtree(db_dir, ignore_errors=True)
        argv = ["--space", "kernels", "--arch", kernel, "--shape", shape_name,
                *search[kernel], "--budget", "3", "--measure-top-k", "2",
                "--db", str(db_dir / "cost_db.jsonl")]
        ops.reset_launch_counts()
        t = time.perf_counter()
        report = dse.main(argv)
        counts = ops.launch_counts()
        route_counts = ops.route_launch_counts()
        path_counts["dse"][kernel] = (counts, route_counts)
        rows = CostDB(db_dir / "cost_db.jsonl").all()
        statuses = {st: sum(d.status == st for d in rows)
                    for st in sorted({d.status for d in rows})}
        print(f"main path {kernel}/{shape_name} ({' '.join(search[kernel])}): "
              f"{time.perf_counter() - t:.1f} s, {len(rows)} rows {statuses}, "
              f"launches {counts} by route {route_counts}", flush=True)
        if "gate" in report:
            g = report["gate"]
            print(f"gate {kernel}: active={g['active']} pruned={g['pruned']} "
                  f"val_rmse={g['val_rmse']:.3f} n={g['n']}", flush=True)
        if counts[kernel] == 0:
            fail(f"{kernel}: the main path launched its kernel no time")
        new_route = {"flash_attention": "wgmma", "rmsnorm": "registers",
                     "ssd_scan": "wgmma"}.get(kernel)
        if new_route and route_counts.get(f"{kernel}/{new_route}", 0) == 0:
            fail(f"{kernel}: the main path never launched the {new_route} kernel")
        if any(d.status == "error" for d in rows):
            fail(f"{kernel}: error rows: {[d.reason for d in rows if d.status == 'error']}")
        checked = [d for d in rows if d.fidelity == "dryrun" and d.status == "ok"]
        measured = [d for d in rows if d.fidelity == "measured"]
        if not checked or report["best"] is None:
            fail(f"{kernel}: no candidate passed the gate")
        if not measured or any(d.status != "ok" or d.metrics["backend"] != "cuda"
                               for d in measured):
            fail(f"{kernel}: measured rows must be ok on cuda: "
                 f"{[(d.status, d.metrics.get('backend')) for d in measured]}")
        picks[kernel] = report["best"]["point"]
        print(f"pick {kernel}: {report['best']['point']} (model); measured "
              + ", ".join(f"{ {k: v for k, v in d.point.items() if k != '__key__'} } "
                          f"{d.metrics['measured_us']:.2f} us" for d in measured), flush=True)
        for d in checked + measured:
            err = d.metrics["max_abs_err"]
            if not (math.isfinite(err) and err <= d.metrics["tol"]):
                fail(f"{kernel}: row {d.point} max|err| {err} beyond tol")

        shape = KERNEL_SHAPE_BY_NAME[shape_name]
        default = baseline_kernel_point(shape, KernelTemplate(shape)).dims
        dim, val = next((k, v) for k, v in default.items() if k != "causal")
        os.environ[conformance.INJECT_ENV] = f"{kernel}:{dim}={val}"
        try:
            bad_dir = OUT / f"{kernel}_inject"
            shutil.rmtree(bad_dir, ignore_errors=True)
            dse.main(["--space", "kernels", "--arch", kernel, "--shape", shape_name,
                      "--iterations", "0", "--db", str(bad_dir / "cost_db.jsonl")])
        finally:
            del os.environ[conformance.INJECT_ENV]
        base = CostDB(bad_dir / "cost_db.jsonl").all()[0]
        if base.status != "infeasible" or not base.reason.startswith("correctness gate"):
            fail(f"{kernel}: injected bad default gave {base.status}: {base.reason}")
        print(f"gate {kernel}: injected {dim}={val} -> infeasible ({base.reason})",
              flush=True)

    # ---- phase 3b: one kernel campaign over every CI and full-width cell ----
    camp_dir = OUT / "campaign"
    shutil.rmtree(camp_dir, ignore_errors=True)
    camp_shapes = [s.name for s in CI_KERNEL_SHAPES] + list(full.values())
    camp_argv = ["--space", "kernels", "--archs", "all", "--shapes", ",".join(camp_shapes),
                 "--strategy", "ensemble", "--gate-factor", "3.0", "--iterations", "3",
                 "--budget", "3", "--measure-top-k", "2", "--out", str(camp_dir)]
    ops.reset_launch_counts()
    t = time.perf_counter()
    summary = campaign.main(camp_argv)
    camp_wall = time.perf_counter() - t
    counts, route_counts = ops.launch_counts(), ops.route_launch_counts()
    path_counts["campaign"] = (counts, route_counts)
    print(f"campaign launches {counts} by route {route_counts}", flush=True)
    for kernel in full:
        if counts[kernel] == 0:
            fail(f"campaign: {kernel} was launched no time")
    for key in ("flash_attention/wgmma", "ssd_scan/wgmma", "rmsnorm/registers"):
        if route_counts.get(key, 0) == 0:
            fail(f"campaign: {key} was launched no time")
    rows = CostDB(camp_dir / "cost_db.jsonl").all()
    if any(d.status == "error" for d in rows):
        fail(f"campaign: error rows: {[d.reason for d in rows if d.status == 'error']}")
    measured = [d for d in rows if d.fidelity == "measured"]
    if not measured or any(d.status != "ok" or d.metrics["backend"] != "cuda"
                           for d in measured):
        fail(f"campaign: measured rows must be ok on cuda: "
             f"{[(d.status, d.metrics.get('backend')) for d in measured]}")
    for d in rows:
        if d.fidelity == "dryrun" and d.status == "ok":
            err = d.metrics["max_abs_err"]
            if not (math.isfinite(err) and err <= d.metrics["tol"]):
                fail(f"campaign: {d.shape} {d.point} max|err| {err} beyond tol")
    bench = json.loads((camp_dir / "BENCH_kernels.json").read_text())
    if len(bench["cells"]) != len(camp_shapes) or summary["ran"] != len(camp_shapes):
        fail(f"campaign: {len(bench['cells'])} cells in BENCH_kernels.json, "
             f"{summary['ran']} ran, expected {len(camp_shapes)}")
    statuses = {st: sum(d.status == st and d.fidelity == "dryrun" for d in rows)
                for st in sorted({d.status for d in rows})}
    print("campaign record " + json.dumps({
        "wall_s": round(camp_wall, 3), "cells": summary["ran"], "rows": len(rows),
        "dryrun_rows_by_status": statuses, "measured_rows": len(measured),
        "evaluations": summary["evaluations"], "compiles": summary["compiles"],
        "correctness": summary["correctness"], "gate": summary["gate"],
        "card": card}), flush=True)
    for r in json.loads((camp_dir / "leaderboard.json").read_text()):
        rep = json.loads(campaign.cell_report_path(camp_dir, r["arch"], r["shape"],
                                                   r["mesh"]).read_text())
        print(f"campaign cell {r['arch']}/{r['shape']}: {r['n_points']} points, "
              f"{sum(it['pruned'] for it in rep['iterations'])} pruned, bound "
              f"{r['bound_s']} s at {r['best_point']}, measured {r['measured_us']} us "
              f"[{r['measured_backend']}], improvement {r['improvement']}", flush=True)

    # the same command again: every cell resumes, nothing launches or runs
    ops.reset_launch_counts()
    again = campaign.main(camp_argv)
    relaunched = {k: n for k, n in ops.launch_counts().items() if n}
    if (again["resumed"] != len(camp_shapes) or again["ran"] or again["evaluations"]
            or again["compiles"] or again["measured"] or relaunched):
        fail(f"campaign rerun: resumed {again['resumed']}, ran {again['ran']}, "
             f"evaluations {again['evaluations']}, launches {relaunched}")
    print(f"campaign rerun: {again['resumed']} cells resumed, 0 evaluations, "
          f"0 launches", flush=True)

    # one full-width cell under --objective pareto: the front, and its
    # leading members measured
    pareto_dir = OUT / "pareto"
    shutil.rmtree(pareto_dir, ignore_errors=True)
    ops.reset_launch_counts()
    t = time.perf_counter()
    report = dse.main(["--space", "kernels", "--arch", "flash_attention",
                       "--shape", full["flash_attention"], "--strategy", "ensemble",
                       "--iterations", "3", "--budget", "3", "--measure-top-k", "2",
                       "--objective", "pareto", "--db", str(pareto_dir / "cost_db.jsonl")])
    pareto_wall = time.perf_counter() - t
    counts, route_counts = ops.launch_counts(), ops.route_launch_counts()
    path_counts["pareto_cell"] = (counts, route_counts)
    off_route = {k: n for k, n in route_counts.items() if n and k != "flash_attention/wgmma"}
    if route_counts.get("flash_attention/wgmma", 0) == 0 or off_route:
        fail(f"pareto cell: launches {route_counts} are not all on flash_attention/wgmma")
    if not report.get("front"):
        fail("pareto cell: no front")
    rows = CostDB(pareto_dir / "cost_db.jsonl").all()
    measured = [d for d in rows if d.fidelity == "measured"]
    if not measured or any(d.status != "ok" or d.metrics["backend"] != "cuda"
                           for d in measured):
        fail(f"pareto cell: measured rows must be ok on cuda: "
             f"{[(d.status, d.metrics.get('backend')) for d in measured]}")
    print(f"pareto cell flash_attention/{full['flash_attention']}: {pareto_wall:.1f} s, "
          f"{len(rows)} rows, launches by route {route_counts}", flush=True)
    for f in report["front"]:
        print(f"pareto front {f['point']}: objectives {f['objectives']}, crowding "
              f"{f['crowding']}", flush=True)
    for d in measured:
        print(f"pareto measured { {k: v for k, v in d.point.items() if k != '__key__'} }: "
              f"{d.metrics['measured_us']:.2f} us (modelled "
              f"{d.metrics['bound_s_modeled'] * 1e6:.2f} us) [{card}]", flush=True)

    # ---- phase 4: times at each full-width default point ----
    results = []
    for kernel, shape_name in full.items():
        shape = KERNEL_SHAPE_BY_NAME[shape_name]
        dims = baseline_kernel_point(shape, KernelTemplate(shape)).dims
        inputs = conformance.make_inputs(shape, device=dev)
        p = shape.params
        if kernel == "vecmul":
            x, y = inputs
            run = lambda: vm.vecmul_cuda(x, y, block=dims["block"])  # noqa: E731
            lib = lambda: torch.mul(x, y)  # noqa: E731
            nbytes, flops = 3 * x.numel() * x.element_size(), x.numel()
        elif kernel == "rmsnorm":
            x, w = inputs
            run = lambda: rn.rmsnorm_cuda(x, w, block_rows=dims["block_rows"])  # noqa: E731
            lib = lambda: F.rms_norm(x, (p["d"],), w, eps=1e-5)  # noqa: E731
            nbytes = (2 * x.numel() + w.numel()) * x.element_size()
            flops = 4 * x.numel()
        elif kernel == "ssd_scan":
            run = lambda: ssd.ssd_scan_cuda(*inputs, chunk=dims["chunk"])  # noqa: E731
            lib = None  # no one PyTorch call computes the SSD scan
            bound_ms, bound_by = ssd_bound(p, dims["chunk"], inputs[0].element_size())
        else:
            q, k, v = inputs
            run = lambda: fa.flash_attention_cuda(  # noqa: E731
                q, k, v, causal=dims["causal"], block_q=dims["block_q"],
                block_k=dims["block_k"])
            qh, kh_, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh_, vh, is_causal=dims["causal"], enable_gqa=True)
            sq, sk = p["sq"], p["sk"]
            pairs = (sum(min(sk, i + 1) for i in range(sq)) if dims["causal"]
                     else sq * sk)
            flops = 4 * p["d"] * p["b"] * p["h"] * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        agree = conformance.agree_with_plain(
            run(), conformance.run_plain(shape, dims, inputs))
        if not agree["passed"]:
            fail(f"{kernel} at its default point: kernel vs plain {agree}")
        err = agree["max_abs_err"]
        if kernel != "ssd_scan":
            t_bytes = nbytes / H100_SXM.hbm_bw
            t_ops = flops / peak_flops(H100_SXM, shape.dtype)
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ms = time_ms(run)
        plain_ms = time_ms(lambda: conformance.run_plain(shape, dims, inputs),
                           budget_s=0.5, max_reps=10)
        library_ms = time_ms(lib) if lib is not None else None
        mod = modules[kernel]
        kernel_route = kernel_space_route(shape, dims)
        source = (mod.SOURCES[kernel_route] if kernel in ("flash_attention", "ssd_scan")
                  else mod.SOURCE)
        n_launches, n_by_path = launches_of(path_counts, kernel, kernel_route)
        results.append({
            "name": kernel, "route": "cuda", "kernel_route": kernel_route, "source": source,
            "replaces": mod.REPLACES, "launches": n_launches, "launches_by_path": n_by_path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        })
        lib_txt = f"{library_ms:.4f} ms" if library_ms is not None else "none"
        print(f"time {kernel} {shape_name} {dims}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_txt}, bound {bound_ms:.4f} ms "
              f"({results[-1]['bound_by']}), {100 * bound_ms / ms:.1f}% of bound "
              f"[{card}]", flush=True)
        del inputs

    # the flash kernel at every feasible full-width tile, beside the
    # resource model's estimate, SDPA and the bound for the same mask
    shape = KERNEL_SHAPE_BY_NAME[full["flash_attention"]]
    p = shape.params
    q, k, v = conformance.make_inputs(shape, device=dev)
    qh, kh_, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    for causal in (True, False):
        pairs = (sum(min(p["sk"], i + 1) for i in range(p["sq"])) if causal
                 else p["sq"] * p["sk"])
        flops = 4 * p["d"] * p["b"] * p["h"] * pairs
        bound_ms = max(flops / peak_flops(H100_SXM, shape.dtype),
                       (2 * q.numel() + k.numel() + v.numel()) * 2 / H100_SXM.hbm_bw) * 1e3
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh_, vh, is_causal=causal, enable_gqa=True))
        for dims in tile_grid(shape):
            res = kernel_resources(shape, dims)
            if not res.feasible or dims["causal"] != causal:
                continue
            ms = time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=causal, block_q=dims["block_q"],
                block_k=dims["block_k"]), max_reps=50)
            regs, local = (fa.wgmma_attributes(p["d"], dims["block_q"], dims["block_k"])
                           if res.route == "wgmma" else (0, 0))
            print(f"sweep flash_attention {dims}: kernel {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, modelled {res.est_latency_us / 1e3:.4f} ms, "
                  f"SDPA {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms, route {res.route}, "
                  f"smem {res.vmem_bytes} B, registers {res.regs_per_thread} modelled / "
                  f"{regs} compiled ({local} B local), {res.threads} threads, "
                  f"{res.blocks_per_sm} CTAs/SM [{card}]", flush=True)
    del q, k, v, qh, kh_, vh

    # rmsnorm at every block_rows, beside F.rms_norm and the bound, and the
    # same rows on the two-pass path, which the wrapper does not take here
    shape = KERNEL_SHAPE_BY_NAME[full["rmsnorm"]]
    x, w = conformance.make_inputs(shape, device=dev)
    bound_ms = (2 * x.numel() + w.numel()) * x.element_size() / H100_SXM.hbm_bw * 1e3
    lib_ms = time_ms(lambda: F.rms_norm(x, (x.shape[1],), w, eps=1e-5))

    def two_pass(block_rows):
        out = torch.empty_like(x)
        _build.check("rmsnorm_launch", _build.library().rmsnorm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            block_rows, 1e-5, _build.dtype_code(x), rn.PATH_CODES["two-pass"], 0,
            rn.THREADS, rn.smem_bytes(x.shape[1]), _build.stream_ptr(dev)))
        return out

    for dims in tile_grid(shape):
        res = kernel_resources(shape, dims)
        br = dims["block_rows"]
        agree = conformance.agree_with_plain(two_pass(br), rn.rmsnorm_plain(x, w, block_rows=br))
        if not agree["passed"]:
            fail(f"rmsnorm two-pass at block_rows={br}: {agree}")
        ms = time_ms(lambda: rn.rmsnorm_cuda(x, w, block_rows=br))
        tp_ms = time_ms(lambda: two_pass(br))
        tag = " (the DSE's pick)" if dims == picks["rmsnorm"] else ""
        print(f"sweep rmsnorm {dims}{tag}: kernel {ms:.4f} ms, {100 * bound_ms / ms:.1f}% of "
              f"bound {bound_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, modelled "
              f"{res.est_latency_us / 1e3:.4f} ms, route {res.route}, "
              f"{res.blocks_per_sm} CTAs/SM; two-pass {tp_ms:.4f} ms [{card}]", flush=True)
    del x, w

    # and the SSD scan's at every chunk: its route, each launch's share from
    # the profiler (the mean over 3 calls), the compiled registers of the
    # wgmma kernel, and the resource model's estimate
    shape = KERNEL_SHAPE_BY_NAME[full["ssd_scan"]]
    p = shape.params
    inputs = conformance.make_inputs(shape, device=dev)
    for dims in tile_grid(shape):
        res = kernel_resources(shape, dims)
        L = dims["chunk"]
        run = lambda: ssd.ssd_scan_cuda(*inputs, chunk=L)  # noqa: E731
        ms = time_ms(run, max_reps=20)
        split = ssd_launch_split(run)
        regs, local = (ssd.wgmma_attributes(L, p["N"], p["dh"]) if res.route == "wgmma"
                       else (0, 0))
        bound_ms, _ = ssd_bound(p, L, 2)
        print(f"sweep ssd_scan {dims}: kernel {ms:.4f} ms ("
              + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(split.items()))
              + f"), bound {bound_ms:.4f} ms, modelled {res.est_latency_us / 1e3:.4f} ms, "
              f"route {res.route}, smem {res.vmem_bytes} B, registers {res.regs_per_thread} "
              f"modelled / {regs} compiled ({local} B local), {res.blocks_per_sm} "
              f"CTAs/SM [{card}]", flush=True)
    # the FMA route on the main path (chunk 32, wgmma's M being 64, and the
    # campaign's f32 cell): its own entry beside the wgmma one, timed at
    # full width
    n_fma, n_fma_by = launches_of(path_counts, "ssd_scan", "fma")
    if n_fma:
        dims = {"chunk": max(d["chunk"] for d in tile_grid(shape)
                             if kernel_resources(shape, d).route == "fma")}
        run = lambda: ssd.ssd_scan_cuda(*inputs, chunk=dims["chunk"])  # noqa: E731
        agree = conformance.agree_with_plain(run(), conformance.run_plain(shape, dims, inputs))
        if not agree["passed"]:
            fail(f"ssd_scan fma at {dims}: kernel vs plain {agree}")
        bound_ms, bound_by = ssd_bound(p, dims["chunk"], 2)
        ms = time_ms(run, max_reps=20)
        plain_ms = time_ms(lambda: conformance.run_plain(shape, dims, inputs),
                           budget_s=0.5, max_reps=10)
        results.append({
            "name": "ssd_scan/fma", "route": "cuda", "kernel_route": "fma",
            "source": ssd.SOURCES["fma"], "replaces": ssd.REPLACES, "launches": n_fma,
            "launches_by_path": n_fma_by, "max_abs_err": agree["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        print(f"time ssd_scan/fma {shape.name} {dims}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms, {n_fma} launches on the main "
              f"path [{card}]", flush=True)
    del inputs

    # flash attention's FMA kernel, which the campaign's f32 cell runs: its
    # own entry, timed at that cell's default tile
    n_fma, n_fma_by = launches_of(path_counts, "flash_attention", "fma")
    if n_fma:
        shape = KERNEL_SHAPE_BY_NAME["attn_s128_f32"]
        p = shape.params
        dims = baseline_kernel_point(shape, KernelTemplate(shape)).dims
        if kernel_space_route(shape, dims) != "fma":
            fail(f"flash_attention at {shape.name} {dims} is not on the fma route")
        q, k, v = conformance.make_inputs(shape, device=dev)
        run = lambda: fa.flash_attention_cuda(  # noqa: E731
            q, k, v, causal=dims["causal"], block_q=dims["block_q"], block_k=dims["block_k"])
        agree = conformance.agree_with_plain(run(), conformance.run_plain(shape, dims,
                                                                          (q, k, v)))
        if not agree["passed"]:
            fail(f"flash_attention fma at {dims}: kernel vs plain {agree}")
        qh, kh_, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = (sum(min(p["sk"], i + 1) for i in range(p["sq"])) if dims["causal"]
                 else p["sq"] * p["sk"])
        t_ops = 4 * p["d"] * p["b"] * p["h"] * pairs / peak_flops(H100_SXM, shape.dtype)
        t_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() / H100_SXM.hbm_bw
        ms = time_ms(run)
        plain_ms = time_ms(lambda: conformance.run_plain(shape, dims, (q, k, v)),
                           budget_s=0.5, max_reps=10)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh_, vh, is_causal=dims["causal"], enable_gqa=True))
        results.append({
            "name": "flash_attention/fma", "route": "cuda", "kernel_route": "fma",
            "source": fa.SOURCES["fma"], "replaces": fa.REPLACES, "launches": n_fma,
            "launches_by_path": n_fma_by, "max_abs_err": agree["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms})
        print(f"time flash_attention/fma {shape.name} {dims}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{results[-1]['bound_ms']:.5f} ms, {n_fma} launches on the main path "
              f"{n_fma_by} [{card}]", flush=True)
        del q, k, v, qh, kh_, vh

    # zamba2-2.7b's widths (80 heads of 64, d_state 64) on the wgmma route,
    # against the plain version and timed
    shape = KernelShape("ssd_zamba2_2_7b_b8_s4096_bf16", "ssd_scan",
                        {"b": 8, "s": 4096, "nh": 80, "dh": 64, "N": 64}, "bfloat16")
    inputs = conformance.make_inputs(shape, device=dev)
    for L in ssd.WGMMA_CHUNKS:
        before = _build.LAUNCHES["ssd_scan/wgmma"]
        agree = conformance.agree_with_plain(ssd.ssd_scan_cuda(*inputs, chunk=L),
                                             ssd.ssd_scan_plain(*inputs, chunk=L))
        if not agree["passed"] or _build.LAUNCHES["ssd_scan/wgmma"] != before + 1:
            fail(f"{shape.name} chunk={L} on wgmma: kernel vs plain {agree}")
        ms = time_ms(lambda: ssd.ssd_scan_cuda(*inputs, chunk=L), max_reps=20)
        bound_ms, bound_by = ssd_bound(shape.params, L, 2)
        res = kernel_resources(shape, {"chunk": L})
        print(f"time ssd_scan {shape.name} chunk={L}: kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of bound, "
              f"modelled {res.est_latency_us / 1e3:.4f} ms, row check err/limit "
              f"{agree['ratio']:.3g} [{card}]", flush=True)
    del inputs

    # ---- phase 5: plan cells ----
    plan_cells(card)

    # ---- phase 6: train cells ----
    train_cells(card)

    # ---- phase 7: the plan loop and the §4 demo ----
    path_counts["loop"] = plan_loop(card)

    # ---- phase 8: the other model families ----
    other_families(card)

    # ---- phase 9: the plan campaign and its supervisor ----
    path_counts["plan_campaign"] = plan_campaign(card)
    for r in results:
        kernel, route = r["name"].split("/")[0], r["kernel_route"]
        r["launches"], r["launches_by_path"] = launches_of(path_counts, kernel, route)

    print(json.dumps({"kernels": results}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
