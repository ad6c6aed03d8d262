"""Shared parts of the dry-run parity tests of the five families beyond
dense (``tests/test_torch_dryrun_families*.py``): the reduced cells, the
reference's records from one subprocess with 8 forced host devices, and
the record comparison with its named allowances (see
``tests/test_torch_dryrun_families.py``)."""
import json

import pytest

from conftest import run_subprocess
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.models import model as TM

#: decode at batch 16 on 2 data shards: 8 tokens a shard, fewer than the
#: reduced MoE's group of 16, so the MoE block takes every token on each
#: shard; prefill's 4 x 128 a shard are whole groups, kept where they are
CELLS = {"train_4k": ("train", 128, 8), "prefill_32k": ("prefill", 128, 8),
         "decode_32k": ("decode", 128, 16)}
EXPERT_RULES = ("experts", "expert_ffn", "none")
PORT_ONLY = {"reduce-scatter"}
REFERENCE_ONLY = {"all-to-all", "collective-permute"}
#: per-device FLOPs of the port less the reference's, each reduced cell on
#: the 2x4 mesh (and mixtral ``prefill_32k`` under each ``expert_rule``),
#: held exactly; 0 where not listed. Read by product signature (result
#: elements, contraction) against the reference's HLO dots; the causes:
#:   * MoE ``prefill_32k`` (and ``expert_rule=experts``): the port routes
#:     every token of its data shard on each model shard, where the
#:     reference splits them over the 4 model shards: 3/4 of the router's
#:     2 * 512 tokens * 64 * 4 experts * 2 layers;
#:   * MoE ``decode_32k``: a data shard's 8 tokens are fewer than the MoE
#:     group (16), so every device routes, dispatches and combines the
#:     whole group: the router on 16 tokens where the reference's routes 2
#:     a device (+14336), dispatch and combine contracting 16 tokens where
#:     the reference's contract 8 (+40960); the expert FFNs are equal;
#:   * SSM and hybrid ``prefill_32k``: the chunk's C·Bᵀ runs over the whole
#:     d_state on each model shard (the core takes B and C whole), where
#:     the reference splits d_state over the model axis: 3/4 of 2 * 4 * 8
#:     chunks * 16 * 16 * 16 * 2 layers (+393216); zamba2's shared block
#:     also runs its rank-4 LoRA products over every local token on each
#:     model shard, 2097152 FLOPs where the reference's sequence-parallel
#:     layout has 917504 (+1179648);
#:   * train: the reference's kv-block checkpoint, nested in the q-chunk
#:     checkpoint, computes one more P·V-shaped product per attention use
#:     (-4194304 for two layers; -2097152 for zamba2's one shared use), and
#:     its remat one more ffn-contracted product per MLP (-2097152; zamba2
#:     the other way, +2097152, with its Mamba out_proj); the port's
#:     vocab-parallel loss adds one [512 x 128] product of contraction 8 in
#:     backward (+1048576; MoE two smaller ones, +1048576); MoE also routes
#:     on every model shard (+1048576) and dispatches and combines over
#:     whole groups (+1310720) less the reference's expert weight-gradient
#:     split (-393216); SSM and hybrid: C·Bᵀ whole (+2097152 with its
#:     backward) against the reference's SSD backward, which contracts its
#:     3-operand einsums in more products (-3801088); zamba2's LoRA
#:     products on every model shard (+6291456 with their gradients).
FLOPS_EXTRA = {
    ("mixtral-8x7b", "prefill_32k"): 393216, ("qwen3-moe-235b-a22b", "prefill_32k"): 393216,
    ("mixtral-8x7b", "decode_32k"): 55296, ("qwen3-moe-235b-a22b", "decode_32k"): 55296,
    ("mamba2-780m", "prefill_32k"): 393216, ("zamba2-2.7b", "prefill_32k"): 1572864,
    ("llava-next-34b", "train_4k"): -5242880, ("seamless-m4t-medium", "train_4k"): -5783552,
    ("mixtral-8x7b", "train_4k"): -1179648, ("qwen3-moe-235b-a22b", "train_4k"): -1179648,
    ("mamba2-780m", "train_4k"): -1703936, ("zamba2-2.7b", "train_4k"): 2752512,
    ("rule/experts", "prefill_32k"): 393216,
}
#: the port's wire bytes per device lie within this factor of the
#: reference's: a plan that moves a cache or a weight it need not (a
#: gathered KV cache is thousands of times the reference's bytes) fails
WIRE_FACTOR = 4.0
#: an SSM or hybrid decode step moves the Mamba core's gathers
#: (``ssm_core_gather_bytes``) and, for the rest of the step, at most this
#: share of the reference's wire bytes (mamba2 0.319, zamba2 0.490; the
#: dense decode 0.547 of a reference that all-reduces where the port
#: reduce-scatters)
SSM_DECODE_REST = 0.5
#: XLA:CPU runs every collective of the reference in f32 (its train HLO
#: all-gathers and all-reduces the [128, 4096, 1024] activations as f32),
#: where the port moves a bf16 model's activations and gradients in bf16:
#: the train cell's wire bytes are held to the reference's at this scale
REFERENCE_F32_WIRE = 0.5
#: the port's train temp bytes over the reference's: the dense family's
#: stay at or under it (``tests/test_torch_dryrun.py``: a loss that
#: gathers the f32 logits over their vocab shards reads 4.75x and fails)
TRAIN_TEMP_FACTOR = 1.0
#: the same for the five other families, whose reduced cells read 0.83x
#: (seamless-m4t-medium) to 1.0021x (mamba2-780m, the only one above 1x)
FAMILY_TRAIN_TEMP_FACTOR = 1.01


def cell(shape):
    kind, s, b = CELLS[shape]
    return ShapeCell(shape, kind, s, b)


def ssm_core_gather_bytes(arch, shape, data=2, model=4) -> float:
    """Wire bytes per device of the Mamba core's gathers in one reduced
    decode step on the 2x4 mesh: the core runs on local shards over
    ``A_log``'s heads with its input replicated over the model axis, so
    each layer all-gathers (ring: (g - 1)/g of the result) the step's
    ``in_proj`` output [b, 1, 2 di + 2 N + nh], the conv carry
    [b, W - 1, di + 2 N], ``conv_w`` [W, di + 2 N] and ``conv_b``, which the
    plan shards over ``model`` on their channels. The reference keeps the
    depthwise conv channel-sharded and moves a collective-permute and an
    all-to-all (19840 bytes for mamba2) where these gathers stand."""
    import torch

    cfg, c = reduced(get_config(arch)), cell(shape)
    s = cfg.ssm
    di, N, nh, W = s.d_inner(cfg.d_model), s.d_state, s.n_heads(cfg.d_model), s.conv_width
    b, ch = c.global_batch // data, di + 2 * N
    elems = b * (2 * di + 2 * N + nh) + b * (W - 1) * ch + W * ch + ch
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return cfg.n_layers * elems * item * (model - 1) / model


def reference_records(out, archs, rules=()):
    """The reference's records of every (arch, cell) of ``archs`` at
    ``reduced`` size on the 2x4 mesh, and of mixtral's prefill under each
    of ``rules``, keyed ``arch/shape`` and ``rule/<rule>``."""
    stdout = run_subprocess(f"""
        import json, pathlib
        from repro.configs import get_config, reduced
        from repro.configs.base import ShapeCell
        from repro.core.design_space import PlanPoint, point_to_plan
        from repro.launch.dryrun import run_cell
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((2, 4), ("data", "model"))
        out = pathlib.Path(r"{out}")
        recs = {{}}
        for a in {list(archs)!r}:
            for s, (k, n, b) in {CELLS!r}.items():
                recs[a + "/" + s] = run_cell(a, s, mesh, "small2x4", cfg=reduced(get_config(a)),
                                             cell=ShapeCell(s, k, n, b), artifact_dir=out)
        cfg, cell = reduced(get_config("mixtral-8x7b")), ShapeCell("prefill_32k", "prefill", 128, 8)
        for r in {tuple(rules)!r}:
            plan = point_to_plan(cfg, cell, PlanPoint({{"expert_rule": r}}), name="er-" + r)
            recs["rule/" + r] = run_cell("mixtral-8x7b", "prefill_32k", mesh, "small2x4", plan,
                                         out, cfg=cfg, cell=cell)
        print("REFS" + json.dumps(recs))
    """, n_devices=8, timeout=600)
    line = next(ln for ln in stdout.splitlines() if ln.startswith("REFS"))
    return json.loads(line[4:])


def _unread_param_bytes(arch, shape, mesh) -> float:
    """Local bytes of the params a step never reads (``jax.jit`` prunes
    them): a decode step's frontend projection and, for encoder-decoder,
    the encoder and the cross-attention's K and V projections (the cache
    holds their products)."""
    if shape != "decode_32k":
        return 0.0
    cfg = reduced(get_config(arch))
    values, axes = TM.abstract_params(cfg)
    plan = dryrun.baseline_plan(cfg, cell(shape))
    unread = [k for k in values if k == "frontend_proj" or k.startswith("enc_blocks.")
              or k in ("ln_enc", "dec_blocks.xattn.wk", "dec_blocks.xattn.wv")]
    total = 0.0
    for k in unread:
        pl = plan.resolve(mesh, values[k].shape, axes[k])
        n = 1
        for d in dryrun.local_shape(mesh, pl, values[k].shape):
            n *= d
        total += n * values[k].element_size()
    return total


def _cross_kv_bytes(arch, shape) -> float:
    """Local bytes of the incoming cross-KV an encoder-decoder prefill
    overwrites (the port aliases it, the reference's jit prunes it)."""
    if arch != "seamless-m4t-medium" or shape != "prefill_32k":
        return 0.0
    cfg, c = reduced(get_config(arch)), cell(shape)
    ck = TM.abstract_cache(cfg, c.global_batch, c.seq_len)["ck"]
    # [L, b, F, kh, dh]: batch over data (2), F over model (4)
    return 2 * ck.numel() * ck.element_size() / 8


def _n_output_leaves(arch, shape) -> int:
    cfg, c = reduced(get_config(arch)), cell(shape)
    cache = TM.abstract_cache(cfg, c.global_batch, c.seq_len)
    return 1 + len(list(dryrun._leaves(cache)))


def check_record(arch, shape, ref, m, name, out):
    """The port's record of one reduced cell against the reference's
    (written under ``out``)."""
    rec = dryrun.run_cell(arch, shape, m, name, cfg=reduced(get_config(arch)),
                          cell=cell(shape), artifact_dir=out)
    assert ref["status"] == rec["status"] == "ok", rec.get("error")
    for part in ("", "memory", "hlo", "roofline"):
        have, want = (rec, ref) if not part else (rec[part], ref[part])
        assert set(want) <= set(have), part
    assert rec["model_flops"] == ref["model_flops"]
    mem, rmem = rec["memory"], ref["memory"]
    assert mem["argument_bytes"] - _unread_param_bytes(arch, shape, m) \
        - _cross_kv_bytes(arch, shape) == rmem["argument_bytes"]
    assert mem["alias_bytes"] - _cross_kv_bytes(arch, shape) == rmem["alias_bytes"]
    if shape == "train_4k":  # the table over the params, both moments and the metrics
        n = len(TM.abstract_params(reduced(get_config(arch)))[0])
        assert 0 <= rmem["output_bytes"] - mem["output_bytes"] <= 8 * (3 * n + 16)
    else:
        assert rmem["output_bytes"] - mem["output_bytes"] == 8 * _n_output_leaves(arch, shape)
    assert rec["hlo"]["flops"] - ref["hlo"]["flops"] == FLOPS_EXTRA.get((arch, shape), 0)
    port, want = set(rec["hlo"]["collect_bytes"]), set(ref["hlo"]["collect_bytes"])
    assert port - want <= PORT_ONLY and want - port <= REFERENCE_ONLY, (port, want)
    assert rec["hlo"]["wire_bytes_total"] > 0
    check_bytes_moved(rec, ref, shape)


def check_bytes_moved(rec, ref, shape):
    """Wire bytes per device within ``WIRE_FACTOR`` of the reference's (a
    train cell's against ``REFERENCE_F32_WIRE`` of them; an SSM or hybrid
    decode cell's at most the core's gathers plus ``SSM_DECODE_REST`` of
    them), and a train cell's temp bytes within ``FAMILY_TRAIN_TEMP_FACTOR``
    of the reference's. ``pytest -s`` prints the FLOPs, wire and temp
    ratios (the numbers PERF.md quotes)."""
    wire = rec["hlo"]["wire_bytes_total"] / ref["hlo"]["wire_bytes_total"]
    temp = rec["memory"]["temp_bytes"] / ref["memory"]["temp_bytes"]
    flops = rec["hlo"]["flops"] / ref["hlo"]["flops"]
    print(f"{rec['arch']} {shape} {rec['plan']}: flops {flops:.5g}, wire {wire:.4g}, "
          f"temp {temp:.4g} of the reference's")
    if shape == "decode_32k" and reduced(get_config(rec["arch"])).ssm is not None:
        core = ssm_core_gather_bytes(rec["arch"], shape)
        rest = rec["hlo"]["wire_bytes_total"] - core
        print(f"{rec['arch']} {shape}: the core's gathers {core:.0f} B, the rest "
              f"{rest / ref['hlo']['wire_bytes_total']:.4g} of the reference's")
        assert 0 < rest <= SSM_DECODE_REST * ref["hlo"]["wire_bytes_total"], rest
    if shape == "train_4k":
        wire /= REFERENCE_F32_WIRE
        assert temp <= FAMILY_TRAIN_TEMP_FACTOR, temp
    assert 1 / WIRE_FACTOR <= wire <= WIRE_FACTOR, wire
