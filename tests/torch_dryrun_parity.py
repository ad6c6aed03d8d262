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
FLOPS_REL = 0.10
#: the port's wire bytes per device lie within this factor of the
#: reference's: a plan that moves a cache or a weight it need not (a
#: gathered KV cache is thousands of times the reference's bytes) fails
WIRE_FACTOR = 4.0
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
    assert rec["hlo"]["flops"] == pytest.approx(ref["hlo"]["flops"], rel=FLOPS_REL)
    port, want = set(rec["hlo"]["collect_bytes"]), set(ref["hlo"]["collect_bytes"])
    assert port - want <= PORT_ONLY and want - port <= REFERENCE_ONLY, (port, want)
    assert rec["hlo"]["wire_bytes_total"] > 0
    check_bytes_moved(rec, ref, shape)


def check_bytes_moved(rec, ref, shape):
    """Wire bytes per device within ``WIRE_FACTOR`` of the reference's (a
    train cell's against ``REFERENCE_F32_WIRE`` of them), and a train
    cell's temp bytes within ``FAMILY_TRAIN_TEMP_FACTOR`` of the
    reference's. ``pytest -s`` prints both ratios (the numbers PERF.md
    quotes)."""
    wire = rec["hlo"]["wire_bytes_total"] / ref["hlo"]["wire_bytes_total"]
    temp = rec["memory"]["temp_bytes"] / ref["memory"]["temp_bytes"]
    print(f"{rec['arch']} {shape} {rec['plan']}: wire {wire:.4g}, temp {temp:.4g} "
          f"of the reference's")
    if shape == "train_4k":
        wire /= REFERENCE_F32_WIRE
        assert temp <= FAMILY_TRAIN_TEMP_FACTOR, temp
    assert 1 / WIRE_FACTOR <= wire <= WIRE_FACTOR, wire
