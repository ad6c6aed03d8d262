"""The port's dry run of the five families beyond dense against the
reference's, at ``reduced`` sizes on the 2x4 mesh, one train, one prefill
and one decode cell per arch (the reference runs them in one subprocess
with 8 forced host devices): here the MoE archs, mixtral's prefill under
each ``expert_rule`` and the full-size ``long_500k`` statuses; the SSM
and hybrid archs in ``tests/test_torch_dryrun_families_ssm.py``, the
VLM and encoder-decoder ones in
``tests/test_torch_dryrun_families_frontend.py``
(``torch_dryrun_parity.py`` holds the comparison).

Held equal: MODEL_FLOPS, argument bytes (less the parameters a step never
reads, which ``jax.jit`` prunes from its arguments: a decode step's
frontend projection and encoder), alias bytes (less the incoming cross-KV
at an encoder-decoder prefill: the reference builds it anew, which jit
prunes, and the port writes it in place), output bytes up to XLA's output
tuple table (8 bytes a leaf), and the record's keys. Within 10%: FLOPs.
Within ``WIRE_FACTOR`` (4x) of the reference's: wire bytes per device (a
train cell's against half of them: XLA:CPU moves a bf16 model's
activations in f32), every expert rule's too; at most 1.01x the
reference's: a train cell's temp bytes.
The collective kinds may differ only as named: the port reduce-scatters
where XLA:CPU all-reduces (Megatron-SP's row-parallel sums, ZeRO-1's
gradients), and never runs XLA's all-to-all or collective-permute
(DTensor moves a shard between tensor dims by all-gather and chunk on a
CPU-typed mesh; attention and the SSD stay head-local, where GSPMD
reshards them to the sequence)."""
import pytest
from torch_dryrun_parity import (CELLS, EXPERT_RULES, FLOPS_REL, PORT_ONLY, REFERENCE_ONLY,
                                 cell, check_bytes_moved, check_record, reference_records)

from repro_torch.configs import SHAPE_BY_NAME, get_config, reduced
from repro_torch.core.design_space import PlanPoint, point_to_plan
from repro_torch.launch import dryrun
from repro_torch.launch.campaign import make_campaign_mesh
from repro_torch.models import model as TM

ARCHS = ["mixtral-8x7b", "qwen3-moe-235b-a22b"]
ALL = ARCHS + ["llava-next-34b", "mamba2-780m", "zamba2-2.7b", "seamless-m4t-medium"]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return reference_records(tmp_path_factory.mktemp("ref"), ARCHS, EXPERT_RULES)


@pytest.fixture(scope="module")
def mesh():
    return make_campaign_mesh("small")


@pytest.mark.parametrize("shape", list(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_small_mesh_record_matches_the_reference(arch, shape, refs, mesh, tmp_path):
    check_record(arch, shape, refs[f"{arch}/{shape}"], *mesh, tmp_path)


@pytest.mark.parametrize("rule", EXPERT_RULES)
def test_every_expert_rule_traces_as_the_reference(rule, refs, mesh, tmp_path):
    m, name = mesh
    cfg, c = reduced(get_config("mixtral-8x7b")), cell("prefill_32k")
    plan = point_to_plan(cfg, c, PlanPoint({"expert_rule": rule}), name="er-" + rule)
    assert plan.rules["experts"] == ("model" if rule == "experts" else None)
    assert plan.rules["expert_ffn"] == ("model" if rule == "expert_ffn" else None)
    ref = refs[f"rule/{rule}"]
    rec = dryrun.run_cell("mixtral-8x7b", "prefill_32k", m, name, plan, tmp_path,
                          cfg=cfg, cell=c)
    assert ref["status"] == rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    assert rec["hlo"]["flops"] == pytest.approx(ref["hlo"]["flops"], rel=FLOPS_REL)
    port, want = set(rec["hlo"]["collect_bytes"]), set(ref["hlo"]["collect_bytes"])
    assert port - want <= PORT_ONLY and want - port <= REFERENCE_ONLY, (port, want)
    check_bytes_moved(rec, ref, "prefill_32k")


def test_long_500k_runs_for_the_sub_quadratic_archs(mesh, tmp_path):
    """Full size on the 2x4 mesh: ``ok`` for mamba2-780m, zamba2-2.7b and
    mixtral-8x7b (its 4096-token window), ``skipped`` for the rest, as the
    reference's ``cell_supported`` says."""
    m, name = mesh
    for arch in ALL:
        rec = dryrun.run_cell(arch, "long_500k", m, name, artifact_dir=tmp_path)
        want = "ok" if get_config(arch).sub_quadratic() else "skipped"
        assert rec["status"] == want, (arch, rec.get("error"))
        if want == "ok":
            assert rec["hlo"]["flops"] > 0 and rec["memory"]["fits_hbm"]
    # the window bounds mixtral's cache at 4096 positions of the 524288
    cache = TM.abstract_cache(get_config("mixtral-8x7b"), 1, SHAPE_BY_NAME["long_500k"].seq_len)
    assert cache["k"].shape[2] == 4096
    cache = TM.abstract_cache(get_config("zamba2-2.7b"), 1, SHAPE_BY_NAME["long_500k"].seq_len)
    assert cache["attn"]["k"].shape == (9, 1, 524288, 32, 80)
