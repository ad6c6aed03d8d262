"""The dry-run parity of ``tests/test_torch_dryrun_families.py`` for the
SSM and hybrid archs (mamba2-780m and zamba2-2.7b): one train, one
prefill and one decode cell each at ``reduced`` size on the 2x4 mesh
against the reference's, with the allowances
``torch_dryrun_parity.check_record`` names."""
import pytest
from torch_dryrun_parity import CELLS, check_record, reference_records

from repro_torch.launch.campaign import make_campaign_mesh

ARCHS = ["mamba2-780m", "zamba2-2.7b"]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return reference_records(tmp_path_factory.mktemp("ref"), ARCHS)


@pytest.fixture(scope="module")
def mesh():
    return make_campaign_mesh("small")


@pytest.mark.parametrize("shape", list(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_small_mesh_record_matches_the_reference(arch, shape, refs, mesh, tmp_path):
    check_record(arch, shape, refs[f"{arch}/{shape}"], *mesh, tmp_path)


@pytest.mark.parametrize("shape", list(CELLS))
def test_hybrid_traces_under_head_dim_plans(shape, mesh, tmp_path):
    """zamba2's shared block with its LoRA under ``attn_rule=head_dim``
    (attention sharded on head_dim): the LoRA deltas are contracted as
    their projections are (q, k, v) or after gathering head_dim (the
    output), where flattening a head_dim-sharded pair fails, forward or
    backward."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.design_space import (PlanPoint, PlanTemplate, baseline_point,
                                               point_to_plan)
    from repro_torch.launch import dryrun
    from torch_dryrun_parity import cell

    m, name = mesh
    cfg, c = reduced(get_config("zamba2-2.7b")), cell(shape)
    base = baseline_point(c, PlanTemplate(cfg, c, dict(zip(m.mesh_dim_names, m.mesh.shape))))
    plan = point_to_plan(cfg, c, PlanPoint({**base.dims, "attn_rule": "head_dim"}))
    assert plan.rules["head_dim"] == "model" and plan.rules["heads"] is None
    rec = dryrun.run_cell("zamba2-2.7b", shape, m, name, plan, tmp_path, cfg=cfg, cell=c)
    assert rec["status"] == "ok", rec.get("error")
