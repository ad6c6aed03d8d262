"""The dry-run parity of ``tests/test_torch_dryrun_families.py`` for the
archs with a frontend stub, VLM and encoder-decoder (llava-next-34b and
seamless-m4t-medium): one train, one prefill and one decode cell each at
``reduced`` size on the 2x4 mesh against the reference's, with the
allowances ``torch_dryrun_parity.check_record`` names."""
import pytest
from torch_dryrun_parity import CELLS, check_record, reference_records

from repro_torch.launch.campaign import make_campaign_mesh

ARCHS = ["llava-next-34b", "seamless-m4t-medium"]


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
