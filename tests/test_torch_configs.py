"""repro_torch.configs is a copy of the reference's: every architecture,
shape cell and reduced config field for field, with the same analytic
parameter counts."""
import dataclasses

import pytest

from repro import configs as jc
from repro_torch import configs as tc


def test_registry_and_shapes_match():
    assert tc.ARCH_NAMES == jc.ARCH_NAMES
    assert [dataclasses.astuple(s) for s in tc.SHAPES] == \
        [dataclasses.astuple(s) for s in jc.SHAPES]
    assert {k: dataclasses.astuple(v) for k, v in tc.SHAPE_BY_NAME.items()} == \
        {k: dataclasses.astuple(v) for k, v in jc.SHAPE_BY_NAME.items()}


@pytest.mark.parametrize("arch", jc.ARCH_NAMES)
def test_arch_config_matches_field_for_field(arch):
    want, got = jc.get_config(arch), tc.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert got.head_dim() == want.head_dim()
    assert got.sub_quadratic() == want.sub_quadratic()
    small_want, small_got = jc.reduced(want), tc.reduced(got)
    assert dataclasses.asdict(small_got) == dataclasses.asdict(small_want)
    assert small_got.n_params() == small_want.n_params()
    assert dataclasses.asdict(tc.reduced(got, n_layers=3, dtype="bfloat16")) == \
        dataclasses.asdict(jc.reduced(want, n_layers=3, dtype="bfloat16"))


def test_unknown_arch_is_refused():
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_config("gpt-17")
