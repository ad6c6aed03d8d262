"""repro_torch oracles and correctness gate against the reference's: the
oracles agree in f32 and bf16 at the gate's tolerances, make_inputs draws
the reference's numbers, and the gate rejects an injected bad tile; the
tile grid, the plain dispatch and the row-wise kernel-against-plain check."""
import itertools

import numpy as np
import pytest
import torch
from torch_parity import as_np, draw, max_err

from repro.core import kernel_space as jks
from repro.kernels import conformance as jconf
from repro.kernels import ref as jref
from repro_torch.core.kernel_space import (CI_KERNEL_SHAPES, KERNEL_SHAPE_BY_NAME,
                                           tile_grid)
from repro_torch.kernels import conformance, ref
from repro_torch.kernels.flash_attention import flash_attention_plain

DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_vecmul_ref_matches(dtype):
    rng = np.random.default_rng(0)
    (xj, xt), (yj, yt) = draw(rng, 1000, dtype=dtype), draw(rng, 1000, dtype=dtype)
    assert max_err(ref.vecmul_ref(xt, yt), jref.vecmul_ref(xj, yj)) <= \
        conformance.tolerance("vecmul", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_ref_matches(dtype):
    rng = np.random.default_rng(1)
    (xj, xt), (wj, wt) = draw(rng, 37, 96, dtype=dtype), draw(rng, 96, dtype=dtype)
    got = ref.rmsnorm_ref(xt, wt)
    assert got.dtype == xt.dtype
    assert max_err(got, jref.rmsnorm_ref(xj, wj)) <= conformance.tolerance("rmsnorm", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,causal", [(64, 64, True), (32, 96, True),
                                          (64, 64, False)])
def test_attention_ref_matches(dtype, sq, sk, causal):
    rng = np.random.default_rng(2)
    (qj, qt) = draw(rng, 2, sq, 3, 16, dtype=dtype)
    (kj, kt), (vj, vt) = draw(rng, 2, sk, 3, 16, dtype=dtype), draw(rng, 2, sk, 3, 16, dtype=dtype)
    got = ref.attention_ref(qt, kt, vt, causal=causal)
    want = jref.attention_ref(qj, kj, vj, causal=causal)
    assert max_err(got, want) <= conformance.tolerance("flash_attention", dtype)


@pytest.mark.parametrize("name", [s.name for s in CI_KERNEL_SHAPES])
def test_make_inputs_draws_the_reference_numbers(name):
    from repro.core.kernel_space import KERNEL_SHAPE_BY_NAME as JSHAPES

    ours = conformance.make_inputs(KERNEL_SHAPE_BY_NAME[name])
    theirs = jconf.make_inputs(JSHAPES[name])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        # ssd_scan's A is f32 whatever the shape's dtype, as in the reference
        assert a.dtype == conformance._DTYPES[str(b.dtype)]
        # f32 draws are identical; bf16 may round a rare halfway value the
        # other way (torch converts f64 -> f32 -> bf16): one bf16 ulp
        ulp = 0.0 if a.dtype == torch.float32 else 2.0 ** -8 * np.abs(as_np(b)).max()
        assert max_err(a, b) <= ulp


def test_gate_passes_default_and_rejects_injected_bad(monkeypatch):
    shape = KERNEL_SHAPE_BY_NAME["attn_s128_f32"]
    dims = {"block_q": 64, "block_k": 64, "causal": True}
    res = conformance.check_candidate(shape, dims)
    assert res["passed"] and res["max_abs_err"] <= res["tol"]
    monkeypatch.setenv(conformance.INJECT_ENV, "flash_attention:block_q=64")
    bad = conformance.check_candidate(shape, dims)
    assert not bad["passed"] and bad["max_abs_err"] > 0.09


@pytest.mark.parametrize("shape", CI_KERNEL_SHAPES, ids=lambda s: s.name)
def test_tile_grid_is_the_product_of_the_reference_pools(shape):
    pools = jks.legal_kernel_dims(jks.KERNEL_SHAPE_BY_NAME[shape.name])
    keys = sorted(pools)
    want = [dict(zip(keys, c)) for c in itertools.product(*(pools[k] for k in keys))]
    assert tile_grid(shape) == want


@pytest.mark.parametrize("name", [s.name for s in CI_KERNEL_SHAPES])
def test_run_plain_is_what_a_cpu_candidate_runs(name):
    shape = KERNEL_SHAPE_BY_NAME[name]
    inputs = conformance.make_inputs(shape)
    for dims in tile_grid(shape)[:3]:
        got = conformance.run_candidate(shape, dims, inputs)
        want = conformance.run_plain(shape, dims, inputs)
        if isinstance(want, tuple):  # ssd_scan: (y, final_state)
            assert len(got) == len(want)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            assert torch.equal(got, want)


def test_plain_agreement_allows_rounding_but_not_a_wrong_late_row():
    shape = KERNEL_SHAPE_BY_NAME["attn_s256_gqa_bf16"]
    q, k, v = conformance.make_inputs(shape)
    dims = {"block_q": 64, "block_k": 64, "causal": True}
    want = conformance.run_plain(shape, dims, (q, k, v))
    # the same f32 values a step apart before the one rounding: <= 1 ulp
    f32 = flash_attention_plain(q.float(), k.float(), v.float(), block_q=64,
                                block_k=64)
    near = conformance.agree_with_plain((f32 * (1 + 2.0 ** -12)).bfloat16(), want)
    assert near["passed"] and 0 < near["ratio"] <= 1
    # a kernel that loses the last K tile: only the rows that see it move
    v_lost = v.clone()
    v_lost[:, -64:] = 0
    wrong = conformance.run_plain(shape, dims, (q, k, v_lost))
    assert torch.equal(wrong[:, :192], want[:, :192])
    bad = conformance.agree_with_plain(wrong, want)
    assert not bad["passed"] and bad["ratio"] > 4
