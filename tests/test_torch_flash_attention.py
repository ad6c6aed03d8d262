"""repro_torch flash attention: the plain tile walk against the Pallas kernel
(interpret mode) over the full legal grid of the CI shapes, plus sq != sk
with q_offset (kernel against kernel, never against the bottom-right
aligned oracle)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import draw, grid_cases, max_err

from repro.kernels import ops as jops
from repro_torch.core.design_space import KernelPoint, KernelTemplate
from repro_torch.core.kernel_space import (KERNEL_SHAPE_BY_NAME, KernelShape,
                                           kernel_resources, tile_grid)
from repro_torch.kernels import ops
from repro_torch.kernels.conformance import tolerance
from repro_torch.kernels.flash_attention import (SOURCES, WGMMA_BLOCKS, WGMMA_D,
                                                 flash_attention_plain,
                                                 k_tiles_walked, route,
                                                 smem_bytes, smem_bytes_wgmma)

SHAPES = [KERNEL_SHAPE_BY_NAME["attn_s128_f32"],
          KERNEL_SHAPE_BY_NAME["attn_s256_gqa_bf16"]]


def _qkv(rng, b, sq, sk, h, kh, d, dtype):
    return (draw(rng, b, sq, h, d, dtype=dtype), draw(rng, b, sk, kh, d, dtype=dtype),
            draw(rng, b, sk, kh, d, dtype=dtype))


@pytest.mark.parametrize("shape,dims", grid_cases(SHAPES))
def test_flash_plain_matches_pallas(shape, dims):
    p = shape.params
    rng = np.random.default_rng(5)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, p["b"], p["sq"], p["sk"], p["h"],
                                        p["kh"], p["d"], shape.dtype)
    kw = dict(causal=dims["causal"], block_q=dims["block_q"], block_k=dims["block_k"])
    want = jops.flash_attention(qj, kj, vj, interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert max_err(got, want) <= tolerance("flash_attention", shape.dtype)


@pytest.mark.parametrize("sq,sk,q_offset,causal", [
    (64, 128, 64, True),    # decode-style tail of the sequence
    (64, 128, 0, True),     # top-left alignment: the causal skip stops early
    (128, 64, 0, True),
    (64, 128, -32, True),   # rows with no visible key average V (-1e30 mask)
    (64, 128, 0, False),
])
def test_flash_plain_matches_pallas_with_q_offset(sq, sk, q_offset, causal):
    rng = np.random.default_rng(9)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, sq, sk, 4, 2, 32, "float32")
    kw = dict(causal=causal, block_q=32, block_k=32, q_offset=q_offset)
    want = jops.flash_attention(qj, kj, vj, interpret=True, **kw)
    got = ops.flash_attention(qt, kt, vt, **kw)
    assert max_err(got, want) <= tolerance("flash_attention", "float32")


def test_fully_masked_rows_average_v_and_stay_finite():
    rng = np.random.default_rng(2)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 1, 32, 32, 2, 1, 16, "float32")
    out = flash_attention_plain(qt, kt, vt, causal=True, block_q=16, block_k=16,
                                q_offset=-64)
    assert torch.isfinite(out).all()
    want = vt.mean(dim=1, keepdim=True).expand(1, 32, 1, 16)
    torch.testing.assert_close(out[:, :, 0], want[:, :, 0], rtol=0, atol=1e-6)


def test_causal_skip_counts_only_visible_tiles():
    assert [k_tiles_walked(qt, 64, 64, 256, causal=True, q_offset=0)
            for qt in range(4)] == [1, 2, 3, 4]
    assert k_tiles_walked(0, 64, 64, 256, causal=False, q_offset=0) == 4
    assert k_tiles_walked(0, 64, 64, 256, causal=True, q_offset=-1) == 4
    assert k_tiles_walked(0, 64, 64, 256, causal=True, q_offset=192) == 4


def test_flash_wgmma_smem_formula():
    # the bf16 q tile, two K and two V stages, five mbarriers, 1024 B slack:
    # (64, 64) at d=128 fits two blocks on one SM, (128, 128) one
    assert smem_bytes_wgmma(64, 64, 128) == 1024 + 2 * 128 * (64 + 4 * 64) + 40 == 82_984
    assert 2 * (82_984 + 1024) <= 233_472
    assert smem_bytes_wgmma(128, 128, 128) == 164_904 <= 232_448


def test_route_is_decided_by_dtype_head_dim_and_tile():
    bf16 = torch.bfloat16
    for bq in WGMMA_BLOCKS:
        for bk in WGMMA_BLOCKS:
            assert route(bf16, 128, bq, bk) == route(bf16, 64, bq, bk) == "wgmma"
    assert route(bf16, 96, 64, 64) == "fma"  # no instantiation at d=96
    assert route(bf16, 64, 64, 256) == route(bf16, 64, 256, 64) == "fma"
    assert route(bf16, 128, 32, 64) == route(bf16, 128, 1, 64) == "fma"  # short q
    assert route(torch.float32, 128, 64, 64) == "fma"  # TF32 would break PLAIN_REL


def test_wgmma_dispatch_instantiates_exactly_the_routed_tiles():
    src = (Path(__file__).resolve().parents[1] / SOURCES["wgmma"]).read_text()
    cases = {tuple(map(int, m)) for m in
             re.findall(r"^\s*FLASH_WGMMA_CASE\((\d+), (\d+), (\d+)\)", src, re.M)}
    assert cases == {(d, bq, bk) for d in WGMMA_D for bq in WGMMA_BLOCKS
                     for bk in WGMMA_BLOCKS}


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_moves_the_plain_version_by_at_most_one_bf16_unit(causal):
    # the same bf16 inputs with P.V in f32 (the FMA route's arithmetic:
    # f32 inputs hold the bf16 values exactly) against P rounded to bf16
    # (the wgmma route's), both outputs in bf16: each element moves by at
    # most one bf16 unit in the last place of its row's largest value
    rng = np.random.default_rng(4)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 1, 256, 256, 4, 2, 64, "bfloat16")
    kw = dict(causal=causal, block_q=64, block_k=64)
    p16 = flash_attention_plain(qt, kt, vt, **kw).float()
    p32 = flash_attention_plain(qt.float(), kt.float(), vt.float(),
                                **kw).to(torch.bfloat16).float()
    row_max = torch.maximum(p16.abs(), p32.abs()).amax(dim=-1, keepdim=True)
    unit = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    assert ((p16 - p32).abs() <= unit).all()
    assert not torch.equal(p16, p32)  # the rounding of P does show


@pytest.mark.parametrize("d,fma_feasible", [
    (128, set()),  # every FMA tile at d=128 overflows shared memory
    (64, {(64, 256), (256, 64)}),  # 164,608 B and 216,064 B fit; the rest do not
])
def test_full_width_tiles_feasible_on_each_route(d, fma_feasible):
    shape = KernelShape("attn", "flash_attention",
                        {"b": 1, "sq": 4096, "sk": 4096, "h": 32, "kh": 8, "d": d},
                        "bfloat16")
    wgmma = {(bq, bk) for bq in WGMMA_BLOCKS for bk in WGMMA_BLOCKS}
    feasible = {"wgmma": set(), "fma": set()}
    for dims in tile_grid(shape):
        res = kernel_resources(shape, dims)
        bq, bk = dims["block_q"], dims["block_k"]
        # the wgmma route takes exactly the tiles it is instantiated for,
        # and each fits; every other tile goes to the FMA kernel, feasible
        # when its f32 tiles fit one block's shared memory
        assert res.route == ("wgmma" if (bq, bk) in wgmma else "fma")
        if res.route == "wgmma":
            assert res.threads == 128 * bq // 64 + 32 and res.regs_per_thread > 0
            assert res.vmem_bytes == smem_bytes_wgmma(bq, bk, d)
        else:
            assert res.vmem_bytes == smem_bytes(bq, bk, d, 2)
        assert res.feasible == (res.vmem_bytes <= 232_448)
        if res.feasible:
            feasible[res.route].add((bq, bk))
    assert feasible == {"wgmma": wgmma, "fma": fma_feasible}
    big = {"block_q": 256, "block_k": 64, "causal": True}
    ok, why = KernelTemplate(shape).validate(KernelPoint(dims=big))
    assert ok == (d == 64)
    if not ok:
        assert why == (f"shared memory {smem_bytes(256, 64, d, 2)} B per block "
                       "exceeds 232448 B limit")


def test_wgmma_route_runs_at_the_tensor_core_rate():
    shape = KERNEL_SHAPE_BY_NAME["attn_llama3_8b_s4096_bf16"]
    bf16 = kernel_resources(shape, {"block_q": 128, "block_k": 128, "causal": True})
    f32 = KernelShape("attn_f32", "flash_attention", shape.params, "float32")
    fma = kernel_resources(f32, {"block_q": 64, "block_k": 64, "causal": True})
    assert (bf16.route, fma.route) == ("wgmma", "fma")
    assert fma.regs_per_thread == 0  # the FMA kernel's registers are not modelled
    # the causal walk at (128, 128): 528 K tiles per head over 32 heads
    flops = 32 * 528 * 4 * 128 * 128 * 128
    assert bf16.est_latency_us * 1e-6 >= flops / 989e12
    assert bf16.est_latency_us < fma.est_latency_us / 5


def test_blocks_must_divide_the_sequence():
    q = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError, match="divide"):
        flash_attention_plain(q, q, q, block_q=64, block_k=64)
