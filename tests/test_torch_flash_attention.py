"""repro_torch flash attention: the plain tile walk against the Pallas kernel
(interpret mode) over the full legal grid of the CI shapes, plus sq != sk
with q_offset (kernel against kernel, never against the bottom-right
aligned oracle); the mma route's split-TF32 arithmetic, emulated in plain
torch, against the plain version; routes, shared memory and the resource
model's feasible tiles."""
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import draw, grid_cases, max_err, tf32, tf32_product, tf32_truncate

from repro.kernels import ops as jops
from repro_torch.core.device import H100_SXM
from repro_torch.core.design_space import (KernelPoint, KernelTemplate,
                                           baseline_kernel_point)
from repro_torch.core.kernel_space import (KERNEL_SHAPE_BY_NAME, KernelShape,
                                           kernel_resources, tile_grid)
from repro_torch.kernels import ops
from repro_torch.kernels.conformance import PLAIN_REL, agree_with_plain, tolerance
from repro_torch.kernels.resource_model import (flash_attention_resources,
                                                flash_mma_registers,
                                                flash_wgmma_launch_registers,
                                                flash_wgmma_registers)
from repro_torch.kernels.flash_attention import (MMA_D, MMA_MAX_D, MMA_SLICE, NEG_INF,
                                                 SOURCES, _launch_plan, mma_slices,
                                                 mma_split_plan,
                                                 WGMMA_BLOCKS, WGMMA_CONSUMER_REGS,
                                                 WGMMA_D, WGMMA_PRODUCER_REGS, _flash_walk,
                                                 flash_attention_plain,
                                                 k_tiles_walked, mma_head_dim,
                                                 mma_max_warps, mma_stage_keys,
                                                 mma_sub_keys, mma_threads, route,
                                                 smem_bytes_fma,
                                                 smem_bytes_mma, smem_bytes_wgmma,
                                                 wgmma_head_dim, wgmma_pass_rows,
                                                 wgmma_sub_keys, wgmma_threads)

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 192, 256])
@pytest.mark.parametrize("q_offset,causal", [(0, True), (64, True), (-32, True), (0, False)])
def test_wide_heads_plain_matches_pallas(d, dtype, q_offset, causal):
    # heads of 129-256 run on the mma kernel, whose plain version walks
    # the same tiles: GQA (4 heads on 2), sq != sk, q_offset, both masks
    rng = np.random.default_rng(d + q_offset)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 64, 128, 4, 2, d, dtype)
    kw = dict(causal=causal, block_q=32, block_k=64, q_offset=q_offset)
    assert route(qt.dtype, d, 32, 64) == "mma"
    want = jops.flash_attention(qj, kj, vj, interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert max_err(got, want) <= tolerance("flash_attention", dtype)


@pytest.mark.parametrize("d", [16, 80, 96, 160, 192, 256])
@pytest.mark.parametrize("q_offset,causal", [(0, True), (64, True), (-32, True), (0, False)])
def test_padded_heads_plain_matches_pallas_on_wgmma(d, q_offset, causal):
    # bf16 at any d up to 256 that is a multiple of 8 runs on the wgmma
    # kernel (zero-padded to 64, 128 or 256; sub-tiles of 64 keys above
    # 128), whose plain version walks its sub-tiles and rounds P to bf16:
    # GQA (2 heads on 1), q_offset, both masks, under the reference's
    # tolerance
    rng = np.random.default_rng(1000 + d + q_offset)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 256, 256, 2, 1, d, "bfloat16")
    kw = dict(causal=causal, block_q=64, block_k=128, q_offset=q_offset)
    assert route(qt.dtype, d, 64, 128) == "wgmma"
    want = jops.flash_attention(qj, kj, vj, interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert max_err(got, want) <= tolerance("flash_attention", "bfloat16")


@pytest.mark.parametrize("causal", [True, False])
def test_64_key_sub_tiles_move_the_plain_version_by_at_most_one_bf16_unit(causal):
    # at d 256 the wgmma route walks sub-tiles of 64 keys and rounds P to
    # bf16 once a sub-tile: against the same bf16 inputs with P.V in f32
    # over whole tiles (the mma route's walk), and against whole tiles with
    # P rounded, each element moves by at most one bf16 unit in the last
    # place of its row's largest value
    rng = np.random.default_rng(256 + causal)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 1, 256, 256, 2, 1, 256, "bfloat16")
    kw = dict(causal=causal, block_q=128, block_k=256)
    assert wgmma_sub_keys(256, 256) == 64
    sub = flash_attention_plain(qt, kt, vt, **kw).float()
    whole = _flash_walk(qt, kt, vt, causal=causal, bq=128, bk=256, q_offset=0,
                        sub_k=256, round_p=True).float()
    p32 = flash_attention_plain(qt.float(), kt.float(), vt.float(),
                                **kw).to(torch.bfloat16).float()
    for other in (whole, p32):
        row_max = torch.maximum(sub.abs(), other.abs()).amax(dim=-1, keepdim=True)
        unit = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
        assert ((sub - other).abs() <= unit).all()
        assert not torch.equal(sub, other)  # the sub-tiles and the rounding show
    # at a block of 64 keys the walk is the whole tile's, bit for bit
    kw64 = dict(causal=causal, block_q=128, block_k=64)
    assert torch.equal(flash_attention_plain(qt, kt, vt, **kw64),
                       _flash_walk(qt, kt, vt, causal=causal, bq=128, bk=64, q_offset=0,
                                   sub_k=64, round_p=True))


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
    # a pass's bf16 q rows, two K and two V sub-tiles, six mbarriers (q
    # full and empty, a full and an empty per stage), 1024 B slack: (64, 64)
    # at d=128 fits two blocks on one SM, (128, 128) one, and every larger
    # tile asks for what (128, 128) does (passes of 128 rows, sub-tiles of
    # 128 keys)
    assert smem_bytes_wgmma(64, 64, 128) == 1024 + 2 * 128 * (64 + 4 * 64) + 48 == 82_992
    assert 2 * (82_992 + 1024) <= 233_472
    assert smem_bytes_wgmma(128, 128, 128) == 164_912 <= 232_448
    for bq in (128, 256, 512):
        for bk in (128, 256, 512):
            assert smem_bytes_wgmma(bq, bk, 128) == 164_912
    assert smem_bytes_wgmma(512, 64, 64) == smem_bytes_wgmma(128, 64, 64)
    assert [wgmma_threads(bq, 128) for bq in WGMMA_BLOCKS] == [160, 288, 288, 288]


def test_wgmma_at_dp_256_fits_a_block():
    # DP 256 walks sub-tiles of 64 keys: at passes of 128 rows a pass's q
    # rows and two K and two V stages take 197,680 B; the producer is a
    # warpgroup (384 threads) that gives its registers to the consumers
    # (setmaxnreg): the model's 224 a consumer thread (S 32, O 128, P 16,
    # 48) within their 232, the CTA launching at a mean of 168 (the
    # compiler's count), one CTA an SM; d 136-248 pad to it and ask for the
    # same. Passes of 64 rows keep one producer warp (160 threads)
    assert smem_bytes_wgmma(128, 64, 256) == 1024 + 2 * 256 * (128 + 4 * 64) + 48 == 197_680
    assert smem_bytes_wgmma(64, 64, 256) == 1024 + 2 * 256 * (64 + 4 * 64) + 48 == 164_912
    for bq in (128, 256, 512):
        for bk in WGMMA_BLOCKS:
            for d in (136, 160, 192, 248, 256):
                assert smem_bytes_wgmma(bq, bk, d) == 197_680 <= 232_448
                assert wgmma_sub_keys(bk, d) == 64
                assert flash_wgmma_registers(bk, d) == 224 <= WGMMA_CONSUMER_REGS
                assert wgmma_threads(bq, d) == 384
                assert flash_wgmma_launch_registers(bq, bk, d) == 168
    assert 2 * 128 * WGMMA_CONSUMER_REGS + 128 * WGMMA_PRODUCER_REGS == 64_512 <= 65_536
    assert 168 * 384 <= 65_536
    assert wgmma_threads(64, 256) == 160 and flash_wgmma_launch_registers(64, 64, 256) == 224
    # d up to 128 keeps one producer warp at every pass
    assert flash_wgmma_launch_registers(128, 128, 128) == 208
    # 128-key sub-tiles at DP 256 would take 272 registers a thread
    assert 128 / 2 + 256 / 2 + 128 / 4 + 48 == 272 > 255
    # d up to 128 keeps its instantiations: d 72-120 pad to 128, 8-56 to 64
    assert smem_bytes_wgmma(128, 128, 80) == smem_bytes_wgmma(128, 128, 128) == 164_912
    assert smem_bytes_wgmma(64, 64, 16) == smem_bytes_wgmma(64, 64, 64)
    assert [flash_wgmma_registers(128, d) for d in (16, 64, 80, 128)] == [176, 176, 208, 208]
    assert [wgmma_sub_keys(512, d) for d in (8, 64, 80, 128, 136, 256)] == \
        [128, 128, 128, 128, 64, 64]
    # the resource model: one CTA an SM at Gemma 2 9B's widths, feasible
    res = flash_attention_resources(1, 4096, 4096, 16, 8, 256, 128, 128, 2)
    assert (res.route, res.feasible, res.threads, res.blocks_per_sm) == ("wgmma", True, 384, 1)
    assert res.regs_per_thread == 168 and res.vmem_bytes == 197_680


def test_wgmma_model_counts_the_padded_head_dim():
    # d 80 pads to 128: the products do 1.6x the work of d 80, d 128's
    # work; the bytes are d 80's (TMA reads no padding). The model counts
    # each walked K/V sub-tile's bytes from device memory, so at 128-row
    # passes it is bound by bytes; with the bytes free, by the padded work
    def model(d, dev=H100_SXM):
        return flash_attention_resources(1, 4096, 4096, 32, 32, d, 128, 128, 2, dev)

    d80, d128 = model(80), model(128)
    assert d80.route == d128.route == "wgmma"
    assert d80.est_latency_us == pytest.approx(d128.est_latency_us * 80 / 128)
    free = dataclasses.replace(H100_SXM, hbm_bw=1e30)
    assert model(80, free).est_latency_us == pytest.approx(model(128, free).est_latency_us)
    assert d80.vmem_bytes == d128.vmem_bytes and d80.threads == d128.threads
    f32 = flash_attention_resources(1, 4096, 4096, 32, 32, 80, 128, 128, 4)
    assert f32.route == "mma" and f32.feasible


def test_route_is_decided_by_dtype_head_dim_and_tile():
    bf16 = torch.bfloat16
    assert WGMMA_BLOCKS == (64, 128, 256, 512)
    for bq in WGMMA_BLOCKS:
        for bk in WGMMA_BLOCKS:
            assert route(bf16, 128, bq, bk) == route(bf16, 64, bq, bk) == "wgmma"
            # every d up to 256 that is a multiple of 8, padded by TMA
            for d in range(8, 257, 8):
                assert route(bf16, d, bq, bk) == "wgmma", (d, bq, bk)
    assert route(bf16, 96, 64, 64) == route(bf16, 80, 512, 512) == "wgmma"
    assert route(bf16, 100, 64, 64) == route(bf16, 81, 128, 128) == "mma"  # d % 8 != 0
    assert route(bf16, 64, 64, 320) == route(bf16, 64, 192, 64) == "mma"  # other tiles
    assert route(bf16, 128, 32, 64) == route(bf16, 128, 1, 64) == "mma"  # short q
    assert route(bf16, 128, 64, 1024) == "mma"
    assert [wgmma_head_dim(d) for d in (8, 16, 64, 72, 80, 128, 136, 160, 192, 256, 264,
                                        81, 0)] == \
        [64, 64, 64, 128, 128, 128, 256, 256, 256, 256, 0, 0, 0]
    # f32 goes to mma.sync with each operand split into two TF32 parts
    # (three products a product): one TF32 product would break PLAIN_REL
    # (test_one_tf32_product_would_not_hold_f32_to_its_plain_version),
    # at every tile: its K/V ring holds sub-tiles where two whole tiles do
    # not fit a block
    for bq in WGMMA_BLOCKS:
        for bk in WGMMA_BLOCKS:
            for d in (16, 80, 128, 160, 256):
                assert route(torch.float32, d, bq, bk) == "mma"
    assert route(torch.float32, 64, 64, 256) == route(bf16, 100, 512, 512) == "mma"
    # heads of 129-256 on the wgmma kernel in bf16 at the pools' tiles (DP
    # 256), on the mma kernel in f32, at other tiles or a d not a multiple
    # of 8; d 257-1024 on the mma route's split kernel, in both types; only
    # d above 1024 goes to the FMA kernel
    assert route(bf16, 160, 64, 64) == route(bf16, 256, 512, 512) == "wgmma"
    assert route(bf16, 136, 128, 128) == route(bf16, 192, 64, 512) == "wgmma"
    assert route(bf16, 160, 32, 64) == route(torch.float32, 256, 1, 1) == "mma"
    assert route(bf16, 129, 512, 512) == route(torch.float32, 192, 64, 64) == "mma"
    assert route(torch.float32, 256, 512, 512) == route(bf16, 256, 1, 256) == "mma"
    assert route(bf16, 257, 64, 64) == route(torch.float32, 320, 1, 1) == "mma"
    assert route(bf16, 264, 64, 64) == route(bf16, 512, 512, 512) == "mma"
    assert route(torch.float32, 1024, 8, 8) == route(bf16, 1024, 512, 512) == "mma"
    assert route(bf16, 1025, 1, 1) == route(torch.float32, 1088, 8, 8) == "fma"


def test_wgmma_dispatch_instantiates_exactly_the_routed_tiles():
    # ten (padded d, pass, sub-tile) cases (64 keys at most at DP 256);
    # every routed call runs on the one its padded head dim, pass and
    # sub-tile name, and each divides its block
    root = Path(__file__).resolve().parents[1]
    src = (root / SOURCES["wgmma"]).read_text()
    cases = {tuple(map(int, m)) for m in
             re.findall(r"^\s*FLASH_WGMMA_CASE\((\d+), (\d+), (\d+)\)", src, re.M)}
    routed = {(wgmma_head_dim(d), wgmma_pass_rows(bq), wgmma_sub_keys(bk, d))
              for d in range(8, 257, 8) for bq in WGMMA_BLOCKS for bk in WGMMA_BLOCKS}
    assert cases == routed and len(cases) == 10
    assert {dp for dp, _, _ in cases} == set(WGMMA_D) == {64, 128, 256}
    assert all(bq % wgmma_pass_rows(bq) == 0 and bk % wgmma_sub_keys(bk, d) == 0
               for d in WGMMA_D for bq in WGMMA_BLOCKS for bk in WGMMA_BLOCKS)
    # each case is instantiated once for d == DP and once for d < DP (the
    # padded epilogue): d 64 and 128 beside the dispatch, d below 64 and
    # 65-120 in a unit of their own, DP 256 in another (built in parallel),
    # those two declared extern beside the dispatch
    made = re.compile(r"^FLASH_WGMMA_INSTANCES\((extern)?, (\d+), (\d+), (\d+), (true|false)\)",
                      re.M)

    def instances(text, extern=""):
        return {(int(a), int(b), int(c), p == "true") for e, a, b, c, p in made.findall(text)
                if e == extern}

    here = instances(src)
    units = [instances((root / SOURCES["wgmma"].replace(".cu", f"_{u}.cu")).read_text())
             for u in ("padded", "wide")]
    assert here == {c + (False,) for c in cases if c[0] <= 128}
    assert units[0] == {c + (True,) for c in cases if c[0] <= 128}
    assert units[1] == {c + (p,) for c in cases if c[0] == 256 for p in (False, True)}
    assert instances(src, "extern") == units[0] | units[1]
    assert len(here | units[0] | units[1]) == 20


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_moves_the_plain_version_by_at_most_one_bf16_unit(causal):
    # the same bf16 inputs with P.V in f32 (the mma route's arithmetic:
    # P in two TF32 parts, V exact; f32 inputs hold the bf16 values
    # exactly) against P rounded to bf16
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", [(128, 256), (512, 512), (64, 512)])
def test_flash_plain_sub_tiled_walk_matches_pallas(block_q, block_k, causal):
    # on the wgmma route a K tile above 128 keys is walked in sub-tiles of
    # 128 (one softmax update and one rounding of P a sub-tile), as the
    # kernel walks it; the reference takes each tile whole
    rng = np.random.default_rng(block_q + block_k)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 512, 512, 4, 2, 64, "bfloat16")
    assert route(qt.dtype, 64, block_q, block_k) == "wgmma"
    kw = dict(causal=causal, block_q=block_q, block_k=block_k, q_offset=64)
    want = jops.flash_attention(qj, kj, vj, interpret=True, **kw)
    got = flash_attention_plain(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert max_err(got, want) <= tolerance("flash_attention", "bfloat16")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_k", [256, 512])
def test_sub_tiles_move_the_plain_version_by_at_most_one_bf16_unit(block_k, causal):
    # the kernel's walk (sub-tiles of 128 keys) against the same tiles
    # walked whole, P rounded to bf16 in both, outputs in bf16: each
    # element moves by at most one bf16 unit in the last place of its row's
    # largest value
    rng = np.random.default_rng(block_k + causal)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 1, 512, 512, 4, 2, 64, "bfloat16")
    kw = dict(causal=causal, block_q=128, block_k=block_k)
    sub = flash_attention_plain(qt, kt, vt, **kw).float()
    whole = _flash_walk(qt, kt, vt, causal=causal, bq=128, bk=block_k, q_offset=0,
                        sub_k=block_k, round_p=True).float()
    row_max = torch.maximum(sub.abs(), whole.abs()).amax(dim=-1, keepdim=True)
    unit = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    assert ((sub - whole).abs() <= unit).all()
    assert not torch.equal(sub, whole)  # the sub-tiles do show
    # at 128 keys and below the walk is the whole tile's, bit for bit
    kw128 = dict(causal=causal, block_q=128, block_k=128)
    assert torch.equal(flash_attention_plain(qt, kt, vt, **kw128),
                       _flash_walk(qt, kt, vt, causal=causal, bq=128, bk=128, q_offset=0,
                                   sub_k=128, round_p=True))


@pytest.mark.parametrize("d,fma_feasible", [
    (128, set()),  # every tile goes to the wgmma kernel, none to the
    (64, set()),   # mma or FMA kernels
])
def test_full_width_tiles_feasible_on_each_route(d, fma_feasible):
    shape = KernelShape("attn", "flash_attention",
                        {"b": 1, "sq": 4096, "sk": 4096, "h": 32, "kh": 8, "d": d},
                        "bfloat16")
    every = {(bq, bk) for bq in WGMMA_BLOCKS for bk in WGMMA_BLOCKS}
    feasible = {"wgmma": set(), "mma": set(), "fma": set()}
    for dims in tile_grid(shape):
        res = kernel_resources(shape, dims)
        bq, bk = dims["block_q"], dims["block_k"]
        # the wgmma route takes every tile of the pools: passes of
        # min(bq, 128) rows, sub-tiles of min(bk, 128) keys, so its threads,
        # shared memory and modelled registers are those of that pass and
        # sub-tile
        assert res.route == "wgmma"
        qp, ks = min(bq, 128), min(bk, 128)
        assert res.threads == 128 * qp // 64 + 32 and res.regs_per_thread > 0
        assert res.vmem_bytes == smem_bytes_wgmma(qp, ks, d) == smem_bytes_wgmma(bq, bk, d)
        assert res.feasible == (res.vmem_bytes <= 232_448) is True
        feasible[res.route].add((bq, bk))
    assert feasible == {"wgmma": every, "mma": set(), "fma": fma_feasible}
    ok, why = KernelTemplate(shape).validate(
        KernelPoint(dims={"block_q": 256, "block_k": 64, "causal": True}))
    assert ok and why == ""
    big = {"block_q": 64, "block_k": 512, "causal": True}
    ok, why = KernelTemplate(shape).validate(KernelPoint(dims=big))
    assert ok and why == ""


def test_every_flash_tile_point_is_feasible_and_the_shipped_tile_stays():
    # every point of every flash shape's tile grid launches, so the DSE's
    # expert initial design at full width is the shipped (512, 512), as in
    # the reference
    flash = [s for s in KERNEL_SHAPE_BY_NAME.values() if s.kernel == "flash_attention"]
    assert len(flash) == 3
    for shape in flash:
        for dims in tile_grid(shape):
            res = kernel_resources(shape, dims)
            assert res.feasible, (shape.name, dims, res.route, res.vmem_bytes)
    full = KERNEL_SHAPE_BY_NAME["attn_llama3_8b_s4096_bf16"]
    assert len(tile_grid(full)) == 32
    assert baseline_kernel_point(full, KernelTemplate(full)).dims == \
        {"block_q": 512, "block_k": 512, "causal": True}


def test_wgmma_model_counts_the_passes_and_sub_tiles_walked():
    # the work at (512, 512) is the work at (128, 128): every pass of 128
    # rows walks the sub-tiles of 128 keys up to its last visible one
    full = KERNEL_SHAPE_BY_NAME["attn_llama3_8b_s4096_bf16"]
    for causal in (True, False):
        small = kernel_resources(full, {"block_q": 128, "block_k": 128, "causal": causal})
        for bq, bk in ((256, 256), (512, 512), (128, 512), (512, 128)):
            big = kernel_resources(full, {"block_q": bq, "block_k": bk, "causal": causal})
            assert big.route == "wgmma" and big.blocks_per_sm == small.blocks_per_sm == 1
            # per block: the same total work over sq / bq q tiles
            assert big.est_cycles_per_block == pytest.approx(
                small.est_cycles_per_block * bq / 128)
    # 528 sub-tiles a head with causal, 1024 without (32 passes x 32)
    walked = sum(k_tiles_walked(g, 128, 128, 4096, causal=True, q_offset=0)
                 for g in range(32))
    assert walked == 528


WIDE_D = (160, 192, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDE_D)
def test_every_wide_head_call_launches_on_the_mma_kernel(d, dtype):
    # the 96 calls at d 160/192/256 with blocks 64-512 (16 a head dim and
    # dtype here; the FMA kernel's one stage fits 7 of them): f32 runs on
    # the mma kernel, bf16 on the wgmma kernel at DP 256 (sub-tiles of 64
    # keys), each within a block's shared memory, its registers and its
    # threads, and the resource model calls each feasible
    itemsize = 4 if dtype == "float32" else 2
    want = "mma" if dtype == "float32" else "wgmma"
    for bq in (64, 128, 256, 512):
        for bk in (64, 128, 256, 512):
            shape = KernelShape("attn_wide", "flash_attention",
                                {"b": 1, "sq": 512, "sk": 512, "h": 2, "kh": 1, "d": d}, dtype)
            res = kernel_resources(shape, {"block_q": bq, "block_k": bk, "causal": True})
            assert res.route == want == route(getattr(torch, dtype), d, bq, bk)
            assert res.feasible, (dtype, d, bq, bk)
            if want == "mma":
                assert res.vmem_bytes == smem_bytes_mma(bq, bk, d, itemsize) <= 232_448
                assert res.threads == mma_threads(bq, d, itemsize) <= 256
                assert res.regs_per_thread <= 255
            else:
                assert res.vmem_bytes == smem_bytes_wgmma(bq, bk, d) <= 232_448
                assert res.threads == wgmma_threads(bq, d) <= 384
                assert res.regs_per_thread == (224 if bq == 64 else 168)
                assert res.regs_per_thread * res.threads <= 65_536


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_range", [(1, 64), (65, 128), (129, 192), (193, 256)])
def test_every_call_up_to_d_256_is_feasible_on_its_route(d_range, dtype):
    # d up to 256, block_q and block_k from 1 to 512: every call launches,
    # on the route route() names (bf16 at a d that is a multiple of 8 and a
    # tile of the pools on wgmma, the rest on mma), and the wrapper's launch
    # plan is the model's (threads, shared memory)
    itemsize = dtype.itemsize
    blocks = (1, 16, 32, 64, 96, 128, 256, 512)
    for d in range(d_range[0], d_range[1] + 1):
        for bq in blocks:
            for bk in blocks:
                res = flash_attention_resources(1, bq, bk, 2, 1, d, bq, bk, itemsize)
                assert res.feasible, (dtype, d, bq, bk, res.route)
                assert res.route == route(dtype, d, bq, bk) != "fma"
                on_wgmma = (dtype == torch.bfloat16 and d % 8 == 0
                            and bq in WGMMA_BLOCKS and bk in WGMMA_BLOCKS)
                assert (res.route == "wgmma") == on_wgmma
                if res.route == "mma":
                    assert res.threads == mma_threads(bq, d, itemsize)
                    assert res.vmem_bytes == smem_bytes_mma(bq, bk, d, itemsize)
                else:
                    assert res.threads == wgmma_threads(bq, d)
                    assert res.vmem_bytes == smem_bytes_wgmma(bq, bk, d) <= 232_448


def test_every_tile_the_fma_kernel_took_still_launches():
    # a call that fits the FMA kernel's shared memory runs on the mma or
    # wgmma route, never the FMA kernel, up to d 1024 (block_q and block_k
    # from 1 to 512), the wrapper's launch plan the model's
    blocks = (1, 16, 32, 64, 96, 128, 256, 512)
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        for d in (8, 16, 24, 64, 80, 96, 128, 160, 256, 264, 320, 384, 448, 512, 640, 768,
                  1000, 1024):
            for bq in blocks:
                for bk in blocks:
                    if smem_bytes_fma(bq, bk, d, itemsize) > 232_448:
                        continue
                    f32 = "float32" if itemsize == 4 else "bfloat16"
                    shape = KernelShape("attn", "flash_attention",
                                        {"b": 1, "sq": bq, "sk": bk, "h": 2, "kh": 1, "d": d}, f32)
                    res = kernel_resources(shape, {"block_q": bq, "block_k": bk, "causal": True})
                    assert res.feasible, (f32, d, bq, bk, res.route)
                    assert res.route == route(dtype, d, bq, bk) != "fma"
                    if res.route == "mma":
                        assert res.threads == mma_threads(bq, d, itemsize)
                        assert res.vmem_bytes == smem_bytes_mma(bq, bk, d, itemsize)
    # the FMA kernel took d 1024 at 8-row tiles, in both types
    assert smem_bytes_fma(8, 8, 1024, 4) <= 232_448 and smem_bytes_fma(8, 8, 1024, 2) <= 232_448


SPLIT_D = (264, 320, 384, 448, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SPLIT_D)
def test_every_pool_tile_above_d_256_launches_on_the_split_kernel(d, dtype):
    # the 16 pool tiles above d 256 (the FMA kernel fit none at d 320 and
    # above, one in bf16 at d 264): each is feasible on the mma route's split
    # kernel, within a block, and the wrapper's launch plan is the model's
    itemsize = dtype.itemsize
    for bq in WGMMA_BLOCKS:
        for bk in WGMMA_BLOCKS:
            res = flash_attention_resources(1, 512, 512, 2, 1, d, bq, bk, itemsize)
            assert res.feasible and res.route == route(dtype, d, bq, bk) == "mma", (bq, bk)
            assert smem_bytes_fma(bq, bk, d, itemsize) > 232_448 or (d, itemsize) == (264, 2)
            plan = _launch_plan((1, 512, 2, d), (1, 512, 1, d), (1, 512, 1, d), dtype,
                                bq, bk, True, 0)
            cfg = list(plan[3])
            assert plan[0] == "flash_attention_mma_launch"
            assert cfg[11:] == [res.threads, res.vmem_bytes, mma_stage_keys(bq, bk, d, itemsize)]
            assert res.vmem_bytes <= 232_448 and res.threads <= 256
            assert res.regs_per_thread <= 255 and res.regs_per_thread * res.threads <= 65_536


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_range", [(257, 448), (449, 640), (641, 832), (833, 1024)])
def test_every_call_from_d_257_to_1024_is_feasible_on_the_split_kernel(d_range, dtype):
    # d 257-1024 (every multiple of 8 and its odd neighbours), block_q and
    # block_k from 1 to 512: each launches on the split kernel, its ring
    # holding a multiple of its sub-tile within a block
    itemsize = dtype.itemsize
    blocks = (1, 16, 32, 64, 96, 128, 256, 512)
    for d in (d for d in range(d_range[0], d_range[1] + 1) if d % 8 in (0, 1, 7)):
        kc, groups = mma_split_plan(d, itemsize)
        assert kc in (8, 16, 32) and groups >= 1 and mma_slices(d) * groups <= 8
        for bq in blocks:
            for bk in blocks:
                res = flash_attention_resources(1, bq, bk, 2, 1, d, bq, bk, itemsize)
                assert res.feasible and res.route == "mma", (d, bq, bk)
                st = mma_stage_keys(bq, bk, d, itemsize)
                assert st % kc == 0 and st >= kc and res.vmem_bytes <= 232_448


def test_split_plan_is_its_sources():
    # slices of 128 columns up to d 1024, one warp a slice; 8 warps a block:
    # two groups of 16 rows up to 4 slices, where they fit beside two stages
    src = (Path(__file__).resolve().parents[1]
           / "src/repro_torch/kernels/csrc/flash_attention_split.cu").read_text()
    assert re.search(rf"constexpr int SLICE = {MMA_SLICE};", src)
    assert re.search(rf"constexpr int SPLIT_MAX_D = {MMA_MAX_D};", src)
    assert [mma_head_dim(d) for d in (257, 264, 320, 321, 1023, 1024, 1025)] == \
        [264, 264, 320, 328, 1024, 1024, 0]
    assert [mma_slices(d) for d in (256, 257, 384, 385, 512, 513, 1024)] == \
        [1, 3, 3, 4, 4, 5, 8]
    # f32: 32-key sub-tiles to d 384 (one group at 384), 16 to 640, 8 above;
    # bf16: 32 to 640, 16 above
    assert [mma_split_plan(d, 4) for d in (264, 320, 384, 512, 640, 768, 1024)] == \
        [(32, 2), (32, 2), (32, 1), (16, 2), (16, 1), (8, 1), (8, 1)]
    assert [mma_split_plan(d, 2) for d in (264, 320, 384, 512, 640, 768, 1024)] == \
        [(32, 2), (32, 2), (32, 2), (32, 2), (32, 1), (16, 1), (16, 1)]
    assert mma_sub_keys(320, 4) == 32 and mma_sub_keys(1024, 4) == 8
    assert [mma_threads(bq, 320, 4) for bq in (1, 16, 17, 512)] == [96, 96, 192, 192]
    assert mma_threads(512, 1024, 2) == 256 and mma_max_warps(512, 4) == 8
    # two stages of 32 keys (328 + 324 words a key), 32 q rows (328 words)
    # and six warps' partials (16 x 32 f32) at d 320 in f32
    assert mma_stage_keys(128, 128, 320, 4) == 32
    assert smem_bytes_mma(128, 128, 320, 4) == \
        4 * (2 * 32 * (328 + 324) + 32 * 328 + 6 * 16 * 32) == 221_184
    # registers: a slice of O (64), S (half the sub-tile) and 40
    assert flash_mma_registers(320, 4) == 120 and flash_mma_registers(1024, 4) == 112


def test_wgmma_route_runs_at_the_tensor_core_rate():
    shape = KERNEL_SHAPE_BY_NAME["attn_llama3_8b_s4096_bf16"]
    bf16 = kernel_resources(shape, {"block_q": 128, "block_k": 128, "causal": True})
    f32 = KernelShape("attn_f32", "flash_attention", shape.params, "float32")
    mma = kernel_resources(f32, {"block_q": 64, "block_k": 64, "causal": True})
    assert (bf16.route, mma.route) == ("wgmma", "mma")
    # modelled: q in f32 (64; split at each use for f32) + O (64) + S (16)
    # + 40
    assert mma.regs_per_thread == 184 and mma.threads == 128
    # the causal walk at (128, 128): 528 K tiles per head over 32 heads
    flops = 32 * 528 * 4 * 128 * 128 * 128
    assert bf16.est_latency_us * 1e-6 >= flops / 989e12
    # f32 on the mma route: three TF32 products a product, at best
    # 495 / 3 TFLOP/s; the causal walk at (64, 64): 2080 K tiles per head
    assert mma.est_latency_us * 1e-6 >= 3 * 32 * 2080 * 4 * 64 * 64 * 128 / 495e12
    assert bf16.est_latency_us < mma.est_latency_us / 2


def test_mma_shared_memory_threads_and_head_dims():
    # K and q rows padded to 8 words mod 32 (f32) or 4 mod 16 (bf16), V rows
    # to 4 mod 16: at d=64 f32 72 + 68 words a key over two stages, and 72
    # a q row, 16 rows a warp
    assert smem_bytes_mma(64, 64, 64, 4) == (2 * 64 * (72 + 68) + 64 * 72) * 4 == 90_112
    assert smem_bytes_mma(128, 128, 64, 4) == (2 * 128 * (72 + 68) + 128 * 72) * 4
    assert smem_bytes_mma(64, 64, 16, 4) == (2 * 64 * (40 + 20) + 64 * 40) * 4
    # two f32 stages of 128 keys at d=128 do not fit a block: 64 keys a stage
    assert smem_bytes_mma(64, 128, 128, 4) == (2 * 64 * (136 + 132) + 64 * 136) * 4
    assert smem_bytes_mma(64, 64, 64, 2) == (2 * 64 * (36 + 36) + 64 * 36) * 4
    # a pass holds at most 128 q rows
    assert smem_bytes_mma(512, 64, 64, 2) == smem_bytes_mma(128, 64, 64, 2)
    # block_k rounds up to whole sub-tiles (64 keys to d=32, 32 above)
    assert mma_sub_keys(32) == 64 and mma_sub_keys(64) == mma_sub_keys(96) == 32
    assert smem_bytes_mma(64, 1, 32, 4) == smem_bytes_mma(64, 64, 32, 4)
    assert smem_bytes_mma(64, 1, 64, 4) == smem_bytes_mma(64, 32, 64, 4)
    assert smem_bytes_mma(64, 40, 128, 2) == smem_bytes_mma(64, 64, 128, 2)
    assert [mma_threads(bq, 128, 4) for bq in (1, 16, 32, 48, 128, 256, 512)] == \
        [32, 32, 64, 96, 256, 256, 256]
    assert [mma_head_dim(d) for d in (1, 16, 24, 64, 80, 96, 112, 128, 129, 192, 193,
                                      256, 257)] == \
        [16, 16, 32, 64, 96, 96, 128, 128, 160, 192, 256, 256, 264]
    assert MMA_D == (16, 32, 64, 96, 128, 160, 192, 256)
    src = (Path(__file__).resolve().parents[1] / SOURCES["mma"]).read_text()
    cases = {int(m) for m in re.findall(r"^\s*FLASH_MMA_CASE\((\d+)\)", src, re.M)}
    assert cases == set(MMA_D)
    # 8 warps a block up to d 192; f32 at d 256: 8 warps' q rows (128 x 264
    # words) and two stages of one 32-key sub-tile (2 x 32 x (264 + 260)
    # words) would pass a block, so 4 warps, 32 keys a stage
    assert [mma_max_warps(d, 4) for d in MMA_D] == [8] * 7 + [4]
    assert [mma_max_warps(d, 2) for d in MMA_D] == [8] * 8
    assert mma_threads(512, 256, 4) == 128 and mma_threads(512, 256, 2) == 256
    assert smem_bytes_mma(512, 512, 256, 4) == 4 * (2 * 32 * (264 + 260) + 64 * 264) == 201_728
    assert smem_bytes_mma(512, 512, 256, 2) == 4 * (2 * 64 * (132 + 132) + 128 * 132)
    # above d = 128 q stays in shared memory: O (d/2), S (16) and 40
    assert [flash_mma_registers(d, 4) for d in (128, 160, 192, 256)] == [184, 136, 152, 184]
    assert [flash_mma_registers(d, 2) for d in (160, 192, 256)] == [136, 152, 184]
    # d 320 on the split kernel; above d = 1024 the FMA kernel takes the call
    f32 = KernelShape("attn_d320", "flash_attention",
                      {"b": 1, "sq": 64, "sk": 64, "h": 1, "kh": 1, "d": 320}, "float32")
    res = kernel_resources(f32, {"block_q": 16, "block_k": 16, "causal": True})
    assert res.route == "mma" and res.feasible
    f32 = KernelShape("attn_d1088", "flash_attention",
                      {"b": 1, "sq": 64, "sk": 64, "h": 1, "kh": 1, "d": 1088}, "float32")
    res = kernel_resources(f32, {"block_q": 8, "block_k": 8, "causal": True})
    assert res.route == "fma" and res.feasible


def _whole_tile_smem_mma(bq, bk, d, itemsize):
    """The mma kernel's shared memory with two whole block_k stages: its
    ring before stages could hold part of a tile."""
    dp, kc = mma_head_dim(d), mma_sub_keys(d)
    kw = (dp + (8 - dp) % 32) if itemsize == 4 else (dp // 2 + (4 - dp // 2) % 16)
    vw = dp * itemsize // 4 + (4 - dp * itemsize // 4) % 16
    return 4 * (2 * (-(-bk // kc) * kc) * (kw + vw) + mma_threads(bq, d, itemsize) // 2 * kw)


def test_mma_ring_fits_a_block_at_every_tile_and_keeps_whole_tiles_where_they_fit():
    blocks = (1, 16, 32, 64, 96, 128, 192, 256, 320, 384, 512)
    n_whole = n_part = 0
    for itemsize in (4, 2):
        for d in range(1, 257):
            kc = mma_sub_keys(d)
            for bq in blocks:
                for bk in blocks:
                    smem = smem_bytes_mma(bq, bk, d, itemsize)
                    st = mma_stage_keys(bq, bk, d, itemsize)
                    whole = _whole_tile_smem_mma(bq, bk, d, itemsize)
                    assert smem <= 232_448 and st % kc == 0 and st >= kc
                    if whole <= 232_448:  # two whole stages fit: as before
                        assert smem == whole and st == -(-bk // kc) * kc
                        n_whole += 1
                    else:  # the largest multiple of the sub-tile that fits
                        assert st < bk
                        assert _whole_tile_smem_mma(bq, st + kc, d, itemsize) > 232_448
                        n_part += 1
    assert n_part and n_whole
    # f32 at d=128: 64 keys a stage, 2 x 64 x 1,072 B + 69,632 B of q rows
    assert mma_stage_keys(512, 512, 128, 4) == 64
    assert smem_bytes_mma(512, 512, 128, 4) == 2 * 64 * 1_072 + 69_632 == 206_848


# -- the mma route's arithmetic, emulated in plain torch ---------------------
def _flash_emulated(q, k, v, *, causal, block_q, block_k, q_offset=0, terms=3):
    """The mma route's walk: ``flash_attention_plain``'s tiles, mask and
    online softmax, with Q.K^T and P.V taken as the kernel takes them."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    bq, bk = min(block_q, sq), min(block_k, sk)
    qf = (q.float() * (1.0 / math.sqrt(d))).view(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    out = torch.empty(b, kh, g, sq, d)
    for qt in range(sq // bq):
        q_t = qf[..., qt * bq:(qt + 1) * bq, :]
        q_pos = q_offset + qt * bq + torch.arange(bq)
        m = torch.full((b, kh, g, bq), NEG_INF)
        l = torch.zeros(b, kh, g, bq)
        acc = torch.zeros(b, kh, g, bq, d)
        for t in range(k_tiles_walked(qt, bq, bk, sk, causal=causal, q_offset=q_offset)):
            k_t = kf[..., t * bk:(t + 1) * bk, :]
            v_t = vf[..., t * bk:(t + 1) * bk, :]
            # above d 256 each slice of 128 columns gives a partial score,
            # added in slice order as the split kernel adds them
            w = MMA_SLICE if d > 256 else d
            s = sum(tf32_product(q_t[..., c:c + w], k_t[..., c:c + w].transpose(-1, -2)
                                 .expand(b, kh, g, min(w, d - c), bk), terms)
                    for c in range(0, d, w))
            if causal:
                k_pos = t * bk + torch.arange(bk)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + tf32_product(p, v_t.expand(b, kh, g, bk, d), terms)
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[..., qt * bq:(qt + 1) * bq, :] = acc / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def test_tf32_emulation_rounds_to_nearest_away_from_zero():
    # ties (half a unit of 2**-10) go away from zero, either sign
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12])
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10),
                                 1.0]
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    big = tf32(r)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - big).abs() <= r.abs() * 2.0 ** -11).all()
    small = tf32_truncate(r - big)
    assert ((r - big - small).abs() <= r.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("dims", [pytest.param(d, id=",".join(f"{k}={v}" for k, v in d.items()))
                                  for d in tile_grid(KERNEL_SHAPE_BY_NAME["attn_s128_f32"])])
def test_split_tf32_holds_attn_s128_f32_to_its_plain_version(dims):
    shape = KERNEL_SHAPE_BY_NAME["attn_s128_f32"]
    p = shape.params
    rng = np.random.default_rng(11)
    (_, q), (_, k), (_, v) = _qkv(rng, p["b"], p["sq"], p["sk"], p["h"], p["kh"],
                                  p["d"], "float32")
    kw = dict(causal=dims["causal"], block_q=dims["block_q"], block_k=dims["block_k"])
    assert route(q.dtype, p["d"], dims["block_q"], dims["block_k"]) == "mma"
    agree = agree_with_plain(_flash_emulated(q, k, v, **kw),
                             flash_attention_plain(q, k, v, **kw))
    assert agree["passed"] and agree["limit"] <= PLAIN_REL[torch.float32], agree


@pytest.mark.parametrize("d", [16, 64, 96, 128, 160, 192, 256, 320, 520])
@pytest.mark.parametrize("q_offset,causal", [(0, True), (-32, True), (0, False)])
def test_split_tf32_holds_each_head_dim_to_its_plain_version(d, q_offset, causal):
    # q_offset -32: the first 32 rows see no key and average V (-1e30 mask)
    rng = np.random.default_rng(d)
    (_, q), (_, k), (_, v) = _qkv(rng, 1, 64, 128, 4, 2, d, "float32")
    kw = dict(causal=causal, block_q=32, block_k=64, q_offset=q_offset)
    want = flash_attention_plain(q, k, v, **kw)
    agree = agree_with_plain(_flash_emulated(q, k, v, **kw), want)
    assert agree["passed"], agree
    if q_offset < 0:
        torch.testing.assert_close(want[:, :32], v.mean(dim=1, keepdim=True)
                                   .repeat_interleave(2, dim=2).expand(1, 32, 4, d),
                                   rtol=0, atol=1e-6)


def test_one_tf32_product_would_not_hold_f32_to_its_plain_version():
    # why the route splits: the same walk with one TF32 product a product
    # (10 mantissa bits) misses PLAIN_REL by far, the split three-term
    # product meets it by far
    rng = np.random.default_rng(3)
    (_, q), (_, k), (_, v) = _qkv(rng, 2, 128, 128, 4, 4, 64, "float32")
    kw = dict(causal=True, block_q=128, block_k=128)
    want = flash_attention_plain(q, k, v, **kw)
    one = agree_with_plain(_flash_emulated(q, k, v, terms=1, **kw), want)
    three = agree_with_plain(_flash_emulated(q, k, v, terms=3, **kw), want)
    assert one["ratio"] > 4 and not one["passed"]
    assert three["ratio"] < 0.25


def test_blocks_must_divide_the_sequence():
    q = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError, match="divide"):
        flash_attention_plain(q, q, q, block_q=64, block_k=64)
