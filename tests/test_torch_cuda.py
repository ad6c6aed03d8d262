"""repro_torch kernels on the card: each CUDA kernel against its plain
version over the full legal grid of the CI shapes and a few odd shapes
(row by row, within ``conformance.PLAIN_REL``), the SSD scan also with an
initial state at every chunk on the route each takes, the bf16 SSD scan on
its wgmma route at every instantiated (chunk, N) over an odd number of
chunks, the SSD scan on its mma route (f32 and bf16, chunks 32-256, odd dh
and N, with and without an initial state), on its mma route's streamed
kernel at the sizes the FMA kernels took (f32 chunk 256, N above 128,
chunk 512, dh above 128, odd dh, N and chunks) and on the FMA kernels at N
past two warps' streamed block (odd dh, N and chunks, masked last tiles and
slices, with and without an initial state), bf16 flash attention
on both of its routes and f32 flash attention on the mma route (its ring
holding part of a tile where two whole ones do not fit) with ``sq != sk``,
``q_offset``, odd K-tile walks and short query blocks at d = 64, 96 and
128, heads of 160, 192 and 256 at the smallest and the largest tile (f32
and bf16 outside the pools on the mma route, bf16 in them on wgmma), bf16
at d 80, 160, 192 and 256 on wgmma over every tile of the pools, the mma
route's split kernel at d = 264-1024 (every tile of the pools at 264-512)
and the FMA kernel at d 1088, every
full-width flash
tile above 128 rows or keys on ``wgmma`` and the shipped blocks through
``ops``, every rmsnorm path (wide rows included) at an odd row count and
every ``block_rows``, the oracle
gate, launch counting, refused launches, one DSE cell with measured
rows on cuda, and a two-cell kernel campaign that resumes with no
launch; and the dense model on the card: llama3-8b at full width with 2
layers, a 2048-token prefill and 8 decode steps in bf16 on the card
against f32 on the CPU on the same weights, and decode consistency; and
the plan loop's measured tier (one llama3-8b decode head, its batch cut
to fit the card) and the §4 demo's vecmul against ``kernels/ref.py``. The
kernels have no CPU mode, so these tests skip where torch sees no card; on a machine with an H100 and nvcc run them from the repo
root with
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
shared conftest imports jax, which that machine need not have; this file
imports none of it)."""
import math

import pytest
import torch

from repro_torch.core.cost_db import CostDB
from repro_torch.core.kernel_space import (CI_KERNEL_SHAPES, KernelShape,
                                           kernel_resources, tile_grid)
from repro_torch.kernels import _build, conformance, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.resource_model import flash_attention_resources
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
from repro_torch.launch import campaign, dse

SHAPES = list(CI_KERNEL_SHAPES) + [
    KernelShape("rms_odd_173x96_f32", "rmsnorm", {"rows": 173, "d": 96}, "float32"),
    KernelShape("vec_odd_5000_bf16", "vecmul", {"L": 5000}, "bfloat16"),
    KernelShape("ssd_odd_b2_s96_f32", "ssd_scan",
                {"b": 2, "s": 96, "nh": 3, "dh": 24, "N": 40}, "float32")]


def _grid():
    return [pytest.param(shape, dims, id=shape.name + "-" + ",".join(
        f"{k}={v}" for k, v in dims.items())) for shape in SHAPES
        for dims in tile_grid(shape)]


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    # the plain versions' matmuls in full f32, as the kernels compute
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dims", _grid())
def test_kernel_matches_plain_on_the_card(shape, dims, card):
    inputs = conformance.make_inputs(shape, device=card)
    if not kernel_resources(shape, dims).feasible:
        with pytest.raises(RuntimeError, match="CUDA error"):
            conformance.run_candidate(shape, dims, inputs)
        return
    before = ops.launch_counts()[shape.kernel]
    got = conformance.run_candidate(shape, dims, inputs)
    torch.cuda.synchronize()
    assert ops.launch_counts()[shape.kernel] == before + 1
    out = got[0] if isinstance(got, tuple) else got
    assert out.is_cuda and out.dtype == inputs[0].dtype
    agree = conformance.agree_with_plain(
        got, conformance.run_plain(shape, dims, inputs))
    assert agree["passed"], agree
    assert conformance.check_candidate(shape, dims, inputs=inputs)["passed"]


@pytest.mark.cuda
def test_dse_cell_measures_on_cuda(card, tmp_path):
    db = tmp_path / "db.jsonl"
    ops.reset_launch_counts()
    rep = dse.main(["--space", "kernels",
                    "--arch", "flash_attention", "--shape", "attn_s256_gqa_bf16",
                    "--iterations", "2", "--budget", "3", "--measure-top-k", "2",
                    "--db", str(db)])
    assert ops.launch_counts()["flash_attention"] > 0
    assert rep["best"] is not None
    measured = [d for d in CostDB(db).all() if d.fidelity == "measured"]
    assert measured and all(d.status == "ok" and d.metrics["backend"] == "cuda"
                            for d in measured)


@pytest.mark.cuda
def test_kernel_campaign_runs_and_resumes_on_cuda(card, tmp_path):
    argv = ["--space", "kernels", "--archs", "vecmul,rmsnorm",
            "--shapes", "vec_64k_f32,rms_1kx256_bf16",
            "--iterations", "2", "--budget", "3", "--measure-top-k", "1",
            "--out", str(tmp_path)]
    ops.reset_launch_counts()
    first = campaign.main(argv)
    counts = ops.launch_counts()
    assert counts["vecmul"] > 0 and counts["rmsnorm"] > 0
    assert (first["ran"], first["measured"]) == (2, 2)
    rows = CostDB(tmp_path / "cost_db.jsonl").all()
    assert not [d.reason for d in rows if d.status == "error"]
    measured = [d for d in rows if d.fidelity == "measured"]
    assert measured and all(d.metrics["backend"] == "cuda" for d in measured)
    ops.reset_launch_counts()
    again = campaign.main(argv)
    assert (again["ran"], again["resumed"], again["evaluations"]) == (0, 2, 0)
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_threads_an_initial_state(chunk, dtype, card):
    shape = KernelShape("ssd_s512", "ssd_scan",
                        {"b": 2, "s": 512, "nh": 4, "dh": 32, "N": 48}, dtype)
    x, dt, A, B, C = conformance.make_inputs(shape, device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    s0 = 0.3 * torch.randn(2, 4, 32, 48, generator=gen, device=card)
    # dh 32 and N 48: the wgmma kernel has no such size, the mma kernel
    # takes every chunk, f32 and bf16
    assert ssd.route(x.dtype, chunk, 32, 48) == "mma"
    for init in (None, s0):
        before = _build.LAUNCHES["ssd_scan/mma"]
        got = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=init)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["ssd_scan/mma"] == before + 1
        want = ssd_scan_plain(x, dt, A, B, C, chunk=chunk, initial_state=init)
        agree = conformance.agree_with_plain(got, want)
        assert agree["passed"], (init is None, agree)


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("N", ssd.WGMMA_N)
@pytest.mark.parametrize("chunk", ssd.WGMMA_CHUNKS)
def test_ssd_wgmma_matches_plain(chunk, N, with_state, card):
    # five chunks (an odd count against the two-stage ring), three heads
    shape = KernelShape("ssd_wgmma", "ssd_scan",
                        {"b": 1, "s": 5 * chunk, "nh": 3, "dh": 64, "N": N}, "bfloat16")
    x, dt, A, B, C = conformance.make_inputs(shape, device=card)
    gen = torch.Generator(device=card).manual_seed(chunk + N)
    init = 0.3 * torch.randn(1, 3, 64, N, generator=gen, device=card) if with_state else None
    assert ssd.route(x.dtype, chunk, 64, N) == "wgmma"
    before = _build.LAUNCHES["ssd_scan/wgmma"]
    got = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_scan/wgmma"] == before + 1
    agree = conformance.agree_with_plain(
        got, ssd_scan_plain(x, dt, A, B, C, chunk=chunk, initial_state=init))
    assert agree["passed"], agree


#: (dtype, dh, N, chunk) the whole-chunk mma kernel takes among f32 and
#: bf16, odd and full-width (dh, N) and chunks 32-256 (launch_key() is a pure
#: function of the sizes: the list is the same on every machine; the mma
#: route's streamed calls are test_ssd_fma_takes_what_the_mma_kernel_cannot's)
SSD_MMA_CASES = [(dtype, dh, N, chunk) for dtype in ("float32", "bfloat16")
                 for dh, N in ((24, 40), (32, 48), (64, 128)) for chunk in (32, 64, 128, 256)
                 if ssd.launch_key(conformance._DTYPES[dtype], chunk, dh, N) == "ssd_scan/mma"]


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype,dh,N,chunk", SSD_MMA_CASES)
def test_ssd_mma_matches_plain(dtype, dh, N, chunk, with_state, card):
    # three chunks (an odd count against the two-stage ring), three heads
    shape = KernelShape("ssd_mma", "ssd_scan",
                        {"b": 2, "s": 3 * chunk, "nh": 3, "dh": dh, "N": N}, dtype)
    x, dt, A, B, C = conformance.make_inputs(shape, device=card)
    gen = torch.Generator(device=card).manual_seed(chunk + N + dh)
    init = (0.3 * torch.randn(2, 3, dh, N, generator=gen, device=card)
            if with_state else None)
    before = _build.LAUNCHES["ssd_scan/mma"]
    got = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_scan/mma"] == before + 1
    agree = conformance.agree_with_plain(
        got, ssd_scan_plain(x, dt, A, B, C, chunk=chunk, initial_state=init))
    assert agree["passed"], agree


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype,dh,N,chunk", [
    ("float32", 64, 128, 256),   # f32 chunk tiles of 256 rows do not fit a block
    ("float32", 64, 64, 256),    # zamba2-2.7b's widths in f32
    ("float32", 32, 160, 64),    # N above 128
    ("bfloat16", 32, 160, 64),
    ("float32", 128, 256, 256),  # N 256 at dh 128: slices of dh
    ("bfloat16", 96, 128, 512),  # a chunk above 256
    ("float32", 30, 130, 96),    # dh and N padded, a masked last sub-tile
    ("bfloat16", 130, 30, 160),  # a last slice of dh with 2 columns
    ("bfloat16", 256, 64, 64),   # dh above 128 in two slices
])
def test_ssd_fma_takes_what_the_mma_kernel_cannot(dtype, dh, N, chunk, with_state, card):
    # the calls the FMA kernels took past the whole-chunk mma kernel: the mma
    # route streams them (csrc/ssd_scan_stream.cu)
    shape = KernelShape("ssd_stream", "ssd_scan",
                        {"b": 1, "s": 2 * chunk, "nh": 2, "dh": dh, "N": N}, dtype)
    x, dt, A, B, C = conformance.make_inputs(shape, device=card)
    gen = torch.Generator(device=card).manual_seed(dh + N + chunk)
    init = (0.3 * torch.randn(1, 2, dh, N, generator=gen, device=card)
            if with_state else None)
    assert ssd.route(x.dtype, chunk, dh, N) == "mma"
    assert ssd.launch_key(x.dtype, chunk, dh, N) == ssd.STREAM_KEY
    before = _build.LAUNCHES[ssd.STREAM_KEY]
    got = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[ssd.STREAM_KEY] == before + 1
    agree = conformance.agree_with_plain(
        got, ssd_scan_plain(x, dt, A, B, C, chunk=chunk, initial_state=init))
    assert agree["passed"], agree


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype,dh,N,chunk,tiles", [
    # N past what two warps' streamed block holds, with (row tile, (state
    # tile, state slice)) of the FMA kernels
    ("float32", 32, 384, 64, (32, (32, 32))),    # a row tile of 32
    ("bfloat16", 16, 768, 32, (32, (16, 16))),
    ("float32", 30, 390, 75, (32, (32, 32))),    # dh, N and the chunk padded to 4,
                                                 # masked last row and state tiles
    ("float32", 131, 401, 48, (48, (32, 32))),   # a masked last slice of 3 columns
    ("bfloat16", 37, 650, 96, (32, (32, 8))),    # slices of 8, the last of 5
    ("float32", 66, 513, 200, (32, (32, 16))),   # masked last row tile, state tile
                                                 # and slice
])
def test_ssd_fma_takes_what_no_mma_block_holds(dtype, dh, N, chunk, tiles, with_state, card):
    shape = KernelShape("ssd_fma", "ssd_scan",
                        {"b": 1, "s": 2 * chunk, "nh": 2, "dh": dh, "N": N}, dtype)
    x, dt, A, B, C = conformance.make_inputs(shape, device=card)
    gen = torch.Generator(device=card).manual_seed(dh + N + chunk)
    init = (0.3 * torch.randn(1, 2, dh, N, generator=gen, device=card)
            if with_state else None)
    assert ssd.route(x.dtype, chunk, dh, N) == "fma" and ssd.supported(chunk, N, dh)
    assert (ssd.row_tile(chunk, N, dh), ssd.state_plan(chunk, N, dh)) == tiles
    before = _build.LAUNCHES["ssd_scan/fma"]
    got = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_scan/fma"] == before + 1
    agree = conformance.agree_with_plain(
        got, ssd_scan_plain(x, dt, A, B, C, chunk=chunk, initial_state=init))
    assert agree["passed"], agree


#: (sq, sk, q_offset, causal) for flash attention on both routes (bf16) and
#: on the mma route (f32)
FLASH_CASES = [
    (128, 256, 0, True),
    (128, 320, 64, True),   # decode-style tail: walks of 3 and 4 tiles of 64
    (128, 256, -32, True),  # rows 0..31 see no key and average V
    (192, 320, 0, False),   # sq != sk; 5 K tiles of 64, odd against 2 stages
    (256, 128, 0, True),    # more queries than keys
    (32, 256, 224, True),   # a 32-row q block: the mma kernel
    (1, 256, 255, True),    # one query row (decode): the mma kernel, 15 rows padded
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("sq,sk,q_offset,causal", FLASH_CASES)
def test_flash_bf16_matches_plain_on_its_route(d, sq, sk, q_offset, causal, card):
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)

    def draw(s, heads):
        return (0.3 * torch.randn(2, s, heads, d, generator=gen, device=card)
                ).to(torch.bfloat16)

    q, k, v = draw(sq, 4), draw(sk, 2), draw(sk, 2)
    for bq, bk in [(64, 64), (64, 128), (128, 64), (128, 128), (256, 256), (128, 512)]:
        bq_, bk_ = min(bq, sq), min(bk, sk)
        if sq % bq_ or sk % bk_ or (bq > sq and bq != 64):
            continue
        key = f"flash_attention/{fa.route(q.dtype, d, bq_, bk_)}"
        assert key.endswith("wgmma") == (bq_ in fa.WGMMA_BLOCKS and bk_ in fa.WGMMA_BLOCKS)
        kw = dict(causal=causal, block_q=bq, block_k=bk, q_offset=q_offset)
        before = _build.LAUNCHES[key]
        got = fa.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[key] == before + 1
        agree = conformance.agree_with_plain(
            got, fa.flash_attention_plain(q, k, v, **kw))
        assert agree["passed"], (bq, bk, agree)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("sq,sk,q_offset,causal", FLASH_CASES)
def test_flash_f32_matches_plain_on_its_route(d, sq, sk, q_offset, causal, card):
    # f32 on split TF32 (three products a product) held to the plain
    # version at the unchanged PLAIN_REL; 256- and 512-row tiles run in
    # passes of 128 rows; where two K/V stages of a whole tile do not fit,
    # the ring holds part of one (64 keys at d=128)
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)

    def draw(s, heads):
        return 0.3 * torch.randn(2, s, heads, d, generator=gen, device=card)

    q, k, v = draw(sq, 4), draw(sk, 2), draw(sk, 2)
    for bq, bk in [(64, 64), (64, 128), (128, 64), (128, 128), (256, 64), (512, 128),
                   (256, 256), (64, 512)]:
        bq_, bk_ = min(bq, sq), min(bk, sk)
        if sq % bq_ or sk % bk_ or (bq > sq and bq != 64):
            continue
        assert flash_attention_resources(2, sq, sk, 4, 2, d, bq_, bk_, 4).feasible
        key = f"flash_attention/{fa.route(q.dtype, d, bq_, bk_)}"
        assert key == "flash_attention/mma" and fa.smem_bytes_mma(bq_, bk_, d, 4) <= 232_448
        kw = dict(causal=causal, block_q=bq, block_k=bk, q_offset=q_offset)
        before = _build.LAUNCHES[key]
        got = fa.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[key] == before + 1
        agree = conformance.agree_with_plain(
            got, fa.flash_attention_plain(q, k, v, **kw))
        assert agree["passed"], (bq, bk, agree)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [160, 192, 256])
def test_flash_wide_heads_match_plain_on_mma(d, dtype, card):
    # each head dim above 128 at the smallest and the largest tile, GQA,
    # q_offset and both masks: f32 on the mma kernel (q read from shared
    # memory at each product; 4 warps a block at d 256), bf16 on the mma
    # kernel at tiles outside the pools and on the wgmma kernel (DP 256,
    # sub-tiles of 64 keys) at tiles of the pools
    gen = torch.Generator(device=card).manual_seed(d)
    for sq, sk, bq, bk, q_offset, causal in [
            (16, 32, 1, 1, 16, True), (512, 512, 512, 512, 0, True),
            (512, 512, 512, 512, 0, False), (128, 320, 64, 64, 64, True),
            (128, 256, 128, 128, -32, True), (1, 256, 1, 256, 255, True)]:
        q, k, v = ((0.3 * torch.randn(2, s_, hh, d, generator=gen, device=card)).to(dtype)
                   for s_, hh in ((sq, 4), (sk, 2), (sk, 2)))
        on_wgmma = (dtype == torch.bfloat16 and bq in fa.WGMMA_BLOCKS
                    and bk in fa.WGMMA_BLOCKS)
        key = "flash_attention/" + ("wgmma" if on_wgmma else "mma")
        assert key == "flash_attention/" + fa.route(dtype, d, bq, bk)
        assert flash_attention_resources(2, sq, sk, 4, 2, d, bq, bk,
                                         q.element_size()).feasible
        kw = dict(causal=causal, block_q=bq, block_k=bk, q_offset=q_offset)
        before = _build.LAUNCHES[key]
        got = fa.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[key] == before + 1
        agree = conformance.agree_with_plain(got, fa.flash_attention_plain(q, k, v, **kw))
        assert agree["passed"], (sq, sk, kw, agree)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [80, 160, 192, 256])
def test_flash_padded_heads_match_plain_on_wgmma(d, causal, card):
    # bf16 at d 80 (stablelm-3b's and zamba2-2.7b's heads; padded to 128)
    # and 160-256 (padded to 256, sub-tiles of 64 keys) over every tile of
    # the pools, GQA and a q_offset, each on the wgmma kernel and within
    # PLAIN_REL of the plain version; the padded output columns are never
    # written past d
    gen = torch.Generator(device=card).manual_seed(d + causal)
    q, k, v = ((0.3 * torch.randn(2, 512, hh, d, generator=gen, device=card)).to(torch.bfloat16)
               for hh in (4, 2, 2))
    for bq in fa.WGMMA_BLOCKS:
        for bk in fa.WGMMA_BLOCKS:
            assert fa.route(q.dtype, d, bq, bk) == "wgmma"
            kw = dict(causal=causal, block_q=bq, block_k=bk, q_offset=64 if causal else 0)
            before = _build.LAUNCHES["flash_attention/wgmma"]
            got = fa.flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["flash_attention/wgmma"] == before + 1
            assert got.shape == q.shape and torch.isfinite(got).all()
            agree = conformance.agree_with_plain(got, fa.flash_attention_plain(q, k, v, **kw))
            assert agree["passed"], (bq, bk, agree)
    regs, local = fa.wgmma_attributes(d, 128, 128)
    assert 0 < regs <= 255 and regs * fa.wgmma_threads(128, d) <= 65_536 and local == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,bq,bk", [
    (torch.bfloat16, 320, 16, 16),   # d above 256: the split kernel
    (torch.float32, 320, 16, 32),
    (torch.float32, 512, 16, 16),
    (torch.float32, 320, 128, 128),  # pool tiles the FMA kernel refused
    (torch.bfloat16, 512, 256, 64),
    (torch.bfloat16, 264, 512, 512),
    (torch.float32, 1024, 8, 8),     # 8 slices, 8-key sub-tiles
    (torch.bfloat16, 1000, 64, 32),
])
def test_flash_fma_takes_what_the_mma_kernel_cannot(dtype, d, bq, bk, card):
    # the calls the FMA kernel took above d 256: the mma route's split kernel
    # (csrc/flash_attention_split.cu) runs them
    gen = torch.Generator(device=card).manual_seed(d + bk)
    q, k, v = ((0.3 * torch.randn(1, 256, hh, d, generator=gen, device=card)).to(dtype)
               for hh in (4, 2, 2))
    assert fa.route(dtype, d, bq, bk) == "mma"
    assert fa.launch_key(dtype, d, bq, bk) == fa.SPLIT_KEY
    before = _build.LAUNCHES[fa.SPLIT_KEY]
    got = fa.flash_attention_cuda(q, k, v, causal=True, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fa.SPLIT_KEY] == before + 1
    agree = conformance.agree_with_plain(
        got, fa.flash_attention_plain(q, k, v, causal=True, block_q=bq, block_k=bk))
    assert agree["passed"], agree
    regs, local = fa.mma_attributes(d, dtype)
    assert 0 < regs <= 255 and local == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [264, 320, 384, 448, 512])
def test_every_pool_tile_above_d_256_matches_plain_on_the_split_kernel(d, dtype, card):
    # the 16 tiles of the pools (block_q, block_k in 64-512), which the FMA
    # kernel refused at d 320 and above: each launches on the split kernel
    gen = torch.Generator(device=card).manual_seed(d)
    q, k, v = ((0.3 * torch.randn(1, 512, hh, d, generator=gen, device=card)).to(dtype)
               for hh in (4, 2, 2))
    for bq in fa.WGMMA_BLOCKS:
        for bk in fa.WGMMA_BLOCKS:
            assert fa.route(dtype, d, bq, bk) == "mma"
            before = _build.LAUNCHES[fa.SPLIT_KEY]
            got = fa.flash_attention_cuda(q, k, v, causal=True, block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            assert _build.LAUNCHES[fa.SPLIT_KEY] == before + 1
            agree = conformance.agree_with_plain(
                got, fa.flash_attention_plain(q, k, v, causal=True, block_q=bq, block_k=bk))
            assert agree["passed"], (bq, bk, agree)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fma_takes_d_above_1024(dtype, card):
    gen = torch.Generator(device=card).manual_seed(1088)
    q, k, v = ((0.3 * torch.randn(1, 64, hh, 1088, generator=gen, device=card)).to(dtype)
               for hh in (2, 1, 1))
    assert fa.route(dtype, 1088, 8, 8) == "fma"
    before = _build.LAUNCHES["flash_attention/fma"]
    got = fa.flash_attention_cuda(q, k, v, causal=True, block_q=8, block_k=8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention/fma"] == before + 1
    agree = conformance.agree_with_plain(
        got, fa.flash_attention_plain(q, k, v, causal=True, block_q=8, block_k=8))
    assert agree["passed"], agree


@pytest.mark.cuda
def test_flash_wgmma_refuses_tiles_it_does_not_instantiate(card):
    # the wrapper sends bf16 at d=100 (not a multiple of 8: TMA's row
    # strides are multiples of 16 bytes) to the mma kernel; the wgmma
    # launcher itself refuses it, d above 256, and a 192-row block (not a
    # whole number of passes)
    q = (0.3 * torch.randn(1, 384, 2, 100, device=card)).to(torch.bfloat16)
    assert fa.route(q.dtype, 100, 128, 128) == "mma"
    before = _build.LAUNCHES["flash_attention/mma"]
    got = fa.flash_attention_cuda(q, q, q, block_q=128, block_k=128)
    assert _build.LAUNCHES["flash_attention/mma"] == before + 1
    assert conformance.agree_with_plain(
        got, fa.flash_attention_plain(q, q, q, block_q=128, block_k=128))["passed"]
    o = torch.empty_like(q)
    err = _build.library().flash_attention_wgmma_launch(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), 1, 384, 384, 2, 2,
        100, 128, 128, 1, 0, 100 ** -0.5, fa.wgmma_threads(128, 128),
        fa.smem_bytes_wgmma(128, 128, 128), _build.stream_ptr(card))
    assert err != 0
    q264 = (0.3 * torch.randn(1, 384, 2, 264, device=card)).to(torch.bfloat16)
    err = _build.library().flash_attention_wgmma_launch(
        q264.data_ptr(), q264.data_ptr(), q264.data_ptr(), torch.empty_like(q264).data_ptr(),
        1, 384, 384, 2, 2, 264, 128, 128, 1, 0, 264 ** -0.5, fa.wgmma_threads(128, 256),
        232_448, _build.stream_ptr(card))
    assert err != 0
    q64 = q[..., :64].contiguous()
    err = _build.library().flash_attention_wgmma_launch(
        q64.data_ptr(), q64.data_ptr(), q64.data_ptr(), o.data_ptr(), 1, 384, 384, 2, 2,
        64, 192, 128, 1, 0, 0.125, fa.wgmma_threads(192, 64),
        fa.smem_bytes_wgmma(192, 128, 64), _build.stream_ptr(card))
    assert err != 0


#: the full-width flash shape, llama3-8b's prefill of 4096 tokens
FULL_WIDTH_FLASH = KernelShape("attn_llama3_8b_s4096_bf16", "flash_attention",
                               {"b": 1, "sq": 4096, "sk": 4096, "h": 32, "kh": 8, "d": 128},
                               "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_full_width_large_tiles_run_on_wgmma(causal, card):
    # every full-width tile with block_q or block_k above 128: passes of
    # 128 rows, sub-tiles of 128 keys, held to the plain version (which
    # walks the same sub-tiles) within PLAIN_REL
    q, k, v = conformance.make_inputs(FULL_WIDTH_FLASH, device=card)
    n = 0
    for dims in tile_grid(FULL_WIDTH_FLASH):
        bq, bk = dims["block_q"], dims["block_k"]
        if dims["causal"] != causal or max(bq, bk) <= 128:
            continue
        assert fa.route(q.dtype, 128, bq, bk) == "wgmma"
        before = _build.LAUNCHES["flash_attention/wgmma"]
        got = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_attention/wgmma"] == before + 1
        agree = conformance.agree_with_plain(
            got, fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk))
        assert agree["passed"], (bq, bk, agree)
        n += 1
    assert n == 12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,route", [
    (torch.bfloat16, (1, 4096, 32, 8, 128), "wgmma"),  # llama3-8b's widths
    (torch.float32, (1, 512, 4, 2, 128), "mma"),       # a ring of 64-key stages
])
def test_flash_shipped_blocks_run_at_full_width(dtype, shape, route, card):
    # ops.flash_attention with no block arguments: the shipped 512 x 512
    b, s, h, kh, d = shape
    gen = torch.Generator(device=card).manual_seed(s + d)
    q, k, v = ((0.3 * torch.randn(b, s, hh, d, generator=gen, device=card)).to(dtype)
               for hh in (h, kh, kh))
    before = _build.LAUNCHES[f"flash_attention/{route}"]
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"flash_attention/{route}"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape and torch.isfinite(got).all()
    agree = conformance.agree_with_plain(got, fa.flash_attention_plain(q, k, v))
    assert agree["passed"], agree


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", [32, 64, 128, 256])
@pytest.mark.parametrize("rows,d,dtype,kind", [
    (8193, 4096, torch.bfloat16, "registers"),  # llama3-8b rows, one left over
    (8193, 6144, torch.bfloat16, "two-pass"),
    (301, 100, torch.bfloat16, "scalar"),
    (173, 96, torch.float32, "registers"),
    (37, 65_536, torch.bfloat16, "wide"),       # w in f32 would not fit a block
    (19, 65_537, torch.float32, "wide"),        # and not whole vectors
])
def test_rmsnorm_paths_match_plain(rows, d, dtype, kind, block_rows, card):
    gen = torch.Generator(device=card).manual_seed(rows + d)
    x = (0.3 * torch.randn(rows, d, generator=gen, device=card)).to(dtype)
    w = (0.3 * torch.randn(d, generator=gen, device=card)).to(dtype)
    assert rn.path(d, x.element_size()) == kind
    before = _build.LAUNCHES[f"rmsnorm/{kind}"]
    got = rn.rmsnorm_cuda(x, w, block_rows=block_rows)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"rmsnorm/{kind}"] == before + 1
    agree = conformance.agree_with_plain(
        got, rn.rmsnorm_plain(x, w, block_rows=block_rows))
    assert agree["passed"], agree


# ---------------------------------------------------------------------------
# the dense model on the card
# ---------------------------------------------------------------------------
def _rel(want, got) -> float:
    want, got = want.float().cpu(), got.float().cpu()
    return float((want - got).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def llama_2l():
    """llama3-8b at full width with 2 layers: random bf16 weights made on
    the card from a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the model runs there in bf16")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    params, _ = M.init_params(cfg, seed=0, device="cuda")
    return cfg, params


@pytest.mark.cuda
def test_full_width_prefill_and_decode_match_the_cpu():
    """bf16 on the card against f32 on the CPU, same weights: a 2048-token
    prefill and 8 decode steps within ``MODEL_REL`` at every step and in
    every cache leaf; f32 on the card within ``F32_REL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the model runs there in bf16")
    from repro_torch.launch.measure import F32_REL, MODEL_REL, check_against_cpu

    chk = check_against_cpu("llama3-8b", n_layers=2, tokens=2048, steps=8, device="cuda")
    assert chk["finite"]
    assert chk["len"] == ([2048 + 8], [2048 + 8])
    assert max(chk["bf16"]["logits"]) < MODEL_REL, chk["bf16"]["logits"]
    assert max(chk["bf16"]["cache"].values()) < MODEL_REL
    assert chk["f32"]["worst"] < F32_REL
    assert chk["ok"]


@pytest.mark.cuda
def test_decode_is_consistent_with_a_longer_prefill_on_the_card(llama_2l):
    from repro_torch.models import model as M

    from repro_torch.launch.measure import MODEL_REL

    cfg, params = llama_2l
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 1025), generator=gen, device="cuda",
                        dtype=torch.int32)
    with torch.no_grad():
        _, cache = M.prefill_fn(cfg, params, {"tokens": tok[:, :1024]},
                                M.init_cache(cfg, 2, 1100, device="cuda"))
        step, _ = M.decode_fn(cfg, params, {"tokens": tok[:, 1024:]}, cache)
        full, _ = M.prefill_fn(cfg, params, {"tokens": tok},
                               M.init_cache(cfg, 2, 1100, device="cuda"))
    assert _rel(full, step) < MODEL_REL


# ---------------------------------------------------------------------------
# the train step on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_full_width_train_step_matches_the_cpu():
    """One train step of llama3-8b at full width, 2 layers, 2048 tokens,
    ``remat=full`` and int8 moments: bf16 on the card against f32 on the
    CPU, same weights and batch; loss and gradient norm within
    ``MODEL_REL``, each gradient leaf, moment and new param within
    ``TRAIN_LEAF_REL`` (``pytest -s`` prints the worst of each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the model runs there in bf16")
    from repro_torch.configs import get_config
    from repro_torch.launch.measure import (MODEL_REL, TRAIN_LEAF_REL,
                                            check_train_against_cpu)

    chk = check_train_against_cpu(get_config("llama3-8b"), n_layers=2, tokens=2048,
                                  device="cuda")
    print(f"loss {chk['loss']:.3g}, grad norm {chk['grad_norm']:.3g}, worst {chk['worst']}")
    assert chk["finite"]
    assert chk["loss"] < MODEL_REL and chk["grad_norm"] < MODEL_REL, chk
    for part, (leaf, err) in chk["worst"].items():
        assert err < TRAIN_LEAF_REL, (part, leaf, err)
    assert chk["ok"]


@pytest.mark.cuda
def test_full_width_train_check_catches_a_wrong_attention_gradient(monkeypatch):
    """The same check with a fault on the card only: the score product's
    gradient to q dropped in bf16. The loss is untouched (the global
    gradient norm, which the embedding and the head dominate at 2 layers,
    moves little: ``pytest -s`` prints it); the leaves that reach the
    scores through q alone read 1 and fail the check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fault is on the card's side")
    from repro_torch.configs import get_config
    from repro_torch.launch.measure import MODEL_REL, check_train_against_cpu
    from repro_torch.models import layers as TL

    backward = TL._ProductF32.backward

    def faulty(ctx, g):
        ga, gb, n = backward(ctx, g)
        return (torch.zeros_like(ga) if ga is not None and ga.is_cuda else ga), gb, n

    monkeypatch.setattr(TL._ProductF32, "backward", staticmethod(faulty))
    chk = check_train_against_cpu(get_config("llama3-8b"), n_layers=2, tokens=2048,
                                  device="cuda")
    print(f"fault: loss {chk['loss']:.3g}, grad norm {chk['grad_norm']:.3g}, "
          f"grad leaves {chk['leaves']['grad']}")
    assert chk["loss"] < MODEL_REL
    assert chk["leaves"]["grad"]["blocks.attn.wq"] == pytest.approx(1.0)
    assert not chk["ok"]


@pytest.mark.cuda
def test_train_launcher_resumes_bit_for_bit_on_the_card(tmp_path):
    """``launch.train`` on the card: 20 steps of the reduced qwen3-0.6b, then
    a restart from step 15 whose losses equal the first run's bit for bit;
    no kernel of the port is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    base = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "20",
            "--ckpt", str(tmp_path / "ck"), "--device", "cuda"]
    train.main(base + ["--history", str(tmp_path / "a.json")])
    train.main(base + ["--resume-step", "15", "--history", str(tmp_path / "b.json")])
    a = [h["loss"] for h in json.loads((tmp_path / "a.json").read_text())]
    b = [h["loss"] for h in json.loads((tmp_path / "b.json").read_text())]
    assert len(a) == 20 and all(math.isfinite(x) for x in a) and b == a[15:]
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
def test_plan_head_is_measured_on_the_card_at_a_batch_that_fits(card, tmp_path):
    from repro_torch.configs import SHAPE_BY_NAME, get_config
    from repro_torch.core.design_space import PlanTemplate, baseline_point
    from repro_torch.core.device import H100_SXM
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.launch import measure

    ev = Evaluator(mesh="pod", torch_device="cuda", artifact_dir=str(tmp_path),
                   measure_runs=1)
    cfg, cell = get_config("llama3-8b"), SHAPE_BY_NAME["decode_32k"]
    point = baseline_point(cell, PlanTemplate(cfg, cell, ev.mesh_shape))
    ops.reset_launch_counts()
    dp = ev.measure("llama3-8b", "decode_32k", point, modeled_bound_s=1e-3)
    m = dp.metrics
    assert dp.status == "ok" and dp.fidelity == "measured", dp.reason
    assert m["backend"] == "cuda" and m["device_name"] == torch.cuda.get_device_name(0)
    # 34.4 GB of cache and 16 GB of weights at 8; about 85 GB at 16
    assert m["reduced"] == {"global_batch": [128, 8]}
    assert m["per_device_bytes_1x1"] <= measure.FIT_SHARE * H100_SXM.hbm_bytes
    assert m["peak_bytes"] < torch.cuda.get_device_properties(0).total_memory
    assert m["measured_s"] > 0 and m["bound_s_1x1"] > 0 and m["bound_s_modeled"] == 1e-3
    assert not any(ops.launch_counts().values())  # torch math, no kernel of the port
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_vecmul_demo_runs_on_the_card(card, tmp_path):
    from repro_torch.examples import dse_vecmul

    ops.reset_launch_counts()
    out = dse_vecmul.run("cuda", db_path=tmp_path / "db.jsonl", verbose=False)
    assert out["design"]["kernel"] == "vecmul" and out["device"] == "cuda"
    assert out["max_abs_err"] == 0.0 and ops.launch_counts()["vecmul"] == 1
    assert out["rows"] == 6 and out["negatives"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b", "llava-next-34b",
                                  "mamba2-780m", "zamba2-2.7b", "seamless-m4t-medium"])
def test_reduced_families_on_the_card_match_the_cpu(arch):
    """Each family at ``reduced`` size in f32 (TF32 off) on the card and on
    the CPU, same weights: a 40-position prefill and two decode steps within
    1e-4 of the largest |logit|, every cache leaf too; no kernel of the
    port runs (the models are torch math)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the models run there")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.measure import _cache_leaves, model_inputs
    from repro_torch.models import model as M

    cfg = reduced(get_config(arch))
    params, _ = M.init_params(cfg, seed=0)
    batch = model_inputs(cfg, 42, torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    try:
        outs = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.to(dev) for k, v in params.items()}
            b = {k: (v[:, :40] if k == "tokens" else v).to(dev) for k, v in batch.items()}
            pre = cfg.frontend_len if cfg.family == "vlm" else 0
            with torch.no_grad():
                lg, cache = M.prefill_fn(cfg, p, b, M.init_cache(cfg, 1, pre + 48, device=dev))
                logits = [lg]
                for i in (40, 41):
                    lg, cache = M.decode_fn(cfg, p, {"tokens": batch["tokens"][:, i:i + 1]
                                                     .to(dev)}, cache)
                    logits.append(lg)
            outs[dev] = ([x.cpu() for x in logits],
                         {k: v.cpu() for k, v in _cache_leaves(cache)})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for want, got in zip(outs["cpu"][0], outs["cuda"][0]):
        assert _rel(want, got) < 1e-4
    for k, want in outs["cpu"][1].items():
        if k.endswith("len"):
            assert torch.equal(want, outs["cuda"][1][k])
        else:
            assert _rel(want, outs["cuda"][1][k]) < 1e-4, k
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["lora", "frontend"])
def test_full_width_model_check_catches_a_fault_on_the_card(fault, monkeypatch):
    """The family model check with a fault on the card only: zamba2-2.7b's
    shared block without its q, k, v and MLP LoRA deltas (one group of 6
    layers), or llava-next-34b's frontend rows shifted by one (2 layers).
    The f32 run fails its limit in both; the bf16 run fails too where the
    fault outgrows bf16's rounding (the LoRA; a reduced llava's shift reads
    0.64% on the CPU). ``pytest -s`` prints the readings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fault is on the card's side")
    from repro_torch.launch.measure import F32_REL, check_against_cpu
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as T

    if fault == "lora":
        arch, n = "zamba2-2.7b", 6
        delta, proj = TL._lora_delta, TL._project_in_lora
        monkeypatch.setattr(TL, "_lora_delta", lambda x, p, nm, use, like=None: delta(
            x, p, nm, use and not x.is_cuda, like))
        monkeypatch.setattr(TL, "_project_in_lora", lambda x, p, nm, use: proj(
            x, p, nm, use and not x.is_cuda))
    else:
        arch, n = "llava-next-34b", 2
        embed = T._embed_inputs

        def shifted(cfg, params, batch, constrain):
            x, positions = embed(cfg, params, batch, constrain)
            if x.is_cuda and "frontend" in batch:
                f = cfg.frontend_len
                x = torch.cat([x[:, 1:f], x[:, :1], x[:, f:]], dim=1)
            return x, positions

        monkeypatch.setattr(T, "_embed_inputs", shifted)
    chk = check_against_cpu(arch, n_layers=n, tokens=2048, steps=8, device="cuda")
    print(f"{fault}: f32 {chk['f32']['worst']:.4g} (limit {F32_REL}), bf16 "
          f"{chk['bf16']['worst']:.4g} (limit {chk['limit']['bf16']:.4g})")
    assert chk["finite"] and not chk["ok"]
    assert chk["f32"]["worst"] > F32_REL
    if fault == "lora":
        assert chk["bf16"]["worst"] > chk["limit"]["bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batcher_on_the_card_matches_its_batch_1_replay(card, dtype):
    """The continuous batcher on reduced qwen3-0.6b on the card, freed rows
    refilled (fewer decode steps than the static waves' 2 x 23): every
    generated token within 2e-2 of the largest |logit| of its position's
    max logit when each request is replayed alone, teacher-forced."""
    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import teacher_forced_gap
    from repro_torch.models import model as M
    from repro_torch.serve import step as serve_step
    from repro_torch.serve.batcher import Batcher
    from repro_torch.sharding.plan import ShardingPlan

    cfg = reduced(get_config("qwen3-0.6b"), dtype=dtype)
    params, _ = M.init_params(cfg, seed=0, device=card)
    plan = ShardingPlan(rules={})
    prefill = serve_step.make_prefill_step(cfg, plan, None)
    decode = serve_step.make_decode_step(cfg, plan, None)

    def init_cache(b, ml):
        return M.init_cache(cfg, b, ml, device=card)

    b = Batcher(cfg, params, prefill, decode, init_cache, max_batch=4, max_len=96)
    rng = np.random.default_rng(0)
    reqs = [b.submit(rng.integers(0, cfg.vocab, 32), max_new=4 if i % 2 == 0 else 24)
            for i in range(8)]
    b.run()
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert b.stats["decode_steps"] < 46 and b.stats["prefills"] > 2
    gap = teacher_forced_gap(params, prefill, decode, init_cache, reqs, 96)
    assert gap <= 2e-2, gap
