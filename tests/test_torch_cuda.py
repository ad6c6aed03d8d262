"""repro_torch kernels on the card: each CUDA kernel against its plain
version over the full legal grid of the CI shapes and a few odd shapes
(row by row, within ``conformance.PLAIN_REL``), the SSD scan also with an
initial state at every chunk, the bf16 SSD scan on its wgmma route at every
instantiated (chunk, N) over an odd number of chunks, bf16 flash attention
on both of its routes
with ``sq != sk``, ``q_offset``, odd K-tile walks and short query blocks at
d = 64, 96 and 128, every
rmsnorm path at an odd row count and every ``block_rows``, the oracle
gate, launch counting, refused launches, one DSE cell with measured
rows on cuda, and a two-cell kernel campaign that resumes with no
launch; and the dense model on the card: llama3-8b at full width with 2
layers, a 2048-token prefill and 8 decode steps in bf16 on the card
against f32 on the CPU on the same weights, and decode consistency. The
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
    rep = dse.main(["--arch", "flash_attention", "--shape", "attn_s256_gqa_bf16",
                    "--iterations", "2", "--budget", "3", "--measure-top-k", "2",
                    "--db", str(db)])
    assert ops.launch_counts()["flash_attention"] > 0
    assert rep["best"] is not None
    measured = [d for d in CostDB(db).all() if d.fidelity == "measured"]
    assert measured and all(d.status == "ok" and d.metrics["backend"] == "cuda"
                            for d in measured)


@pytest.mark.cuda
def test_kernel_campaign_runs_and_resumes_on_cuda(card, tmp_path):
    argv = ["--archs", "vecmul,rmsnorm", "--shapes", "vec_64k_f32,rms_1kx256_bf16",
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
    for init in (None, s0):
        got = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=init)
        torch.cuda.synchronize()
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


#: (sq, sk, q_offset, causal) for bf16 flash attention on both routes
FLASH_CASES = [
    (128, 256, 0, True),
    (128, 320, 64, True),   # decode-style tail: walks of 3 and 4 tiles of 64
    (128, 256, -32, True),  # rows 0..31 see no key and average V
    (192, 320, 0, False),   # sq != sk; 5 K tiles of 64, odd against 2 stages
    (256, 128, 0, True),    # more queries than keys
    (32, 256, 224, True),   # a 32-row q block: the FMA kernel
    (1, 256, 255, True),    # one query row (decode): the FMA kernel
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
    for bq, bk in [(64, 64), (64, 128), (128, 64), (128, 128)]:
        bq_, bk_ = min(bq, sq), min(bk, sk)
        if sq % bq_ or sk % bk_ or (bq > sq and bq != 64):
            continue
        key = f"flash_attention/{fa.route(q.dtype, d, bq_, bk_)}"
        assert key.endswith("wgmma") == (d != 96 and sq >= 64)
        kw = dict(causal=causal, block_q=bq, block_k=bk, q_offset=q_offset)
        before = _build.LAUNCHES[key]
        got = fa.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[key] == before + 1
        agree = conformance.agree_with_plain(
            got, fa.flash_attention_plain(q, k, v, **kw))
        assert agree["passed"], (bq, bk, agree)


@pytest.mark.cuda
def test_flash_wgmma_refuses_tiles_it_does_not_instantiate(card):
    # the wrapper sends (256, 64) to the FMA kernel; the wgmma launcher
    # itself refuses it
    q = (0.3 * torch.randn(1, 256, 2, 64, device=card)).to(torch.bfloat16)
    before = _build.LAUNCHES["flash_attention/fma"]
    got = fa.flash_attention_cuda(q, q, q, block_q=256, block_k=64)
    assert _build.LAUNCHES["flash_attention/fma"] == before + 1
    assert conformance.agree_with_plain(
        got, fa.flash_attention_plain(q, q, q, block_q=256, block_k=64))["passed"]
    o = torch.empty_like(q)
    err = _build.library().flash_attention_wgmma_launch(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), 1, 256, 256, 2, 2,
        64, 256, 64, 1, 0, 0.125, fa.wgmma_threads(256),
        fa.smem_bytes_wgmma(256, 64, 64), _build.stream_ptr(card))
    assert err != 0


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", [32, 64, 128, 256])
@pytest.mark.parametrize("rows,d,dtype,kind", [
    (8193, 4096, torch.bfloat16, "registers"),  # llama3-8b rows, one left over
    (8193, 6144, torch.bfloat16, "two-pass"),
    (301, 100, torch.bfloat16, "scalar"),
    (173, 96, torch.float32, "registers"),
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
    prefill and 8 decode steps within ``MODEL_REL`` at every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the model runs there in bf16")
    from repro_torch.launch.measure import MODEL_REL, check_against_cpu

    chk = check_against_cpu("llama3-8b", n_layers=2, tokens=2048, steps=8, device="cuda")
    assert chk["finite"]
    assert chk["len"] == ([2048 + 8], [2048 + 8])
    assert max(chk["logits"]) < MODEL_REL, chk["logits"]
    assert chk["cache"] < MODEL_REL
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
