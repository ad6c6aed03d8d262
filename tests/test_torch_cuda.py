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
