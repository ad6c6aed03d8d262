"""repro_torch's continuous batcher and serve launcher.

The reference's four batcher tests mirrored on the port (reduced
qwen3-0.6b): end to end, unique rids, freed slots refilled (fewer decode
steps than the static-wave schedule's 14, 3 prefills, the same tokens)
and ``t_done`` at actual completion. Then the port's ``Batcher`` against
the reference's on the same weights (``params_from_reference``) and
equal-length prompts in f32, with mixed ``max_new`` so that freed rows are
spliced into a live cache: dense (qwen3-0.6b), SSM (mamba2-780m) and
hybrid (zamba2-2.7b) caches, whose leaves put the batch axis in different
places. Token lists must be identical and the stats' counts equal; the
first prefill's logits agree within 1e-4 of the largest. Last, ``python -m
repro_torch.launch.serve --device cpu`` prints the reference launcher's
counts."""
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.launch import serve as jserve_cli
from repro.models import model as JM
from repro.serve import step as jserve_step
from repro.serve.batcher import Batcher as JBatcher
from repro.sharding.plan import ShardingPlan as JPlan
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.serve import step as serve_step
from repro_torch.serve.batcher import Batcher, _splice_rows
from repro_torch.sharding.plan import ShardingPlan

COUNT_KEYS = ("requests", "tokens", "decode_steps", "prefills")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small models, so that under the
    suite's parallel workers they do not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def serving_stack():
    cfg = reduced(get_config("qwen3-0.6b"))
    params, _ = M.init_params(cfg, seed=0)
    plan = ShardingPlan(rules={})
    return (cfg, params, serve_step.make_prefill_step(cfg, plan, None),
            serve_step.make_decode_step(cfg, plan, None))


def _make_batcher(serving_stack, **kw):
    cfg, params, prefill, decode = serving_stack
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 64)
    return Batcher(cfg, params, prefill, decode,
                   init_cache=lambda bs, ml: M.init_cache(cfg, bs, ml), **kw)


def _static_wave_outputs(serving_stack, prompts, max_news, max_batch, max_len=64):
    """The pre-continuous-batching schedule: waves of ``max_batch`` decoded
    in lock-step to the wave-max ``max_new``. Returns (per-request outputs,
    total decode steps)."""
    cfg, params, prefill, decode = serving_stack
    outs = [[] for _ in prompts]
    n_steps = 0
    start = 0
    with torch.inference_mode():
        while start < len(prompts):
            idx = list(range(start, min(start + max_batch, len(prompts))))
            start += len(idx)
            plen = max(len(prompts[j]) for j in idx)
            toks = np.zeros((len(idx), plen), np.int32)
            for k, j in enumerate(idx):
                toks[k, plen - len(prompts[j]):] = prompts[j]
            cache = M.init_cache(cfg, len(idx), max_len)
            logits, cache = prefill(params, {"tokens": torch.from_numpy(toks)}, cache)
            cur = torch.argmax(logits[:, -1], -1).to(torch.int32)
            for k, j in enumerate(idx):
                outs[j].append(int(cur[k]))
            active = [True] * len(idx)
            steps = 0
            while any(active) and steps < max(max_news[j] for j in idx) - 1:
                logits, cache = decode(params, {"tokens": cur[:, None]}, cache)
                cur = torch.argmax(logits[:, -1], -1).to(torch.int32)
                steps += 1
                n_steps += 1
                for k, j in enumerate(idx):
                    if active[k]:
                        outs[j].append(int(cur[k]))
                        if len(outs[j]) >= max_news[j]:
                            active[k] = False
    return outs, n_steps


def test_batcher_end_to_end(serving_stack):
    b = _make_batcher(serving_stack)
    rng = np.random.default_rng(0)
    for n in (5, 9, 3, 7):  # 4 requests > max_batch: two waves
        b.submit(rng.integers(0, b.cfg.vocab, size=n), max_new=6)
    done = b.run()
    assert len(done) == 4
    assert all(r.done and len(r.out) == 6 for r in done)
    assert b.stats["tokens"] == 24
    assert b.stats["tok_per_s"] > 0


def test_batcher_rids_unique_across_interleaved_runs(serving_stack):
    """Interleaved submit/run must hand out unique rids."""
    b = _make_batcher(serving_stack, max_batch=2)
    rng = np.random.default_rng(1)
    first = [b.submit(rng.integers(0, b.cfg.vocab, size=4), max_new=2) for _ in range(2)]
    b.run()
    second = [b.submit(rng.integers(0, b.cfg.vocab, size=4), max_new=2) for _ in range(2)]
    b.run()
    rids = [r.rid for r in first + second]
    assert len(set(rids)) == 4, rids


def test_batcher_refills_freed_slots(serving_stack):
    """Freed slots are refilled mid-decode, so a mixed-``max_new`` workload
    takes fewer decode steps than the static-wave schedule while every
    request's tokens stay identical (equal-length prompts: padding is
    attended)."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, size=6) for _ in range(4)]
    max_news = [2, 8, 2, 8]
    want, static_steps = _static_wave_outputs(serving_stack, prompts, max_news, max_batch=2)

    b = _make_batcher(serving_stack, max_batch=2)
    reqs = [b.submit(p, max_new=mn) for p, mn in zip(prompts, max_news)]
    done = b.run()
    assert len(done) == 4 and all(r.done for r in done)
    assert [r.out for r in reqs] == want
    assert all(len(r.out) == r.max_new for r in reqs)
    assert static_steps == 14  # two waves of max(2, 8) - 1 decode steps
    assert b.stats["decode_steps"] < 14
    assert b.stats["prefills"] == 3  # initial wave + two single-slot admits


def test_batcher_t_done_marks_actual_completion(serving_stack):
    rng = np.random.default_rng(3)
    b = _make_batcher(serving_stack, max_batch=2)
    short = b.submit(rng.integers(0, b.cfg.vocab, size=5), max_new=1)
    long = b.submit(rng.integers(0, b.cfg.vocab, size=5), max_new=8)
    done = b.run()
    t_end = time.time()
    assert [r.rid for r in done] == [short.rid, long.rid]
    assert len(short.out) == 1  # exactly max_new, not one step of overshoot
    assert short.t_done is not None and long.t_done is not None
    assert short.t_done < long.t_done <= t_end


def test_splice_rows_finds_each_leafs_batch_axis():
    full = {"k": torch.zeros(2, 4, 3), "len": torch.zeros(4, dtype=torch.int32),
            "ssm": {"h": torch.zeros(2, 4, 5, 6)}}
    sub = {"k": torch.ones(2, 2, 3), "len": torch.tensor([7, 9], dtype=torch.int32),
           "ssm": {"h": torch.full((2, 2, 5, 6), 2.0)}}
    out = _splice_rows(full, sub, [3, 1])
    assert out is full
    assert full["len"].tolist() == [0, 9, 0, 7]
    assert full["k"][:, [1, 3]].eq(1).all() and full["k"][:, [0, 2]].eq(0).all()
    assert full["ssm"]["h"][:, [1, 3]].eq(2).all() and full["ssm"]["h"][:, 0].eq(0).all()


# ---------------------------------------------------------------------------
# the port's batcher against the reference's, same weights
# ---------------------------------------------------------------------------
def _both(arch):
    jcfg = jreduced(jget(arch))
    tcfg = reduced(get_config(arch))
    values, _ = JM.materialize_params(jcfg, jax.random.key(0))
    tparams = M.params_from_reference(tcfg, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), values))
    jplan, tplan = JPlan(rules={}), ShardingPlan(rules={})
    jb = JBatcher(jcfg, values, jax.jit(jserve_step.make_prefill_step(jcfg, jplan, None)),
                  jax.jit(jserve_step.make_decode_step(jcfg, jplan, None)),
                  init_cache=lambda b, ml: JM.init_cache(jcfg, b, ml),
                  max_batch=3, max_len=48)
    tb = Batcher(tcfg, tparams, serve_step.make_prefill_step(tcfg, tplan, None),
                 serve_step.make_decode_step(tcfg, tplan, None),
                 init_cache=lambda b, ml: M.init_cache(tcfg, b, ml),
                 max_batch=3, max_len=48)
    return jb, tb


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m", "zamba2-2.7b"])
def test_batcher_matches_the_reference(arch):
    jb, tb = _both(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tb.cfg.vocab, size=7) for _ in range(7)]
    max_news = [3, 9, 2, 6, 4, 8, 5]
    jr = [jb.submit(p, max_new=n) for p, n in zip(prompts, max_news)]
    tr = [tb.submit(p, max_new=n) for p, n in zip(prompts, max_news)]
    jb.run()
    tb.run()
    assert [r.out for r in tr] == [r.out for r in jr]
    assert {k: tb.stats[k] for k in COUNT_KEYS} == {k: jb.stats[k] for k in COUNT_KEYS}
    # rows were spliced into live caches (more prefills than waves)
    assert tb.stats["prefills"] > 3

    # the first prefill's logits, the batcher's own step on a left-padded group
    toks = np.stack(prompts[:3]).astype(np.int32)
    jl, _ = jb.prefill_step(jb.params, {"tokens": jnp.asarray(toks)},
                            jb.init_cache(3, jb.max_len))
    with torch.inference_mode():
        tl, _ = tb.prefill_step(tb.params, {"tokens": torch.from_numpy(toks)},
                                tb.init_cache(3, tb.max_len))
    jl = np.asarray(jl, np.float32)
    assert np.abs(jl - tl.float().numpy()).max() <= 1e-4 * np.abs(jl).max()


def test_serve_cli_prints_the_reference_counts(capsys, monkeypatch):
    s = serve_cli.main(["--arch", "qwen3-0.6b", "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen3-0.6b"])
    jserve_cli.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    counts = re.compile(r"^(\d+) requests, (\d+) tokens, [\d.]+ tok/s$")
    assert counts.match(got).groups() == counts.match(want).groups() == ("8", "96")
    assert (s["requests"], s["tokens"]) == (8, 96)
    with pytest.raises(SystemExit, match="text-in"):
        serve_cli.main(["--arch", "llava-next-34b", "--device", "cpu"])
