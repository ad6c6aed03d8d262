"""The port's data, checkpoints, trainer and launcher: batches byte for
byte equal to the reference's; a bit-exact checkpoint round trip with a
bf16 leaf, in the reference's layout; an uncommitted checkpoint ignored;
resume equal to an uninterrupted run; faults survived and ``max_retries``;
the straggler watchdog; the prefetcher's order; and ``python -m
repro_torch.launch.train --reduced --device cpu`` for 20 steps from the
reference launcher's initial checkpoint against the reference launcher's
losses (within 1e-3 relative per step, falling), then restarted from a
checkpoint with the same losses bit for bit."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro_torch.configs import get_config, reduced
from repro_torch.sharding.plan import ShardingPlan
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import step as step_mod
from repro_torch.train.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

SRC = Path(__file__).resolve().parents[1] / "src"


def _tiny(**plan_kw):
    cfg = reduced(get_config("qwen3-0.6b"))
    plan = ShardingPlan(rules={}, zero1=False, remat="none", **plan_kw)
    state, _ = step_mod.init_train_state(cfg, plan, seed=0)
    step = step_mod.make_train_step(cfg, plan, None, AdamWConfig(warmup_steps=1))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    return cfg, plan, state, step, data


def _leaves(tree):
    return [t for _, t in ckpt._flatten(tree)]


@pytest.mark.parametrize("host_id", [0, 1])
def test_data_is_the_reference_byte_for_byte(host_id):
    kw = dict(vocab=300, seq_len=12, global_batch=6, seed=3, n_hosts=2, host_id=host_id)
    mine, ref = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for step in (0, 1, 7):
        a, b = mine.batch(step), ref.batch(step)
        assert set(a) == set(b) == {"tokens", "targets"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_checkpoint_roundtrip_is_bit_exact_with_a_bf16_leaf(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"params": {"blocks.attn.wq": torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
                        "ln_f": torch.randn(5, generator=g)},
             "opt": {"m": {"ln_f": {"q": torch.randint(-127, 128, (5,), dtype=torch.int8),
                                    "s": torch.rand(1, generator=g)}},
                     "step": torch.tensor(7, dtype=torch.int32)}}
    ckpt.save_checkpoint(tmp_path, 7, state, extra={"note": "x"})
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert set(manifest) == {"step", "time", "extra", "leaves"}
    by = {rec["path"]: rec for rec in manifest["leaves"]}
    assert by["params/blocks/attn/wq"]["dtype"] == "bfloat16"
    assert by["params/blocks/attn/wq"]["shape"] == [2, 3, 4]
    assert set(by) == {"params/blocks/attn/wq", "params/ln_f", "opt/m/ln_f/q", "opt/m/ln_f/s",
                       "opt/step"}
    assert (tmp_path / "step_00000007" / "COMMIT").exists()
    like = {"params": {k: torch.zeros_like(v) for k, v in state["params"].items()},
            "opt": {"m": {"ln_f": {"q": torch.zeros(5, dtype=torch.int8),
                                   "s": torch.zeros(1)}},
                    "step": torch.tensor(0, dtype=torch.int32)}}
    restored, step, extra = ckpt.restore_checkpoint(tmp_path, like)
    assert step == 7 and extra == {"note": "x"}
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_uncommitted_checkpoint_ignored(tmp_path):
    _, _, state, _, _ = _tiny()
    ckpt.save_checkpoint(tmp_path, 5, state)
    ckpt.save_checkpoint(tmp_path, 9, state)
    os.remove(tmp_path / "step_00000009" / "COMMIT")  # a crash mid-write
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "none", state)


def test_resume_equals_uninterrupted(tmp_path):
    """6 steps straight == 3 steps, checkpoint, restore, 3 steps, bit for bit."""
    _, _, state0, step, data = _tiny(opt_int8=True)

    def run(state, a, b):
        for i in range(a, b):
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
        return state

    clone = lambda s: {k: clone(v) if isinstance(v, dict) else v.clone()  # noqa: E731
                       for k, v in s.items()}
    straight = run(clone(state0), 0, 6)
    half = run(clone(state0), 0, 3)
    ckpt.save_checkpoint(tmp_path, 3, half)
    restored, s, _ = ckpt.restore_checkpoint(tmp_path, half)
    assert s == 3
    resumed = run(restored, 3, 6)
    for a, b in zip(_leaves(straight), _leaves(resumed)):
        assert torch.equal(a, b)


def test_trainer_survives_injected_faults(tmp_path):
    cfg, plan, state, step, data = _tiny()
    boom = {11: True, 17: True}

    def fault(s):
        if boom.pop(s, None):
            raise RuntimeError(f"injected node failure at {s}")

    tr = Trainer(cfg, plan, step, state, data,
                 TrainerConfig(total_steps=24, ckpt_every=5, log_every=100,
                               ckpt_dir=str(tmp_path)), fault_hook=fault)
    out = tr.run()
    assert out["final_step"] == 24 and not boom  # both faults fired
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses))
    assert all(h["data_s"] >= 0 and h["dt"] > 0 for h in out["history"])
    assert ckpt.latest_step(tmp_path) == 24


def test_trainer_gives_up_after_max_retries(tmp_path):
    cfg, plan, state, step, data = _tiny()

    def always_fail(s):
        if s >= 2:
            raise RuntimeError("persistent failure")

    tr = Trainer(cfg, plan, step, state, data,
                 TrainerConfig(total_steps=10, ckpt_every=2, max_retries=2, log_every=100,
                               ckpt_dir=str(tmp_path)), fault_hook=always_fail)
    with pytest.raises(RuntimeError, match="giving up"):
        tr.run()


def test_straggler_watchdog(tmp_path):
    """One step 50x slower than the others is flagged and rebalanced. The
    step is a stub that sleeps, so the test does not hang on how fast the
    CPU runs a model while other tests load it."""
    cfg, plan, state, _, data = _tiny()
    calls = []

    def slow_step(state, batch):
        time.sleep(1.0 if len(calls) == 8 else 0.02)  # one straggling step
        calls.append(1)
        return state, {"loss": torch.tensor(1.0)}

    rebalanced = []
    tr = Trainer(cfg, plan, slow_step, state, data,
                 TrainerConfig(total_steps=12, ckpt_every=50, log_every=100,
                               ckpt_dir=str(tmp_path), straggler_factor=3.0),
                 rebalance_hook=rebalanced.append)
    tr.run()
    assert 8 in tr.stragglers and rebalanced == tr.stragglers


def test_prefetcher_delivers_in_order():
    src = SyntheticLM(DataConfig(vocab=50, seq_len=4, global_batch=2))
    pf = Prefetcher(src, start_step=3, depth=2)
    try:
        for step in (3, 4, 5):
            np.testing.assert_array_equal(pf.next()["tokens"], src.batch(step)["tokens"])
    finally:
        pf.close()


def test_launcher_matches_the_reference_launcher(tmp_path):
    """Both launchers train reduced qwen3-0.6b for 20 steps (batch 8 x 64)
    from the same initial state: the reference's step-0 checkpoint, copied
    into the port's ``--ckpt`` and taken up with ``--resume-step 0``. Then the port restarts from its step
    15 and replays steps 15-19 bit for bit."""
    ref = tmp_path / "ref"
    run_subprocess(f"""
        import json, sys
        from repro.train import trainer
        run = trainer.Trainer.run
        def keep(self, *a, **k):
            out = run(self, *a, **k)
            open(r"{tmp_path / 'ref.json'}", "w").write(json.dumps(out["history"]))
            return out
        trainer.Trainer.run = keep
        sys.argv = ["train", "--arch", "qwen3-0.6b", "--reduced", "--steps", "20",
                    "--ckpt", r"{ref}"]
        from repro.launch import train
        train.main()
    """, n_devices=1, timeout=300)
    want = [h["loss"] for h in json.loads((tmp_path / "ref.json").read_text())]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b",
            "--reduced", "--steps", "20", "--device", "cpu", "--ckpt", str(tmp_path / "port")]
    shutil.copytree(ref / "step_00000000", tmp_path / "port" / "step_00000000")
    r = subprocess.run(base + ["--resume-step", "0", "--history", str(tmp_path / "a.json")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    got = [h["loss"] for h in json.loads((tmp_path / "a.json").read_text())]
    assert len(got) == len(want) == 20
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-3 * abs(b)
    assert got[-1] < got[0] - 0.05  # it learns
    from repro_torch.launch import train

    train.main(base[3:] + ["--resume-step", "15", "--history", str(tmp_path / "b.json")])
    assert [h["loss"] for h in json.loads((tmp_path / "b.json").read_text())] == got[15:]


def test_launcher_refuses_cuda_without_a_card_and_parses():
    from repro_torch.launch import train

    args = train.build_parser().parse_args(["--arch", "qwen3-0.6b"])
    assert (args.device, args.steps, args.batch, args.seq, args.remat) == \
        ("cuda", 50, 8, 64, "none")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1"])
