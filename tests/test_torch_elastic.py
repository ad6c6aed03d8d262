"""repro_torch's elastic re-scaling: ``choose_mesh_shape`` against the
reference's, then a trajectory across device counts on real ``gloo``
groups of CPU processes. Reduced qwen3-0.6b under the baseline rules trains
2 steps on 4 ranks (a 2x2 mesh), is checkpointed, is rebuilt on 2 ranks
(2x1) for 2 more steps, checkpointed, and rebuilt on 4 ranks for a fifth.
The global batch is kept, so every loss must be within 1e-5 (relative) of
one plain process's five steps on the same batches."""
import socket

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.train.elastic import choose_mesh_shape, live_world_size, rebuild

#: intra-op threads of each rank
THREADS = 1
SEQ, BATCH = 16, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small models, so that under the
    suite's parallel workers they do not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _setup():
    from repro_torch.configs import get_config, reduced
    from repro_torch.sharding.plan import ShardingPlan, baseline_rules
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig

    cfg = reduced(get_config("qwen3-0.6b"))
    plan = ShardingPlan(rules=baseline_rules(), remat="none")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
    return cfg, plan, data, AdamWConfig(warmup_steps=1)


def _rank(rank: int, legs, ckpt: str, out) -> None:
    """One process through every leg: in a leg of ``world`` ranks it joins
    that leg's group (or sits it out), rebuilds from the latest
    checkpoint, takes the leg's steps and saves the whole state (rank 0
    writes); then it leaves the group for the next leg."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.train import checkpoint as ckpt_mod

    torch.set_num_threads(THREADS)
    for world, steps, port in legs:
        if rank >= world:
            continue
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            cfg, plan, data, opt = _setup()
            state, mesh, step_fn, start = rebuild(cfg, plan, ckpt, opt_cfg=opt, device="cpu")
            assert live_world_size() == world and mesh.size() == world
            assert tuple(mesh.mesh.shape) == choose_mesh_shape(world)[0]
            losses = []
            for i in range(start, start + steps):
                state, m = step_fn(state, {k: torch.from_numpy(v)
                                           for k, v in data.batch(i).items()})
                losses.append((i, float(m["loss"])))

            def whole(tree):
                if isinstance(tree, dict):
                    return {k: whole(v) for k, v in tree.items()}
                return tree.full_tensor() if isinstance(tree, DTensor) else tree

            full = whole(state)
            if rank == 0:
                ckpt_mod.save_checkpoint(ckpt, start + steps, full)
                out.extend(losses)
            dist.barrier()
        except Exception as e:  # noqa: BLE001 — reported to the parent, which fails the test
            import traceback

            out.append(f"rank {rank}/{world}: {type(e).__name__}: {e}\n"
                       f"{traceback.format_exc()[-1500:]}")
            return
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 48, 64, 96, 100, 128, 256, 384, 512])
def test_choose_mesh_shape_matches_the_reference(n):
    # the reference is imported here: spawned ranks import this module, and
    # it would bring jax into each of them
    from repro.train.elastic import choose_mesh_shape as j_choose

    assert choose_mesh_shape(n) == j_choose(n)


def test_choose_mesh_shape_every_count_to_512():
    from repro.train.elastic import choose_mesh_shape as j_choose

    assert all(choose_mesh_shape(n) == j_choose(n) for n in range(1, 513))


def test_rebuild_on_one_device_without_a_group(tmp_path):
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import step as step_mod

    cfg, plan, data, opt = _setup()
    state, _ = step_mod.init_train_state(cfg, plan, seed=0)
    ckpt_mod.save_checkpoint(tmp_path, 3, state)
    got, mesh, step_fn, step = rebuild(cfg, plan, str(tmp_path), devices=1, opt_cfg=opt,
                                       device="cpu")
    assert step == 3 and mesh.size() == 1
    assert all(torch.equal(got["params"][k], v) for k, v in state["params"].items())
    _, m = step_fn(got, data.batch(3))
    want = step_mod.make_train_step(cfg, plan, None, opt)(state, {
        k: torch.from_numpy(v) for k, v in data.batch(3).items()})[1]
    assert float(m["loss"]) == float(want["loss"])
    with pytest.raises(ValueError, match="live process group"):
        rebuild(cfg, plan, str(tmp_path), devices=2, device="cpu")


def test_trajectory_across_4_2_4_ranks_matches_one_process(tmp_path):
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import step as step_mod

    cfg, plan, data, opt = _setup()
    state, _ = step_mod.init_train_state(cfg, plan, seed=0)
    ckpt_mod.save_checkpoint(tmp_path, 0, state)
    plain = step_mod.make_train_step(cfg, plan, None, opt)
    want = []
    for i in range(5):
        state, m = plain(state, {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
        want.append(float(m["loss"]))

    # one spawn of 4 processes; the legs' groups have 4, 2 and 4 ranks
    legs = [(world, steps, _free_port()) for world, steps in ((4, 2), (2, 2), (4, 1))]
    ctx = mp.get_context("spawn")
    out = ctx.Manager().list()
    procs = [ctx.Process(target=_rank, args=(r, legs, str(tmp_path), out)) for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks still running after 240 s: {alive}"
    errors = [x for x in out if isinstance(x, str)]
    assert errors == [], errors
    assert [p.exitcode for p in procs] == [0] * 4
    got = list(out)
    assert [i for i, _ in got] == [0, 1, 2, 3, 4]
    rel = [abs(g - w) / abs(w) for (_, g), w in zip(got, want)]
    assert max(rel) <= 1e-5, (got, want)
    assert ckpt_mod.latest_step(tmp_path) == 5
