"""The sharded program computes what the unsharded one does: four CPU
processes on a real ``gloo`` group run the dense model's prefill and two
decode steps as DTensors under a plan (the dry run only ever traces this
program on fake tensors), and every rank checks the gathered logits and
KV cache against the plain run, within 1e-4 of the largest value (f32).
The train step likewise: one step of the baseline train plan (ZeRO-1
moments, full remat) and one of microbatches, int8 moments and loss
chunks on a 2x2 mesh, against the plain step on the same weights and
batch: loss and gradient norm within 1e-5, the new params within 1e-6
where |g| >= 1e-3 max|g| (step 1's Adam update is +-lr, so a gradient
that rounds to the other side of zero flips it).

Meshes: 2x2 (KV heads sharded with the q heads) and 1x4 (2 KV heads on 4
q-head shards: each shard reads the KV head its q heads share), each
with the baseline plan (sequence-parallel residuals, a sequence-sharded
cache) under both decode paths, ``gspmd`` (the plan's cache placements,
the softmax reduced across their sequence shards) and ``sp_shardmap``
(the cache's sequence split over ``model``)."""
import dataclasses
import socket

import torch
import torch.multiprocessing as mp

WORLD = 4
#: intra-op threads of each worker: four workers at the host's default
#: would oversubscribe the cores the rest of the suite runs on
THREADS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, port: int, errors) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPE_BY_NAME, get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serve import step as S
    from repro_torch.sharding.plan import baseline_plan

    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        cfg = reduced(get_config("qwen3-0.6b"), n_kv_heads=2)  # 4 q heads, 2 KV heads
        params, _ = M.init_params(cfg, seed=0)
        gen = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab, (2, 26), generator=gen, dtype=torch.int32)
        with torch.no_grad():
            want_l, want_c = [], M.init_cache(cfg, 2, 32)
            lg, want_c = M.prefill_fn(cfg, params, {"tokens": tok[:, :24]}, want_c)
            want_l.append(lg)
            for i in (24, 25):
                lg, want_c = M.decode_fn(cfg, params, {"tokens": tok[:, i:i + 1]}, want_c)
                want_l.append(lg)

        def rel(want, got):
            got = got.full_tensor() if isinstance(got, DTensor) else got
            return float((want - got).abs().max() / want.abs().max())

        for shape in ((2, 2), (1, 4)):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for decode_attn in ("gspmd", "sp_shardmap"):
                plan = dataclasses.replace(baseline_plan(cfg, SHAPE_BY_NAME["decode_32k"]),
                                           decode_attn=decode_attn)
                specs = {"batch": {"tokens": tok[:, :24]}, "cache": M.init_cache(cfg, 2, 32)}
                pp, bp, cp = S.serve_shardings(cfg, plan, mesh, specs)
                dparams = {k: distribute_tensor(v, mesh, pp[k]) for k, v in params.items()}
                cache = {k: distribute_tensor(v, mesh, cp[k]) for k, v in specs["cache"].items()}

                def batch(t):
                    return {"tokens": distribute_tensor(t, mesh, bp["tokens"])}

                prefill = S.make_prefill_step(cfg, plan, mesh)
                decode = S.make_decode_step(cfg, plan, mesh)
                with torch.no_grad(), implicit_replication():
                    got = [prefill(dparams, batch(tok[:, :24]), cache)]
                    cache = got[0][1]
                    for i in (24, 25):
                        got.append(decode(dparams, batch(tok[:, i:i + 1]), cache))
                        cache = got[-1][1]
                    errs = [rel(w, g[0]) for w, g in zip(want_l, got)]
                    errs += [rel(want_c[k], cache[k]) for k in ("k", "v")]
                    lens = cache["len"].full_tensor().tolist()
                if max(errs) > 1e-4 or lens != [26, 26]:
                    errors.append(f"rank {rank} mesh {shape} {decode_attn}: {errs} len {lens}")
    except Exception as e:  # noqa: BLE001 — reported to the parent, which fails the test
        import traceback

        errors.append(f"rank {rank}: {type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}")
    finally:
        dist.destroy_process_group()


def test_sharded_serve_steps_match_the_plain_run():
    # spawned workers start from this process's sys.path
    ctx = mp.get_context("spawn")
    errors = ctx.Manager().list()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, errors)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"workers still running after 240 s: {alive}"
    assert [p.exitcode for p in procs] == [0] * WORLD
    assert list(errors) == []


def _train_worker(rank: int, port: int, errors) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPE_BY_NAME, get_config, reduced
    from repro_torch.sharding.plan import ShardingPlan, baseline_plan
    from repro_torch.train import step as T

    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        cfg = reduced(get_config("qwen3-0.6b"))
        gen = torch.Generator().manual_seed(2)
        tok = torch.randint(0, cfg.vocab, (2, 4, 64), generator=gen, dtype=torch.int32)
        batch = {"tokens": tok[0], "targets": tok[1]}
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        base = baseline_plan(cfg, SHAPE_BY_NAME["train_4k"])
        for over in ({}, {"microbatches": 2, "opt_int8": True, "loss_chunk": 32}):
            plan = dataclasses.replace(base, **over)
            plain = ShardingPlan(rules={}, zero1=False, remat="none",
                                 opt_int8=plan.opt_int8)
            state, logical = T.init_train_state(cfg, plan, seed=0)
            want = {k: v.clone() for k, v in state["params"].items()}
            ref, wm = T.make_train_step(cfg, plain)(
                T._new_state(want, plain), batch)
            leaves = {k: v.detach().requires_grad_() for k, v in state["params"].items()}
            from repro_torch.models import model as M

            loss, _ = M.loss_fn(cfg, leaves, batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            specs = T.state_specs(mesh, plan, state, logical)

            def place(tree, pl):
                if isinstance(tree, dict):
                    return {k: place(v, pl[k]) for k, v in tree.items()}
                return distribute_tensor(tree, mesh, pl)

            dstate = place(state, specs)
            bp = plan.batch_specs(mesh, batch)
            dbatch = {k: distribute_tensor(v, mesh, bp[k]) for k, v in batch.items()}
            with implicit_replication():
                dstate, dm = T.make_train_step(cfg, plan, mesh)(dstate, dbatch)
                got = {k: v.full_tensor() for k, v in dstate["params"].items()}
                mets = {k: float(v.full_tensor() if isinstance(v, DTensor) else v)
                        for k, v in dm.items()}
            bad = [k for k in ("loss", "grad_norm")
                   if abs(mets[k] - float(wm[k])) > 1e-5 * abs(float(wm[k]))]
            for k, g in grads.items():
                big = g.abs() >= 1e-3 * g.abs().max()
                if float((got[k] - ref["params"][k]).abs()[big].max()) > 1e-6:
                    bad.append(k)
            if bad:
                errors.append(f"rank {rank} train {over}: {bad} {mets} "
                              f"{ {k: float(v) for k, v in wm.items()} }")
    except Exception as e:  # noqa: BLE001 — reported to the parent, which fails the test
        import traceback

        errors.append(f"rank {rank}: {type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}")
    finally:
        dist.destroy_process_group()


def test_sharded_train_step_matches_the_plain_step():
    ctx = mp.get_context("spawn")
    errors = ctx.Manager().list()
    port = _free_port()
    procs = [ctx.Process(target=_train_worker, args=(r, port, errors)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"workers still running after 240 s: {alive}"
    assert [p.exitcode for p in procs] == [0] * WORLD
    assert list(errors) == []
