"""The sharded program computes what the unsharded one does: four CPU
processes on a real ``gloo`` group run the dense model's prefill and two
decode steps as DTensors under a plan (the dry run only ever traces this
program on fake tensors), and every rank checks the gathered logits and
KV cache against the plain run, within 1e-4 of the largest value (f32).

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
