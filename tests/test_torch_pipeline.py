"""repro_torch's GPipe pipeline on real ranks: one spawn of 8 CPU processes
on a ``gloo`` group runs both of the reference's cases, the (4, 2)
``("stage", "model")`` mesh (8 layers of tanh(x W + b), 6 microbatches)
and the (2, 2, 2) ``("pod", "data", "model")`` mesh with stages on
``pod`` (4 layers of tanh(x W)). On every rank each output is within 2e-5
of the sequential layers; the (4, 2) case also matches the reference's
``pipeline_forward`` on the same numpy inputs, run meanwhile in a
subprocess on 8 forced host devices, as ``tests/test_pipeline.py`` runs
it."""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
#: intra-op threads of each rank
THREADS = 1
TOL = 2e-5

REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.sharding.pipeline import pipeline_forward

z = np.load(r"{inputs}")
mesh = make_mesh((4, 2), ("stage", "model"))
W, b, x = (jnp.asarray(z[k]) for k in ("W", "b", "x"))

def layer_fn(lp, x):
    return jnp.tanh(x @ lp["w"] + lp["b"])

with mesh:
    got = pipeline_forward(layer_fn, {{"w": W, "b": b}}, x, mesh)
np.save(r"{out}", np.asarray(got))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(path: Path) -> None:
    rng = np.random.default_rng(0)
    np.savez(path,
             W=(0.3 * rng.standard_normal((8, 16, 16))).astype(np.float32),
             b=(0.1 * rng.standard_normal((8, 16))).astype(np.float32),
             x=rng.standard_normal((6, 4, 16)).astype(np.float32),
             W2=(0.3 * rng.standard_normal((4, 8, 8))).astype(np.float32),
             x2=rng.standard_normal((4, 2, 8)).astype(np.float32))


def _rank(rank: int, port: int, inputs: str, out_dir: str, errors) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.pipeline import pipeline_forward

    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        z = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}

        # case 1: 4 stages on ("stage", "model"), params a dict pytree
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("stage", "model"))
        W, b, x = z["W"], z["b"], z["x"]
        got = pipeline_forward(lambda lp, h: torch.tanh(h @ lp["w"] + lp["b"]),
                               {"w": W, "b": b}, x, mesh)
        want = x
        for i in range(W.shape[0]):
            want = torch.tanh(want @ W[i] + b[i])
        err1 = float((got - want).abs().max())
        if rank == 0:
            np.save(os.path.join(out_dir, "port_stage.npy"), got.numpy())

        # case 2: 2 stages on the pod axis of a (2, 2, 2) mesh, params one tensor
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        W2, x2 = z["W2"], z["x2"]
        got2 = pipeline_forward(lambda lp, h: torch.tanh(h @ lp), W2, x2, mesh,
                                stage_axis="pod")
        want2 = x2
        for i in range(W2.shape[0]):
            want2 = torch.tanh(want2 @ W2[i])
        err2 = float((got2 - want2).abs().max())
        for case, err in (("stage", err1), ("pod", err2)):
            if not err <= TOL:
                errors.append(f"{case}: rank {rank} err {err}")
    except Exception as e:  # noqa: BLE001 — reported to the parent, which fails the test
        import traceback

        errors.append(f"spawn: rank {rank}: {type(e).__name__}: {e}\n"
                      f"{traceback.format_exc()[-1500:]}")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 8-rank spawn, with the reference's run started beside it."""
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs = tmp / "inputs.npz"
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(
            inputs=inputs, out=tmp / "reference.npy"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ctx = mp.get_context("spawn")
        errors = ctx.Manager().list()
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(r, port, str(inputs), str(tmp), errors))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=180)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
        exitcodes = [p.exitcode for p in procs]
        errors = list(errors)
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    return {"tmp": tmp, "alive": alive, "exitcodes": exitcodes, "errors": errors,
            "ref_rc": ref.returncode, "ref_log": log}


def _ranks_ok(run, case):
    assert not run["alive"], f"ranks still running after 180 s: {run['alive']}"
    assert run["exitcodes"] == [0] * WORLD
    assert [e for e in run["errors"] if e.startswith(("spawn", case))] == []


def test_stage_mesh_matches_sequential_layers(run):
    _ranks_ok(run, "stage")


def test_pod_axis_mesh_matches_sequential_layers(run):
    _ranks_ok(run, "pod")


def test_stage_mesh_matches_the_reference(run):
    _ranks_ok(run, "stage")
    assert run["ref_rc"] == 0, run["ref_log"][-3000:]
    got = np.load(run["tmp"] / "port_stage.npy")
    want = np.load(run["tmp"] / "reference.npy")
    assert got.shape == want.shape == (6, 4, 16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
