"""Tier-2 measured execution for kernel cells: launch the kernel and time it.

Counterpart of ``repro/launch/measure.py::measure_kernel_cell``. One warm
call (the first launch builds and loads the kernel library), then ``runs``
timed calls; the record reports the **minimum**. On a card each timed call
sits between two ``torch.cuda.Event`` records after a ``synchronize()``,
so the time is the device's, never the host's enqueue time. With
``device="cpu"`` the plain versions run and the host clock times them; the
record's ``backend`` says which.

``measure_kernel_cell`` never raises: a failed launch is a
``status="error"`` record.
"""
from __future__ import annotations

import time
import traceback
from typing import Any, Dict

import torch

DEFAULT_RUNS = 3


def _time_call(fn, device: torch.device) -> float:
    """Seconds one call of ``fn`` takes on ``device``."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def measure_kernel_cell(kshape, dims: Dict[str, Any], *,
                        device: torch.device | str = "cuda",
                        mesh_name: str = "dev1", runs: int = DEFAULT_RUNS,
                        seed: int = 0) -> Dict[str, Any]:
    """Launch the kernel with the candidate tile dims and time it (warm
    call, then min of ``runs``), then re-run the correctness gate on the
    warm output against the ``kernels.ref`` oracle.

    Returns ``status`` ``ok`` (correct within tolerance), ``incorrect``
    (the output is wrong; the caller makes it an ``infeasible`` row) or
    ``error``, with ``backend`` (``cuda`` or ``cpu``) and ``device_name``.
    """
    if runs < 1:
        raise ValueError(f"runs must be >= 1, got {runs}")
    from repro_torch.kernels import conformance

    t0 = time.time()
    rec: Dict[str, Any] = {"arch": f"kernel:{kshape.kernel}",
                           "shape": kshape.name, "mesh": mesh_name,
                           "fidelity": "measured", "n": runs,
                           "measured_at": round(t0, 3)}
    try:
        dev = torch.device(device)
        inputs = conformance.make_inputs(kshape, seed=seed, device=dev)
        outs = []

        def call():
            outs.append(conformance.run_candidate(kshape, dims, inputs))

        t_warm = time.perf_counter()
        call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        warm_s = time.perf_counter() - t_warm
        want = conformance.run_reference(kshape, dims, inputs)
        err = conformance.max_abs_error(outs[0], want)
        del want
        tol = conformance.tolerance(kshape.kernel, kshape.dtype)
        times = []
        for _ in range(runs):
            outs.clear()
            times.append(_time_call(call, dev))
        rec.update(status="ok" if err <= tol else "incorrect",
                   measured_s=min(times),
                   times_s=times,
                   warm_s=warm_s,
                   backend=dev.type,
                   device_name=(torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                   max_abs_err=err,
                   tol=tol)
    except Exception as e:  # noqa: BLE001 — a failed measurement is a negative datapoint
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec
