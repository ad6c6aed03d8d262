"""Kernel-cell evaluation (paper §3.2.2): gate, resources, measurement.

Counterpart of ``repro/core/evaluator.py::KernelEvaluator`` together with
the parts of its ``Evaluator`` base it uses (the caches, the counters and
the row plumbing). The design space is one kernel's tile dims:

* surrogate gate (optional): a candidate the gate predicts slower than
  its threshold times the incumbent becomes a ``status="pruned"`` row with
  the prediction, and is never run.
* evaluation tier: run the kernel with the candidate's tiles on
  deterministic inputs (the Hopper kernel on the card, the plain version
  when the caller asked for the CPU), hold it against the ``kernels.ref``
  oracle on the same device (the correctness gate), and take ``bound_s``
  from the Hopper resource model's ``est_latency_us``. A candidate with the
  wrong answer becomes a ``status="infeasible"`` row with ``max_abs_err``
  recorded, never a winner. A tile the card cannot launch is rejected by
  the template before it runs. Inputs are made once per batch, and the
  oracle runs once per batch for each set of dims it reads
  (``conformance.reference_key``): the SSD oracle is a 4096-step
  recurrence at full width.
* measured tier: ``measure`` times real launches through
  ``launch.measure.measure_kernel_cell`` and re-checks correctness on the
  output; ``measured_cache`` replay keeps measurement exactly-once with
  byte-identical rows.

Both caches key a record by the backend as well as the design: the
evaluation tier runs a different program on each (the plain version on the
CPU, the CUDA kernel on a card, whose sources can change), so a record
taken on one is never replayed for another, nor for edited kernel sources.

``arch`` is the encoded ``kernel:<name>`` column and ``shape`` a
``KERNEL_SHAPES`` name. Evaluation is serial: one card.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import kernel_space
from repro_torch.core.cost_db import DataPoint, derive_objectives
from repro_torch.core.design_space import KernelTemplate, PlanPoint
from repro_torch.core.device import H100_SXM, DeviceModel
from repro_torch.core.eval_cache import DryRunCache
from repro_torch.core.kernel_space import (KERNEL_SHAPE_BY_NAME,
                                           kernel_workload, parse_kernel_arch)


@dataclass
class KernelEvaluator:
    mesh_name: str
    device: DeviceModel = H100_SXM
    torch_device: str = "cuda"  # where kernels run: "cuda" or "cpu"
    cache: Optional[DryRunCache] = None
    compile_count: int = 0  # candidates run through the kernel (cache misses)
    pruned_count: int = 0  # candidates the surrogate gate kept out of the pool
    # tier-2 (measured execution) state — see ``measure``
    measured_cache: Optional[DryRunCache] = None
    measure_runs: int = 3  # timed calls per measurement (min is reported)
    measured_count: int = 0  # actual timed executions (cache misses)
    measured_replayed: int = 0  # measurements served from measured_cache

    def evaluate_batch(self, arch: str, shape: str,
                       points: Sequence[PlanPoint], *,
                       source: str | Sequence[str] = "explorer",
                       iteration: int = -1, gate=None,
                       incumbent_bound: Optional[float] = None,
                       ) -> List[DataPoint]:
        """Evaluate kernel candidates (order-preserving): template
        rejections inline, cache hits replayed, surrogate-gate pruning
        (with ``gate`` and the incumbent's ``incumbent_bound``), then kernel
        + correctness check + resource-model bound for the rest. ``source``
        is one tag for the batch or one per point."""
        from repro_torch.kernels import conformance

        srcs = ([source] * len(points) if isinstance(source, str)
                else list(source))
        if len(srcs) != len(points):
            raise ValueError(f"{len(srcs)} sources for {len(points)} points")
        kernel = parse_kernel_arch(arch)
        if kernel is None:
            raise ValueError(
                f"KernelEvaluator expects a 'kernel:<name>' arch, got {arch!r}")
        kshape = KERNEL_SHAPE_BY_NAME[shape]
        template = KernelTemplate(kshape, self.device)
        wl = kernel_workload(kshape)
        cache_mesh = self.cache_mesh()

        results: List[Optional[DataPoint]] = [None] * len(points)
        pending: List[Tuple[int, PlanPoint]] = []
        for i, point in enumerate(points):
            base = self._base(arch, shape, point, srcs[i], iteration)
            ok, why = template.validate(point)
            if not ok:
                results[i] = DataPoint(**base, status="rejected", reason=why,
                                       metrics={"workload": wl})
                continue
            rec = (self.cache.get(arch, shape, cache_mesh, point.key())
                   if self.cache is not None else None)
            if rec is not None:
                results[i] = self._kernel_rec_to_datapoint(rec, wl, base)
                continue
            pending.append((i, point))

        pending = self._gate_prune(gate, pending, wl=wl,
                                   incumbent_bound=incumbent_bound,
                                   srcs=srcs, arch=arch, shape=shape,
                                   iteration=iteration, results=results)

        if pending:
            inputs = conformance.make_inputs(kshape, device=self.torch_device)
            wants: Dict[Tuple, Any] = {}
            for i, point in pending:
                rec = self._run_kernel(kshape, point, inputs, conformance,
                                       wants)
                self.compile_count += 1
                # errors stay retryable; correctness verdicts are
                # deterministic and replay forever
                if self.cache is not None and rec.get("status") == "ok":
                    self.cache.put(arch, shape, cache_mesh, point.key(), rec)
                base = self._base(arch, shape, point, srcs[i], iteration)
                results[i] = self._kernel_rec_to_datapoint(rec, wl, base)
        return results  # type: ignore[return-value]

    def _gate_prune(self, gate, pending: List[Tuple[int, PlanPoint]], *,
                    wl: Dict[str, float], incumbent_bound: Optional[float],
                    srcs: Sequence[str], arch: str, shape: str,
                    iteration: int,
                    results: List[Optional[DataPoint]],
                    ) -> List[Tuple[int, PlanPoint]]:
        """Tier-0 surrogate gate. The gate only sees candidates that would
        run: cache hits are free and template rejections are already
        negative points. Pruned candidates are written into ``results`` as
        ``status="pruned"`` rows with the prediction; returns the
        still-pending subset."""
        if gate is None or not pending:
            return pending
        verdicts = gate.prune_verdicts([pt for _, pt in pending], wl,
                                       incumbent_bound)
        still: List[Tuple[int, PlanPoint]] = []
        for (i, pt), v in zip(pending, verdicts):
            if v is None:
                still.append((i, pt))
                continue
            pred, pfeas = v
            self.pruned_count += 1
            base = self._base(arch, shape, pt, srcs[i], iteration)
            # the threshold in force, annealing included (part of the gate
            # protocol: the audit row must match the decision)
            factor = gate.effective_factor
            results[i] = DataPoint(
                **base, status="pruned",
                reason=(f"surrogate gate: predicted {pred:.3g}s > "
                        f"{factor:g}x incumbent {incumbent_bound:.3g}s"),
                metrics={"workload": wl, "predicted_bound_s": pred,
                         "predicted_p_feasible": pfeas,
                         "gate_factor": factor})
        return still

    def measure(self, arch: str, shape: str, point: PlanPoint, *,
                runs: Optional[int] = None,
                modeled_bound_s: Optional[float] = None) -> DataPoint:
        """Tier-2 promotion: time real launches of the kernel
        (``launch.measure.measure_kernel_cell``) and re-run the correctness
        gate on the output. A ``measured_cache`` hit replays the record, and
        the DataPoint is built solely from it (``ts`` included), so replayed
        rows serialize byte-identically."""
        kshape = KERNEL_SHAPE_BY_NAME[shape]
        wl = kernel_workload(kshape)
        cache_mesh = self.cache_mesh()
        rec = (self.measured_cache.get(arch, shape, cache_mesh, point.key())
               if self.measured_cache is not None else None)
        if rec is not None:
            self.measured_replayed += 1
        else:
            from repro_torch.launch import measure as measure_mod

            rec = measure_mod.measure_kernel_cell(
                kshape, dict(point.dims), mesh_name=self.mesh_name,
                runs=runs if runs is not None else self.measure_runs,
                device=self.torch_device)
            self.measured_count += 1
            if (self.measured_cache is not None
                    and rec.get("status") in ("ok", "incorrect")):
                self.measured_cache.put(arch, shape, cache_mesh, point.key(),
                                        rec)
        base = self._base(arch, shape, point, "ladder", -1)
        base.update(fidelity="measured", ts=rec["measured_at"])
        if rec["status"] == "error":
            return DataPoint(**base, status="error", reason=rec["error"],
                             metrics={"workload": wl})
        metrics = {
            "workload": wl,
            "measured_s": rec["measured_s"],
            "measured_us": rec["measured_s"] * 1e6,
            "n": rec["n"],
            "warm_s": rec["warm_s"],
            "backend": rec["backend"],
            "device_name": rec["device_name"],
            "max_abs_err": rec["max_abs_err"],
            "tol": rec["tol"],
        }
        if modeled_bound_s is not None:
            metrics["bound_s_modeled"] = modeled_bound_s
        if rec["status"] == "incorrect":
            return DataPoint(
                **base, status="infeasible",
                reason=(f"correctness gate: max|err| {rec['max_abs_err']:.3g}"
                        f" > tol {rec['tol']:.3g} vs kernels.ref"),
                metrics=metrics)
        return DataPoint(**base, status="ok", metrics=metrics)

    def cache_mesh(self) -> str:
        """The mesh part of a cache key: ``mesh_name@cpu`` for the plain
        versions, ``mesh_name@cuda:<source fingerprint>`` for the kernels
        on a card. Rows keep ``mesh_name`` in their mesh column."""
        backend = torch.device(self.torch_device).type
        if backend == "cpu":
            return f"{self.mesh_name}@cpu"
        from repro_torch.kernels import _build

        return f"{self.mesh_name}@{backend}:{_build.fingerprint()}"

    # ------------------------------------------------------------------
    def _base(self, arch: str, shape: str, point: PlanPoint,
              source: str, iteration: int) -> Dict[str, Any]:
        return dict(arch=arch, shape=shape, mesh=self.mesh_name,
                    point={**point.to_dict(), "__key__": point.key()},
                    source=source, iteration=iteration)

    def _run_kernel(self, kshape, point: PlanPoint, inputs, conformance,
                    wants: Dict[Tuple, Any]) -> Dict[str, Any]:
        """One evaluation record: correctness check + resources. Never
        raises — a failed launch is a negative datapoint. ``wants`` holds
        the oracle's answers on ``inputs`` by ``reference_key``, filled on
        first need."""
        t0 = time.perf_counter()
        try:
            key = conformance.reference_key(kshape, point.dims)
            if key not in wants:
                wants[key] = conformance.run_reference(kshape, point.dims,
                                                       inputs)
            check = conformance.check_candidate(kshape, point.dims,
                                                inputs=inputs, want=wants[key])
        except Exception as e:  # noqa: BLE001 — negative datapoint
            return {"status": "error", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]}
        res = kernel_space.kernel_resources(kshape, point.dims, self.device)
        return {"status": "ok", "check": check, "resources": res.to_dict(),
                "run_s": round(time.perf_counter() - t0, 4)}

    def _kernel_rec_to_datapoint(self, rec: Dict[str, Any],
                                 wl: Dict[str, float],
                                 base: Dict[str, Any]) -> DataPoint:
        """Map an evaluation record onto the DataPoint contract: a failed
        correctness check is ``infeasible`` (with the error pinned in the
        reason), a passing one ranks on the modelled ``bound_s``."""
        if rec["status"] == "error":
            return DataPoint(**base, status="error", reason=rec["error"],
                             metrics={"workload": wl})
        res = rec["resources"]
        check = rec["check"]
        metrics = {
            "workload": wl,
            "bound_s": res["est_latency_us"] / 1e6,
            "est_latency_us": res["est_latency_us"],
            "est_cycles_per_block": res["est_cycles_per_block"],
            "vmem_util": res["vmem_util"],
            "mxu_aligned": res["mxu_aligned"],
            "vpu_aligned": res["vpu_aligned"],
            "fits_hbm": res["feasible"],
            "max_abs_err": check["max_abs_err"],
            "tol": check["tol"],
            "correct": check["passed"],
            "run_s": rec.get("run_s"),
        }
        metrics["objectives"] = derive_objectives(metrics)
        if not check["passed"]:
            return DataPoint(
                **base, status="infeasible",
                reason=(f"correctness gate: max|err| "
                        f"{check['max_abs_err']:.3g} > tol "
                        f"{check['tol']:.3g} vs kernels.ref"),
                metrics=metrics)
        return DataPoint(**base, status="ok", metrics=metrics)
