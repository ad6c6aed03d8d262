"""Evaluation module (paper §3.2.2): simulation-first design assessment.

Counterpart of ``repro/core/evaluator.py``: the plan ``Evaluator`` and its
kernel-cell subclass ``KernelEvaluator``, which share the surrogate gate
(``_gate_prune``), the row base (``_base``), the counters and the cache
key (``cache_mesh``).

**Plan cells.** The 'SystemC simulation' is the dry run
(``launch/dryrun.py``: the step traced on fake tensors on the fake mesh,
no device); the 'hardware resource limits' gate is the H100 cluster's
memory per card. Designs that fail, violate budgets, or fall outside the
template are returned as *negative* data points, never dropped.

* ``evaluate_batch`` fans the dry runs of a batch out over a spawn-based
  ``concurrent.futures`` process pool: each worker makes the mesh on a fake
  process group of its own and runs only dry runs, never CUDA. A pool's
  workers import torch afresh (8.9 s for two on the H100's host, before
  any dry run), so one pool of ``max_workers`` serves every batch until
  ``close()``; its workers keep their mesh between batches.
* A content-addressed :class:`~repro_torch.core.eval_cache.DryRunCache`
  keyed by ``(arch, shape, mesh_name, point.key())`` serves repeated
  designs without tracing again, across iterations, restarts and
  campaigns.
* ``mesh`` is the ``--mesh`` choice (``pod``, ``multipod``, ``small``,
  ``tiny``), not a mesh: a process holds one default process group, and a
  mesh of another size makes the older meshes stale
  (``launch/mesh.py``), so each call makes the mesh it needs
  (``launch/mesh.make_campaign_mesh``).
* ``measure`` (the promotion ladder's tier 2) runs the point's plan on one
  device, at the largest power-of-two global batch whose one-device dry
  run fits ``launch.measure.FIT_SHARE`` of the H100's memory
  (``launch.measure.one_device_batch``); the cut goes into the record and
  the row as ``reduced``. A point that does not fit at its first batch is
  a ``rejected`` row and is never launched; one the card cannot hold at
  the fitted batch is an ``error`` row, left uncached.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.core import kernel_space
from repro_torch.core.cost_db import DataPoint, derive_objectives, workload_features
from repro_torch.core.design_space import (KernelTemplate, PlanPoint,
                                           PlanTemplate, point_to_plan)
from repro_torch.core.device import H100_CLUSTER, H100_SXM, DeviceModel
from repro_torch.core.eval_cache import DryRunCache
from repro_torch.core.kernel_space import (KERNEL_SHAPE_BY_NAME,
                                           kernel_workload, parse_kernel_arch)
from repro_torch.launch.mesh import CAMPAIGN_MESHES, campaign_mesh_shape


# ---------------------------------------------------------------------------
# pool worker (top-level for pickling; runs in a fresh spawn interpreter)
# ---------------------------------------------------------------------------
_WORKER_MESH: Optional[Tuple[str, Any]] = None  # (--mesh choice, DeviceMesh)


def _pool_worker_evaluate(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Dry-run one candidate in a worker process; returns the run_cell rec.
    The worker's one mesh lives on its own fake process group."""
    global _WORKER_MESH
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_campaign_mesh

    if _WORKER_MESH is None or _WORKER_MESH[0] != payload["mesh"]:
        _WORKER_MESH = (payload["mesh"], make_campaign_mesh(payload["mesh"], "cpu")[0])
    mesh = _WORKER_MESH[1]
    cfg, cell = payload["cfg"], payload["cell"]
    point = PlanPoint(dims=payload["dims"])
    plan = point_to_plan(cfg, cell, point, multi_pod="pod" in mesh.mesh_dim_names)
    return dryrun.run_cell(payload["arch"], payload["shape"], mesh,
                           payload["run_name"], plan=plan,
                           artifact_dir=Path(payload["artifact_dir"]),
                           cfg=cfg, cell=cell)


@dataclass
class Evaluator:
    mesh: Optional[str] = None  # --mesh choice; None for kernel cells
    mesh_name: str = ""  # defaults to the choice's name (pod -> pod16x16)
    device: DeviceModel = H100_CLUSTER
    torch_device: str = "cuda"  # where the measured tier runs: "cuda" or "cpu"
    artifact_dir: Optional[str] = None
    cache: Optional[DryRunCache] = None
    max_workers: int = 1  # >1 enables the process pool in evaluate_batch
    compile_count: int = 0  # dry runs (cache misses; excludes template-skips)
    pruned_count: int = 0  # candidates the surrogate gate kept out of the pool
    # tier-2 (measured execution) state — see ``measure``
    measured_cache: Optional[DryRunCache] = None  # content-addressed, beside dryrun_cache
    measure_runs: int = 3  # timed calls per measurement (min is reported)
    measured_count: int = 0  # actual timed executions (cache misses)
    measured_replayed: int = 0  # measurements served from measured_cache
    dryrun_s: float = 0.0  # wall seconds spent tracing (serial or pooled)
    _pool: Any = dataclasses.field(default=None, repr=False, compare=False)

    def close(self) -> None:
        """Shut the kept pool down (idempotent; a later batch makes a new
        one)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __post_init__(self):
        if self.mesh is not None and not self.mesh_name:
            self.mesh_name = CAMPAIGN_MESHES[self.mesh][2]

    @property
    def mesh_shape(self) -> Dict[str, int]:
        """``{axis name: size}`` of the evaluator's mesh."""
        return campaign_mesh_shape(self.mesh)

    # ------------------------------------------------------------------
    def evaluate(self, arch: str, shape: str, point: PlanPoint,
                 *, source: str = "explorer", iteration: int = -1) -> DataPoint:
        return self.evaluate_batch(arch, shape, [point], source=source,
                                   iteration=iteration, workers=1)[0]

    def evaluate_batch(self, arch: str, shape: str,
                       points: Sequence[PlanPoint], *,
                       source: str | Sequence[str] = "explorer",
                       iteration: int = -1,
                       workers: Optional[int] = None,
                       gate=None,
                       incumbent_bound: Optional[float] = None,
                       ) -> List[DataPoint]:
        """Evaluate ``points`` (order-preserving). Template rejections are
        decided inline, cached designs are served without tracing again,
        the optional :class:`~repro_torch.search.gate.SurrogateGate` prunes
        candidates whose predicted bound is hopeless vs ``incumbent_bound``
        (recorded as ``pruned`` data points with the prediction, never
        traced), and the remaining dry runs fan out across the process pool.

        ``source`` may be one tag for the whole batch or a per-point
        sequence (strategy provenance for the cost DB ``source`` field)."""
        srcs = ([source] * len(points) if isinstance(source, str)
                else list(source))
        if len(srcs) != len(points):
            raise ValueError(f"{len(srcs)} sources for {len(points)} points")
        cfg = get_config(arch)
        cell = SHAPE_BY_NAME[shape]
        template = PlanTemplate(cfg, cell, self.mesh_shape, self.device)
        wl = workload_features(cfg, cell)

        results: List[Optional[DataPoint]] = [None] * len(points)
        pending: List[Tuple[int, PlanPoint]] = []
        for i, point in enumerate(points):
            base = self._base(arch, shape, point, srcs[i], iteration)
            ok, why = template.validate(point)
            if not ok:
                results[i] = DataPoint(**base, status="rejected", reason=why,
                                       metrics={"workload": wl})
                continue
            rec = (self.cache.get(arch, shape, self.mesh_name, point.key())
                   if self.cache is not None else None)
            if rec is not None:
                results[i] = self._rec_to_datapoint(rec, wl, base)
                continue
            pending.append((i, point))

        pending = self._gate_prune(gate, pending, wl=wl,
                                   incumbent_bound=incumbent_bound,
                                   srcs=srcs, arch=arch, shape=shape,
                                   iteration=iteration, results=results)

        n_workers = self.max_workers if workers is None else workers
        n_workers = min(n_workers, len(pending))
        t0 = time.perf_counter()
        if pending and n_workers > 1:
            recs = self._run_pool(arch, shape, cfg, cell, pending)
        else:
            recs = [self._run_serial(arch, shape, cfg, cell, pt)
                    for _, pt in pending]
        self.dryrun_s += time.perf_counter() - t0

        for (i, point), rec in zip(pending, recs):
            if rec.get("status") not in ("skipped", "worker-failed"):
                self.compile_count += 1  # a dry run was actually traced
            # errors are NOT cached: run_cell catches everything, so a
            # transient crash (a dead worker) must stay retryable; only
            # deterministic outcomes are worth replaying forever
            if self.cache is not None and rec.get("status") in ("ok", "skipped"):
                self.cache.put(arch, shape, self.mesh_name, point.key(), rec)
            base = self._base(arch, shape, point, srcs[i], iteration)
            results[i] = self._rec_to_datapoint(rec, wl, base)
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    def _gate_prune(self, gate, pending: List[Tuple[int, PlanPoint]], *,
                    wl: Dict[str, float], incumbent_bound: Optional[float],
                    srcs: Sequence[str], arch: str, shape: str,
                    iteration: int,
                    results: List[Optional[DataPoint]],
                    ) -> List[Tuple[int, PlanPoint]]:
        """Tier-0 surrogate gate, shared by the plan and kernel evaluation
        paths. The gate only sees candidates that would run: cache hits are
        free and template rejections are already negative points. Pruned
        candidates are written into ``results`` as ``status="pruned"`` rows
        with the prediction; returns the still-pending subset."""
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

    # ------------------------------------------------------------------
    def measure(self, arch: str, shape: str, point: PlanPoint, *,
                runs: Optional[int] = None,
                modeled_bound_s: Optional[float] = None) -> DataPoint:
        """Tier-2 promotion: run the step of ``point``'s plan on one device
        (``torch_device``) at the batch ``launch.measure.one_device_batch``
        fits, and time it (``launch.measure.measure_cell``), returning a
        ``fidelity="measured"`` data point.

        Exactly-once semantics ride on ``measured_cache``, keyed by
        ``cache_mesh()`` (so a CPU record never replays for the card): a
        hit replays the recorded timing (``measured_replayed``), and the
        DataPoint is built *solely* from the cached record, ``ts``
        included, so the replayed row serializes byte-identically. Only
        deterministic outcomes (``ok``/``skipped``) are cached; errors (an
        OOM among them) stay retryable. ``modeled_bound_s`` (the row's
        bound on the evaluator's mesh) is recorded beside the time; the
        one-device dry run's bound at the cut batch is ``bound_s_1x1``."""
        cfg = get_config(arch)
        cell = SHAPE_BY_NAME[shape]
        wl = workload_features(cfg, cell)
        cache_mesh = self.cache_mesh()
        rec = (self.measured_cache.get(arch, shape, cache_mesh, point.key())
               if self.measured_cache is not None else None)
        if rec is not None:
            self.measured_replayed += 1
        else:
            rec = self._measure_one_device(arch, shape, cfg, cell, point,
                                           runs if runs is not None else self.measure_runs)
            self.measured_count += 1
            if (self.measured_cache is not None
                    and rec.get("status") in ("ok", "skipped")):
                self.measured_cache.put(arch, shape, cache_mesh, point.key(), rec)
        base = self._base(arch, shape, point, "ladder", -1)
        base.update(fidelity="measured", ts=rec["measured_at"])
        if rec["status"] == "skipped":
            return DataPoint(**base, status="rejected", reason=rec["reason"],
                             metrics={"workload": wl})
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
            "peak_bytes": rec["peak_bytes"],
            "reduced": rec["reduced"],
            "bound_s_1x1": rec["bound_s_1x1"],
            "per_device_bytes_1x1": rec["per_device_bytes_1x1"],
        }
        if modeled_bound_s is not None:
            # deliberately NOT "bound_s": measured rows must never rank in
            # bound-keyed queries (best/winners exclude them anyway)
            metrics["bound_s_modeled"] = modeled_bound_s
        return DataPoint(**base, status="ok", metrics=metrics)

    def _measure_one_device(self, arch: str, shape: str, cfg, cell,
                            point: PlanPoint, runs: int) -> Dict[str, Any]:
        """One measured-tier record: fit the batch on the CPU's 1x1 dry
        run, then time the step on the 1x1 mesh of ``torch_device``. Never
        raises: a card that runs out of memory gives an ``error`` record."""
        from repro_torch.launch import measure as measure_mod
        from repro_torch.launch.mesh import make_campaign_mesh

        t0 = time.time()
        plan = point_to_plan(cfg, cell, point)  # one device: no pod axis
        run_name = f"{self.mesh_name}-{point.key()}-1x1"
        fit = measure_mod.one_device_batch(arch, shape, plan, cfg=cfg, cell=cell,
                                           artifact_dir=self._adir() / "fit1x1",
                                           run_name=run_name)
        if fit["status"] != "ok":
            return {"arch": arch, "shape": shape, "mesh": run_name,
                    "fidelity": "measured", "n": runs, "measured_at": round(t0, 3),
                    **fit, "wall_s": round(time.time() - t0, 2)}
        cut = dataclasses.replace(cell, global_batch=fit["batch"])
        mesh, name = make_campaign_mesh("tiny", self.torch_device)
        rec = measure_mod.measure_cell(arch, shape, mesh, name, plan, runs=runs,
                                       cfg=cfg, cell=cut)
        if torch.device(self.torch_device).type == "cuda":
            torch.cuda.empty_cache()
        rec.update(reduced={**rec.get("reduced", {}),
                            **({"global_batch": [cell.global_batch, cut.global_batch]}
                               if cut.global_batch != cell.global_batch else {})},
                   bound_s_1x1=fit["bound_s"],
                   per_device_bytes_1x1=fit["per_device_bytes"],
                   fit_traced=fit["traced"])
        return rec

    def cache_mesh(self) -> str:
        """The mesh part of a cache key: ``mesh_name@cpu`` for a CPU
        device, ``mesh_name@cuda:<kernel source fingerprint>`` on a card.
        Rows keep ``mesh_name`` in their mesh column. The kernel cells key
        both caches with it, the plan cells their measured cache (a dry
        run needs no device)."""
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

    def _adir(self) -> Path:
        from repro_torch.launch import dryrun

        # sibling of the dry-run CLI's artifact dir, not inside it
        return (Path(self.artifact_dir) if self.artifact_dir
                else dryrun.ARTIFACT_DIR.parent / "dse")

    def _run_serial(self, arch: str, shape: str, cfg, cell,
                    point: PlanPoint) -> Dict[str, Any]:
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_campaign_mesh

        mesh, _ = make_campaign_mesh(self.mesh, "cpu")
        plan = point_to_plan(cfg, cell, point, multi_pod="pod" in mesh.mesh_dim_names)
        return dryrun.run_cell(arch, shape, mesh,
                               f"{self.mesh_name}-{point.key()}", plan=plan,
                               artifact_dir=self._adir(), cfg=cfg, cell=cell)

    def _run_pool(self, arch: str, shape: str, cfg, cell,
                  pending: Sequence[Tuple[int, PlanPoint]]) -> List[Dict[str, Any]]:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        adir = str(self._adir())
        payloads = [dict(arch=arch, shape=shape, cfg=cfg, cell=cell,
                         dims=dict(pt.dims), mesh=self.mesh,
                         run_name=f"{self.mesh_name}-{pt.key()}",
                         artifact_dir=adir)
                    for _, pt in pending]
        if self._pool is None:  # fresh interpreters: no CUDA, no parent group
            self._pool = ProcessPoolExecutor(max_workers=self.max_workers,
                                             mp_context=mp.get_context("spawn"))
        recs: List[Dict[str, Any]] = []
        futures = [self._pool.submit(_pool_worker_evaluate, p) for p in payloads]
        for fut in futures:
            try:
                recs.append(fut.result())
            except Exception as e:  # noqa: BLE001 — a dead worker is a negative datapoint
                recs.append({"status": "worker-failed",
                             "error": f"{type(e).__name__}: {e}"})
        if any(r["status"] == "worker-failed" for r in recs):
            self.close()  # a dead worker breaks the pool: the next batch makes one
        return recs

    def _rec_to_datapoint(self, rec: Dict[str, Any], wl: Dict[str, float],
                          base: Dict[str, Any]) -> DataPoint:
        if rec["status"] == "skipped":
            return DataPoint(**base, status="rejected", reason=rec["reason"],
                             metrics={"workload": wl})
        if rec["status"] in ("error", "worker-failed"):
            return DataPoint(**base, status="error", reason=rec["error"],
                             metrics={"workload": wl})
        r = rec["roofline"]
        fits = rec["memory"]["fits_hbm"]
        metrics = {
            "workload": wl,
            "compute_s": r["compute_s"],
            "memory_s": r["memory_s"],
            "collective_s": r["collective_s"],
            "bound_s": r["bound_s"],
            "dominant": r["dominant"],
            "fits_hbm": fits,
            "per_device_gib": rec["memory"]["per_device_bytes"] / 2**30,
            "flops_per_dev": rec["hlo"]["flops"],
            "wire_bytes": rec["hlo"]["wire_bytes_total"],
            "hbm_bytes": rec["hlo"]["hbm_bytes"],
            "model_flops_per_dev": rec["model_flops_per_dev"],
            "useful_flops_ratio": rec["useful_flops_ratio"],
            "mfu_at_bound": rec["model_flops_per_dev"] / (
                max(r["bound_s"], 1e-9) * self.device.peak_flops_bf16),
            "compile_s": rec["compile_s"],
        }
        # per-row objective storage for Pareto campaigns; built from the
        # metric dict either way, so cache replays stamp identically
        metrics["objectives"] = derive_objectives(metrics)
        status = "ok" if fits else "infeasible"
        reason = "" if fits else (
            f"per-device {metrics['per_device_gib']:.1f} GiB exceeds "
            f"{self.device.hbm_bytes/2**30:.0f} GiB HBM")
        return DataPoint(**base, status=status, reason=reason, metrics=metrics)


@dataclass
class KernelEvaluator(Evaluator):
    """Kernel-cell evaluation: the same multi-fidelity surface as
    :class:`Evaluator`, but the design space is one kernel's tile dims.

    * surrogate gate (optional): a candidate the gate predicts slower than
      its threshold times the incumbent becomes a ``status="pruned"`` row
      with the prediction, and is never run.
    * evaluation tier: run the kernel with the candidate's tiles on
      deterministic inputs (the Hopper kernel on the card, the plain
      version when the caller asked for the CPU), hold it against the
      ``kernels.ref`` oracle on the same device (the correctness gate),
      and take ``bound_s`` from the Hopper resource model's
      ``est_latency_us``. A candidate with the wrong answer becomes a
      ``status="infeasible"`` row with ``max_abs_err`` recorded, never a
      winner. A tile the card cannot launch is rejected by the template
      before it runs. Inputs are made once per batch, and the oracle runs
      once per batch for each set of dims it reads
      (``conformance.reference_key``): the SSD oracle is a 4096-step
      recurrence at full width.
    * measured tier: ``measure`` times real launches through
      ``launch.measure.measure_kernel_cell`` and re-checks correctness on
      the output; ``measured_cache`` replay keeps measurement exactly-once
      with byte-identical rows.

    Both caches key a record by ``cache_mesh()``, the backend as well as
    the design: the evaluation tier runs a different program on each (the
    plain version on the CPU, the CUDA kernel on a card, whose sources can
    change), so a record taken on one is never replayed for another, nor
    for edited kernel sources.

    ``arch`` is the encoded ``kernel:<name>`` column and ``shape`` a
    ``KERNEL_SHAPES`` name; ``mesh`` is unused. Evaluation is serial: one
    card.
    """

    device: DeviceModel = H100_SXM

    def evaluate_batch(self, arch: str, shape: str,
                       points: Sequence[PlanPoint], *,
                       source: str | Sequence[str] = "explorer",
                       iteration: int = -1,
                       workers: Optional[int] = None,
                       gate=None,
                       incumbent_bound: Optional[float] = None,
                       ) -> List[DataPoint]:
        """Evaluate kernel candidates (order-preserving): template
        rejections inline, cache hits replayed, surrogate-gate pruning
        (with ``gate`` and the incumbent's ``incumbent_bound``), then kernel
        + correctness check + resource-model bound for the rest. ``source``
        is one tag for the batch or one per point; ``workers`` is accepted
        for the plan path's interface and ignored (one card)."""
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
