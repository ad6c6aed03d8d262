"""Cost-model database: the append-only store of hardware data points.

Counterpart of ``repro/core/cost_db.py``, copied with what the kernel
space uses, the plan cells' workload features and the cell queries:
the scalar and the Pareto rankings, the promotion ladder's queries and the
surrogate's training set. Rows are the same JSON lines, byte for byte: a row
written here reads back in the reference's ``CostDB`` and serializes the
same way. The DB feeds the surrogate cost model's training set and the
promotion ladder's heads.
"""
from __future__ import annotations

import hashlib
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pareto import front_order


@dataclass
class DataPoint:
    """One hardware data point (paper §3.1: summarized results + config)."""

    arch: str
    shape: str
    mesh: str
    point: Dict[str, Any]  # PlanPoint dims
    status: str  # ok | infeasible | error | rejected | pruned
    metrics: Dict[str, Any] = field(default_factory=dict)
    reason: str = ""
    source: str = "explorer"  # explorer | llm | expert | search:<strategy>
    # ``search:<strategy>`` tags record which proposal engine produced the
    # design
    iteration: int = -1
    ts: float = field(default_factory=time.time)
    # evaluation tier that produced the row: ``dryrun`` = analytical
    # roofline bound from a dry-run compile (every row before the
    # promotion ladder existed), ``measured`` = wall-clock execution of
    # the compiled computation (``metrics["measured_s"]``, see
    # ``repro.launch.measure``). Measured rows are first-class datapoints
    # but are *not* surrogate training targets and never rank as a cell's
    # "best" design — the bound stays the leaderboard's ranking key, with
    # the measurement reported alongside.
    fidelity: str = "dryrun"

    def negative(self) -> bool:
        return self.status != "ok"

    def to_json(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True, default=str)

    @staticmethod
    def from_json(line: str) -> "DataPoint":
        d = {k: json.loads(line).get(k) for k in
             ("arch", "shape", "mesh", "point", "status", "metrics",
              "reason", "source", "iteration", "ts", "fidelity")}
        if d.get("fidelity") is None:  # pre-ladder rows are all dry-run
            d["fidelity"] = "dryrun"
        return DataPoint(**d)


# featurization used by both RAG retrieval and the learned cost model
_CATEGORICAL = {
    "batch_rule": ("data", "data+model"),
    "seq_rule": (None, "model"),
    "attn_rule": ("heads", "head_dim", "heads_pad", "none"),
    "ffn_rule": ("model", None),
    "vocab_rule": ("model", None),
    "expert_rule": ("experts", "expert_ffn", "none"),
    "embed_rule": (None, "data"),
    "seq_kv_rule": ("model", None, "kv_heads"),
    "remat": ("none", "dots", "full"),
    "grad_compress": ("none", "int8", "topk"),
    "decode_attn": ("gspmd", "sp_shardmap"),
    "attn_impl": ("chunked", "tri"),
}
_NUMERIC = ("microbatches", "loss_chunk",
            # kernel-space tile dims (plan points simply featurize to zero
            # here, and vice versa — one surrogate serves both spaces)
            "block_q", "block_k", "block_rows", "chunk", "block")
_BOOLEAN = ("zero1", "opt_int8", "causal")


def featurize(point: Dict[str, Any], workload: Dict[str, float]) -> np.ndarray:
    """Plan dims + workload context -> dense feature vector."""
    feats: List[float] = []
    for k, vals in _CATEGORICAL.items():
        v = point.get(k)
        for cand in vals:
            feats.append(1.0 if v == cand else 0.0)
    for k in _NUMERIC:
        feats.append(math.log2(1 + float(point.get(k) or 0)))
    for k in _BOOLEAN:
        feats.append(1.0 if point.get(k) else 0.0)
    for k in ("n_params", "seq_len", "global_batch", "n_layers", "d_model",
              "vocab", "n_experts", "is_train", "is_decode"):
        feats.append(math.log10(1 + float(workload.get(k, 0.0))))
    return np.asarray(feats, np.float32)


def workload_features(cfg, cell) -> Dict[str, float]:
    return {
        "n_params": cfg.n_params(),
        "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "vocab": cfg.vocab,
        "n_experts": cfg.moe.n_experts if cfg.moe else 0,
        "is_train": 1.0 if cell.kind == "train" else 0.0,
        "is_decode": 1.0 if cell.kind == "decode" else 0.0,
    }


#: objectives where larger is better (every other objective is minimized)
MAXIMIZE_OBJECTIVES = frozenset({"flops_util"})


def derive_objectives(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Objective vector for one row's metric dict, derived from the metrics
    every evaluator already records (so pre-refactor DB rows rank in Pareto
    campaigns too). Returns ``{}`` for rows with no bound (errors,
    rejections, pruned predictions).

    Plan rows: ``bound_s`` (s), ``hbm_bytes`` (HLO HBM traffic),
    ``vmem_bytes`` (per-device working set, ``per_device_gib * 2**30``),
    ``flops_util`` (``mfu_at_bound``, maximized). Kernel rows (detected by
    ``est_latency_us``): ``bound_s``, ``vmem_util`` (resource-model VMEM
    pressure), ``flops_util`` (mean MXU/VPU alignment, maximized)."""
    bound = metrics.get("bound_s")
    if not bound:
        return {}
    obj: Dict[str, float] = {"bound_s": float(bound)}
    if "est_latency_us" in metrics:  # kernel-cell row: resource-model vector
        if metrics.get("vmem_util") is not None:
            obj["vmem_util"] = float(metrics["vmem_util"])
        mxu, vpu = metrics.get("mxu_aligned"), metrics.get("vpu_aligned")
        if mxu is not None and vpu is not None:
            obj["flops_util"] = (float(mxu) + float(vpu)) / 2.0
        return obj
    if metrics.get("hbm_bytes") is not None:
        obj["hbm_bytes"] = float(metrics["hbm_bytes"])
    if metrics.get("per_device_gib") is not None:
        obj["vmem_bytes"] = float(metrics["per_device_gib"]) * 2**30
    if metrics.get("mfu_at_bound") is not None:
        obj["flops_util"] = float(metrics["mfu_at_bound"])
    return obj


def objectives_of(dp: "DataPoint") -> Dict[str, float]:
    """The row's stored objective vector (``metrics["objectives"]``,
    stamped by the evaluators) with a derived fallback for rows written
    before objective storage existed."""
    stored = dp.metrics.get("objectives")
    if isinstance(stored, dict) and stored:
        return {k: float(v) for k, v in stored.items() if v is not None}
    return derive_objectives(dp.metrics)


def objective_value(dp: "DataPoint", key: str = "bound_s",
                    ) -> Optional[float]:
    """Shared objective extraction behind every ranking query (``best``,
    ``winners``, ``pareto_rows``): one code path for plan rows, kernel
    rows (``kernel:<name>`` archs), and measured rows. Returns None when
    the row must not rank — measured fidelity (wall clocks measure a
    different quantity than the modeled bound), failed resource gate
    (``fits_hbm``), or no such objective on the row."""
    if dp.fidelity == "measured":
        return None
    if not dp.metrics.get("fits_hbm", True):
        return None
    if key in dp.metrics:
        v = dp.metrics.get(key)
        return None if v is None else v
    v = objectives_of(dp).get(key)
    return None if v is None else v


def pareto_rows(rows: Sequence["DataPoint"],
                ) -> List[Tuple["DataPoint", int, float, Dict[str, float]]]:
    """Deterministic Pareto ordering of one cell's rows: ``(row, rank,
    crowding, objectives)`` tuples sorted by ``(rank, -crowding, ts,
    serialized row)``. A pure function of the row *set*: any insertion
    order (shard merges, queue steals, kill/heal replays) yields the same
    sequence, which is what keeps merged Pareto leaderboards
    byte-identical.

    Eligibility matches ``winners``: ``status == "ok"``, dry-run fidelity,
    ``fits_hbm``, truthy bound; one row per design key (earliest
    ``(ts, to_json())`` wins, mirroring ``merge_cost_dbs``). Vectors are
    aligned over the sorted union of objective keys: a missing objective
    is ``+inf`` (never better), maximize-objectives are negated."""
    eligible = [d for d in rows
                if d.status == "ok" and objective_value(d, "bound_s")]
    by_key: Dict[str, DataPoint] = {}
    for d in sorted(eligible, key=lambda d: (d.ts or 0.0, d.to_json())):
        by_key.setdefault(d.point.get("__key__") or d.to_json(), d)
    deduped = list(by_key.values())
    if not deduped:
        return []
    objs = [objectives_of(d) for d in deduped]
    keys = sorted({k for o in objs for k in o})
    vectors = [tuple(
        float("inf") if o.get(k) is None
        else -float(o[k]) if k in MAXIMIZE_OBJECTIVES
        else float(o[k])
        for k in keys) for o in objs]
    tiebreaks = [(d.ts or 0.0, d.to_json()) for d in deduped]
    order, ranks, crowding = front_order(vectors, tiebreaks)
    return [(deduped[i], ranks[i], crowding[i], objs[i]) for i in order]


def _val_row(point_key: str) -> bool:
    """Deterministic ~20% held-out split by point-key hash: ``val`` rows are
    never used for surrogate training (stable across processes/shards)."""
    h = hashlib.sha1(point_key.encode()).hexdigest()
    return int(h[:8], 16) % 5 == 0


class CostDB:
    def __init__(self, path: Path | str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._cache: Optional[List[DataPoint]] = None
        # per-(arch, shape) {design key -> status} index, kept current by
        # append_many — dedupe is O(batch), not O(DB), per loop iteration,
        # and the status lets callers treat gate-pruned designs (predicted,
        # never measured) as still proposable
        self._key_index: Optional[Dict[Tuple[str, str], Dict[str, str]]] = None

    def append(self, dp: DataPoint) -> None:
        self.append_many([dp])

    def append_many(self, dps: Sequence[DataPoint]) -> None:
        """One write syscall per batch — campaign cells append whole
        evaluation batches at a time."""
        if not dps:
            return
        with self.path.open("a") as f:
            f.write("".join(dp.to_json() + "\n" for dp in dps))
        if self._cache is not None:
            self._cache.extend(dps)
        if self._key_index is not None:
            for d in dps:
                self._index_one(d)

    def _index_one(self, d: DataPoint) -> None:
        k = d.point.get("__key__")
        if not k:
            return
        cell = self._key_index.setdefault((d.arch, d.shape), {})
        # a measured status never regresses to 'pruned' (a pruned row is
        # only a surrogate prediction, not an outcome)
        if cell.get(k) is None or cell[k] == "pruned":
            cell[k] = d.status

    def all(self) -> List[DataPoint]:
        """Every row, file order, cached in memory after the first read.
        Unparseable lines (e.g. a torn tail line after a SIGKILL mid-append)
        are skipped with a warning, never raised — a campaign must always be
        able to resume over its own crash debris."""
        if self._cache is None:
            self._cache = []
            if self.path.exists():
                for line in self.path.read_text().splitlines():
                    if not line.strip():
                        continue
                    try:
                        self._cache.append(DataPoint.from_json(line))
                    except (json.JSONDecodeError, TypeError, AttributeError):
                        print(f"cost_db: skipping unreadable row in {self.path}")
        return list(self._cache)

    def query(self, arch: Optional[str] = None, shape: Optional[str] = None,
              status: Optional[str] = None,
              mesh: Optional[str] = None) -> List[DataPoint]:
        out = self.all()
        if arch:
            out = [d for d in out if d.arch == arch]
        if shape:
            out = [d for d in out if d.shape == shape]
        if status:
            out = [d for d in out if d.status == status]
        if mesh:
            out = [d for d in out if d.mesh == mesh]
        return out

    def best(self, arch: str, shape: str, key: str = "bound_s",
             mesh: Optional[str] = None) -> Optional[DataPoint]:
        # measured rows carry wall-clock timings, not the full roofline
        # metric set — ranking stays on the dry-run bound, measurement rides
        # alongside (see build_leaderboard's measured_us column). The
        # eligibility/extraction rules live in ``objective_value`` so plan,
        # kernel, and measured rows share one code path with ``winners``.
        ok = [(objective_value(d, key), d)
              for d in self.query(arch, shape, "ok", mesh)]
        ok = [(v, d) for v, d in ok if v is not None]
        return min(ok, key=lambda vd: vd[0])[1] if ok else None

    def keys(self, arch: str, shape: str, *,
             include_pruned: bool = True) -> set:
        """Recorded design keys for one cell, from the cached index (built
        lazily from disk once, then maintained incrementally by append_many).
        ``include_pruned=False`` returns only *measured* designs — the right
        dedupe set for proposal selection, so a design the surrogate gate
        once skipped stays reachable if the gate relaxes or improves."""
        if self._key_index is None:
            self._key_index = {}
            for d in self.all():
                self._index_one(d)
        cell = self._key_index.get((arch, shape), {})
        if include_pruned:
            return set(cell)
        return {k for k, st in cell.items() if st != "pruned"}

    def seen(self, arch: str, shape: str, point_key: str) -> bool:
        return point_key in self.keys(arch, shape)

    def cells(self) -> List[Tuple[str, str, str]]:
        """Distinct (arch, shape, mesh) cells present — the campaign engine's
        view of which workloads already hold data."""
        return sorted({(d.arch, d.shape, d.mesh) for d in self.all()})

    def winners(self, arch: str, shape: str, k: int = 3,
                mesh: Optional[str] = None) -> List[DataPoint]:
        """The cell's ``k`` fastest *feasible* designs, one row per design key.

        Sorted by measured ``bound_s`` ascending (seconds), ties broken by
        earliest ``ts`` then append order — deterministic for a fixed DB
        file. Rows without a ``bound_s`` metric or failing ``fits_hbm`` are
        excluded; an empty list means the cell has no feasible design yet.
        The promotion ladder's head query."""
        ok = [(objective_value(d), d)
              for d in self.query(arch, shape, "ok", mesh)]
        ok = [(v, d) for v, d in ok if v]  # truthy: a zero bound never ranks
        ok.sort(key=lambda vd: (vd[0], vd[1].ts or 0.0))
        seen, out = set(), []
        for _, d in ok:
            key = d.point.get("__key__")
            if key is not None and key in seen:
                continue
            seen.add(key)
            out.append(d)
            if len(out) == k:
                break
        return out

    def pareto(self, arch: str, shape: str, mesh: Optional[str] = None,
               ) -> List[Tuple[DataPoint, int, float, Dict[str, float]]]:
        """The cell's rows in deterministic Pareto order: ``(row, rank,
        crowding, objectives)`` per unique feasible design, rank 0 = the
        non-dominated front (see :func:`pareto_rows` for the ordering and
        byte-stability contract)."""
        return pareto_rows(self.query(arch, shape, "ok", mesh))

    def front(self, arch: str, shape: str, k: Optional[int] = 3,
              mesh: Optional[str] = None) -> List[DataPoint]:
        """The cell's ``k`` leading designs in Pareto front order: the
        multi-objective analog of :meth:`winners`, and the promotion
        ladder's head query under ``--objective pareto``: rank-0 boundary
        points first, so measured execution covers the front's extremes
        before its interior. ``k=None`` returns every ranked design."""
        heads = [d for d, _, _, _ in self.pareto(arch, shape, mesh)]
        return heads if k is None else heads[:k]

    def measured_rows(self, arch: Optional[str] = None,
                      shape: Optional[str] = None,
                      mesh: Optional[str] = None) -> List[DataPoint]:
        """Every tier-2 (``fidelity == "measured"``) row, optionally
        restricted to one cell — the promotion planner's dedupe source and
        the leaderboard's ``measured_us`` lookup."""
        return [d for d in self.query(arch, shape, mesh=mesh)
                if d.fidelity == "measured"]

    def iteration_batches(self, arch: str, shape: str,
                          mesh: Optional[str] = None,
                          ) -> List[Tuple[int, List[DataPoint]]]:
        """The cell's rows grouped by loop iteration, ascending, preserving
        append order within each group: the provenance replay stream
        ``Ensemble.rebuild_credit`` consumes. Rows with no recorded
        iteration sort first under index ``-1``."""
        groups: Dict[int, List[DataPoint]] = {}
        for d in self.query(arch, shape, mesh=mesh):
            it = int(d.iteration) if d.iteration is not None else -1
            groups.setdefault(it, []).append(d)
        return sorted(groups.items())

    def count(self, arch: Optional[str] = None, shape: Optional[str] = None,
              status: Optional[str] = None, mesh: Optional[str] = None) -> int:
        """How many rows match (every row when no filter is given)."""
        return len(self.query(arch, shape, status, mesh))

    def training_set(self, split: Optional[str] = None, *,
                     arch: Optional[str] = None, shape: Optional[str] = None,
                     mesh: Optional[str] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(features, targets [log10 bound_s], feasible mask) for the surrogate.

        ``split``: None = every usable row; ``"train"`` / ``"val"`` = the
        deterministic ~80/20 key-hash partition (see ``_val_row``).
        ``arch``/``shape``/``mesh`` restrict to one cell's rows (the
        surrogate gate's per-cell calibration). ``pruned`` rows are always
        skipped: they carry only a surrogate *prediction*, never a
        measured outcome.
        """
        X, y, feas = [], [], []
        for d in self.all():
            if ((arch is not None and d.arch != arch)
                    or (shape is not None and d.shape != shape)
                    or (mesh is not None and d.mesh != mesh)):
                continue
            wl = d.metrics.get("workload")
            if not wl or d.status == "pruned":
                continue
            # measured rows are wall-clock outcomes of a *different*
            # quantity than the analytical bound the surrogate models —
            # they calibrate the model (measured_calibration), never
            # train it
            if d.fidelity == "measured":
                continue
            if split is not None:
                key = d.point.get("__key__") or json.dumps(
                    {k: v for k, v in sorted(d.point.items())}, default=str)
                if _val_row(key) != (split == "val"):
                    continue
            X.append(featurize(d.point, wl))
            b = d.metrics.get("bound_s")
            ok = d.status == "ok" and d.metrics.get("fits_hbm", False)
            y.append(math.log10(max(b, 1e-6)) if (b and ok) else 3.0)
            feas.append(1.0 if ok else 0.0)
        if not X:
            z = np.zeros((0,), np.float32)
            return z.reshape(0, 1), z, z
        return np.stack(X), np.asarray(y, np.float32), np.asarray(feas, np.float32)
