"""Per-device cost of one traced step: the port's counterpart of
``core/hlo_analysis.py``.

The reference compiles a step and reads exact per-device costs off the
HLO text. Here the step runs once on fake tensors (no memory, no device)
under :class:`StepCounter`, a dispatch mode that sees each device's *local*
work: it steps aside for every op on DTensors (returning
``NotImplemented``), so DTensor lowers the op to local ops and functional
collectives, which come back to it on local tensors. It ignores the ops
DTensor runs to propagate shapes (those run under DTensor's own fake mode).
The counts are for rank 0 of the mesh; every rank holds the same shapes.

* ``dot_flops``: ``2 * numel(result) * contraction`` of every product.
* ``hbm_bytes``: operands and result of every product, gathers (embedding
  and index reads) read and written, in-place writes (cache updates,
  chunk outputs) read and written, and collective results. Elementwise
  ops, reductions and layout copies are taken as fused into the products
  around them and not charged: the figure is what a fused program would
  move, not what eager torch moves (attention's materialized scores are
  charged once, as the product's result, though the mask, the softmax and
  the cast to bf16 each pass over them again), and the reference's
  analyzer, which charges each XLA fusion, gives a higher one.
* collectives by kind, with the reference's ring model of wire bytes
  (``_wire_factor``), and the wire bytes split by link: a group inside one
  node goes over NVLink, one that crosses nodes over the NIC
  (``DeviceModel.link_class``).

Loops run through :meth:`StepCounter.walk`, which traces representative
steps and weights their counts by the trip count (the reference multiplies
each ``while`` body by its ``known_trip_count``): ``uniform`` loops (every
step the same, as the layer loop) trace step 0 with weight ``n``;
``affine`` ones (work growing by the same amount each step, as the
triangular chunk walk) trace the first and last steps with weight ``n/2``
each. ``unroll=True`` runs every step with weight 1, which the tests hold
the weighted counts to.

Backward: autograd runs a traced step's backward ops (and ``remat`` 's
recompute of its forward) after the walk has left the step. Each traced
step records the range of autograd sequence numbers its forward created;
autograd executes nodes in decreasing sequence number, and while a node
runs (``torch._C._current_autograd_node()``) every op takes the weight of
the innermost traced step that created it, times the weights of walks
re-entered by a recompute inside it.

The peak of live local allocations during the step (each new storage an
op's outputs make, counted once and freed when the storage goes: a
detached alias, as selective checkpointing and a recompute keep of what
they save, holds the bytes as long as the tensor itself) gives the temp
memory term. A step of weight ``w`` stands for ``w`` steps, so while
autograd records, the bytes it leaves alive (its saved activations, or
its checkpointed input under ``remat``) are counted ``w - 1`` more times
from its end until backward has left it, and its own peak is taken on
top of them. Without autograd a step keeps nothing past its end (caches
are written in place; what it leaves alive is its input, still named by
the caller, which the next step would free).

These are the step's own bytes. A card adds a fixed cost of its runtime
that no step holds: the cuBLAS workspace, 32 MiB on the H100, allocated
through the caching allocator by a process's first product and kept for
the process's life, so it shows in the card's peak of whichever step
first multiplies. In a fresh process mamba2-780m ``long_500k`` (batch 1)
peaks at 1.676 GB on the card against 1.642 GB modelled: that workspace,
and the step 0.05% over its model (``scripts/ssm_peak_probe.py``, NVIDIA
H100 80GB HBM3, 700 W). The card's peak also counts whatever else the
process holds when the step starts.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode, _disable_current_modes,
                                         _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

from repro_torch.core.device import H100_CLUSTER, DeviceModel

# ring-model wire bytes per device, as a multiple of the RESULT buffer size
def _wire_factor(kind: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)  # result is 1/g of the reduced input
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "all-to-all":
        return (g - 1) / g
    if kind == "collective-permute":
        return 1.0
    return 1.0


_aten = torch.ops.aten
# products whose first operand is the addend (``dtype``: bf16 operands, f32 result)
_ADDEND_FIRST = {_aten.addmm.default, _aten.baddbmm.default, _aten.baddbmm_.default,
                 _aten.baddbmm.out, _aten.baddbmm.dtype, _aten.baddbmm.dtype_out}
_PRODUCTS = {_aten.mm.default, _aten.bmm.default, _aten.bmm.out, _aten.bmm.dtype,
             _aten.bmm.dtype_out} | _ADDEND_FIRST
# mixed-type products, whose fake-tensor rule some torch versions lack: the
# counter makes their result itself
_MIXED = {_aten.bmm.dtype, _aten.bmm.dtype_out, _aten.baddbmm.dtype, _aten.baddbmm.dtype_out}
_GATHERS = {_aten.embedding.default, _aten.index.Tensor, _aten.index_select.default}
_WRITES = {_aten.copy_.default, _aten.index_put_.default}
# functional collectives (torch.ops._c10d_functional) by op name
_FUNCOL = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
           "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_to_all_single": "all-to-all"}


def _seq_now() -> int:
    """The autograd sequence number the next node created will exceed."""
    with _disable_current_modes(), torch.enable_grad():
        t = torch.zeros((), requires_grad=True)
        return (t * 1).grad_fn._sequence_nr()


def _backward_node():
    """The autograd node backward is running, or ``None`` outside backward."""
    return torch._C._current_autograd_node()


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _group_table(mesh) -> Dict[str, list]:
    """Process-group name -> the ranks of rank 0's group, for every live
    group of the process: the mesh's dims and the world, and the groups of
    older meshes of the same shape, which DTensor's cached sharding
    propagation can hand a step's outputs back on."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _world

    table = {}
    if mesh is None or not dist.is_initialized():
        return table
    for pg, name in _world.pg_names.items():
        table[name] = dist.get_process_group_ranks(pg)
    table[dist.group.WORLD.group_name] = list(range(dist.get_world_size()))
    if mesh.size() > 1:
        for i in range(mesh.ndim):
            pg = mesh.get_group(i)
            table[pg.group_name] = dist.get_process_group_ranks(pg)
    return table


class StepCounter(TorchDispatchMode):
    """Counts one step's local work (see the module docstring). Use as a
    context manager around the step; tensors made inside it are fake."""

    def __init__(self, mesh=None, *, device: DeviceModel = H100_CLUSTER,
                 unroll: bool = False):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensorMode

        # DTensor's own code writes scalars made outside any mode (setitem)
        self.fake = FakeTensorMode(allow_non_fake_inputs=True)
        self.device = device
        self.unroll = unroll
        self.groups = _group_table(mesh)
        self.weight = 1.0
        self.dot_flops = 0.0
        self.dot_flops_once = 0.0
        self.hbm_bytes = 0.0
        self.collect_bytes: Dict[str, float] = defaultdict(float)
        self.wire_bytes: Dict[str, float] = defaultdict(float)
        self.wire_by_link: Dict[str, float] = defaultdict(float)
        self.live = 0.0
        self.peak = 0.0
        self._storages = set()  # the live storages counted in ``live``
        self._regions = []  # [start, end or None, weight] per traced step
        self._phantoms = []  # [start, bytes]: what the w - 1 untraced steps keep
        self._step_peaks = []
        self._bwd_factor = 1.0

    # ------------------------------------------------------------------
    def walk(self, n: int, kind: str = "uniform"):
        """Steps of a loop of ``n``, as ``(step, weight)``; each step's
        counts are multiplied by its weight."""
        if self.unroll or kind == "all" or n <= 2:
            steps = [(i, 1.0) for i in range(n)]
        elif kind == "uniform":
            steps = [(0, float(n))]
        elif kind == "affine":
            steps = [(0, n / 2.0), (n - 1, n / 2.0)]
        else:
            raise ValueError(f"unknown walk kind {kind!r}")
        for i, w in steps:
            if _backward_node() is not None:  # a recompute inside backward
                outer = self._bwd_factor
                self._bwd_factor = outer * w
                try:
                    yield i, w
                finally:
                    self._bwd_factor = outer
                continue
            outer = self.weight
            self.weight = outer * w
            region = [_seq_now(), None, self.weight]
            self._regions.append(region)
            live0 = self.live
            saves = torch.is_grad_enabled()
            self._step_peaks.append(live0)
            try:
                yield i, w
            finally:
                self.weight = outer
                region[1] = _seq_now()
                step_peak = self._step_peaks.pop()
                extra = (w - 1.0) * (self.live - live0) if saves else 0.0
                if extra > 0:
                    self._phantoms.append([region[0], extra])
                    self.live += extra
                self._note_peak(step_peak + max(extra, 0.0))

    def _note_peak(self, level: float) -> None:
        self.peak = max(self.peak, level)
        if self._step_peaks:
            self._step_peaks[-1] = max(self._step_peaks[-1], level)

    def _current_weight(self) -> float:
        node = _backward_node()
        if node is None:
            return self.weight
        seq = node._sequence_nr()
        while self._phantoms and seq < self._phantoms[-1][0]:
            self.live -= self._phantoms.pop()[1]  # backward has left that step
        w = 1.0
        for start, end, rw in reversed(self._regions):  # innermost first
            if start < seq and (end is None or seq < end):
                w = rw
                break
        return w * self._bwd_factor

    def empty(self, shape, dtype, device) -> torch.Tensor:
        """A fake tensor of ``shape`` (a step input's local shard)."""
        with self.fake:
            return torch.empty(tuple(shape), dtype=dtype, device=device)

    # ------------------------------------------------------------------
    def _alloc(self, out, func) -> None:
        rets = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for r, t in zip(rets, outs):
            if isinstance(t, torch.Tensor) and r.alias_info is None:
                # once per storage: some ops return their input's storage
                # without saying so in their schema (``_unsafe_view``)
                storage = t.untyped_storage()
                if storage._cdata in self._storages:
                    continue
                n = _nbytes(t)
                self._storages.add(storage._cdata)
                self.live += n
                self._note_peak(self.live)
                weakref.finalize(storage, self._free, storage._cdata, n)

    def _free(self, key: int, n: float) -> None:
        self._storages.discard(key)
        self.live -= n

    def _collective(self, kind: str, args, out) -> None:
        name = next(a for a in reversed(args) if isinstance(a, str))
        ranks = self.groups.get(name, [0])
        r = _nbytes(out)
        w = self._w
        self.collect_bytes[kind] += w * r
        wire = w * r * _wire_factor(kind, len(ranks))
        self.wire_bytes[kind] += wire
        self.wire_by_link[self.device.link_class(ranks)] += wire
        self.hbm_bytes += w * r

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensorMode

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor lowers it to local ops, seen next
        if any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack()):
            return func(*args, **kwargs)  # DTensor's shape propagation
        flat, _ = tree_flatten((args, kwargs))
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        if func in _MIXED:
            out = kwargs.get("out")
            if out is None:
                a, b = args[1:3] if func in _ADDEND_FIRST else args[:2]
                out_dtype = args[3 if func in _ADDEND_FIRST else 2]
                out = self.empty((*a.shape[:-1], b.shape[-1]), out_dtype, a.device)
        elif tensors:
            out = func(*args, **kwargs)
        else:
            with self.fake:  # factory: the step's own new tensor
                out = func(*args, **kwargs)
        self._w = w = self._current_weight()
        node = _backward_node()
        self._routing = node is not None and type(node).__name__ == "CopySlices"
        self._alloc(out, func)
        if func in _PRODUCTS:
            a = args[1] if func in _ADDEND_FIRST else args[0]
            f = 2.0 * out.numel() * a.shape[-1]
            self.dot_flops += w * f
            self.dot_flops_once += f
            # operands read (an addend only where it is read: beta != 0) and
            # the result written
            ops = tensors[1:3] if func in _ADDEND_FIRST else tensors[:2]
            if func in _ADDEND_FIRST and kwargs.get("beta", 1) != 0:
                ops = tensors[:3]
            self.hbm_bytes += w * (sum(_nbytes(t) for t in ops) + _nbytes(out))
        elif func in _GATHERS:
            self.hbm_bytes += w * 2 * _nbytes(out)
        elif func in _WRITES and not self._routing:
            # copy_(dst, src) / index_put_(dst, indices, values); not the
            # copies autograd makes to route a gradient through an in-place
            # write (``CopySlices``), layout work like any other
            src = args[2] if func is _aten.index_put_.default else args[1]
            self.hbm_bytes += w * 2 * _nbytes(src)
        elif func.namespace == "_c10d_functional" and func._opname in _FUNCOL:
            self._collective(_FUNCOL[func._opname], args, out)
        return out

    # ------------------------------------------------------------------
    def result(self) -> Dict:
        """``analyze_hlo``'s keys, per device, plus ``wire_bytes_by_link``
        (``nvlink`` / ``nic``) and ``dot_flops_once`` (each traced step
        counted once, the counterpart of XLA's ``cost_analysis``)."""
        collect = dict(self.collect_bytes)
        wire = dict(self.wire_bytes)
        return {
            "dot_flops": self.dot_flops,
            "conv_flops": 0.0,
            "hbm_bytes": self.hbm_bytes,
            "collect_bytes": collect,
            "wire_bytes": wire,
            "collective_bytes_total": sum(collect.values()),
            "wire_bytes_total": sum(wire.values()),
            "wire_bytes_by_link": {"nvlink": self.wire_by_link.get("nvlink", 0.0),
                                   "nic": self.wire_by_link.get("nic", 0.0)},
            "flops": self.dot_flops,
            "dot_flops_once": self.dot_flops_once,
        }
