"""The port's plan space against the reference's: the template's legal
ranges, validation, neighbours, repair and random draws, the plans that
points materialise to, and the placements every parameter and cache leaf
resolves to on a 2x4 mesh.

Mapping between the two: the reference's ``PartitionSpec`` puts mesh axes
on each tensor dim; DTensor puts ``Shard(d)`` (or ``Replicate()``) on each
mesh dim. A spec and a placement tuple agree when, for every tensor dim
``d``, the mesh axes the spec lists for ``d`` are exactly the mesh dims
holding ``Shard(d)``, in mesh order."""
import random

import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES, SHAPES, get_config, reduced
from repro.core import design_space as jds
from repro.models import model as JM
from repro.sharding import plan as jplan
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced as treduced
from repro_torch.core import design_space as tds
from repro_torch.core.cost_db import workload_features
from repro_torch.core.device import H100_CLUSTER
from repro_torch.launch.campaign import make_campaign_mesh
from repro_torch.models import model as TM
from repro_torch.sharding import plan as tplan

MESHES = {"small2x4": {"data": 2, "model": 4}, "pod16x16": {"data": 16, "model": 16},
          "multipod2x16x16": {"pod": 2, "data": 16, "model": 16}}
DENSE = [a for a in ARCH_NAMES if get_config(a).family == "dense"]


class _AxisSizes:
    """What the reference's ``resolve`` reads of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = shape


def _cases():
    return [pytest.param(a, s.name, m, id=f"{a}-{s.name}-{m}")
            for a in ARCH_NAMES for s in SHAPES for m in MESHES]


@pytest.mark.parametrize("arch,shape,mesh", _cases())
def test_template_and_plans_match_the_reference(arch, shape, mesh):
    from repro.configs import SHAPE_BY_NAME
    from repro_torch.configs import SHAPE_BY_NAME as TSHAPES

    cfg, cell = get_config(arch), SHAPE_BY_NAME[shape]
    tcfg, tcell = tget(arch), TSHAPES[shape]
    jt = jds.PlanTemplate(cfg, cell, MESHES[mesh])
    tt = tds.PlanTemplate(tcfg, tcell, MESHES[mesh])
    assert tt.device is H100_CLUSTER
    assert tt.dims() == jt.dims()
    jbase, tbase = jds.baseline_point(cell, jt), tds.baseline_point(tcell, tt)
    assert tbase.dims == jbase.dims and tbase.key() == jbase.key()
    assert tds.baseline_point(tcell).dims == jds.baseline_point(cell).dims
    assert [p.dims for p in tt.neighbors(tbase)] == [p.dims for p in jt.neighbors(jbase)]
    jr, tr = random.Random(7), random.Random(7)
    jpts, tpts = jt.random_points(jr, 12), tt.random_points(tr, 12)
    assert [p.dims for p in tpts] == [p.dims for p in jpts]
    multi = "pod" in MESHES[mesh]
    for jp, tp in zip([jbase] + jpts + list(jt.neighbors(jbase))[:4],
                      [tbase] + tpts + list(tt.neighbors(tbase))[:4]):
        assert tt.validate(tp) == jt.validate(jp)
        assert tt.repair(tp).dims == jt.repair(jp).dims
        assert tds.point_to_plan(tcfg, tcell, tp, multi_pod=multi).to_dict() == \
            jds.point_to_plan(cfg, cell, jp, multi_pod=multi).to_dict()
    bad = tds.PlanPoint(dims={**tbase.dims, "microbatches": 8, "batch_rule": "data+model"})
    jbad = jds.PlanPoint(dims=dict(bad.dims))
    assert tt.validate(bad) == jt.validate(jbad)
    assert tt.repair(bad).dims == jt.repair(jbad).dims
    assert tplan.baseline_plan(tcfg, tcell, multi_pod=multi).to_dict() == \
        jplan.baseline_plan(cfg, cell, multi_pod=multi).to_dict()
    from repro.core.cost_db import workload_features as jwf
    assert workload_features(tcfg, tcell) == jwf(cfg, cell)


def _entries(spec):
    """A PartitionSpec as one tuple of mesh axes per tensor dim."""
    return [() if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec]


def _from_placements(placements, names, ndim):
    return [tuple(n for n, p in zip(names, placements) if p.is_shard(d)) for d in range(ndim)]


def _plans(arch, shape):
    """The baseline plan and a spread of template points for one cell."""
    from repro.configs import SHAPE_BY_NAME

    cfg, cell = get_config(arch), SHAPE_BY_NAME[shape]
    jt = jds.PlanTemplate(cfg, cell, MESHES["small2x4"])
    pts = [jds.baseline_point(cell, jt)] + jt.random_points(random.Random(3), 6)
    pts.append(jds.PlanPoint(dims={**pts[0].dims, "attn_rule": "heads_pad"}))
    return [(jds.point_to_plan(cfg, cell, p), tds.point_to_plan(
        tget(arch), cell, tds.PlanPoint(dims=dict(p.dims)))) for p in pts]


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_param_and_cache_placements_match_partition_specs(arch, shape):
    from repro.configs import SHAPE_BY_NAME
    from repro.models.layers import split_params
    import jax

    mesh, _ = make_campaign_mesh("small")
    names = list(mesh.mesh_dim_names)
    sizes = _AxisSizes(MESHES["small2x4"])
    cfg, tcfg = reduced(get_config(arch)), treduced(tget(arch))
    jvals, jaxes = split_params(jax.eval_shape(lambda: JM.init_params(cfg, jax.random.key(0))))
    tvals, taxes = TM.abstract_params(tcfg)
    flat = {}

    def walk(v, a, prefix):
        for k in v:
            if isinstance(v[k], dict):
                walk(v[k], a[k], f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = (v[k].shape, a[k])

    walk(jvals, jaxes, "")
    assert sorted(flat) == sorted(tvals)
    cell = SHAPE_BY_NAME[shape]
    small = type(cell)(cell.name, cell.kind, 64, 8)
    jcache = JM.abstract_cache(cfg, small.global_batch, small.seq_len)
    tcache = TM.input_specs(tcfg, small)["cache"]
    for jp, tp in _plans(arch, shape):
        pl = tp.param_shardings(mesh, tvals, taxes)
        for name, (shp, axes) in flat.items():
            assert tuple(tvals[name].shape) == tuple(shp) and taxes[name] == tuple(axes)
            want = _entries(jp.resolve(sizes, shp, axes))
            got = _from_placements(pl[name], names, len(shp))
            assert got[:len(want)] == want and not any(got[len(want):]), (name, jp.name)
        cpl = tp.cache_specs(mesh, tcache)
        jspecs = jp.cache_specs(sizes, jcache)
        for k in ("k", "v", "len"):
            want = _entries(jspecs[k])
            got = _from_placements(cpl[k], names, tcache[k].ndim)
            assert got[:len(want)] == want and not any(got[len(want):]), (k, jp.name)
        tok = TM.input_specs(tcfg, small)["batch"]["tokens"]
        want = _entries(jp.resolve(sizes, tuple(tok.shape), ("batch", None)))
        got = _from_placements(tp.batch_specs(mesh, {"tokens": tok})["tokens"], names, 2)
        assert got[:len(want)] == want and not any(got[len(want):])


def test_replicated_fallbacks_are_recorded():
    from repro_torch.configs import SHAPE_BY_NAME

    plan = tplan.baseline_plan(tget("llama3-8b"), SHAPE_BY_NAME["decode_32k"])
    dims = ("layers", "embed", "kv_heads", "head_dim")
    replicated = []
    spec = plan.resolve_spec(MESHES["pod16x16"], (32, 4096, 8, 128), dims, replicated)
    assert spec == () and replicated == [(2, "kv_heads")]
    jspec = jplan.baseline_plan(get_config("llama3-8b"), SHAPES[2]).resolve(
        _AxisSizes(MESHES["pod16x16"]), (32, 4096, 8, 128), dims)
    assert jspec == P()
