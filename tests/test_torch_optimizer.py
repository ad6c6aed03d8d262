"""The port's AdamW against the reference's: ``lr_schedule``, the initial
state, ``adamw_update`` fed the same numpy params, grads and state (f32 and
int8 moments, with and without master weights) within 1e-6, the blocked
update bit-identical to a whole-leaf one, and ``opt_specs`` ' placements
spec for spec against the reference's ``PartitionSpec`` s on the 2x4, pod
and multi-pod meshes.

A spec and a placement tuple agree when, for every tensor dim ``d``, the
mesh axes the spec lists for ``d`` are exactly the mesh dims holding
``Shard(d)``, in mesh order (``tests/test_torch_plan.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPE_BY_NAME, get_config
from repro.models import model as JM
from repro.sharding import plan as jplan
from repro.train import optimizer as jopt
from repro_torch.configs import get_config as tget
from repro_torch.launch.campaign import make_campaign_mesh
from repro_torch.models import model as TM
from repro_torch.sharding import plan as tplan
from repro_torch.train import optimizer as topt

SHAPES = {"embed": (48, 16), "blocks.mlp.wi": (3, 16, 40), "blocks.attn.wq": (3, 16, 2, 8),
          "ln_f": (16,)}
CFG = dict(lr=1e-2, warmup_steps=3, total_steps=40, weight_decay=0.1, grad_clip=0.5)


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) != {"q", "s"}:
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7, 21, 40, 55])
def test_lr_schedule_matches(step):
    jc, tc = jopt.AdamWConfig(**CFG), topt.AdamWConfig(**CFG)
    want = float(jopt.lr_schedule(jc, jnp.int32(step)))
    got = topt.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-30)


def _draw(seed):
    rng = np.random.default_rng(seed)
    params = {k: (0.5 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = {k: (0.3 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    m = {k: (0.05 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    v = {k: np.abs(0.01 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    return params, grads, m, v


def _states(int8, master, seed=0):
    """The same optimizer state in both packages: random moments (int8 ones
    quantized by the reference), step 4."""
    params, grads, m, v = _draw(seed)
    jst = {"step": jnp.int32(4)}
    tst = {"step": torch.tensor(4, dtype=torch.int32)}
    for name, mom in (("m", m), ("v", v)):
        if int8:
            q = {k: jopt._q8(jnp.asarray(x)) for k, x in mom.items()}
            jst[name] = _nest({k: {"q": a, "s": s} for k, (a, s) in q.items()})
            tst[name] = {k: {"q": torch.from_numpy(np.asarray(a).copy()),
                             "s": torch.from_numpy(np.asarray(s).copy())}
                         for k, (a, s) in q.items()}
        else:
            jst[name] = _nest({k: jnp.asarray(x) for k, x in mom.items()})
            tst[name] = {k: torch.from_numpy(x.copy()) for k, x in mom.items()}
    if master:
        jst["master"] = _nest({k: jnp.asarray(x) + 0.01 for k, x in params.items()})
        tst["master"] = {k: torch.from_numpy(x + np.float32(0.01)) for k, x in params.items()}
    return params, grads, jst, tst


def _close(want, got, tol=1e-6):
    want, got = np.asarray(want, np.float32), got.float().numpy()
    assert want.shape == got.shape
    return float(np.abs(want - got).max()) <= tol


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_adamw_update_matches_the_reference(int8, master):
    params, grads, jst, tst = _states(int8, master)
    jc, tc = jopt.AdamWConfig(**CFG), topt.AdamWConfig(**CFG)
    jp, jnew, jm = jopt.adamw_update(jc, _nest({k: jnp.asarray(x) for k, x in params.items()}),
                                     _nest({k: jnp.asarray(x) for k, x in grads.items()}), jst)
    tp = {k: torch.from_numpy(x.copy()) for k, x in params.items()}
    out_p, tnew, tm = topt.adamw_update(tc, tp, {k: torch.from_numpy(x) for k, x in grads.items()},
                                        tst)
    assert out_p is tp and tnew is tst  # updated in place, as the reference donates
    assert int(tnew["step"]) == int(jnew["step"]) == 5
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9
    jpf = _flat(jp)
    for k in SHAPES:
        assert _close(jpf[k], tp[k]), k
    for name in ("m", "v"):
        jf = _flat(jnew[name])
        for k in SHAPES:
            if int8:
                # the dequantized moments: a rounding flip moves one level
                # of the row's scale, within 1e-6 of the moments here
                want = jopt._dq8(jf[k]["q"], jf[k]["s"], SHAPES[k])
                got = topt._dq8(tnew[name][k]["q"], tnew[name][k]["s"], SHAPES[k])
                assert _close(want, got), (name, k)
                assert tnew[name][k]["q"].dtype == torch.int8
            else:
                assert _close(jf[k], tnew[name][k]), (name, k)
    if master:
        jf = _flat(jnew["master"])
        for k in SHAPES:
            assert _close(jf[k], tnew["master"][k]), k


@pytest.mark.parametrize("int8", [False, True])
def test_blocked_update_is_bit_identical(int8, monkeypatch):
    """Walking a leaf in blocks of its leading dim (what keeps a stacked
    full-width leaf's f32 temporaries to one layer) changes no bit."""
    outs = []
    for block in (1 << 26, 17):
        monkeypatch.setattr(topt, "BLOCK_ELEMS", block)
        params, grads, _, tst = _states(int8, master=True, seed=3)
        tp = {k: torch.from_numpy(x.copy()) for k, x in params.items()}
        topt.adamw_update(topt.AdamWConfig(**CFG), tp,
                          {k: torch.from_numpy(x) for k, x in grads.items()}, tst)
        outs.append((tp, tst))
    assert len(topt._blocks(torch.zeros(SHAPES["blocks.mlp.wi"]))) == 3
    (p0, s0), (p1, s1) = outs
    for k in SHAPES:
        assert torch.equal(p0[k], p1[k])
        for name in ("m", "v"):
            a, b = s0[name][k], s1[name][k]
            if int8:
                assert torch.equal(a["q"], b["q"]) and torch.equal(a["s"], b["s"])
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("int8", [False, True])
def test_init_opt_state_matches(int8):
    params = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    jst = jopt.init_opt_state(_nest({k: jnp.zeros(s, jnp.bfloat16) for k, s in SHAPES.items()}),
                              master_weights=True, int8_moments=int8)
    tst = topt.init_opt_state(params, master_weights=True, int8_moments=int8)
    assert topt.uses_int8(tst) == jopt.uses_int8(jst) == int8
    for name in ("m", "v", "master"):
        jf = _flat(jst[name])
        for k in SHAPES:
            a, b = jf[k], tst[name][k]
            pairs = [(a["q"], b["q"]), (a["s"], b["s"])] if isinstance(b, dict) else [(a, b)]
            for x, y in pairs:
                assert tuple(y.shape) == x.shape and str(y.dtype).split(".")[1] == str(x.dtype)
                assert np.array_equal(np.asarray(x, np.float32), y.float().numpy())
    assert int(tst["step"]) == 0 and tst["step"].dtype == torch.int32


class _AxisSizes:
    """What the reference's ``resolve`` and ``opt_specs`` read of a mesh."""

    def __init__(self, shape):
        self.shape = shape


def _spec(mesh, placements, ndim):
    names = list(mesh.mesh_dim_names)
    parts = []
    for d in range(ndim):
        axes = tuple(names[i] for i, p in enumerate(placements) if p.is_shard(d))
        parts.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _strip(spec):
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@pytest.mark.parametrize("mesh_name", ["small", "pod", "multipod"])
def test_opt_specs_match_the_reference(mesh_name):
    mesh, _ = make_campaign_mesh(mesh_name)
    axes = _AxisSizes(dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    for arch in ("qwen3-0.6b", "llama3-8b"):
        cfg, cell = get_config(arch), SHAPE_BY_NAME["train_4k"]
        jvalues, jlogical = JM.abstract_params(cfg)
        jp = jplan.baseline_plan(cfg, cell, multi_pod=mesh_name == "multipod")
        jspecs = jp.param_specs(axes, jvalues, jlogical)
        tvalues, tlogical = TM.abstract_params(tget(arch))
        tp = tplan.baseline_plan(tget(arch), cell, multi_pod=mesh_name == "multipod")
        tpl = tp.param_shardings(mesh, tvalues, tlogical)
        for zero1 in (False, True):
            for int8 in (False, True):
                want = jopt.opt_specs(axes, jspecs, jvalues, zero1=zero1, master=True,
                                      int8=int8)
                got = topt.opt_specs(mesh, tpl, tvalues, zero1=zero1, master=True, int8=int8)
                assert all(x.is_replicate() for x in got["step"]) and want["step"] == ()
                for name in ("m", "v", "master"):
                    jf = _flat(want[name])
                    for k, v in tvalues.items():
                        w, g = jf[k], got[name][k]
                        if int8 and name != "master":
                            assert _spec(mesh, g["q"], v.ndim) == _strip(w["q"]), (k, name)
                            assert _spec(mesh, g["s"], v.ndim) == _strip(w["s"]), (k, name)
                        else:
                            assert _spec(mesh, g, v.ndim) == _strip(w), (arch, k, name, zero1)
