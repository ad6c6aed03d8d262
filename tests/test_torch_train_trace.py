"""The dry run's weighted trace of a train step against a fully unrolled
one, on qwen3-0.6b reduced to 3 layers on the 2x4 mesh: FLOPs, HBM bytes
and collectives equal under each plan's loops (layers, q chunks, loss
chunks, microbatches), with forward, backward and ``remat`` 's recompute
each weighted as the step that made it; the memory peak within
``PEAK_REL``."""
import dataclasses

import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.campaign import make_campaign_mesh
from repro_torch.sharding.plan import baseline_plan


def _counts(counter):
    r = counter.result()
    return (r["flops"], r["hbm_bytes"], r["collect_bytes"], r["wire_bytes"])


#: the weighted train trace's memory peak lies within this share of the
#: unrolled one's: the untraced steps' kept bytes are counted exactly, but
#: autograd's transient copies for in-place writes (the masked scores, the
#: chunk outputs) depend on each chunk's mask, which one traced chunk
#: stands for
PEAK_REL = 0.02


@pytest.mark.parametrize("over,seq", [({}, 1536), ({"remat": "dots", "loss_chunk": 512}, 1536),
                                      ({"microbatches": 3}, 1024),
                                      ({"remat": "none", "attn_impl": "tri", "opt_int8": True},
                                       1536)],
                         ids=["full", "dots-loss_chunk", "microbatches3", "none-tri-opt_int8"])
def test_weighted_train_trace_equals_an_unrolled_one(over, seq):
    """Forward, backward (each traced layer's and chunk's backward, and the
    recompute of ``remat``, weighted as they are) and the optimizer."""
    mesh, _ = make_campaign_mesh("small")
    cfg = reduced(get_config("qwen3-0.6b"), n_layers=3)
    cell = ShapeCell("train_4k", "train", seq, 6)  # 1536: three q chunks of 512
    plan = dataclasses.replace(baseline_plan(cfg, cell), **over)
    weighted, wm = dryrun.trace_cell("qwen3-0.6b", "train_4k", mesh, plan, cfg=cfg, cell=cell)
    unrolled, um = dryrun.trace_cell("qwen3-0.6b", "train_4k", mesh, plan, cfg=cfg, cell=cell,
                                     unroll=True)
    for w, u in zip(_counts(weighted), _counts(unrolled)):
        assert w == pytest.approx(u, rel=1e-12)
    assert weighted.result()["dot_flops_once"] < unrolled.result()["dot_flops_once"]
    assert weighted.peak == pytest.approx(unrolled.peak, rel=PEAK_REL)
    assert wm["argument_bytes"] == um["argument_bytes"] and wm["alias_bytes"] == um["alias_bytes"]


