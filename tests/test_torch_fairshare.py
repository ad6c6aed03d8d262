"""repro_torch's fair-share policy: the reference's nine tests mirrored on
the port's copy, and the port's ``plan_worker_grants`` against the
reference's on hypothesis-drawn tenant snapshots (equal grants and
credits, exactly: both are the same pure function)."""
from _hypothesis_compat import given, settings, strategies as st
from repro.core import fairshare as jfs
from repro_torch.core.fairshare import (GrantPlan, TenantSnapshot, budget_left,
                                        over_budget, plan_worker_grants)


def _t(name, **kw):
    kw.setdefault("backlog", 4)
    return TenantSnapshot(name=name, **kw)


def test_budget_accounting():
    assert budget_left(None, 100) is None
    assert budget_left(5, 2) == 3
    assert budget_left(5, 9) == 0
    assert not over_budget(None, 10 ** 6)
    assert not over_budget(5, 4)
    assert over_budget(5, 5)


def test_equal_priority_splits_slots_evenly():
    plan = plan_worker_grants([_t("a"), _t("b")], free_slots=4,
                              max_workers_per_tenant=4)
    assert sorted(plan.grants) == ["a", "a", "b", "b"]


def test_priority_weights_grant_share():
    tenants = [_t("hi", priority=2, backlog=8), _t("lo", priority=1, backlog=8)]
    plan = plan_worker_grants(tenants, free_slots=3, max_workers_per_tenant=8)
    assert plan.grants.count("hi") == 2 and plan.grants.count("lo") == 1


def test_backlog_caps_grants():
    # one pending cell never earns a second worker
    plan = plan_worker_grants([_t("a", backlog=1), _t("b", backlog=6)],
                              free_slots=4, max_workers_per_tenant=4)
    assert plan.grants.count("a") == 1
    assert plan.grants.count("b") == 3


def test_exhausted_budget_is_skipped():
    tenants = [_t("spent", budget_cells=3, cells_done=3), _t("fresh")]
    plan = plan_worker_grants(tenants, free_slots=2)
    assert plan.grants == ["fresh", "fresh"]


def test_stalled_tenant_cannot_absorb_slots():
    tenants = [_t("stuck", priority=9, stalled=True), _t("ok")]
    plan = plan_worker_grants(tenants, free_slots=2)
    assert all(g == "ok" for g in plan.grants)


def test_credits_carry_fairness_across_ticks():
    # pool of one slot: alternating ticks should alternate the winner
    winners = []
    credits = {"a": 0.0, "b": 0.0}
    for _ in range(4):
        snap = [TenantSnapshot("a", backlog=4, credit=credits["a"]),
                TenantSnapshot("b", backlog=4, credit=credits["b"])]
        plan = plan_worker_grants(snap, free_slots=1)
        winners.extend(plan.grants)
        credits = plan.credits
    assert winners.count("a") == 2 and winners.count("b") == 2


def test_grants_deterministic_under_permutation():
    tenants = [_t("c", priority=1), _t("a", priority=3), _t("b", priority=2)]
    plan_fwd = plan_worker_grants(tenants, free_slots=5, max_workers_per_tenant=5)
    plan_rev = plan_worker_grants(list(reversed(tenants)), free_slots=5,
                                  max_workers_per_tenant=5)
    assert plan_fwd == GrantPlan(plan_rev.grants, plan_rev.credits)


def test_no_eligible_tenants_returns_empty_plan():
    plan = plan_worker_grants([_t("idle", backlog=0)], free_slots=3)
    assert plan.grants == []


_TENANT = st.tuples(
    st.integers(1, 4),            # priority
    st.integers(0, 6),            # backlog
    st.integers(0, 3),            # workers
    st.integers(0, 5),            # cells_done
    st.integers(0, 6),            # budget_cells, 0 = unlimited
    st.integers(-8, 8),           # credit, in quarters
    st.booleans())                # stalled


@settings(max_examples=150, deadline=None)
@given(st.lists(_TENANT, min_size=0, max_size=5), st.integers(0, 6), st.integers(1, 4))
def test_grants_equal_the_reference_on_random_snapshots(rows, free, cap):
    def snaps(cls):
        return [cls(name=f"t{i}", priority=p, backlog=b, workers=w, cells_done=d,
                    budget_cells=bc or None, credit=c / 4, stalled=s)
                for i, (p, b, w, d, bc, c, s) in enumerate(rows)]

    got = plan_worker_grants(snaps(TenantSnapshot), free, max_workers_per_tenant=cap)
    want = jfs.plan_worker_grants(snaps(jfs.TenantSnapshot), free,
                                  max_workers_per_tenant=cap)
    assert got.grants == want.grants
    assert got.credits == want.credits
