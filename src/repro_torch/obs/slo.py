"""Per-tenant SLOs, multi-window burn rates, and error budgets.

SRE-style objective tracking on the simulated clock.  Each tenant gets a
frozen ``SloPolicy`` — a latency target, the fraction of jobs that must
hit it (``deadline_rate``), and optionally a cumulative cost ceiling —
and an ``SloTracker`` folds every completed job into:

  - **Error budget**: a deadline_rate of 0.99 allows 1% of jobs to be
    bad; ``budget_remaining`` is the fraction of that allowance still
    unspent (1.0 untouched, 0.0 exhausted, negative = blown).  With a
    cost ceiling the budget is the *minimum* of the reliability and cost
    axes — whichever budget is closer to gone governs.
  - **Multi-window burn rates**: the classic fast/slow pair.  Burn rate
    is (observed bad fraction) / (allowed bad fraction) over a trailing
    window — 1.0 means spending exactly on schedule, 14x means the fast
    window alone would exhaust a day's budget in ~100 minutes.  A page
    fires only when *both* windows exceed their thresholds (fast alone is
    noise, slow alone is stale), which is what ``should_shed`` checks.

Everything lands in the metrics registry as gauges (``slo.<tenant>.
budget_remaining`` / ``burn_fast`` / ``burn_slow``) and counters, so the
health detectors, the cross-run store, and the HTML console all see it
for free.  The tracker is pure observation: it draws no randomness,
reads no wall clock, and never mutates the run — admission control only
consults ``should_shed`` when ``AdmissionPolicy.budget_aware`` opts in
(``repro_torch.tenancy.scheduler``), and that is a scheduler decision, not a
telemetry side effect.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """One tenant's objective.  Windows are simulated seconds."""

    latency_target_s: float        # a job slower than this is "bad"
    deadline_rate: float = 0.99    # fraction of jobs that must hit it
    cost_ceiling_usd: Optional[float] = None  # cumulative dollars cap
    fast_window_s: float = 30.0    # fast burn window
    slow_window_s: float = 120.0   # slow burn window
    fast_burn: float = 6.0         # page when fast burn exceeds this ...
    slow_burn: float = 3.0         # ... AND slow burn exceeds this

    @property
    def allowed_bad(self) -> float:
        return max(1e-9, 1.0 - self.deadline_rate)


@dataclasses.dataclass
class _TenantState:
    policy: SloPolicy
    #: (t, bad) per completed job, arrival order == completion order here
    events: List[Tuple[float, bool]] = dataclasses.field(
        default_factory=list)
    dollars: float = 0.0
    #: (t, budget_remaining, burn_fast, burn_slow) after each job — the
    #: console's burn-chart series.
    series: List[Tuple[float, float, float, float]] = dataclasses.field(
        default_factory=list)


class SloTracker:
    """Folds completed jobs into per-tenant budgets and burn rates."""

    def __init__(self, policies: Dict[str, SloPolicy], telemetry=None):
        self.policies = dict(policies)
        self.telemetry = telemetry
        self._state: Dict[str, _TenantState] = {
            t: _TenantState(policy=p) for t, p in self.policies.items()}

    # ----------------------------------------------------------- recording
    def record_job(self, tenant: str, t: float, latency_s: float,
                   deadline_missed: bool, failed: bool,
                   dollars: float) -> None:
        """Fold one completed job.  A job is *bad* when it failed, missed
        its declared deadline, or ran past the policy's latency target."""
        st = self._state.get(tenant)
        if st is None:
            return
        pol = st.policy
        bad = bool(failed or deadline_missed
                   or latency_s > pol.latency_target_s)
        st.events.append((float(t), bad))
        st.dollars += float(dollars)
        remaining = self.budget_remaining(tenant)
        bf = self.burn_rate(tenant, t, pol.fast_window_s)
        bs = self.burn_rate(tenant, t, pol.slow_window_s)
        st.series.append((float(t), remaining, bf, bs))
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            m = tel.metrics
            m.gauge(f"slo.{tenant}.budget_remaining").set(remaining)
            m.gauge(f"slo.{tenant}.burn_fast").set(bf)
            m.gauge(f"slo.{tenant}.burn_slow").set(bs)
            if bad:
                m.counter(f"slo.{tenant}.bad_jobs").inc()

    # ------------------------------------------------------------- queries
    def burn_rate(self, tenant: str, t: float, window_s: float) -> float:
        """(bad fraction over the trailing window) / (allowed fraction)."""
        st = self._state.get(tenant)
        if st is None:
            return 0.0
        lo = float(t) - window_s
        inside = [bad for (et, bad) in st.events if et >= lo]
        if not inside:
            return 0.0
        frac = sum(1 for bad in inside if bad) / len(inside)
        return frac / st.policy.allowed_bad

    def budget_remaining(self, tenant: str) -> float:
        """Fraction of the error budget left; min of reliability and cost
        axes when a cost ceiling is set.  Negative = budget blown."""
        st = self._state.get(tenant)
        if st is None:
            return 1.0
        pol = st.policy
        if st.events:
            frac = sum(1 for _, bad in st.events if bad) / len(st.events)
            rel = 1.0 - frac / pol.allowed_bad
        else:
            rel = 1.0
        if pol.cost_ceiling_usd is not None and pol.cost_ceiling_usd > 0:
            cost = 1.0 - st.dollars / pol.cost_ceiling_usd
            return min(rel, cost)
        return rel

    def should_shed(self, tenant: str, t: float) -> bool:
        """True when this tenant's budget is gone or both burn windows
        are paging — the signal ``budget_aware`` admission acts on."""
        st = self._state.get(tenant)
        if st is None:
            return False
        if self.budget_remaining(tenant) <= 0.0:
            return True
        pol = st.policy
        return (self.burn_rate(tenant, t, pol.fast_window_s) > pol.fast_burn
                and self.burn_rate(tenant, t, pol.slow_window_s)
                > pol.slow_burn)

    # ------------------------------------------------------------- exports
    def summary(self) -> dict:
        """Deterministic per-tenant summary (sorted tenants)."""
        out = {}
        for tenant in sorted(self._state):
            st = self._state[tenant]
            bad = sum(1 for _, b in st.events if b)
            last_t = st.events[-1][0] if st.events else 0.0
            out[tenant] = {
                "jobs": len(st.events), "bad_jobs": bad,
                "dollars": st.dollars,
                "budget_remaining": self.budget_remaining(tenant),
                "burn_fast": self.burn_rate(tenant, last_t,
                                            st.policy.fast_window_s),
                "burn_slow": self.burn_rate(tenant, last_t,
                                            st.policy.slow_window_s),
                "latency_target_s": st.policy.latency_target_s,
                "deadline_rate": st.policy.deadline_rate,
                "cost_ceiling_usd": st.policy.cost_ceiling_usd,
            }
        return out

    def rows(self) -> List[dict]:
        """JSONL-ready rows (``kind: "slo"``), one per tenant, carrying
        the full burn series for the console's charts."""
        out = []
        for tenant, summ in self.summary().items():
            row = {"kind": "slo", "tenant": tenant}
            row.update(summ)
            row["series"] = [[t, r, bf, bs]
                             for (t, r, bf, bs)
                             in self._state[tenant].series]
            out.append(row)
        return out
