"""Serverless cost model: Lambda GB-seconds + invocations + S3 ops (a copy
of ``repro/runtime/cost.py``).

The paper's headline claim is a *dollar* claim as much as a wall-clock one
(Sec. 5: ~3000 Lambda workers at 3 GB each vs a fixed EC2 cluster), so every
simulated phase is billed, not just timed.  Constants default to the public
AWS price points the paper's experiments ran under (us-west-2, 2019-era
prices; the *ratios* are what matter for scheme-vs-scheme comparisons):

  - Lambda compute: $1.66667e-5 per GB-second, billed for each attempt's
    full duration — a straggler that loses the k-of-n race still runs (and
    bills) to completion, which is exactly why k-of-n saves time but not
    compute dollars, while `speculative`/`hedged` relaunches bill extra
    attempts on top.
  - Lambda invocations: $2e-7 per request (every attempt, retries and
    hedges included).
  - S3: $5e-6 per PUT, $4e-7 per GET.  Workers communicate through S3
    (paper Sec. 2): each attempt GETs its inputs and each *successful*
    attempt PUTs its output; per-phase `comm_units` add master-side traffic
    on the same meters.
  - Provisioned concurrency: $4.1667e-6 per GB-second while a prewarmed
    container sits idle (the real Lambda provisioned-concurrency price,
    ~25% of the execution rate).  The ``WarmPool``'s pinned-warm reserve
    bills this whether or not any job ever lands on it — the tenancy
    scheduler accrues ``provisioned_gb_seconds`` as the integral of the
    provisioned target over simulated time, times ``memory_gb``.

``CostModel`` is the frozen price sheet; ``CostLedger`` is the mutable
accumulator a ``FleetEngine`` carries across phases.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Price sheet for one simulated fleet (immutable, hashable)."""

    memory_gb: float = 3.0              # paper: 3 GB Lambda workers
    # per_attempt: each invocation bills its own duration (Lambda).
    # reserved: the whole fleet bills wall-clock per phase, idle included
    # (a fixed EC2/MPI cluster — stragglers hold every node hostage).
    billing: str = "per_attempt"
    usd_per_gb_second: float = 1.66667e-5
    usd_per_invocation: float = 2e-7
    usd_per_s3_put: float = 5e-6
    usd_per_s3_get: float = 4e-7
    # Per-attempt S3 traffic: inputs read at launch, output written on
    # success (stragglers that are cancelled before writing still read).
    gets_per_attempt: float = 2.0
    puts_per_success: float = 1.0
    # One master-side comm unit (the SimClock ``comm_units`` axis) in ops.
    gets_per_comm_unit: float = 1.0
    puts_per_comm_unit: float = 1.0
    # Idle prewarmed (provisioned-concurrency) rate: billed per GB-second
    # the pinned-warm reserve exists, independent of invocations.
    usd_per_provisioned_gb_second: float = 4.1667e-6

    def dollars(self, gb_seconds: float, invocations: float,
                s3_puts: float, s3_gets: float,
                provisioned_gb_seconds: float = 0.0) -> float:
        return (gb_seconds * self.usd_per_gb_second
                + invocations * self.usd_per_invocation
                + s3_puts * self.usd_per_s3_put
                + s3_gets * self.usd_per_s3_get
                + provisioned_gb_seconds * self.usd_per_provisioned_gb_second)


@dataclasses.dataclass
class CostLedger:
    """Running totals across phases; ``dollars`` is derived, never drifts."""

    gb_seconds: float = 0.0
    invocations: float = 0.0
    s3_puts: float = 0.0
    s3_gets: float = 0.0
    provisioned_gb_seconds: float = 0.0

    def add(self, other: "CostLedger") -> None:
        self.gb_seconds += other.gb_seconds
        self.invocations += other.invocations
        self.s3_puts += other.s3_puts
        self.s3_gets += other.s3_gets
        self.provisioned_gb_seconds += other.provisioned_gb_seconds

    def dollars(self, model: CostModel) -> float:
        return model.dollars(self.gb_seconds, self.invocations,
                             self.s3_puts, self.s3_gets,
                             self.provisioned_gb_seconds)

    def as_dict(self) -> dict:
        d = {"gb_seconds": self.gb_seconds,
             "invocations": self.invocations,
             "s3_puts": self.s3_puts, "s3_gets": self.s3_gets}
        # Additive (trace schema v4): emitted only when nonzero so every
        # pre-tenancy fixture row stays byte-identical.
        if self.provisioned_gb_seconds:
            d["provisioned_gb_seconds"] = self.provisioned_gb_seconds
        return d


def bill_phase(cost: CostModel, attempts, successes: int,
               comm_units: float) -> CostLedger:
    """Ledger entry for one phase.

    ``attempts`` is an iterable of (launch_time, end_time) pairs — every
    Lambda invocation of the phase, including failed tries, policy
    relaunches, and losers of k-of-n races (they run to completion).  An
    attempt may instead be a (launch, end, mem_scale) triple: it billed at
    ``mem_scale`` times the phase's Lambda size (OOM-escalated retries
    from the fault plane run on bigger instances).
    """
    attempts = list(attempts)
    billed = 0.0      # unscaled GB-second base (same sum order as ever)
    scaled = 0.0      # memory-escalated attempts, pre-multiplied by scale
    for a in attempts:
        dur = max(0.0, a[1] - a[0])
        if len(a) > 2 and a[2] != 1.0:
            scaled += a[2] * dur
        else:
            billed += dur
    n_attempts = len(attempts)
    return CostLedger(
        gb_seconds=cost.memory_gb * billed + cost.memory_gb * scaled,
        invocations=float(n_attempts),
        s3_puts=(cost.puts_per_success * successes
                 + cost.puts_per_comm_unit * comm_units),
        s3_gets=(cost.gets_per_attempt * n_attempts
                 + cost.gets_per_comm_unit * comm_units),
    )
