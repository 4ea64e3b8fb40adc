"""Warm-container pool: stateful cold-start dynamics keyed off the event
clock; port of ``repro/scheduler/pool.py``, host code with no tensors.

A steady sequential schedule keeps re-hitting the same warm containers; a
bursty DAG schedule that launches two fan-outs at once needs twice the
footprint and pays cold starts.  ``WarmPool`` models that:

  - ``acquire(t)`` takes the most-recently-used free, unexpired container
    at absolute simulated time ``t`` (True: warm) or starts cold (False);
  - ``release(t)`` returns the attempt's container, idle from ``t``
    (failed attempts release too);
  - containers idle longer than ``ttl`` expire lazily; ``capacity``
    LRU-evicts past a pool-size cap;
  - prewarmed (provisioned) containers stay warm until first use;
    ``prewarm`` / ``cool`` resize that reserve, ``cull`` kills a seeded
    fraction of the idle containers (the fault plane's pool death).

Attached to a ``FleetEngine`` (``SimClock(..., pool=...)``) it replaces the
i.i.d. cold-start coin; the delay still comes from
``FleetConfig.cold_start_lo/hi``.  Policy relaunches bypass the pool.
"""
from __future__ import annotations

import bisect
from typing import List, Optional


class WarmPool:
    """Container pool with TTL expiry; all times are absolute simulated
    seconds on the fleet engine's clock."""

    def __init__(self, ttl: float = 300.0, capacity: Optional[int] = None,
                 prewarmed: int = 0):
        if ttl <= 0:
            raise ValueError(f"pool ttl must be positive, got {ttl}")
        if capacity is not None and capacity < 1:
            raise ValueError(f"pool capacity must be >= 1, got {capacity}")
        self.ttl = float(ttl)
        self.capacity = capacity
        # Sorted idle-since times; entry i is a container free from _free[i].
        self._free: List[float] = []
        # Provisioned containers, pinned warm until first use: never in
        # _free, so lazy TTL expiry cannot discard them before a late
        # first dispatch.
        self._fresh = int(prewarmed)
        self.warm_hits = 0
        self.cold_starts = 0
        self.killed = 0

    # ------------------------------------------------------------ lifecycle
    def _expire(self, t: float) -> None:
        cut = bisect.bisect_left(self._free, t - self.ttl)
        if cut:
            del self._free[:cut]

    def acquire(self, t: float) -> bool:
        """Take a warm container for a launch at time ``t``; True if one was
        available (no cold start), False if the attempt starts cold."""
        t = float(t)
        self._expire(t)
        # MRU: the container with the largest available_at <= t.  Released
        # containers outrank provisioned ones (which are idle "since 0"):
        # hot containers stay hot, the provisioned reserve drains last.
        i = bisect.bisect_right(self._free, t) - 1
        if i >= 0:
            del self._free[i]
            self.warm_hits += 1
            return True
        if self._fresh > 0:
            self._fresh -= 1
            self.warm_hits += 1
            return True
        self.cold_starts += 1
        return False

    def release(self, t: float) -> None:
        """Return a container to the pool, idle from time ``t``."""
        bisect.insort(self._free, float(t))
        if (self.capacity is not None
                and self._fresh + len(self._free) > self.capacity):
            # LRU evict: the provisioned reserve is the longest-idle.
            if self._fresh:
                self._fresh -= 1
            else:
                del self._free[0]

    def prewarm(self, k: int) -> None:
        """Provision ``k`` more pinned-warm containers (autoscale up)."""
        self._fresh += max(0, int(k))

    def cool(self, k: int) -> int:
        """Decommission up to ``k`` unused provisioned containers
        (autoscale down); returns how many were actually removed."""
        take = min(max(0, int(k)), self._fresh)
        self._fresh -= take
        return take

    @property
    def fresh(self) -> int:
        """Provisioned containers still pinned warm (never used)."""
        return self._fresh

    def cull(self, fraction: float, rng) -> int:
        """Kill a seeded random ``fraction`` of the idle containers — the
        fault plane's container-death event (the provider reclaimed them
        out from under the tenant).  In-flight containers are unaffected;
        they die with their attempt's own fault, not here.  Returns how
        many containers were culled."""
        n = self._fresh + len(self._free)
        k = int(round(float(fraction) * n))
        if k <= 0:
            return 0
        # Index space [0, _fresh) is the provisioned reserve, the rest maps
        # onto _free — same sorted layout the single-list pool exposed.
        idx = rng.choice(n, size=k, replace=False)
        fresh_killed = 0
        for i in sorted(idx, reverse=True):
            if i < self._fresh:
                fresh_killed += 1
            else:
                del self._free[i - self._fresh]
        self._fresh -= fresh_killed
        self.killed += k
        return k

    # ------------------------------------------------------------- inspect
    def snapshot(self, t: float) -> dict:
        """Telemetry-friendly state: cumulative hit/miss/kill counters plus
        the warm, unexpired container count a launch at ``t`` would see."""
        return {"warm_hits": self.warm_hits,
                "cold_starts": self.cold_starts,
                "killed": self.killed,
                "free": self.free_at(t),
                "containers": self._fresh + len(self._free)}

    def free_at(self, t: float) -> int:
        """How many warm, unexpired containers a launch at ``t`` could use."""
        t = float(t)
        lo = bisect.bisect_left(self._free, t - self.ttl)
        hi = bisect.bisect_right(self._free, t)
        return max(0, hi - lo) + self._fresh

    def earliest_fit(self, t: float, need: int, deadline: float) -> float:
        """Earliest launch time in ``[t, deadline]`` at which the most of a
        ``need``-container burst lands warm.  Candidates are the release
        times of currently busy-until-then containers; returns ``t`` when
        waiting gains nothing.  Pool-aware dispatch spends per-phase slack
        (``obs.critical_path``) through this: delaying an off-critical-path
        phase to a candidate returned here converts cold starts into warm
        hits without moving the makespan."""
        t = float(t)
        deadline = float(deadline)
        best_t, best_n = t, min(need, self.free_at(t))
        if best_n >= need or deadline <= t:
            return best_t
        lo = bisect.bisect_right(self._free, t)
        hi = bisect.bisect_right(self._free, deadline)
        for cand in self._free[lo:hi]:
            n = min(need, self.free_at(cand))
            if n > best_n:
                best_t, best_n = cand, n
                if best_n >= need:
                    break
        return best_t

    def __len__(self) -> int:
        return self._fresh + len(self._free)
