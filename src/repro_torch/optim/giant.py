"""GIANT: Globally Improved Approximate Newton Direction (Wang et al.,
2018), the paper's main second-order serverful baseline (Fig. 4); port of
``repro/optim/giant.py``.

Two distributed stages per iteration:
  1. workers compute local gradients from their shard; the master sums
     them into the full g;
  2. workers compute a local Newton direction p_i = H_i^{-1} g from their
     local Hessian; the master averages them into p.

Straggler variants (paper Fig. 6): wait_all (uncoded), gcode (gradient
coding on stage 1), ignore (drop stragglers in both stages).  Both stages
are scored on the simulated clock, through ``scheduler.DagRun`` (a chain:
stage 2 consumes stage 1's sum, so the DAG schedule equals the sequential
one bit for bit) or directly.  A stage whose retry budget runs out
(``PhaseExhaustedError``) drops the dead shards.

On the device the shards are one padded stack (``num_workers``, rows per
shard, d); the local gradients are a batched autograd of the objective's
``masked_value``, the local Hessians ``scale a_i^T a_i + (hess_reg + 1e-8)
I`` one batched matmul of the shards' ``hess_sqrt``, and the local
directions one batched Cholesky solve.  CUDA unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import obs, prng, resolve_device, scheduler
from repro_torch.core import linesearch, solvers, straggler
from repro_torch.core.objectives import Dataset
from repro_torch.optim.gradient_coding import gradient_coding_phase
from repro_torch.runtime.faults import PhaseExhaustedError


@dataclasses.dataclass(frozen=True)
class GiantConfig:
    iters: int = 20
    num_workers: int = 60
    policy: str = "wait_all"     # wait_all | gcode | ignore
    gcode_redundancy: int = 2
    unit_step: bool = True
    cg_iters: int = 30
    # Phase dispatch through the scheduler's DAG layer.  The two stages
    # form a chain, so the DAG schedule reproduces the sequential one bit
    # for bit.
    schedule: str = "dag"        # dag | sequential
    phase_memory: bool = False   # bill each stage at its shard working set
    seed: int = 0
    track_test_error: bool = False


def _shard_bounds(n: int, w: int):
    per = -(-n // w)
    return [(i * per, min((i + 1) * per, n)) for i in range(w)]


def _shard_stack(data: Dataset, bounds, per: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shards padded with zero rows to ``per`` rows and stacked: x (W, per,
    d), y (W, per, ...), and the float32 row weights (1 real, 0 padding)."""
    w = len(bounds)
    x, y = data.x, data.y
    xs = x.new_zeros((w, per) + tuple(x.shape[1:]))
    ys = y.new_zeros((w, per) + tuple(y.shape[1:]))
    wts = torch.zeros((w, per), dtype=torch.float32, device=x.device)
    for i, (lo, hi) in enumerate(bounds):
        xs[i, :hi - lo] = x[lo:hi]
        ys[i, :hi - lo] = y[lo:hi]
        wts[i, :hi - lo] = 1.0
    return xs, ys, wts


def giant(objective, data: Dataset, w0, cfg: GiantConfig,
          model: Optional[straggler.StragglerModel] = straggler.StragglerModel(),
          device=None) -> Dict[str, List[float]]:
    """Run GIANT; needs the objective's ``hess_sqrt`` and ``masked_value``
    on sub-datasets.  ``model`` may also be a prebuilt ``SimClock`` (a
    custom fleet, cost or trace) or None.  Returns first_order's
    per-iteration log with the final iterate under ``"w"``."""
    if cfg.schedule not in ("dag", "sequential"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    device = resolve_device(device)
    data = Dataset(*(None if t is None else t.to(device) for t in data))
    key = prng.PRNGKey(cfg.seed)
    if isinstance(model, straggler.SimClock):
        clock = model
    else:
        clock = straggler.SimClock(model) if model is not None else None
    n, d = data.x.shape
    bounds = _shard_bounds(n, cfg.num_workers)
    per = bounds[0][1] - bounds[0][0]
    xs, ys, wts = _shard_stack(data, bounds, per)

    def local_grads(w_vec: torch.Tensor) -> torch.Tensor:
        def masked(wv, x_i, y_i, wt_i):
            return objective.masked_value(wv, Dataset(x=x_i, y=y_i), wt_i)
        return torch.func.vmap(torch.func.grad(masked),
                               in_dims=(None, 0, 0, 0))(w_vec, xs, ys, wts)

    def local_newton(w_vec: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        # Local Hessian via the shard's hess_sqrt, padding rows zeroed;
        # softmax's hess_sqrt has n K rows, which the reference leaves
        # unmasked.
        a = torch.func.vmap(lambda x_i, y_i: objective.hess_sqrt(
            w_vec, Dataset(x=x_i, y=y_i)))(xs, ys)
        if a.shape[1] == per:
            a = a * wts[:, :, None]
        scale = per / wts.sum(1).clamp_min(1.0)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        h = (scale[:, None, None] * (a.transpose(1, 2) @ a)
             + (objective.hess_reg + 1e-8) * eye)
        del a    # the shards' factors (3.6 GB at full width) go first
        return solvers.psd_solve(h, g)

    hist: Dict[str, List[float]] = {k: [] for k in (
        "iter", "fval", "gnorm", "step", "time", "cost", "test_error",
        "wall_s")}
    w = torch.as_tensor(w0, dtype=torch.float32).to(device)
    tel = clock.telemetry if clock is not None else obs.NULL
    run_span = tel.trace.begin(
        "giant", "run", clock.time if clock is not None else 0.0,
        policy=cfg.policy, workers=cfg.num_workers, schedule=cfg.schedule)
    if tel.enabled:
        tel.metrics.gauge("giant.cg_iters").set(cfg.cg_iters)

    grad_flops = 2.0 * per * d                    # local gradient pass
    # GIANT's local solves are CG / Hessian-free (Wang et al.): cg_iters
    # Hessian-vector products over the local shard per iteration.
    newton_flops = 2.0 * per * d * cfg.cg_iters
    # Both stages stream the same (per x d) shard; CG adds a few d-vectors.
    shard_bytes = scheduler.matvec_worker_bytes(per, d)
    shard_mem = (scheduler.lambda_memory_gb(shard_bytes)
                 if cfg.phase_memory else None)
    # The true working set, declared always: an attached fault plan with
    # an OomSpec kills undersized attempts.
    shard_ws = float(shard_bytes) / 2.0 ** 30
    everyone = torch.ones((cfg.num_workers,), dtype=torch.bool)
    for t in range(cfg.iters):
        t_wall = time.perf_counter()
        key, k1, k2, k3 = prng.split(key, 4)
        it_span = tel.trace.begin(
            f"iter{t}", "iteration",
            clock.time if clock is not None else float(t))
        dag = (scheduler.DagRun(clock)
               if cfg.schedule == "dag" and clock is not None else None)

        def phase(k, name, deps, *, policy, kk=None, flops, comm):
            try:
                if dag is not None:
                    # Every dep is the previous stage: the chain resolves
                    # to the engine's sequential path.  A dep that ran on
                    # the direct clock (the gcode round) has no DAG node;
                    # the barrier at the current clock stands in for it.
                    known = tuple(dd for dd in deps if dd in dag.results)
                    return dag.dispatch(scheduler.PhaseSpec(
                        name=name, workers=cfg.num_workers, policy=policy,
                        k=kk, flops_per_worker=flops, comm_units=comm,
                        memory_gb=shard_mem, working_set_gb=shard_ws,
                        deps=known), key=k,
                        sequential=len(known) < len(deps)).mask
                return clock.phase(k, cfg.num_workers, policy=policy, k=kk,
                                   flops_per_worker=flops, comm_units=comm,
                                   memory_gb=shard_mem,
                                   working_set_gb=shard_ws,
                                   phase_name=name)[1]
            except PhaseExhaustedError as e:
                # The retry budget ran out: attempts billed, the dead
                # shards' results never arrive.  Both stages average
                # shard-local quantities, so the finishers' mask drops
                # them (the ignore policy's math, forced by the fleet).
                tel.metrics.counter("giant.exhausted_phases").inc()
                return torch.from_numpy(e.mask)

        # --- stage 1: gradient -------------------------------------------
        if cfg.policy == "ignore" and clock is not None:
            fin = phase(k1, "grad", (), policy="k_of_n",
                        kk=max(1, int(0.95 * cfg.num_workers)),
                        flops=grad_flops, comm=1.0)
        else:
            fin = everyone
            if clock is not None:
                if cfg.policy == "gcode":
                    # The coded gradient round stays on the direct clock;
                    # the next stage launches after it either way.
                    gradient_coding_phase(clock, k1, cfg.num_workers,
                                          cfg.gcode_redundancy,
                                          flops_per_worker=grad_flops)
                else:
                    # All True on a healthy fleet; under an exhausted
                    # fault plan the dead shards drop out of the average.
                    fin = phase(k1, "grad", (), policy="wait_all",
                                flops=grad_flops, comm=1.0)
        weights = fin.to(device=device, dtype=torch.float32) * wts.sum(1)
        g = ((weights[:, None] * local_grads(w)).sum(0)
             / weights.sum().clamp_min(1.0))
        # masked_value includes the regularizer per shard; averaging
        # keeps it.

        # --- stage 2: local second-order directions -----------------------
        if cfg.policy == "ignore" and clock is not None:
            fin2 = phase(k2, "local-newton", ("grad",), policy="k_of_n",
                         kk=max(1, int(0.95 * cfg.num_workers)),
                         flops=newton_flops, comm=1.0)
        else:
            fin2 = everyone
            if clock is not None:
                fin2 = phase(k2, "local-newton", ("grad",),
                             policy="wait_all", flops=newton_flops,
                             comm=1.0)
        fin2f = fin2.to(device=device, dtype=torch.float32)
        p = -((fin2f[:, None] * local_newton(w, g)).sum(0)
              / fin2f.sum().clamp_min(1.0))

        step = 1.0
        if not cfg.unit_step:
            step = float(linesearch.linesearch_strongly_convex(
                objective, data, w, p, g))
            if clock is not None:
                phase(k3, "linesearch", ("local-newton",),
                      policy="wait_all", flops=grad_flops * 6, comm=0.3)
        w = w + step * p

        hist["iter"].append(t)
        hist["fval"].append(float(objective.value(w, data)))
        hist["gnorm"].append(float(torch.linalg.norm(
            objective.gradient(w, data))))
        hist["step"].append(float(step))
        hist["time"].append(clock.time if clock is not None else float(t + 1))
        hist["cost"].append(clock.dollars if clock is not None else 0.0)
        if tel.enabled and dag is not None and dag.results:
            rep = dag.critical_path()
            tel.trace.set_attrs(it_span,
                                critical_path=list(rep.critical_path),
                                dag_makespan=rep.makespan)
        tel.trace.end(it_span,
                      clock.time if clock is not None else float(t + 1))
        if cfg.track_test_error and data.x_test is not None:
            hist["test_error"].append(
                float(objective.error(w, data.x_test, data.y_test)))
        else:
            hist["test_error"].append(float("nan"))
        # Host seconds of the iteration; the float() reads above wait for
        # the device, so this includes its work.
        hist["wall_s"].append(time.perf_counter() - t_wall)
    hist["w"] = w
    tel.trace.end(run_span,
                  clock.time if clock is not None else float(cfg.iters))
    return hist
