"""First-order baselines of the paper's experiments (Sec. 5.4): gradient
descent, Nesterov accelerated gradient and mini-batch SGD, each with a
straggler policy and the same simulated wall clock as OverSketched Newton,
so convergence-against-time plots compare directly (Fig. 11); port of
``repro/optim/first_order.py``.

Straggler policies for the gradient phase:
  wait_all - uncoded, wait for every worker;
  ignore   - mini-batch gradient: drop the stragglers' shards (Fig. 5c);
  gcode    - gradient coding (Tandon et al.): the exact gradient from any
             W - (r - 1) workers at r-fold replication (Fig. 5b),
             ``optim.gradient_coding``.

The tensors live on the entry point's device (CUDA unless the caller
passes ``device="cpu"``); the fleet stays on the host.  sgd's batch is
``prng.permutation(kb, n)[:nb]``, jax's ``choice(..., replace=False)``,
whose sort keys the draw kernel draws on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch import prng, resolve_device
from repro_torch.core import straggler
from repro_torch.core.objectives import Dataset
from repro_torch.optim.gradient_coding import gradient_coding_phase


@dataclasses.dataclass(frozen=True)
class FirstOrderConfig:
    iters: int = 100
    lr: float = 1.0
    method: str = "gd"              # gd | nag | sgd
    policy: str = "ignore"          # wait_all | ignore | gcode
    num_workers: int = 60
    gcode_redundancy: int = 2       # r: data repeated r times per worker
    momentum: float = 0.9           # NAG
    batch_fraction: float = 0.2     # sgd
    backtracking: bool = True       # backtracking line search (Fig. 11 setup)
    bt_shrink: float = 0.5
    bt_c: float = 1e-4
    bt_max: int = 20
    seed: int = 0
    track_test_error: bool = False


def _worker_shards(n: int, w: int, device=None) -> torch.Tensor:
    """Row -> worker assignment, contiguous shards."""
    per = -(-n // w)
    return torch.clamp(torch.arange(n, device=device) // per, max=w - 1)


def _masked_gradient(objective, data: Dataset, w_vec: torch.Tensor,
                     shard_of_row: torch.Tensor,
                     finished: torch.Tensor) -> torch.Tensor:
    """Mean gradient over the rows owned by finished workers (mini-batch /
    ignore-stragglers scheme), regularizer included: autograd of the
    objective's ``masked_value``."""
    row_ok = finished.to(shard_of_row.device)[shard_of_row]
    return torch.func.grad(
        lambda wv: objective.masked_value(wv, data, row_ok))(w_vec)


def _backtrack(objective, data: Dataset, w: torch.Tensor, g: torch.Tensor,
               direction: torch.Tensor, cfg: FirstOrderConfig) -> float:
    f0 = objective.value(w, data)
    gtd = g @ direction
    t = cfg.lr
    for _ in range(cfg.bt_max):
        if float(objective.value(w + t * direction, data)) <= \
                float(f0 + cfg.bt_c * t * gtd):
            return t
        t *= cfg.bt_shrink
    return t


def first_order(objective, data: Dataset, w0, cfg: FirstOrderConfig,
                model: Optional[straggler.StragglerModel] = straggler.StragglerModel(),
                device=None) -> Dict[str, List[float]]:
    """Run the configured method; returns the per-iteration log (``iter``,
    ``fval``, ``gnorm``, ``step``, simulated ``time`` and ``cost``,
    ``test_error`` and the port's own ``wall_s``, host seconds per
    iteration) with the final iterate under ``"w"``.  ``model`` is a
    ``StragglerModel``, a prebuilt ``SimClock`` or None (no fleet)."""
    device = resolve_device(device)
    data = Dataset(*(None if t is None else t.to(device) for t in data))
    key = prng.PRNGKey(cfg.seed)
    if isinstance(model, straggler.SimClock):
        clock, model = model, model.model
    else:
        clock = straggler.SimClock(model) if model is not None else None
    n = data.x.shape[0]
    shard_of_row = _worker_shards(n, cfg.num_workers, device)

    hist: Dict[str, List[float]] = {k: [] for k in (
        "iter", "fval", "gnorm", "step", "time", "cost", "test_error",
        "wall_s")}
    w = torch.as_tensor(w0, dtype=torch.float32).to(device)
    velocity = torch.zeros_like(w)
    d = data.x.shape[1]
    grad_flops = 2.0 * (n / cfg.num_workers) * d

    for t in range(cfg.iters):
        t_wall = time.perf_counter()
        key, kp, kb = prng.split(key, 3)
        # Gradient evaluation point (NAG looks ahead).
        w_eval = w + cfg.momentum * velocity if cfg.method == "nag" else w

        if cfg.method == "sgd":
            nb = max(1, int(cfg.batch_fraction * n))
            idx = prng.permutation(kb, n, device=device)[:nb]
            g = objective.gradient(w_eval, Dataset(x=data.x[idx],
                                                   y=data.y[idx]))
            if clock is not None:
                clock.phase(kp, cfg.num_workers, policy="wait_all",
                            flops_per_worker=grad_flops * cfg.batch_fraction,
                            comm_units=0.5)
        elif cfg.policy == "wait_all" or model is None:
            g = objective.gradient(w_eval, data)
            if clock is not None:
                clock.phase(kp, cfg.num_workers, policy="wait_all",
                            flops_per_worker=grad_flops, comm_units=1.0)
        elif cfg.policy == "ignore":
            _, finished = clock.phase(
                kp, cfg.num_workers, policy="k_of_n",
                k=max(1, int(0.95 * cfg.num_workers)),
                flops_per_worker=grad_flops, comm_units=1.0)
            g = _masked_gradient(objective, data, w_eval, shard_of_row,
                                 finished)
        elif cfg.policy == "gcode":
            g = objective.gradient(w_eval, data)   # decoded exactly
            gradient_coding_phase(clock, kp, cfg.num_workers,
                                  cfg.gcode_redundancy,
                                  flops_per_worker=grad_flops)
        else:
            raise ValueError(cfg.policy)

        if cfg.backtracking:
            step = _backtrack(objective, data, w_eval, g, -g, cfg)
            if clock is not None:   # line search costs a round (Fig. 11)
                clock.phase(prng.fold_in(kp, 3), cfg.num_workers,
                            policy="wait_all",
                            flops_per_worker=grad_flops * 3, comm_units=0.3)
        else:
            step = cfg.lr

        if cfg.method == "nag":
            velocity = cfg.momentum * velocity - step * g
            w = w + velocity
        else:
            w = w - step * g

        hist["iter"].append(t)
        hist["fval"].append(float(objective.value(w, data)))
        hist["gnorm"].append(float(torch.linalg.norm(
            objective.gradient(w, data))))
        hist["step"].append(float(step))
        hist["time"].append(clock.time if clock is not None else float(t + 1))
        hist["cost"].append(clock.dollars if clock is not None else 0.0)
        if cfg.track_test_error and data.x_test is not None:
            hist["test_error"].append(
                float(objective.error(w, data.x_test, data.y_test)))
        else:
            hist["test_error"].append(float("nan"))
        # Host seconds of the iteration; the float() reads above wait for
        # the device, so this includes its work.
        hist["wall_s"].append(time.perf_counter() - t_wall)
    hist["w"] = w
    return hist
