"""The LM trainer with the production run's survival kit (the counterpart
of ``repro/training/trainer.py``):

  * the train step: ``loss.backward()`` (gradients added in place into a
    tree of stacked leaves, ``common.zero_grads``), ``adamw.apply`` with
    global-norm clipping, then the metrics;
  * checkpoint/restart: atomic async checkpoints every K steps,
    restore-from-latest, deterministic per-step data (replay-safe);
  * a simulated chip failure -> restart loop (``run_with_restarts``);
  * optional straggler-resilient data-parallel gradients: each rank of
    ``group`` takes its slice of the batch and reduces its gradients with
    the k-of-n mean (``distributed.resilient_psum``, or its int8 form),
    the paper's termination rule applied to data-parallel training.

The reference's ``mesh`` maps to ``group`` (a ``torch.distributed``
process group).  Its tensor- and fully-sharded layouts, activation
sharding and elastic restore onto another mesh wait for ROADMAP Queue 1
item 12: every rank here holds the whole model.  ``step_time`` brackets
the device work (the device is synchronized before the clock is read);
the reference reads its clock before jax's asynchronous result arrives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch import prng, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.straggler import StragglerModel
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.collectives import (compressed_resilient_psum,
                                                 resilient_psum)
from repro_torch.models import common
from repro_torch.models.registry import ModelBundle, ShapeSpec
from repro_torch.optim import adamw

Pytree = Any


class SimulatedFailure(RuntimeError):
    """Injected chip/worker failure (fault-tolerance tests)."""


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    arch: str
    smoke: bool = True
    steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    log_every: int = 10
    seed: int = 0
    lr: float = 3e-4
    warmup_steps: int = 20
    resilient_grads: bool = False
    grad_compression: bool = False   # int8 wire format for the DP reduction
    straggler: Optional[StragglerModel] = None
    seq_shard_activations: bool = True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, cfg: TrainerConfig, device=None, group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        from repro_torch.configs import smoke_config
        from repro_torch.models.registry import get_config
        mcfg = smoke_config(cfg.arch) if cfg.smoke else get_config(cfg.arch)
        self.bundle = ModelBundle(mcfg)
        self.mcfg = mcfg
        self.ocfg = adamw.AdamWConfig(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                                      total_steps=cfg.steps)
        self.ckpt = CheckpointManager(cfg.ckpt_dir) if cfg.ckpt_dir else None
        shape = ShapeSpec("train", "train", cfg.seq, cfg.batch)
        ins = self.bundle.input_specs(shape, reduced=True)
        extra = {k: v for k, v in ins.items()
                 if k in ("frame_embeds", "patch_embeds")}
        self.pipeline = TokenPipeline(
            mcfg.vocab_size, cfg.batch, ins["tokens"].shape[1],
            seed=cfg.seed, device=self.device, extra_specs=extra)
        self.n_workers, self.rank = 1, 0
        if cfg.resilient_grads and (group is not None or
                                    dist.is_initialized()):
            self.n_workers = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        # The gradient tree the backward pass fills (reused between steps).
        self.grad_tree: Optional[Pytree] = None

    # ------------------------------------------------------------ stepping --
    def _loss_and_grads(self, params: nn.Module, batch: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Pytree]:
        """The loss of ``batch`` and its gradient tree in the reference's
        layout (stacked layers), filled in place by the backward pass."""
        self.grad_tree = common.zero_grads(params, self.grad_tree)
        loss = self.bundle.loss(params, batch)
        loss.backward()
        return loss.detach(), self.grad_tree

    def grads(self, params: nn.Module, batch: Dict[str, torch.Tensor],
              live: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Pytree]:
        """(loss, gradient tree) of one step.  With ``resilient_grads``,
        this rank's slice of the batch, its loss and gradients reduced
        over the live ranks (``live``: the (n,) live mask; all live when
        None)."""
        if not self.cfg.resilient_grads:
            return self._loss_and_grads(params, batch)
        n, r = self.n_workers, self.rank
        per = self.cfg.batch // n
        local = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
        loss, grads = self._loss_and_grads(params, local)
        live_r = (torch.ones((), device=self.device) if live is None
                  else torch.as_tensor(live[r]).float().to(self.device))
        reduce_fn = (compressed_resilient_psum
                     if self.cfg.grad_compression else resilient_psum)
        return (resilient_psum(loss, live_r, self.group),
                reduce_fn(grads, live_r, self.group))

    def step(self, params: nn.Module, opt_state: adamw.AdamWState,
             batch: Dict[str, torch.Tensor],
             live: Optional[torch.Tensor] = None
             ) -> Tuple[adamw.AdamWState, Dict[str, torch.Tensor]]:
        """One train step (``grads``, then AdamW), the parameters updated
        in place -> (the new AdamW state, loss and grad norm)."""
        loss, grads = self.grads(params, batch, live)
        gnorm = adamw.global_norm(grads)
        _, opt_state = adamw.apply(self.ocfg, grads, opt_state, params.tree,
                                   gnorm)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    def init_state(self) -> Tuple[nn.Module, adamw.AdamWState]:
        """The model from PRNGKey(seed) on the trainer's device, trainable,
        and a fresh AdamW state."""
        params = self.bundle.init(prng.PRNGKey(self.cfg.seed),
                                  device=self.device)
        params.requires_grad_(True)
        return params, adamw.init(params.tree)

    def _live(self, key: torch.Tensor) -> torch.Tensor:
        """The (n,) live mask of one step: the k = max(1, int(0.9 n))
        fastest workers of the straggler model's draw (all live without
        one)."""
        n = self.n_workers
        if self.cfg.straggler is None:
            return torch.ones((n,), dtype=torch.float32)
        times = self.cfg.straggler.sample_times(key, n)
        kk = max(1, int(0.9 * n))
        return (times <= torch.sort(times).values[kk - 1]).float()

    # -------------------------------------------------------------- running --
    def run(self, params: nn.Module, opt_state: adamw.AdamWState,
            start_step: int = 0, fail_at: Optional[int] = None
            ) -> Tuple[nn.Module, adamw.AdamWState, List[Dict]]:
        cfg = self.cfg
        history: List[Dict] = []
        key = prng.PRNGKey(cfg.seed + 17)
        for step in range(start_step, cfg.steps):
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"chip lost at step {step}")
            batch = self.pipeline.device_batch(step)
            _sync(self.device)
            t0 = time.perf_counter()
            live = None
            if cfg.resilient_grads:
                key, k = prng.split(key)
                live = self._live(k)
            opt_state, metrics = self.step(params, opt_state, batch, live)
            _sync(self.device)
            dt = time.perf_counter() - t0
            history.append({"step": step, "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "step_time": dt})
            if self.ckpt and (step + 1) % cfg.ckpt_every == 0:
                self.ckpt.async_save(step + 1, {"params": params.tree,
                                                "opt": opt_state})
        if self.ckpt:
            self.ckpt.wait()
        return params, opt_state, history

    def restore(self, step: int, params: nn.Module,
                opt_state: adamw.AdamWState) -> adamw.AdamWState:
        """Checkpoint ``step`` into ``params`` (in place, through its
        stacked leaves) -> the restored AdamW state."""
        state = self.ckpt.restore(step, {"params": params.tree,
                                         "opt": opt_state})
        with torch.no_grad():
            restored = dict(common.flatten(state["params"]))
            for path, leaf in common.flatten(params.tree):
                leaf.copy_(restored[path])
        return state["opt"]

    def run_with_restarts(self, fail_at: Optional[int] = None,
                          max_restarts: int = 3) -> List[Dict]:
        """Checkpoint-restart loop: a failure resumes from the latest
        checkpoint (or step 0), replaying deterministic data."""
        params, opt_state = self.init_state()
        all_hist: List[Dict] = []
        start, restarts = 0, 0
        while True:
            try:
                params, opt_state, hist = self.run(params, opt_state, start,
                                                   fail_at=fail_at)
                all_hist.extend(hist)
                return all_hist
            except SimulatedFailure:
                restarts += 1
                if restarts > max_restarts:
                    raise
                fail_at = None   # don't re-fail
                if self.ckpt:
                    self.ckpt.wait()     # the save in flight lands first
                latest = self.ckpt.latest_step() if self.ckpt else None
                if latest is not None:
                    opt_state = self.restore(latest, params, opt_state)
                    start = latest
                else:
                    params, opt_state = self.init_state()
                    start = 0
