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

With ``mesh`` (a ``launch.mesh.Mesh`` whose size is the default
group's world size), the reference's mesh training: the parameters are
DTensors laid out by ``distributed.param_shardings`` (tensor parallel on
"model"), the batch by ``batch_shardings``, the residual stream
redistributed between layers by ``activation_constraint`` (batch over
("pod","data"), sequence over "model"), and AdamW's moments laid out by
``opt_state_shardings`` with ZeRO-1 over "data": each rank updates its
slice of the moments and parameters, then the parameters are gathered
back to their layout.  A checkpoint holds whole-shape tensors (each
rank writes its own boxes of them), so it restores onto another mesh, or
onto no mesh (elastic restore).  The
straggler-resilient path takes ``group`` instead, every rank holding the
whole model, as the reference's replicates its parameters there.
``step_time`` brackets the device work (the device is synchronized
before the clock is read); the reference reads its clock before jax's
asynchronous result arrives.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.distributed import shard_ops
from repro_torch.distributed.collectives import (compressed_resilient_psum,
                                                 resilient_psum)
from repro_torch.distributed.sharding import (activation_constraint,
                                              batch_shardings, coordinates,
                                              distribute, from_local,
                                              opt_state_shardings,
                                              param_boxes, param_shardings,
                                              placements, whole)
from repro_torch.models import common
from repro_torch.models.registry import ModelBundle, ShapeSpec, build
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


@torch.no_grad()
def zero1_apply(ocfg: adamw.AdamWConfig, grads: Pytree,
                opt_state: adamw.AdamWState, params: Pytree,
                gnorm: torch.Tensor) -> adamw.AdamWState:
    """AdamW on DTensor leaves, ZeRO-1: each leaf's gradient and parameter
    taken to its moments' layout (a local slice: the moments only add a
    "data" split to the parameter's layout), ``adamw.apply`` on the local
    slices with the whole gradients' global norm ``gnorm`` (a plain
    tensor), then each updated slice gathered back into its parameter's
    layout, in place.  -> the new state (the moments updated in place)."""
    from torch.distributed.tensor import DTensor
    mus, nus = dict(common.flatten(opt_state.mu)), \
        dict(common.flatten(opt_state.nu))
    local = {"g": [], "p": [], "mu": [], "nu": []}
    for (path, g), (_, p) in zip(common.flatten(grads),
                                 common.flatten(params)):
        m = mus[path]
        local["g"].append((path, g.redistribute(
            m.device_mesh, m.placements).to_local()))
        local["p"].append((path, p.redistribute(
            m.device_mesh, m.placements).to_local()))
        local["mu"].append((path, m.to_local()))
        local["nu"].append((path, nus[path].to_local()))
    tree = {k: common.unflatten(v) for k, v in local.items()}
    new_p, st = adamw.apply(
        ocfg, tree["g"], adamw.AdamWState(opt_state.step, tree["mu"],
                                          tree["nu"]), tree["p"], gnorm)
    updated = dict(common.flatten(new_p))
    for path, p in common.flatten(params):
        m = mus[path]
        whole = DTensor.from_local(updated[path], m.device_mesh,
                                   m.placements, run_check=False,
                                   shape=p.shape, stride=p.stride())
        p.to_local().copy_(whole.redistribute(p.device_mesh,
                                              p.placements).to_local())
    return adamw.AdamWState(st.step, opt_state.mu, opt_state.nu)


class Trainer:
    def __init__(self, cfg: TrainerConfig, device=None, group=None,
                 mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        if mesh is not None and cfg.resilient_grads:
            raise ValueError("resilient_grads takes a group, not a mesh: "
                             "its ranks hold the whole model")
        self.mesh = mesh
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
        self.constrain = None
        if mesh is not None:
            self.device_mesh = mesh.device_mesh(self.device.type)
            self.p_shard = param_shardings(self.bundle, mesh)
            self.b_shard = batch_shardings(self.bundle, mesh, ins)
            self.opt_shard = opt_state_shardings(self.p_shard,
                                                 self.bundle.abstract())
            self.constrain = activation_constraint(
                mesh, cfg.seq_shard_activations)

    def _sharded(self):
        """DTensor's implicit replication of plain tensors (positions,
        masks, constants) while the mesh runs; nothing without one."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()

    # ------------------------------------------------------------ stepping --
    def _loss_and_grads(self, params: nn.Module, batch: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Pytree]:
        """The loss of ``batch`` and its gradient tree in the reference's
        layout (stacked layers), filled in place by the backward pass."""
        self.grad_tree = common.zero_grads(params, self.grad_tree)
        with self._sharded():
            loss = self.bundle.loss(params, batch, self.constrain)
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
        if self.mesh is not None:
            with self._sharded():
                gnorm = whole(adamw.global_norm(grads))
            opt_state = zero1_apply(self.ocfg, grads, opt_state, params.tree,
                                    gnorm)
            return opt_state, {"loss": whole(loss), "grad_norm": gnorm}
        gnorm = adamw.global_norm(grads)
        _, opt_state = adamw.apply(self.ocfg, grads, opt_state, params.tree,
                                   gnorm)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    def init_state(self) -> Tuple[nn.Module, adamw.AdamWState]:
        """The model from PRNGKey(seed) on the trainer's device, trainable,
        and a fresh AdamW state.  On a mesh, each rank draws only its own
        shards (``_sharded_state``)."""
        if self.mesh is not None:
            return self._sharded_state()
        params = self.bundle.init(prng.PRNGKey(self.cfg.seed),
                                  device=self.device)
        params.requires_grad_(True)
        return params, adamw.init(params.tree)

    def _sharded_state(self) -> Tuple[nn.Module, adamw.AdamWState]:
        """The model laid out on the mesh, as the reference's
        ``jax.jit(init, out_shardings=...)`` builds it: this rank's boxes
        of every leaf drawn alone (``bundle.init_local``: the same bits as
        the whole init's, no leaf made whole), each wrapped as its DTensor
        with no communication; and a zero AdamW state in the moments'
        layout (local zeros)."""
        from torch.distributed.tensor import zeros as dzeros
        dm = self.device_mesh
        boxes = param_boxes(self.bundle, self.mesh, coordinates(dm))
        local = dict(common.flatten(self.bundle.init_local(
            prng.PRNGKey(self.cfg.seed), boxes, self.device)))
        shard = dict(common.flatten(self.p_shard))
        dtree = common.unflatten([
            (path, from_local(local[path], shard[path], dm, spec.shape))
            for path, spec in common.flatten(self.bundle.specs())])
        params = build(self.mcfg, dtree)
        params.requires_grad_(True)

        def moments(shardings, dtype=None):
            return common.unflatten([
                (path, dzeros(leaf.shape, dtype=dtype or leaf.dtype,
                              device_mesh=dm,
                              placements=placements(sh.spec, dm)))
                for (path, leaf), (_, sh) in zip(common.flatten(dtree),
                                                 common.flatten(shardings))])
        opt = adamw.AdamWState(step=torch.zeros((), dtype=torch.int32),
                               mu=moments(self.opt_shard.mu),
                               nu=moments(self.opt_shard.nu, torch.float32))
        return params, opt

    def place_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """A whole batch (the same on every rank) laid out by the batch
        shardings; as it is without a mesh."""
        if self.mesh is None:
            return batch
        return {k: distribute(v, self.b_shard[k], self.device_mesh)
                for k, v in batch.items()}

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
            batch = self.place_batch(self.pipeline.device_batch(step))
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
        stacked leaves) -> the restored AdamW state; on a mesh, each leaf
        laid out by this trainer's shardings, whatever mesh saved it."""
        shardings = None
        if self.mesh is not None:
            shardings = {"params": self.p_shard, "opt": self.opt_shard}
        state = self.ckpt.restore(step, {"params": params.tree,
                                         "opt": opt_state}, shardings)
        with torch.no_grad():
            restored = dict(common.flatten(state["params"]))
            for path, leaf in common.flatten(params.tree):
                shard_ops.shard_of(leaf).copy_(
                    shard_ops.shard_of(restored[path]))
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
