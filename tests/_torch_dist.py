"""Worker bodies of the multi-process gloo tests in
``tests/test_torch_trainer.py``, in a module of their own so the spawned
processes import torch and the port only.  Each worker joins a gloo
group at ``tcp://localhost:<port>`` and writes what it computed to
``<out>/rank<r>.pt``."""
import os

import torch
import torch.distributed as dist


def _join(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


def collectives(rank: int, world: int, port: int, out: str, xs, lives):
    """The three collectives of rank's row of each case: xs (n, ...) per
    case, lives (cases, n)."""
    from repro_torch.distributed import collectives as col
    _join(rank, world, port)
    res = []
    for x, live in zip(xs, lives):
        tree = {"a": x[rank].clone(), "b": {"c": 2.0 * x[rank].clone()}}
        res.append({
            "psum": col.resilient_psum(tree, live[rank]),
            "gather": col.masked_allgather_mean(x[rank], live[rank]),
            "int8": col.compressed_resilient_psum(tree, live[rank])})
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def resilient_step(rank: int, world: int, port: int, out: str, live):
    """One resilient_grads trainer step's gradients of the smoke qwen3-4b
    at float32 on this rank's half of the batch, with the given live
    mask: the reduced gradient tree and loss."""
    from repro_torch.configs import smoke_config
    from repro_torch.training import trainer as tr
    _join(rank, world, port)
    tr_cfg = tr.TrainerConfig(arch="qwen3-4b", steps=2, batch=4, seq=32,
                              lr=1e-3, resilient_grads=True)
    import repro_torch.configs as configs
    configs.smoke_config = lambda name: smoke_config(name).scaled(
        dtype="float32")
    t = tr.Trainer(tr_cfg, device="cpu")
    params, opt = t.init_state()
    loss, grads = t.grads(params, t.pipeline.device_batch(0),
                          torch.as_tensor(live))
    from repro_torch.models import common
    torch.save({"grads": dict(common.flatten(grads)), "loss": float(loss)},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
