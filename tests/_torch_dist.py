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


def distributed_paths(rank: int, world: int, port: int, out: str, case):
    """The three distributed functions of ``case`` (whole inputs, every
    rank slicing its own share; the data rows split evenly for the line
    search) on this rank."""
    from repro_torch.core import coded, linesearch, objectives, sketch
    _join(rank, world, port)
    cs = sketch.CountSketch(h=case["h"], sigma=case["sigma"],
                            block_size=case["block"])
    gram = sketch.distributed_sketched_gram(case["a"], cs, case["surv"])
    code = coded.ProductCode(*case["code"])
    y, ok = coded.distributed_coded_matvec(case["enc_flat"], case["v"],
                                           case["erased"], code,
                                           case["out_rows"])
    per = case["x"].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    f = linesearch.distributed_f_trials(
        objectives.LogisticRegression(lam=1e-3),
        objectives.Dataset(case["x"][rows], case["y"][rows]), case["w"],
        case["p"], case["cand"])
    torch.save({"gram": gram, "y": y, "ok": bool(ok), "f": f},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _float32_smoke():
    """``smoke_config`` at float32 in this worker (a test-side patch, as
    the trainer tests patch it)."""
    import repro_torch.configs as configs
    base = configs.smoke_config
    configs.smoke_config = lambda name: base(name).scaled(dtype="float32")


def mesh_train(rank: int, world: int, port: int, out: str, shape, steps,
               ckpt_dir, ckpt_every, restore: bool):
    """The float32 smoke qwen3-4b trainer on a ("data","model") mesh of
    ``shape`` over all ranks: ``steps`` steps from step 0, checkpoints
    every ``ckpt_every`` into ``ckpt_dir``; with ``restore``, first the
    latest checkpoint (written on any mesh) restored onto this one and
    the run continued from it.  Rank 0 writes the history, and whether
    ``init_state`` built every leaf whole (its global shape) on this rank
    before slicing it, while the leaves it kept are shards (ROADMAP
    Queue 3: the mesh trainer's init holds the whole model on each
    rank)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common
    from repro_torch.training import trainer as tr
    _join(rank, world, port)
    _float32_smoke()
    cfg = tr.TrainerConfig(arch="qwen3-4b", steps=steps, batch=8, seq=64,
                           lr=1e-3, ckpt_dir=ckpt_dir,
                           ckpt_every=ckpt_every)
    t = tr.Trainer(cfg, device="cpu", mesh=make_mesh(shape,
                                                     ("data", "model")))
    built, init = [], t.bundle.init

    def recording_init(*args, **kwargs):
        model = init(*args, **kwargs)
        built.extend(leaf.shape for _, leaf in common.flatten(model.tree))
        return model
    t.bundle.init = recording_init
    params, opt = t.init_state()
    specs = [s.shape for _, s in common.flatten(t.bundle.specs())]
    leaves = [leaf for _, leaf in common.flatten(params.tree)]
    init_whole = [tuple(b) for b in built] == [tuple(s) for s in specs]
    sharded = any(tuple(leaf.to_local().shape) != tuple(leaf.shape)
                  for leaf in leaves)
    start = 0
    if restore:
        start = t.ckpt.latest_step()
        opt = t.restore(start, params, opt)
    _, _, hist = t.run(params, opt, start)
    if rank == 0:
        torch.save({"hist": hist, "init_whole": init_whole,
                    "kept_shards": sharded},
                   os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
