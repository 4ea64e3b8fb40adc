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
    the run continued from it.  Every rank writes ``init<rank>.pt``: the
    shapes of the leaves ``init_state`` drew on it (through
    ``bundle.init_local``) beside their local shapes under the policy,
    and whether each shard equals its slice of the unsharded init, bit
    for bit; rank 0 also writes the history.  Every rank writes
    ``save<rank>.pt`` (``_audit_saves``)."""
    from repro_torch import prng
    from repro_torch.distributed.sharding import local_shape
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
    built, init_local = [], t.bundle.init_local

    def recording_init(*args, **kwargs):
        tree = init_local(*args, **kwargs)
        built.extend(tuple(leaf.shape) for _, leaf in common.flatten(tree))
        return tree
    t.bundle.init_local = recording_init
    audit = _audit_saves(t.ckpt, rank, os.path.join(out, "plain"))
    params, opt = t.init_state()
    shard = dict(common.flatten(t.p_shard))
    want = [local_shape(s.shape, shard[path].spec, t.mesh)
            for path, s in common.flatten(t.bundle.specs())]
    whole = dict(common.flatten(t.bundle.init(prng.PRNGKey(cfg.seed),
                                              device="cpu").tree))
    equal = []
    for path, leaf in common.flatten(params.tree):
        full = whole[path].detach()
        for dim, (start, size) in enumerate(_box(leaf)):
            full = full.narrow(dim, start, size)
        local = leaf.to_local().detach()
        equal.append(torch.equal(local.view(torch.int32),
                                 full.contiguous().view(torch.int32)))
    torch.save({"built": built, "local_shapes": want, "equal": equal},
               os.path.join(out, f"init{rank}.pt"))
    start = 0
    if restore:
        start = t.ckpt.latest_step()
        opt = t.restore(start, params, opt)
    _, _, hist = t.run(params, opt, start)
    torch.save(audit, os.path.join(out, f"save{rank}.pt"))
    if rank == 0:
        torch.save({"hist": hist}, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _audit_saves(ckpt, rank: int, plain_dir: str) -> dict:
    """Wraps the trainer's checkpoint manager: counts the
    ``DTensor.full_tensor`` calls made inside its ``save``,
    ``async_save`` and ``wait`` (``full_tensor``), and records each async
    snapshot's host bytes (``snapshot_bytes``) beside the rank's local
    shard bytes (``shard_bytes``) and the state's whole bytes
    (``whole_bytes``); after each ``async_save``, the same state is
    gathered whole outside the manager and saved unsharded by rank 0
    into ``plain_dir``.  -> the record, filled as the run goes."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as cm
    from repro_torch.distributed.sharding import whole
    audit = {"full_tensor": 0, "snapshot_bytes": [], "shard_bytes": [],
             "whole_bytes": [], "steps": []}
    inside = [False]
    full_tensor = DTensor.full_tensor

    def counted(self, *args, **kwargs):
        audit["full_tensor"] += inside[0]
        return full_tensor(self, *args, **kwargs)
    DTensor.full_tensor = counted
    snapshot = cm._snapshot

    def recorded(parts):
        host = snapshot(parts)
        audit["snapshot_bytes"].append(sum(
            p[0].numel() * p[0].element_size() for p in host
            if p is not None))
        return host
    cm._snapshot = recorded

    def audited(method):
        def call(*args, **kwargs):
            inside[0] = True
            try:
                return method(*args, **kwargs)
            finally:
                inside[0] = False
        return call
    async_save = audited(ckpt.async_save)

    def audited_async(step, state):
        async_save(step, state)
        leaves = [leaf for _, leaf in cm._flatten_with_names(state)]
        audit["steps"].append(step)
        audit["shard_bytes"].append(sum(
            getattr(t, "to_local", lambda t=t: t)().numel() *
            t.element_size() for t in leaves))
        audit["whole_bytes"].append(sum(t.numel() * t.element_size()
                                        for t in leaves))
        gathered = cm._unflatten_like(state, {
            name: whole(leaf).detach().clone()
            for name, leaf in cm._flatten_with_names(state)})
        if rank == 0:
            CheckpointManager(plain_dir).save(step, gathered)
    ckpt.async_save = audited_async
    ckpt.save = audited(ckpt.save)
    ckpt.wait = audited(ckpt.wait)
    return audit


def _box(dtensor):
    """A DTensor's local (start, size) a dim."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        dtensor.shape, dtensor.device_mesh, dtensor.placements)
    return list(zip(offset, shape))


def shard_ops_cases(rank: int, world: int, port: int, out: str):
    """``shard_ops.decode_attention`` (the cache split by kv heads, by its
    sequence over "model", and over both mesh dims as a long-context
    cache is; the plain decode and the ring buffer's),
    ``shard_ops.ssd_scan``, ``ssd_readout`` and ``split_matmul`` (forward
    and gradients) on a 2 x 2 ("data", "model") mesh of float32
    DTensors against the plain functions on the whole inputs: the
    largest gap of each, relative to max |plain|."""
    import numpy as np
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import shard_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, ssd, transformer
    _join(rank, world, port)
    dm = make_mesh((2, 2), ("data", "model")).device_mesh("cpu")
    rng = np.random.default_rng(0)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def put(t, *pl):
        return distribute_tensor(t, dm, list(pl), src_data_rank=None)

    def gap(got, want):
        return float((got.full_tensor() - want).abs().max() /
                     want.abs().max())
    r, s0, s1, s2 = Replicate(), Shard(0), Shard(1), Shard(2)
    gaps = {}
    q, k, v = arr(4, 1, 4, 8), arr(4, 16, 2, 8), arr(4, 16, 2, 8)
    layouts = {"kv_heads": ((s0, s2), (s0, s2)),
               "sequence": ((s0, s1), (s0, r)),
               "long_context": ((s1, s1), (r, r))}
    for name, (kv_pl, q_pl) in layouts.items():
        for pos, window, cap in ((9, 0, 0.0), (5, 0, 0.0), (12, 4, 5.0)):
            want = attention.decode_attention(q, k, v, pos, window=window,
                                              softcap=cap)
            got = attention.decode_attention(
                put(q, *q_pl), put(k, *kv_pl), put(v, *kv_pl), pos,
                window=window, softcap=cap)
            gaps[f"decode/{name}/{pos}/{window}"] = gap(got, want)
        want = transformer._ring_decode_attn(q, k, v, 11, softcap=3.0)
        got = transformer._ring_decode_attn(put(q, *q_pl), put(k, *kv_pl),
                                            put(v, *kv_pl), 11, softcap=3.0)
        gaps[f"ring/{name}"] = gap(got, want)
    xh, dt, bm, cm = arr(4, 32, 4, 8), arr(4, 32, 4).abs(), arr(4, 32, 16), \
        arr(4, 32, 16)
    a, skip = -arr(4).abs(), arr(4)
    want, _ = ssd._chunked_scan(xh, dt, a, bm, cm, skip, 8)
    got, _ = shard_ops.ssd_scan(ssd._chunked_scan, put(xh, s0, s2),
                                put(dt, s0, s2), put(a, r, s0),
                                put(bm, s0, r), put(cm, s0, r),
                                put(skip, r, s0), 8)
    gaps["ssd_scan"] = gap(got, want)
    # the final state after 27 of the 32 positions (a right padding)
    _, want_last = ssd._chunked_scan(xh, dt, a, bm, cm, skip, 8, 27)
    _, last = shard_ops.ssd_scan(ssd._chunked_scan, put(xh, s0, s2),
                                 put(dt, s0, s2), put(a, r, s0),
                                 put(bm, s0, r), put(cm, s0, r),
                                 put(skip, r, s0), 8, 27)
    gaps["ssd_scan_state"] = gap(last, want_last)
    gaps["ssd_scan_state_layout"] = [getattr(p, "dim", None)
                                     for p in last.placements]
    st, c = arr(4, 4, 8, 16), arr(4, 16)
    gaps["ssd_readout"] = gap(
        shard_ops.ssd_readout(put(st, s0, s2), put(c, s0, r)),
        torch.einsum("bhpn,bn->bhp", st, c))
    x, w, g = arr(4, 6, 8), arr(8, 6), arr(4, 6, 6)
    xd = put(x, s0, s2).requires_grad_()
    wd = put(w, r, s0).requires_grad_()
    y = shard_ops.split_matmul(xd, wd)
    (y.full_tensor() * g).sum().backward()
    gaps["split_matmul"] = gap(y, x @ w)
    gaps["split_matmul_dx"] = gap(xd.grad, g @ w.T)
    gaps["split_matmul_dw"] = gap(wd.grad, x.reshape(-1, 8).T @
                                  g.reshape(-1, 6))
    gaps["ssd_scan_layout"] = [getattr(p, "dim", None)
                               for p in got.placements]
    gaps.update(_whisper_loss_on_mesh())
    if rank == 0:
        torch.save(gaps, os.path.join(out, "rank0.pt"))
    dist.destroy_process_group()


def _whisper_loss_on_mesh() -> dict:
    """whisper-large-v3's smoke train loss and gradients at float32 on a
    2 x 2 ("data", "model") mesh (the trainer's shards, batch layout and
    activation constraint) against the unsharded trainer's on the same
    batch: the loss's gap relative to it, the gradients' largest gap
    relative to the tree's largest entry, and whether the first decoder
    layer's input held a pending sum (``Partial``), which some torch
    releases (2.11) refuse to add a bias to."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common, encdec
    from repro_torch.training import trainer as tr
    _float32_smoke()
    cfg = tr.TrainerConfig(arch="whisper-large-v3", steps=1, batch=4,
                           seq=32)
    plain = tr.Trainer(cfg, device="cpu")
    params, _ = plain.init_state()
    batch = plain.pipeline.device_batch(0)
    want_loss, want = plain.grads(params, batch)
    want = {k: v.clone() for k, v in common.flatten(want)}
    t = tr.Trainer(cfg, device="cpu",
                   mesh=make_mesh((2, 2), ("data", "model")))
    params, _ = t.init_state()
    first_input = []
    layer = encdec._decoder_layer

    def recording(cfg, lp, h, memory, constrain):
        if not first_input:
            first_input.extend(h.placements)
        return layer(cfg, lp, h, memory, constrain)
    encdec._decoder_layer = recording
    try:
        loss, grads = t.grads(params, t.place_batch(batch))
    finally:
        encdec._decoder_layer = layer
    got = {k: v.full_tensor() for k, v in common.flatten(grads)}
    top = max(float(g.abs().max()) for g in want.values())
    return {"whisper_loss": abs(float(loss.full_tensor()) -
                                float(want_loss)) / abs(float(want_loss)),
            "whisper_grads": max(float((got[k] - want[k]).abs().max())
                                 for k in want) / top,
            "whisper_first_layer_input": [str(p) for p in first_input],
            "whisper_partial": any(p.is_partial() for p in first_input)}
