"""Training launcher (the counterpart of ``repro/launch/train.py``).

Runs the trainer end to end: the smoke-scale config by default, the
published architecture with ``--full-config``; the card unless ``--device
cpu``.  Fault-tolerance demo: ``--fail-at N`` injects a chip failure at
step N and the launcher restarts from the latest checkpoint.  ``--mesh
2x4`` trains on a ("data", "model") mesh, ``--mesh 2x2x2`` on ("pod",
"data", "model"), over the default process group: started by
``torchrun --nproc-per-node N`` (gloo on the CPU, NCCL on the card), or
a one-rank group of its own for a mesh of size 1.  Exits 0 iff the last
loss is under the first.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --steps 30 --batch 4 --seq 128 --ckpt-dir /tmp/ckpt --fail-at 17 \\
      [--device cpu] [--mesh 1x1]
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --mesh 4x2 --batch 8 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.training.trainer import Trainer, TrainerConfig


def parse_mesh(text: str):
    """"2x4" -> a ("data", "model") mesh; three dims -> ("pod", "data",
    "model")."""
    dims = tuple(int(x) for x in text.split("x"))
    axes = ("data", "model")[:len(dims)] if len(dims) <= 2 else \
        ("pod", "data", "model")
    return make_mesh(dims, axes)


def _join_group(mesh, device: torch.device) -> bool:
    """Join the default process group the mesh runs on -> whether this
    call created it.  Under torchrun its environment names the group; a
    mesh of one rank gets a group of its own on a file store."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    elif mesh.size == 1:
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    else:
        raise SystemExit(f"--mesh of {mesh.size} ranks: start with "
                         f"torchrun --nproc-per-node {mesh.size}")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen3-4b")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture (default: smoke scale)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated chip failure at this step")
    ap.add_argument("--resilient-grads", action="store_true",
                    help="straggler-resilient k-of-n gradient reduction")
    ap.add_argument("--mesh", type=str, default=None,
                    help='e.g. "2x4" => ("data","model") mesh')
    ap.add_argument("--device", type=str, default=None,
                    help="cpu, or the CUDA device when not given")
    ap.add_argument("--json-out", type=str, default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = parse_mesh(args.mesh) if args.mesh else None
    own_group = mesh is not None and _join_group(mesh, device)
    cfg = TrainerConfig(
        arch=args.arch, smoke=not args.full_config, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resilient_grads=args.resilient_grads)
    trainer = Trainer(cfg, device=device, mesh=mesh)
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    where = f" mesh={mesh.shape}" if mesh is not None else ""
    print(f"arch={args.arch} params={trainer.bundle.param_count():,} "
          f"device={device.type} devices={devices}{where}")

    hist = trainer.run_with_restarts(fail_at=args.fail_at)
    if own_group:
        dist.destroy_process_group()
    for rec in hist:
        if rec["step"] % max(1, cfg.log_every) == 0 or \
                rec["step"] == cfg.steps - 1:
            print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.3f} {rec['step_time']*1e3:.0f}ms")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(hist, f, indent=1)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} over {len(hist)} logged steps")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
