"""Training launcher (the counterpart of ``repro/launch/train.py``).

Runs the trainer end to end on one device: the smoke-scale config by
default, the published architecture with ``--full-config``; the card
unless ``--device cpu``.  Fault-tolerance demo: ``--fail-at N`` injects a
chip failure at step N and the launcher restarts from the latest
checkpoint.  The reference's ``--mesh`` waits for ROADMAP Queue 1 item 12.
Exits 0 iff the last loss is under the first.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --steps 30 --batch 4 --seq 128 --ckpt-dir /tmp/ckpt --fail-at 17 \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.training.trainer import Trainer, TrainerConfig


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
    ap.add_argument("--device", type=str, default=None,
                    help="cpu, or the CUDA device when not given")
    ap.add_argument("--json-out", type=str, default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = TrainerConfig(
        arch=args.arch, smoke=not args.full_config, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resilient_grads=args.resilient_grads)
    trainer = Trainer(cfg, device=device)
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={args.arch} params={trainer.bundle.param_count():,} "
          f"device={device.type} devices={devices}")

    hist = trainer.run_with_restarts(fail_at=args.fail_at)
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
