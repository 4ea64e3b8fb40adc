"""End-to-end training on the torch port (the counterpart of
``examples/train_lm.py``): train a reduced qwen3-family LM for a few
hundred steps with the production code path (AdamW, the deterministic
data pipeline, async checkpoints) and a mid-run simulated chip failure
with automatic restart, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \\
      [--device cpu]
"""
import argparse
import tempfile

from repro_torch import resolve_device
from repro_torch.training.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", type=str, default="qwen3-4b")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cpu, or the CUDA device when not given")
    args = ap.parse_args()

    device = resolve_device(args.device)
    ckpt_dir = tempfile.mkdtemp(prefix="repro-torch-lm-")
    cfg = TrainerConfig(
        arch=args.arch, smoke=True, steps=args.steps, batch=8, seq=128,
        lr=1e-3, warmup_steps=20, ckpt_dir=ckpt_dir, ckpt_every=50)
    trainer = Trainer(cfg, device=device)
    print(f"arch={args.arch} (reduced) params={trainer.bundle.param_count():,}"
          f" ckpt={ckpt_dir} device={device.type}")

    fail_at = args.fail_at if args.fail_at is not None else args.steps // 2
    hist = trainer.run_with_restarts(fail_at=fail_at)
    for rec in hist[:: max(1, len(hist) // 20)]:
        print(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
              f"gnorm {rec['grad_norm']:.3f}")
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(from {hist[0]['loss']:.4f}; survived a simulated failure at "
          f"step {fail_at})")


if __name__ == "__main__":
    main()
