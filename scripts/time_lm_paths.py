#!/usr/bin/env python3
"""Time qwen3-4b's train and decode steps and mamba2-780m's prefill of one
source tree on one GPU.

    python3 scripts/time_lm_paths.py [--src DIR] [--label NAME]
                                     [--phases train,decode,ssm_prefill]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so that two versions of the port can be timed in one run on one card: run
it once per tree, alternating (A, B, B, A).  Only public entry points
that every version of the port since its training slice has are called:

  train    ``training.trainer.Trainer`` at qwen3-4b's published width from
           PRNGKey(0), ``TrainerConfig(smoke=False, steps=6, batch=4,
           seq=128, lr=1e-3)`` (``chip_smoke.py``'s lm_train setting);
           each step's ``step_time`` (the device synchronized before the
           clock is read), loss and grad norm;
  decode   the bundle's ``prefill`` of 16 x 64 tokens drawn from seed 0,
           then 24 ``decode`` steps at batch 16, each step's wall ms with
           the device synchronized on both sides;
  ssm_prefill
           mamba2-780m at its published width from PRNGKey(0): the
           bundle's ``prefill`` of ``chip_smoke.py``'s lm_families wave
           (16 prompts of 4 to 1,024 tokens from RandomState(0),
           left-padded to the longest, as ``BatchedServer`` pads them),
           once untimed, then SSM_REPS times, each wall ms with the device
           synchronized on both sides, and the state it leaves.

Prints one JSON line for each phase asked for (all three by default),
then the nvidia-smi line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, TRAIN_STEPS, BATCH, SEQ = "qwen3-4b", 6, 4, 128
SERVE_BATCH, PROMPT, DECODE_STEPS = 16, 64, 24
SSM_ARCH, SSM_PROMPT, SSM_REPS = "mamba2-780m", 1024, 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--phases", default="train,decode,ssm_prefill")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_lm_paths: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import prng
    from repro_torch.models import registry
    from repro_torch.training import trainer as tr

    dev = torch.device("cuda")
    if "train" in phases:
        train(tr, args.label, dev)
    if "decode" in phases:
        decode(prng, registry, args.label, dev)
    if "ssm_prefill" in phases:
        ssm_prefill(prng, registry, args.label, dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


def train(tr, label: str, dev) -> None:
    import torch
    t = tr.Trainer(tr.TrainerConfig(arch=ARCH, smoke=False,
                                    steps=TRAIN_STEPS, batch=BATCH, seq=SEQ,
                                    lr=1e-3), device=dev)
    hist = t.run(*t.init_state())[2]
    print(json.dumps({"label": label, "phase": "train",
                      "step_ms": [h["step_time"] * 1e3 for h in hist],
                      "loss": [h["loss"] for h in hist],
                      "grad_norm": [h["grad_norm"] for h in hist]}),
          flush=True)
    del t, hist
    torch.cuda.empty_cache()


def decode(prng, registry, label: str, dev) -> None:
    import torch
    bundle = registry.ModelBundle(registry.get_config(ARCH))
    params = bundle.init(prng.PRNGKey(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, bundle.cfg.vocab_size, (SERVE_BATCH, PROMPT),
                           generator=g, device=dev, dtype=torch.int32)
    cache = bundle.init_cache(SERVE_BATCH, PROMPT + DECODE_STEPS, device=dev)
    logits, cache = bundle.prefill(params, tokens, cache)
    token = logits[:, -1].argmax(-1).to(torch.int32)
    ms = []
    for _ in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bundle.decode(params, cache, token)
        token = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"label": label, "phase": "decode",
                      "batch": SERVE_BATCH, "decode_ms": ms,
                      "last_tokens": token[:4].tolist()}), flush=True)
    del bundle, params, cache
    torch.cuda.empty_cache()


def ssm_prefill(prng, registry, label: str, dev) -> None:
    import numpy as np
    import torch
    bundle = registry.ModelBundle(registry.get_config(SSM_ARCH))
    params = bundle.init(prng.PRNGKey(0), device=dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, bundle.cfg.vocab_size - 1,
                          rs.randint(4, SSM_PROMPT + 1))
               for _ in range(SERVE_BATCH)]
    plen = max(len(p) for p in prompts)
    toks = np.zeros((SERVE_BATCH, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    tokens = torch.from_numpy(toks).to(dev)
    ms = []
    for _ in range(SSM_REPS + 1):
        cache = bundle.init_cache(SERVE_BATCH, SSM_PROMPT + 1, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bundle.prefill(params, tokens, cache)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ssm = cache["layers"]["ssm"].float()
    print(json.dumps({"label": label, "phase": "ssm_prefill",
                      "batch": SERVE_BATCH, "prompt_len": plen,
                      "prefill_ms": ms[1:], "first_ms": ms[0],
                      "state_abs_max": float(ssm.abs().max()),
                      "state_abs_sum": float(ssm.abs().sum()),
                      "last_tokens": logits[:4, -1].argmax(-1).tolist()}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
