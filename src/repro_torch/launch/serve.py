"""Batched serving driver (the counterpart of ``repro/launch/serve.py``):
prefill + greedy decode over waves of ``batch`` prompts.

The reference's semantics: each wave's prompts are left-padded with token
0 to the wave's longest prompt; the pads are attended, and positions
count from 0 over the padded prompt; one position for the whole batch;
greedy argmax; a slot stops after it emits ``eos_id``.  Decode runs
eagerly (no CUDA graphs, no ``torch.compile``), without autograd.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --requests 8 --batch 4 --max-new 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.models.registry import ModelBundle


class BatchedServer:
    """Slot-based batching over a fixed decode batch, on the device of the
    model's parameters."""

    def __init__(self, bundle: ModelBundle, params, batch: int,
                 max_seq: int, eos_id: int = 2):
        self.bundle = bundle
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = params.embed.device

    @torch.no_grad()
    def generate(self, prompts: List[np.ndarray], max_new: int
                 ) -> List[List[int]]:
        """Greedy-decode every prompt; prompts are padded to a common length
        per prefill wave, then decoded together."""
        out: List[List[int]] = [[] for _ in prompts]
        for wave_start in range(0, len(prompts), self.batch):
            wave = prompts[wave_start:wave_start + self.batch]
            plen = max(len(p) for p in wave)
            toks = np.zeros((self.batch, plen), np.int32)
            for i, p in enumerate(wave):
                toks[i, plen - len(p):] = p       # left-pad
            cache = self.bundle.init_cache(self.batch, self.max_seq,
                                           device=self.device)
            logits, cache = self.bundle.prefill(
                self.params, torch.from_numpy(toks).to(self.device), cache)
            tok = logits[:, -1].argmax(dim=-1)
            done = np.zeros(self.batch, bool)
            for _ in range(max_new):
                host = tok.tolist()
                for i in range(len(wave)):
                    if not done[i]:
                        out[wave_start + i].append(host[i])
                        if host[i] == self.eos_id:
                            done[i] = True
                if done[:len(wave)].all():
                    break
                logits, cache = self.bundle.decode(self.params, cache, tok)
                tok = logits.argmax(dim=-1)
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", type=str, default=None,
                    help="cpu, or the CUDA device when not given")
    args = ap.parse_args(argv)

    from repro_torch.configs import smoke_config
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    bundle = ModelBundle(cfg)
    params = bundle.init(prng.PRNGKey(0), device=device)

    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, cfg.vocab_size - 1,
                          rs.randint(4, args.prompt_len + 1))
               for _ in range(args.requests)]
    server = BatchedServer(bundle, params, args.batch, args.max_seq)
    t0 = time.perf_counter()
    outs = server.generate(prompts, args.max_new)
    dt = time.perf_counter() - t0
    total_new = sum(len(o) for o in outs)
    print(f"served {len(prompts)} requests, {total_new} new tokens "
          f"in {dt:.2f}s ({total_new/dt:.1f} tok/s on {device.type})")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: prompt[{len(prompts[i])}] -> {o[:12]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
