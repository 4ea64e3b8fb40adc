"""Serving example on the torch port: batched prefill + greedy decode in
waves, the same run as examples/serve_lm.py (same weights, same prompts).

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import prng, resolve_device
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import BatchedServer
from repro_torch.models.registry import ModelBundle

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cpu, or the CUDA device")
device = resolve_device(ap.parse_args().device)

cfg = smoke_config("qwen3-4b")
bundle = ModelBundle(cfg)
params = bundle.init(prng.PRNGKey(0), device=device)

rs = np.random.RandomState(0)
prompts = [rs.randint(1, cfg.vocab_size - 1, rs.randint(4, 16))
           for _ in range(10)]

server = BatchedServer(bundle, params, batch=4, max_seq=128)
outs = server.generate(prompts, max_new=12)
for i, (p, o) in enumerate(zip(prompts, outs)):
    print(f"req{i}: prompt_len={len(p)} -> {o}")
