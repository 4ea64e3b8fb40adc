"""Token pipeline for LM training (the counterpart of
``repro/data/pipeline.py``).

A deterministic synthetic corpus (a seeded per-step ``RandomState`` over
a Zipfian token distribution with induced local structure, so the loss
falls), copied line for line from the reference so every batch is the
same bits; host-side prefetch; ``device_batch`` puts a batch on the
trainer's device.  The determinism-by-step contract (step -> batch,
independent of world size) is what a restart needs to replay the data.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq: int, *,
                 seed: int = 0, device=None,
                 extra_specs: Optional[Dict] = None, prefetch: int = 2):
        """``extra_specs``: name -> anything with a ``.shape`` (the
        bundle's meta tensors) for the frame or patch embeddings; they are
        drawn in float32.  ``device``: where ``device_batch`` puts a
        batch (the CPU when None)."""
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = torch.device(device or "cpu")
        self.extra_specs = extra_specs or {}
        self.prefetch = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ batches --
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a step (restart/elastic-safe)."""
        rs = np.random.RandomState(self.seed * 1_000_003 + step)
        # Zipf-ish marginal + markov-ish structure: next token is previous
        # token + small delta half the time.
        base = rs.zipf(1.5, size=(self.batch, self.seq))
        base = np.minimum(base, self.vocab_size - 2).astype(np.int32)
        shift = np.roll(base, 1, axis=1)
        mix = rs.rand(self.batch, self.seq) < 0.5
        tokens = np.where(mix, np.minimum(shift + 1, self.vocab_size - 1),
                          base)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        out = {"tokens": tokens, "labels": labels}
        for name, spec in self.extra_specs.items():
            out[name] = rs.randn(*spec.shape).astype(np.float32) * 0.02
        return out

    def device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {name: torch.from_numpy(arr).to(self.device)
                for name, arr in self.batch_at(step).items()}

    # ----------------------------------------------------------- prefetch --
    def start(self, first_step: int) -> None:
        def worker():
            step = first_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, self.device_batch(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        return self._q.get()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
