"""Public entry points of the CUDA kernels and their launch counts.

Each entry point runs its plain version (``ref.py``, or ``prng`` for the
draws) on the CPU and its hand-written CUDA kernel on a CUDA device.
``KERNELS`` maps each kernel's name to its ``CudaKernel``, whose
``launches`` counts the launches made through the entry point.
``INNER`` counts the kernels with no entry point of their own, which run
inside others' launches: the grouped gather of ``count_sketch_apply`` and
the fused count-sketch and SJLT Grams.  ``launch_counts`` reports both.

Profiling hook: ``set_profiler(metrics_registry)`` attaches an
``obs.MetricsRegistry`` to the eight entry points the reference wraps;
each call is then timed on the host clock into a ``kernel.<op>.us``
histogram and a ``kernel.<op>.calls`` counter.  On CUDA tensors the
device is synchronized before and after the call, so queued work is
neither hidden nor charged to it.  With no profiler attached the cost is
one ``is None`` check; the draws (``normal``, ``normal_window`` and the
draw kernel's modes) are not wrapped, as the reference has no such
metric.
"""
from __future__ import annotations

import functools
import time
from typing import Dict

import torch

from repro_torch.kernels import coded_matvec as _cm
from repro_torch.kernels import count_sketch as _cs
from repro_torch.kernels import draw as _draw
from repro_torch.kernels import normal as _normal
from repro_torch.kernels import oversketch_matmul as _og
from repro_torch.kernels import sketch_gram as _sg
from repro_torch.kernels import srht as _srht
from repro_torch.kernels._build import CudaKernel

_PROFILER = None    # obs.MetricsRegistry while attached, else None


def set_profiler(metrics) -> None:
    """Attach (or with None detach) a metrics registry to the wrapped
    entry points; see the module docstring."""
    global _PROFILER
    _PROFILER = metrics


def get_profiler():
    return _PROFILER


def _sync(tensors) -> None:
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def _timed(op: str, fn):
    """``fn`` timed into ``kernel.<op>.*`` while a profiler is attached."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if _PROFILER is None:
            return fn(*args, **kwargs)
        _sync(args)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync((out,))
        _PROFILER.histogram(f"kernel.{op}.us").observe(
            (time.perf_counter() - t0) * 1e6)
        _PROFILER.counter(f"kernel.{op}.calls").inc()
        return out
    return entry


coded_block_matvec = _timed("coded_block_matvec", _cm.coded_block_matvec)
count_sketch_apply = _timed("count_sketch_apply", _cs.count_sketch_apply)
normal = _normal.normal
normal_window = _normal.normal_window
oversketch_gram = _timed("oversketch_gram", _og.oversketch_gram)
sketch_gram_count = _timed("sketch_gram_count", _sg.sketch_gram_count)
sketch_gram_sjlt = _timed("sketch_gram_sjlt", _sg.sketch_gram_sjlt)
sketch_gram_srht = _timed("sketch_gram_srht", _sg.sketch_gram_srht)
fwht = _timed("fwht", _srht.fwht)
fwht_two_pass = _timed("fwht_two_pass", _srht.fwht_two_pass)
bits = _draw.bits
randint = _draw.randint
rademacher = _draw.rademacher
uniform = _draw.uniform
bernoulli = _draw.bernoulli
gumbel = _draw.gumbel
categorical = _draw.categorical

KERNELS: Dict[str, CudaKernel] = {
    k.name: k for k in (_sg.KERNEL, _cs.KERNEL, _og.KERNEL, _cm.KERNEL,
                        _sg.SJLT_KERNEL, _sg.SRHT_KERNEL, _srht.FWHT_KERNEL,
                        _srht.TWO_PASS_KERNEL, _normal.KERNEL,
                        _normal.WINDOW_KERNEL, _draw.KERNEL)}
INNER: Dict[str, _cs.InnerLaunches] = {_cs.GROUPED.name: _cs.GROUPED}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in {**KERNELS, **INNER}.items()}


def reset_launch_counts() -> None:
    for k in (*KERNELS.values(), *INNER.values()):
        k.launches = 0
