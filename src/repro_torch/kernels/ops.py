"""Public entry points of the CUDA kernels and their launch counts.

Each entry point runs its plain version (``ref.py``, or ``prng`` for the
draws) on the CPU and its hand-written CUDA kernel on a CUDA device.
``KERNELS`` maps each kernel's name to its ``CudaKernel``, whose
``launches`` counts the launches made through the entry point.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import coded_matvec as _cm
from repro_torch.kernels import count_sketch as _cs
from repro_torch.kernels import draw as _draw
from repro_torch.kernels import normal as _normal
from repro_torch.kernels import oversketch_matmul as _og
from repro_torch.kernels import sketch_gram as _sg
from repro_torch.kernels import srht as _srht
from repro_torch.kernels._build import CudaKernel

coded_block_matvec = _cm.coded_block_matvec
count_sketch_apply = _cs.count_sketch_apply
normal = _normal.normal
oversketch_gram = _og.oversketch_gram
sketch_gram_count = _sg.sketch_gram_count
sketch_gram_sjlt = _sg.sketch_gram_sjlt
sketch_gram_srht = _sg.sketch_gram_srht
fwht = _srht.fwht
fwht_two_pass = _srht.fwht_two_pass
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
                        _draw.KERNEL)}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
