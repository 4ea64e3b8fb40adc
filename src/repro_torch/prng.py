"""jax-compatible counter-based keys and draws, on torch tensors.

The reference draws every sketch, survivor mask and fleet coin flip from
``jax.random`` threefry keys.  This module reproduces that surface so the
same seed gives the same draws in both packages:

  PRNGKey, split, fold_in, key_data          key algebra
  uniform, bernoulli, rademacher, randint,   draws
  normal_plain, normal_bf16_plain,
  normal_window, choice,
  gumbel, categorical, permutation
  one_hot                                    jax.nn.one_hot

The generator is threefry2x32 (20 rounds) in the layout jax uses when
``jax_threefry_partitionable`` is on (the default since jax 0.5): element
``i`` of a draw of any shape hashes the 64-bit counter ``i`` (row-major
flat index) split into two 32-bit words, and a 32-bit draw is the XOR of
the two output words.  ``split(key, n)[i]`` and ``fold_in(key, x)`` hash
the counters ``(0, i)`` and ``(0, x)``.

A key is an int64 tensor of shape ``(2,)`` holding the two uint32 words;
a batch of keys has shape ``(n, 2)``.  Keys live on the CPU.  Draws run
on the ``device`` they are given (the CUDA device when none is given,
``resolve_device``), on int64 tensors masked to 32 bits, and are
counter-based: ``bits[i]`` depends only on ``(key, i)``, so large
draws are made in chunks of ``CHUNK`` elements and never hold int64
temporaries for the whole shape.  These are the plain versions: the
port's draws on the card go through ``kernels.ops`` (``randint``,
``rademacher``, ``uniform``, ``bernoulli``, ``normal``, and ``gumbel``
and ``categorical`` on the uniform draw), whose CUDA kernels compute the
same bits and which take these on the CPU.

Every draw is bit-exact against jax on the CPU.  ``normal_plain`` is
``sqrt(2) * erfinv(u)`` with XLA's float32 erfinv polynomial, its Horner
steps fused as XLA fuses them, and the ``log1p`` inside it is XLA's CPU
lowering (``log1p_f32``: a Cephes rational below sqrt(2) - 1, else
``log_f32(1 + x)``, the Cephes float32 log XLA emits), in the same
float32 operations and multiply-add contractions.  ``exp_f32`` is XLA's
CPU float32 exp in the same manner; the fleet's lognormal factor takes it.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK = 1 << 24            # elements per chunk of a large draw

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.reshape(-1).tolist()
    if len(k) != 2:
        raise ValueError(f"a key has two uint32 words, got shape {tuple(key.shape)}")
    return int(k[0]) & M32, int(k[1]) & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _threefry2x32(k0: int, k1: int, x0, x1):
    """threefry2x32 with 20 rounds on int64 tensors (or numpy arrays)
    holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _hash_counters(key: torch.Tensor, start: int, count: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    k0, k1 = _words(key)
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    return _threefry2x32(k0, k1, i >> 32, i & M32)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & M32], dtype=torch.int64)


def _key_hash(key: torch.Tensor, x1: np.ndarray) -> torch.Tensor:
    """The keys threefry(key, (0, x1[i])), shape (len(x1), 2).  Hashed in
    numpy on the host: a key op is a few words, and numpy's per-operation
    cost is a fraction of torch's."""
    k0, k1 = _words(key)
    y0, y1 = _threefry2x32(k0, k1, np.zeros_like(x1), x1)
    return torch.from_numpy(np.stack([y0, y1], axis=1))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys, key i = threefry(key, (0, i))."""
    return _key_hash(key, np.arange(int(num), dtype=np.int64))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry(key, (0, data)) for uint32 data."""
    return _key_hash(key, np.array([int(data) & M32], dtype=np.int64))[0]


def key_data(key: torch.Tensor) -> np.ndarray:
    """The key's raw uint32 words (``jax.random.key_data``)."""
    return np.asarray(key.cpu().numpy() & M32, dtype=np.uint32)


def _bits(key: torch.Tensor, start: int, count: int, device) -> torch.Tensor:
    """32-bit draws for flat counters [start, start + count) as int64."""
    y0, y1 = _hash_counters(key, start, count, device)
    return y0 ^ y1


def _chunked(key: torch.Tensor, shape: Tuple[int, ...], dtype, device,
             fn) -> torch.Tensor:
    """Fill a tensor of ``shape`` chunk by chunk: ``fn(bits) -> values``."""
    size = math.prod(shape)
    out = torch.empty(size, dtype=dtype, device=device)
    for start in range(0, size, CHUNK):
        count = min(CHUNK, size - start)
        out[start:start + count] = fn(_bits(key, start, count, device))
    return out.reshape(shape)


def _mantissa_floats(m: torch.Tensor) -> torch.Tensor:
    """The float32 m / 2^23 of 23-bit integers m, as the mantissa trick
    makes it."""
    return (m | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick of jax's uniform: float32 in [0, 1) from the top 23
    bits of each word."""
    return _mantissa_floats(bits >> 9)


def _uniform_params(minval: float, maxval: float) -> Tuple[np.float32,
                                                            np.float32]:
    """uniform's float32 lower end and scale, maxval - minval rounded to
    float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return lo, np.float32(hi - lo)


def _uniform_of(f: torch.Tensor, lo: np.float32,
                scale: np.float32) -> torch.Tensor:
    """max(lo, f scale + lo) for unit floats f, with XLA's fused FMA."""
    lo_t = torch.tensor(lo, device=f.device)
    return torch.maximum(lo_t, _fma(f, float(scale), lo_t))


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, *, device=None) -> torch.Tensor:
    """float32 uniform on [minval, maxval) (``jax.random.uniform``)."""
    device = resolve_device(device)
    lo, scale = _uniform_params(minval, maxval)
    return _chunked(key, _shape(shape), torch.float32, device,
                    lambda bits: _uniform_of(_unit_floats(bits), lo, scale))


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Shape = (), *,
              device=None) -> torch.Tensor:
    """bool draws with P[True] = p (``jax.random.bernoulli``)."""
    device = resolve_device(device)
    pf = float(np.float32(p))
    return _chunked(key, _shape(shape), torch.bool, device,
                    lambda bits: _unit_floats(bits) < pf)


def rademacher(key: torch.Tensor, shape: Shape = (), *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """+-1 draws (``jax.random.rademacher``)."""
    device = resolve_device(device)
    one = torch.ones((), dtype=dtype, device=device)

    def fn(bits):
        return torch.where(_unit_floats(bits) < 0.5, one, -one)
    return _chunked(key, _shape(shape), dtype, device, fn)


def _randint_params(minval: int, maxval: int) -> Tuple[int, int, int]:
    """randint's lower end, span (1 when the range is empty) and the
    multiplier that folds the high word in: jax's (2^16 mod span)^2 mod
    span with the square taken in uint32, so it wraps (to 0 from 2^32)
    for spans past 2^16, as jax's does."""
    lo, hi = int(minval), int(maxval)
    if not (-(1 << 31) <= lo < (1 << 31) and -(1 << 31) <= hi < (1 << 31)):
        raise ValueError("randint bounds must fit in int32")
    span = (hi - lo) & M32 if hi > lo else 1
    return lo, span, ((((1 << 16) % span) ** 2) & M32) % span


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval) (``jax.random.randint``), from two
    32-bit words per element folded modulo the span in uint32 arithmetic."""
    device = resolve_device(device)
    lo, span, mult = _randint_params(minval, maxval)
    k_hi, k_lo = split(key)
    shape = _shape(shape)
    size = math.prod(shape)
    out = torch.empty(size, dtype=torch.int32, device=device)
    for start in range(0, size, CHUNK):
        count = min(CHUNK, size - start)
        hb = _bits(k_hi, start, count, device)
        lb = _bits(k_lo, start, count, device)
        off = ((((hb % span) * mult) & M32) + lb % span) & M32
        out[start:start + count] = (off % span + lo).to(torch.int32)
    return out.reshape(shape)


# XLA's float32 erfinv (Giles' single-precision approximation).
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _fma(a, b, c) -> torch.Tensor:
    """float32 a*b + c with one rounding (the product is exact in float64);
    scalar operands are float32 values given as Python floats."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else float(v)
    return (f64(a) * f64(b) + f64(c)).float()


def _f32(bits: int) -> float:
    """The float32 with the given bit pattern, as a Python float."""
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# XLA's CPU float32 log (the Cephes logf polynomial on the mantissa).
_LOG_P = tuple(_f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,
    0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LOG_Q1, _LOG_Q2 = _f32(0xB95E8083), _f32(0x3F318000)
_SQRT_HALF = _f32(0x3F3504F3)
_MIN_NORMAL = _f32(0x00800000)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend computes it: x = m 2^e with
    m in [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1 and the
    exponent added in two parts; -inf at 0 and at subnormals (XLA flushes
    them to zero), nan below."""
    v = x.clamp_min(_MIN_NORMAL).view(torch.int32)
    m = ((v & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    e = ((v >> 23) - 0x7F).float() + 1.0
    low = m < _SQRT_HALF
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    m = _fma(-0.5, x2, m)
    m = _fma(_LOG_Q2, e, m + y)
    m = torch.where(x.abs() < _MIN_NORMAL, -torch.inf, m)
    m = torch.where(x == torch.inf, torch.inf, m)
    return torch.where((x < 0) | x.isnan(), torch.nan, m)


# XLA's float32 log1p below |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x)
# (Cephes), each polynomial in Horner form from its leading coefficient.
_LOG1P_SMALL = float(np.float32(0.41421356237309504880))
_LOG1P_DEN = tuple(float(np.float32(c)) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_NUM = tuple(float(np.float32(c)) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 log(1 + x) as XLA's CPU backend computes it."""
    def horner(coefs):
        r = torch.full_like(x, coefs[0])
        for c in coefs[1:]:
            r = _fma(r, x, c)
        return r
    x2 = x * x
    small = x + _fma(-0.5, x2, (x * x2) * (horner(_LOG1P_NUM)
                                           / horner(_LOG1P_DEN)))
    return torch.where(x.abs() < _LOG1P_SMALL, small, log_f32(x + 1.0))


# XLA's CPU float32 exp (the Cephes expf polynomial, FMA-contracted).
_EXP_LO, _EXP_HI = float(np.float32(-87.8)), float(np.float32(88.8))
_LOG2E = float(np.float32(1.44269504088896341))
_EXP_C1, _EXP_C2 = float(np.float32(-0.693359375)), float(np.float32(2.12194440e-4))
_EXP_P = tuple(float(np.float32(c)) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural exp as XLA's CPU backend computes it: x clamped to
    [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to [-127, 127], the
    remainder r = x - n ln(2) in two parts, a degree-5 polynomial for e^r,
    scaled by 2^n (exactly, through float64); results below the smallest
    normal float32 flush to 0, past the largest they are inf, nan stays
    nan."""
    xc = x.clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(_fma(xc, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = _fma(n, _EXP_C1, xc)
    r = _fma(n, _EXP_C2, r)
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    out = (y.double() * torch.pow(2.0, n.double())).float()
    out = torch.where(out < _MIN_NORMAL, 0.0, out)
    return torch.where(x.isnan(), x, out)


@functools.lru_cache(maxsize=None)
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def cos_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 cos as XLA's CPU backend computes it: the C library's
    ``cosf`` (glibc's, equal to jax's bit for bit over [0, pi]), element
    by element on the host, for the few scalars of a schedule."""
    cosf = _cosf()
    vals = [cosf(v) for v in x.detach().float().cpu().reshape(-1).tolist()]
    return torch.tensor(vals, dtype=torch.float32).reshape(x.shape).to(
        x.device)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by XLA's polynomial, +-inf at +-1."""
    w = -log1p_f32(-x * x)
    lt = w < 5.0
    # sqrt correctly rounded (float64, then float32: exact for sqrt);
    # torch's float32 sqrt on the CPU is not.
    t = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(np.float32(_ERFINV_W_LT5[i]), device=x.device),
                           torch.tensor(np.float32(_ERFINV_W_GE5[i]), device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT5)):
        p = _fma(p, t, coef(i))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


# normal's uniform draw is on (nextafter(-1, 0), 1); the result is scaled
# by the float32 sqrt(2).
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal_of_mantissas(m: torch.Tensor) -> torch.Tensor:
    """The normal draw of every 32-bit word whose top 23 bits are m:
    sqrt(2) erfinv(u), u normal's uniform of the word.  A draw depends on
    those bits alone, so over all 2^23 values of m this is every normal
    draw there is (the normal kernel's table, ``kernels/normal.py``)."""
    lo, scale = _uniform_params(NORMAL_LO, 1.0)
    u = _uniform_of(_mantissa_floats(m), lo, scale)
    return torch.tensor(np.float32(SQRT2), device=m.device) * erfinv(u)


def normal_plain(key: torch.Tensor, shape: Shape, device) -> torch.Tensor:
    """float32 standard normal draws (``jax.random.normal``) on any device:
    sqrt(2) erfinv(u).  The entry point is ``kernels.ops.normal``, which
    takes this on the CPU and the normal kernel on a CUDA device."""
    return _chunked(key, _shape(shape), torch.float32, device,
                    lambda bits: normal_of_mantissas(bits >> 9))


# bfloat16 normals: jax draws 8 random bits an element (the low byte of
# the 32-bit word) for a float with 7 mantissa bits, and its uniform keeps
# the top 7 of them, bits 1-7 of the word.  Every step runs in bfloat16,
# rounded after each operation: the uniform on (nextafter(-1, 0), 1), then
# sqrt(2) erfinv(u) with erfinv computed in float32 and rounded.
NORMAL_BF16_LO = -0.99609375      # nextafter(-1, 0) in bfloat16
NORMAL_BF16_VALUES = 128


def normal_bf16_table() -> torch.Tensor:
    """The bfloat16 normal draw of every word whose bits 1-7 are m, for
    m in [0, 128), on the CPU (the normal kernel's bfloat16 table)."""
    bf = torch.bfloat16
    m = torch.arange(NORMAL_BF16_VALUES, dtype=torch.int32)
    one = torch.tensor(1.0, dtype=bf)
    f = (m | 0x3F80).to(torch.int16).view(bf) - one
    lo = torch.tensor(NORMAL_BF16_LO, dtype=bf)
    u = torch.maximum(lo, f * (one - lo) + lo)
    return torch.tensor(SQRT2, dtype=bf) * erfinv(u.float()).to(bf)


def normal_bf16_plain(key: torch.Tensor, shape: Shape,
                      device) -> torch.Tensor:
    """bfloat16 standard normal draws (``jax.random.normal(key, shape,
    jnp.bfloat16)``) on any device: the table read at bits 1-7 of each
    word.  The entry point is ``kernels.ops.normal`` with ``dtype``."""
    table = normal_bf16_table().to(device)
    return _chunked(key, _shape(shape), torch.bfloat16, device,
                    lambda bits: table[(bits >> 1) & 0x7F])


Box = Sequence[Tuple[int, int]]


def check_box(shape: Tuple[int, ...], box: Box) -> Tuple[Tuple[int, int],
                                                          ...]:
    """``box`` as (start, size) int pairs, one a dim of ``shape``, each
    inside its dim; raises ValueError otherwise."""
    box = tuple((int(s), int(n)) for s, n in box)
    if len(box) != len(shape) or any(
            s < 0 or n < 0 or s + n > d for (s, n), d in zip(box, shape)):
        raise ValueError(f"box {box} does not lie in shape {shape}")
    return box


def box_counters(shape: Tuple[int, ...], box: Box, start: int,
                 count: int, device) -> torch.Tensor:
    """The flat counters in ``shape`` (int64) of the box's elements
    start .. start + count - 1, in the box's row-major order."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    flat = torch.zeros_like(i)
    stride = 1
    for (lo, n), dim in zip(reversed(box), reversed(shape)):
        flat += (i % n + lo) * stride
        i = i // n
        stride *= dim
    return flat


def normal_window(key: torch.Tensor, shape: Shape, box: Box,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> torch.Tensor:
    """The box of ``jax.random.normal(key, shape, dtype)`` (float32 or
    bfloat16), without the rest of it: ``box`` holds a (start, size) pair
    a dim of ``shape``, and the element at each index of the box takes the
    64-bit counter of its flat index in the whole ``shape`` (jax's
    partitionable threefry, so a shard of a sharded draw is a box).  The
    box is drawn chunk by chunk.  The entry point is
    ``kernels.ops.normal_window``, which takes this on the CPU."""
    device = resolve_device(device)
    shape = _shape(shape)
    box = check_box(shape, box)
    if dtype == torch.float32:
        def fn(bits):
            return normal_of_mantissas(bits >> 9)
    elif dtype == torch.bfloat16:
        table = normal_bf16_table().to(device)

        def fn(bits):
            return table[(bits >> 1) & 0x7F]
    else:
        raise ValueError(f"normal_window: dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    sizes = tuple(n for _, n in box)
    size = math.prod(sizes)
    k0, k1 = _words(key)
    out = torch.empty(size, dtype=dtype, device=device)
    for start in range(0, size, CHUNK):
        count = min(CHUNK, size - start)
        c = box_counters(shape, box, start, count, device)
        y0, y1 = _threefry2x32(k0, k1, c >> 32, c & M32)
        out[start:start + count] = fn(y0 ^ y1)
    return out.reshape(sizes)


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sequential float32 running sum along the last axis."""
    out = x.clone()
    for j in range(1, x.shape[-1]):
        out[..., j] += out[..., j - 1]
    return out


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along the last axis in the order of
    XLA's CPU ``jnp.cumsum`` (along any axis, each line alike): rows of 16
    (zero-padded at the end) summed in order, the row totals' prefix by
    the same scheme (in order once 16 or fewer remain), and each row's
    exclusive prefix added to it.  The same float32 adds on every device;
    never ``torch.cumsum``, which accumulates in float64 on the CPU."""
    n = x.shape[-1]
    if n <= 16:
        return _cumsum_rows(x)
    lead = x.shape[:-1]
    rows = x.new_zeros(lead + (-(-n // 16), 16))
    rows.view(lead + (-1,))[..., :n] = x
    rows = _cumsum_rows(rows)
    totals = cumsum_f32(rows[..., -1].contiguous())
    rows[..., 1:, :] += totals[..., :-1, None]
    return rows.view(lead + (-1,))[..., :n]


def choice(key: torch.Tensor, n: int, shape: Shape,
           p: torch.Tensor) -> torch.Tensor:
    """int32 indices in [0, n) drawn with replacement with probabilities
    ``p`` (``jax.random.choice(key, n, shape, replace=True, p=p)``), on
    p's device: the uniform draw inverted through p's float32 prefix sum
    (``cumsum_f32``) with a left-sided search."""
    if p.shape != (int(n),):
        raise ValueError(f"p must have shape ({n},), got {tuple(p.shape)}")
    p_cuml = cumsum_f32(p.to(torch.float32))
    shape = _shape(shape)
    r = p_cuml[-1] * (1.0 - uniform(key, shape, device=p.device))
    ind = torch.searchsorted(p_cuml, r.reshape(-1), side="left")
    return ind.to(torch.int32).reshape(shape)


# gumbel's uniform draw is on [tiny, 1): tiny is float32's smallest normal.
GUMBEL_MINVAL = _MIN_NORMAL


def gumbel_of_uniform(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) in XLA's float32 log: the Gumbel draw of gumbel's
    uniform draw u (jax's default mode, "low")."""
    return -log_f32(-log_f32(u))


def gumbel(key: torch.Tensor, shape: Shape = (), *,
           device=None) -> torch.Tensor:
    """float32 standard Gumbel draws (``jax.random.gumbel`` in its default
    mode): the uniform on [GUMBEL_MINVAL, 1) through two float32 logs.  The
    entry point is ``kernels.ops.gumbel``, which takes this on the CPU and
    the draw kernel's uniform on a CUDA device."""
    return gumbel_of_uniform(uniform(key, shape, GUMBEL_MINVAL, 1.0,
                                     device=device))


def categorical_shapes(logits_shape: Tuple[int, ...], axis: int,
                       shape) -> Tuple[Tuple[int, ...], int, int]:
    """``jax.random.categorical``'s shapes (replace=True): the Gumbel
    draw's shape, the axis counted from the end, and how many leading
    dimensions ``shape`` adds to the logits'."""
    ndim = len(logits_shape)
    axis = axis - ndim if axis >= 0 else axis
    batch = logits_shape[:ndim + axis] + logits_shape[ndim + axis + 1:]
    shape = batch if shape is None else _shape(shape)
    if len(shape) < len(batch):
        raise ValueError(f"categorical: shape {shape} is shorter than the "
                         f"logits' batch shape {batch}")
    lead = len(shape) - len(batch)
    draw = list(shape[lead:])
    draw.insert(axis % ndim, logits_shape[axis])
    return (*shape[:lead], *draw), axis, lead


def categorical_of_gumbel(g: torch.Tensor, logits: torch.Tensor, axis: int,
                          lead: int) -> torch.Tensor:
    """The index of the largest g + logits along ``axis`` (the first at a
    tie, as ``jnp.argmax``), int32; ``lead`` leading dimensions of g that
    logits lacks."""
    z = g + logits.reshape((1,) * lead + tuple(logits.shape))
    return torch.argmax(z, dim=axis).to(torch.int32)


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1,
                shape=None) -> torch.Tensor:
    """int32 draws from the categorical distributions softmax(logits,
    axis) (``jax.random.categorical``, replace=True, the default Gumbel
    mode), on the logits' device: the argmax of Gumbel draws plus the
    logits.  The entry point is ``kernels.ops.categorical``."""
    draw, axis, lead = categorical_shapes(tuple(logits.shape), axis, shape)
    g = gumbel(key, draw, device=logits.device)
    return categorical_of_gumbel(g, logits, axis, lead)


def permutation(key: torch.Tensor, n: int, *, device=None) -> torch.Tensor:
    """int32 random permutation of range(n) (``jax.random.permutation(key,
    n)``; ``[:k]`` of it is ``jax.random.choice(key, n, (k,),
    replace=False)``).  jax's ``_shuffle``: ceil(3 ln n / ln(2^32 - 1))
    rounds, each splitting the key, drawing n 32-bit sort keys under the
    second half and sorting the running permutation by them, stably.  The
    sort keys come from ``kernels.ops.bits``: the draw kernel on a CUDA
    device, the plain bits on the CPU."""
    from repro_torch.kernels import ops   # kernels import prng
    device = resolve_device(device)
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int32, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = ops.bits(sub, 0, n, device=device).to(torch.int64) & M32
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows of integer labels (``jax.nn.one_hot``): a label
    outside [0, num_classes) gives a row of zeros."""
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(torch.float32)
