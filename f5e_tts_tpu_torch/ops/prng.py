"""JAX's threefry PRNG in torch: the part of `jax.random` that the JAX
package's inference draws its sampler noise from (`PRNGKey`, `fold_in`,
`split`, `bits`, `uniform`, `normal` under the default threefry2x32
implementation), so a seed gives the same noise in both packages.

A key is an int64 tensor of shape (..., 2) holding two uint32 words (torch's
uint32 lacks shifts and xors on every device, so the words live in int64 and
every sum is masked with `& 0xFFFFFFFF`); a key of shape (B, 2) is a batch of
B keys and every function maps over the leading dimensions, as `jax.vmap`
over the JAX function does. Everything runs on the key's device as plain
integer and f32 ops, with no copy from the host that would wait for the
device (constants are filled on the device, keys copied without a sync). Threefry is adds, rotates and xors, so keys, bits and
uniforms are exactly JAX's on any device; normals go through XLA's f32
`erf_inv` polynomial and agree with `jax.random.normal` to a few ulp (the
log1p inside it rounds differently on each library).

Only the partitionable counter layout (`jax_threefry_partitionable`, JAX's
default since 0.5) is reproduced, not the legacy one.

reference: jax/_src/prng.py (threefry_2x32, _threefry_seed, _threefry_split,
_threefry_fold_in, _threefry_random_bits_partitionable) and jax/_src/random.py
(_uniform, _normal_real), jax 0.9.0.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's f32 ErfInv (M. Giles, "Approximating the erfinv function"): a degree-8
# polynomial in w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# the normal's uniform draws from [nextafter(-1, 0), 1) in f32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as the JAX package builds it (64-bit types
    off): the seed is taken as an int64 and cut to int32, so the key is (0,
    seed mod 2**32) for any seed in int64's range (-1 gives (0, 0xFFFFFFFF))
    and a seed outside it raises OverflowError, as JAX does."""
    return prng_keys([seed], device)[0]


def prng_keys(seeds: Union[Sequence[int], torch.Tensor], device="cpu") -> torch.Tensor:
    """(B, 2) keys, row i `prng_key(seeds[i])` (JAX's `vmap(PRNGKey)` over an
    int32 array)."""
    seeds = [int(s) for s in (seeds.tolist() if torch.is_tensor(seeds) else seeds)]
    for s in seeds:
        if not -2 ** 63 <= s < 2 ** 63:
            raise OverflowError(f"seed {s} does not fit in int64")
    rows = torch.tensor([[0, s & MASK] for s in seeds], dtype=torch.int64).reshape(-1, 2)
    # from pageable memory, a non-blocking copy returns once the rows are
    # staged, without waiting for the device's queue
    return rows.to(device, non_blocking=True)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block cipher, 20 rounds, elementwise over the
    broadcast of key words (k0, k1) and counter words (x0, x1), each an int64
    tensor of uint32 values. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _words(key: torch.Tensor, ndim: int):
    """The key's two words, shaped to broadcast over `ndim` trailing dims."""
    pad = (1,) * ndim
    return key[..., 0].reshape(key.shape[:-1] + pad), key[..., 1].reshape(key.shape[:-1] + pad)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: threefry of the counter (0, data mod 2**32)
    under `key`. `data` is an int or an integer tensor that broadcasts with
    the key's leading dims (so `fold_in(key, torch.arange(B))` gives B keys)."""
    data = (data.to(key.device, torch.int64) if torch.is_tensor(data)
            else torch.full((), int(data), dtype=torch.int64, device=key.device)) & MASK
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counters(shape: Sequence[int], device):
    """The flat index of each element of `shape`, as (high, low) words
    (`iota_2x32_shape`)."""
    idx = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64, device=device)
    idx = idx.reshape(tuple(shape))
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` under the partitionable layout: (...,
    num, 2), subkey i the threefry of the counter (0, i)."""
    hi, lo = _counters((num,), key.device)
    y0, y1 = threefry2x32(*_words(key, 1), hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits(key, shape)` at 32 bits: the two threefry words of
    each element's flat index, xored. (..., *shape) int64 of uint32 values."""
    hi, lo = _counters(shape, key.device)
    y0, y1 = threefry2x32(*_words(key, len(shape)), hi, lo)
    return y0 ^ y1


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: Sequence[int], lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in f32: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [lo, hi) and held >= lo. The scaling
    u (hi - lo) + lo is rounded once to f32, as the fused multiply-add XLA
    compiles it to (the f32 product is exact in f64)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo_t, hi_t = _f32(lo, key.device), _f32(hi, key.device)
    scaled = torch.addcmul(lo_t.double(), floats, (hi_t - lo_t).double()).float()
    return torch.maximum(lo_t, scaled)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 `ErfInv`, op for op (not `torch.erfinv`, whose rounding
    differs by up to ~100 ulp): +-inf at +-1. Each Horner step c + p w is
    rounded once to f32, as the fused multiply-add XLA compiles it to: the
    product of two f32 values is exact in f64."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    # the coefficients as f32 values (exact in the f32 select, then in f64)
    coeffs = [(float(np.float32(a)), float(np.float32(b)))
              for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = torch.where(small, *coeffs[0])
    for a, b in coeffs[1:]:
        p = torch.addcmul(torch.where(small, a, b), p, w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.normal` in f32: sqrt(2) erf_inv(u) for u uniform on
    [nextafter(-1, 0), 1). (..., *shape) for keys (..., 2)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _f32(2.0 ** 0.5, key.device) * erf_inv(u)
