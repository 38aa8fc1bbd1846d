"""JAX's threefry PRNG in torch: the part of `jax.random` that the JAX
package draws from (`PRNGKey`, `fold_in`, `split`, `bits`, `uniform`,
`normal`, `bernoulli`, `permutation` under the default threefry2x32
implementation): the sampler's noise, training's draws (the loss's spans,
times and noise, dropout, the codebook's gumbel noise and permutations) and
the seeded init weights, so a seed gives the same numbers in both packages.
These are the plain versions of the threefry kernel
(`kernels/threefry.py`), which draws the large tensors on the card.

A key is an int64 tensor of shape (..., 2) holding two uint32 words (torch's
uint32 lacks shifts and xors on every device, so the words live in int64 and
every sum is masked with `& 0xFFFFFFFF`); a key of shape (B, 2) is a batch of
B keys and every function maps over the leading dimensions, as `jax.vmap`
over the JAX function does. Everything runs on the key's device as plain
integer and f32 ops, with no copy from the host that would wait for the
device (constants are filled on the device, keys copied without a sync);
CPU keys are hashed on the host, in numpy or, for the key chain's splits
and folds of one key, Python ints. Threefry is adds, rotates and xors, so
keys, bits and uniforms are exactly JAX's on any device; normals go
through XLA's f32 `erf_inv` polynomial and agree with `jax.random.normal`
to a few ulp (the log1p inside it rounds differently on each library).

Only the partitionable counter layout (`jax_threefry_partitionable`, JAX's
default since 0.5) is reproduced, not the legacy one. In that layout an
element's counter is its flat index in the array, so a slice of a larger
array draws exactly its part of the larger array's stream: the draws take
the larger (global) shape and the slice's offset along each dim, which is
how a rank of a mesh draws its rows or columns of what the unsharded array
gets (pjit's global draw).

reference: jax/_src/prng.py (threefry_2x32, _threefry_seed, _threefry_split,
_threefry_fold_in, _threefry_random_bits_partitionable) and jax/_src/random.py
(_uniform, _normal_real), jax 0.9.0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

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
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


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
    """Rotate int32 words left by r (the right shift is arithmetic on int32,
    so its sign bits are masked off)."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _int32(x) -> torch.Tensor:
    """uint32 values of an int64 tensor as the int32 words of the same bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block cipher, 20 rounds, elementwise over the
    broadcast of key words (k0, k1) and counter words (x0, x1), each an int64
    tensor of uint32 values. Returns the two output words, int64 of uint32
    values. On a device the rounds run on int32 words, whose sums wrap as
    uint32 sums do; CPU tensors are hashed on the host (`_threefry2x32_host`)."""
    if all(t.device.type == "cpu" for t in (k0, k1, x0, x1)):
        return _threefry2x32_host(k0, k1, x0, x1)
    k0, k1, x0, x1 = (_int32(t) for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)  # the parity word is under 2**31
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0.to(torch.int64) & MASK, x1.to(torch.int64) & MASK


def _threefry2x32_host(k0, k1, x0, x1):
    """`threefry2x32` of CPU tensors on numpy's uint32 words, whose adds
    wrap and whose shifts and xors are native: about twice as fast as
    torch's CPU ops at any size, and single-threaded."""
    k0, k1, x0, x1 = torch.broadcast_tensors(k0, k1, x0, x1)
    shape = k0.shape
    k0, k1, x0, x1 = (t.reshape(-1).numpy().astype(np.uint32) for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_KS_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return (torch.from_numpy(x0.astype(np.int64)).reshape(shape),
            torch.from_numpy(x1.astype(np.int64)).reshape(shape))


# a split or fold of one CPU key into at most this many keys hashes Python
# ints: the training step's key chain, ~50 such calls a micro-step, where
# each array op's fixed cost (~150 ops a hash) would dominate
_HOST_INTS = 16


def _one_host_key(key: torch.Tensor) -> bool:
    return key.device.type == "cpu" and key.shape == (2,)


def _threefry2x32_ints(k0: int, k1: int, x0: int, x1: int):
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0, x1 = (x0 + k0) & MASK, (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _words(key: torch.Tensor, ndim: int):
    """The key's two words, shaped to broadcast over `ndim` trailing dims."""
    pad = (1,) * ndim
    return key[..., 0].reshape(key.shape[:-1] + pad), key[..., 1].reshape(key.shape[:-1] + pad)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: threefry of the counter (0, data mod 2**32)
    under `key`. `data` is an int or an integer tensor that broadcasts with
    the key's leading dims (so `fold_in(key, torch.arange(B))` gives B keys)."""
    if _one_host_key(key) and not torch.is_tensor(data):
        k0, k1 = key.tolist()
        return torch.tensor(_threefry2x32_ints(k0, k1, 0, int(data) & MASK), dtype=torch.int64)
    data = (data.to(key.device, torch.int64) if torch.is_tensor(data)
            else torch.full((), int(data), dtype=torch.int64, device=key.device)) & MASK
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def slab(shape: Sequence[int], rows: Optional[Tuple[int, int]] = None,
         cols: Optional[Tuple[int, int]] = None):
    """(global_shape, offset) of a block of `shape` that is `rows` = (global
    rows, first row) of a larger array along dim 0 and `cols` = (global
    columns, first column) along the last dim; (None, None) when neither is
    given (the block is the whole array)."""
    if rows is None and cols is None:
        return None, None
    glob, off = list(shape), [0] * len(shape)
    if rows is not None:
        glob[0], off[0] = rows
    if cols is not None:
        glob[-1], off[-1] = cols
    return tuple(glob), tuple(off)


def _check_slab(shape, global_shape, offset):
    shape = tuple(int(s) for s in shape)
    if global_shape is None:
        if offset is not None and any(offset):
            raise ValueError("an offset needs the global shape")
        return shape, shape, (0,) * len(shape)
    glob = tuple(int(s) for s in global_shape)
    off = tuple(int(o) for o in offset) if offset is not None else (0,) * len(shape)
    if len(glob) != len(shape) or len(off) != len(shape):
        raise ValueError(f"global shape {glob} and offset {off} do not match the shape {shape}")
    if any(o < 0 or o + n > g for n, g, o in zip(shape, glob, off)):
        raise ValueError(f"a block of {shape} at {off} does not fit in {glob}")
    return shape, glob, off


def _flat_index(shape: Sequence[int], device, global_shape: Optional[Sequence[int]] = None,
                offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The flat index in `global_shape` (default: `shape` itself) of each
    element of a block of `shape` at `offset` (`iota_2x32_shape` of the
    global array, sliced), int64."""
    shape, glob, off = _check_slab(shape, global_shape, offset)
    if glob == shape:
        return torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64,
                            device=device).reshape(shape)
    strides = [int(np.prod(glob[d + 1:], dtype=np.int64)) for d in range(len(glob))]
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for n, o, st in zip(shape, off, strides):
        idx = idx[..., None] + (torch.arange(n, dtype=torch.int64, device=device) + o) * st
    return idx


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` under the partitionable layout: (...,
    num, 2), subkey i the threefry of the counter (0, i)."""
    if _one_host_key(key) and num <= _HOST_INTS:
        k0, k1 = key.tolist()
        return torch.tensor([_threefry2x32_ints(k0, k1, 0, i) for i in range(num)],
                            dtype=torch.int64).reshape(num, 2)
    idx = _flat_index((num,), key.device)
    y0, y1 = threefry2x32(*_words(key, 1), idx >> 32, idx & MASK)
    return torch.stack([y0, y1], dim=-1)


# elements a CPU pass of a draw hashes and finishes at once: under torch's
# grain size (32768), below which an op runs on the calling thread alone.
# The finishing torch ops (a uniform's scaling, a normal's erf_inv, dropout)
# over larger tensors would each be a parallel region, and processes that
# share the cores (pytest's workers) then wait on each other's spinning
# threads at every one.
CHUNK = 3 << 13


def _draw(key: torch.Tensor, shape: Sequence[int], global_shape, offset, finish,
          x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """finish(bits) (or finish(bits, x's elements)) of the 32-bit draw of
    `shape` under `key` (int64 of uint32 values, (..., *shape) for keys
    (..., 2)): the two threefry words of each element's flat index, xored.
    On the CPU the draw is made key by key, CHUNK elements at a time."""
    shape, glob, off = _check_slab(shape, global_shape, offset)
    n = int(np.prod(shape, dtype=np.int64))
    if key.device.type != "cpu" or (key.dim() == 1 and n <= CHUNK):
        idx = _flat_index(shape, key.device, glob, off)
        y0, y1 = threefry2x32(*_words(key, len(shape)), idx >> 32, idx & MASK)
        return finish(y0 ^ y1) if x is None else finish(y0 ^ y1, x)
    if key.dim() > 1:
        rows = [_draw(k, shape, glob, off, finish) for k in key.reshape(-1, 2)]
        return torch.stack(rows).reshape(key.shape[:-1] + shape)
    flat = None if glob == shape else _flat_index(shape, "cpu", glob, off).reshape(-1)
    xs = None if x is None else x.reshape(-1)
    out = None
    for start in range(0, n, CHUNK):
        stop = min(start + CHUNK, n)
        idx = torch.arange(start, stop, dtype=torch.int64) if flat is None else flat[start:stop]
        y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
        part = finish(y0 ^ y1) if xs is None else finish(y0 ^ y1, xs[start:stop])
        if out is None:
            out = torch.empty(n, dtype=part.dtype)
        out[start:stop] = part
    return out.reshape(shape)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                global_shape: Optional[Sequence[int]] = None,
                offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`jax.random.bits(key, shape)` at 32 bits: the two threefry words of
    each element's flat index, xored. (..., *shape) int64 of uint32 values.
    With `global_shape` (and `offset`), the block of `shape` at `offset` of
    `bits(key, global_shape)`."""
    return _draw(key, shape, global_shape, offset, lambda bits: bits)


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 operands, rounded once to f32, as a fused
    multiply-add (XLA's compiled form of it, and `fmaf` on the card). The
    product is exact in f64; the sum is rounded to f64 by round-to-odd (its
    error, from TwoSum, says which neighbour of the nearest sum is odd),
    after which the rounding to f32 is the single rounding of the exact
    value (53 bits >= 24 + 2)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    even_inexact = (err != 0) & ((bits & 1) == 0)
    # one ulp toward the exact sum: up in magnitude when err has s's sign
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(even_inexact, bits + step, bits).view(torch.float64).float()


def _uniform_of_bits(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_t, hi_t = _f32(lo, bits.device), _f32(hi, bits.device)
    return torch.maximum(lo_t, fma_f32(floats, hi_t - lo_t, lo_t))


def uniform(key: torch.Tensor, shape: Sequence[int], lo: float = 0.0,
            hi: float = 1.0, global_shape: Optional[Sequence[int]] = None,
            offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`jax.random.uniform` in f32: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [lo, hi) and held >= lo. The scaling
    u (hi - lo) + lo is rounded once to f32 (`fma_f32`), as the fused
    multiply-add XLA compiles it to. `global_shape`, `offset`: see
    `random_bits`."""
    return _draw(key, shape, global_shape, offset, lambda bits: _uniform_of_bits(bits, lo, hi))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 `ErfInv`, op for op (not `torch.erfinv`, whose rounding
    differs by up to ~100 ulp): +-inf at +-1. Each Horner step c + p w is
    formed in f64, where the product of two f32 values is exact, and rounded
    to f32: the fused multiply-add XLA compiles it to, but for a sum that
    f64 rounds onto an f32 midpoint (far rarer than the f32 log1p's
    differences, and within the normals' 4 ulp)."""
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


def normal(key: torch.Tensor, shape: Sequence[int], global_shape: Optional[Sequence[int]] = None,
           offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`jax.random.normal` in f32: sqrt(2) erf_inv(u) for u uniform on
    [nextafter(-1, 0), 1). (..., *shape) for keys (..., 2)."""
    return _draw(key, shape, global_shape, offset,
                 lambda bits: normal_of_uniform(_uniform_of_bits(bits, NORMAL_LO, 1.0)))


def normal_of_uniform(u: torch.Tensor) -> torch.Tensor:
    """The normal that `normal` makes of its uniform draw u."""
    return _f32(2.0 ** 0.5, u.device) * erf_inv(u)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int],
              global_shape: Optional[Sequence[int]] = None,
              offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` for a Python float p: a uniform
    draw in f32 below p in f32 (jax/_src/random.py: _bernoulli, mode
    "low"). Bool."""
    return _draw(key, shape, global_shape, offset,
                 lambda bits: _uniform_of_bits(bits, 0.0, 1.0) < _f32(p, bits.device))


def dropout(key: torch.Tensor, x: torch.Tensor, rate: float,
            global_shape: Optional[Sequence[int]] = None,
            offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The JAX package's dropout on a draw (f5e_tts_tpu ops/nn.py: dropout):
    where(bernoulli(key, 1 - rate, x.shape), x / c, 0) in x's dtype, with c =
    1 - rate rounded to x's dtype first (JAX's weakly typed Python scalar
    takes the array's type, so bf16 divides by 0.8984375 at rate 0.1) and
    the quotient formed in f32 (f64 for f64 x) and rounded once. Linear in
    x: the gradient is the same function of the cotangent under the same
    key."""
    p = _f32(1.0 - rate, x.device)
    return _draw(key.to(x.device), x.shape, global_shape, offset,
                 lambda bits, xs: scaled_where(_uniform_of_bits(bits, 0.0, 1.0) < p, xs, rate), x)


def scaled_where(keep: torch.Tensor, x: torch.Tensor, rate: float) -> torch.Tensor:
    """where(keep, x / c, 0) with `dropout`'s c and rounding. The divisor is
    a tensor of x's shape: torch divides by a scalar as a product with its
    reciprocal on the card, which is not the IEEE quotient."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xc = x.to(ct)
    c = torch.full_like(xc, torch.tensor(1.0 - rate, dtype=x.dtype).item())
    return torch.where(keep, (xc / c).to(x.dtype), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: arange(n) put through
    ceil(3 ln n / ln(2**32 - 1)) rounds, each splitting the key, drawing 32
    bits an element from the second half and sorting stably by them
    (jax/_src/random.py: _shuffle; `lax.sort_key_val` is stable). int64 on
    the key's device."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(random_bits(sub, (n,)), stable=True).indices]
    return x
