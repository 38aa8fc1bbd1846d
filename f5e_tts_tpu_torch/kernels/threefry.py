"""Threefry draws on the card: f32 uniforms and normals, and dropout, each
bit for bit the draw of `jax.random` (threefry2x32, the partitionable
counter layout) that ops/prng.py's torch-op functions, their plain
versions, give.

The kernel is `csrc/threefry.cu` (its header says what bounds it and how it
is built). It replaces no TPU kernel: XLA fuses the JAX package's draws
into the ops that consume them, and without a kernel the port's draws would
run the hash as ~170 torch ops an element. CPU tensors take the plain
versions; on the card each wrapper launches the kernel or raises, and counts
its launches: `uniform_launches` (normals included: their uniform draw),
`dropout_launches` and `dropout_bwd_launches`.

A key is a (2,) int64 tensor of uint32 words (ops/prng.py). The wrappers
read its two words on the host, so the keys of the training step live on
the CPU (a CUDA key works, at the cost of a synchronisation). Every draw
takes an optional `global_shape` and `offset`: the block of `shape` at
`offset` of the draw of `global_shape`, which is how a rank of a mesh draws
its rows or columns of the unsharded draw. The kernel takes blocks of up to
three dims (more when the leading ones are whole).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from f5e_tts_tpu_torch.kernels import _build
from f5e_tts_tpu_torch.ops import prng

uniform_launches = 0  # uniform epilogue (uniforms and normals) since last set to 0
dropout_launches = 0  # dropout forward
dropout_bwd_launches = 0  # dropout backward (the same kernel on the gradient)
DROPOUT_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("threefry")
    u32, p, ll, f = ctypes.c_uint32, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    layout = [ll] * 8 + [p]
    lib.threefry_uniform.argtypes = [u32, u32, p, f, f] + layout
    for suffix in DROPOUT_DTYPES.values():
        getattr(lib, f"threefry_dropout_{suffix}").argtypes = [u32, u32, p, p, f, f] + layout
    for fn in ("threefry_uniform", "threefry_dropout_bf16", "threefry_dropout_f32"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _key_words(key: torch.Tensor):
    if key.shape != (2,):
        raise ValueError(f"threefry kernel takes one key of shape (2,), got {tuple(key.shape)}")
    k0, k1 = (int(w) for w in key.tolist())
    return k0 & prng.MASK, k1 & prng.MASK


def layout(shape: Sequence[int], global_shape: Optional[Sequence[int]] = None,
           offset: Optional[Sequence[int]] = None) -> tuple:
    """(l0, l1, l2, g1, g2, o0, o1, o2) of the kernel for a block of `shape`
    at `offset` of `global_shape`: the block as three dims, leading ones of
    size 1 added and, past three dims, leading ones merged where the block
    holds them whole."""
    shape, glob, off = prng._check_slab(shape, global_shape, offset)
    shape, glob, off = list(shape), list(glob), list(off)
    while len(shape) > 3:  # merge dims 0 and 1 when dim 1 is whole in the block
        if shape[1] != glob[1] or off[1]:
            raise ValueError(f"threefry kernel: a block of {tuple(shape)} at {tuple(off)} of "
                             f"{tuple(glob)} is not three dims")
        shape[:2], glob[:2], off[:2] = [shape[0] * shape[1]], [glob[0] * glob[1]], [off[0] * glob[1]]
    pad = 3 - len(shape)
    shape, glob, off = [1] * pad + shape, [1] * pad + glob, [0] * pad + off
    return (shape[0], shape[1], shape[2], glob[1], glob[2], off[0], off[1], off[2])


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"threefry {name} kernel launch failed: CUDA error {err}")


def uniform(key: torch.Tensor, shape: Sequence[int], device="cpu", lo: float = 0.0,
            hi: float = 1.0, global_shape: Optional[Sequence[int]] = None,
            offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`prng.uniform` (f32 on [lo, hi)) on `device`."""
    global uniform_launches
    device = torch.device(device)
    if device.type == "cpu":
        return prng.uniform(key.to(device), shape, lo, hi, global_shape, offset)
    lay = layout(shape, global_shape, offset)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    _check(_lib().threefry_uniform(*_key_words(key), out.data_ptr(), float(np.float32(lo)),
                                   float(np.float32(hi)), *lay, _stream(device)), "uniform")
    uniform_launches += 1
    return out


def normal(key: torch.Tensor, shape: Sequence[int], device="cpu",
           global_shape: Optional[Sequence[int]] = None,
           offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`prng.normal` on `device`: the kernel's uniform draw, then the same
    erf_inv in torch ops."""
    device = torch.device(device)
    if device.type == "cpu":
        return prng.normal(key.to(device), shape, global_shape, offset)
    return prng.normal_of_uniform(uniform(key, shape, device, prng.NORMAL_LO, 1.0, global_shape,
                                          offset))


def dropout(key: torch.Tensor, x: torch.Tensor, rate: float,
            global_shape: Optional[Sequence[int]] = None,
            offset: Optional[Sequence[int]] = None, backward: bool = False) -> torch.Tensor:
    """`prng.dropout(key, x, rate)`: CPU tensors take it; CUDA tensors in bf16
    or f32 launch the kernel (counted in `dropout_bwd_launches` with
    `backward`) or raise. Not differentiable: see `ThreefryDropout`."""
    global dropout_launches, dropout_bwd_launches
    if x.device.type == "cpu":
        return prng.dropout(key.to(x.device), x, rate, global_shape, offset)
    if not x.is_cuda or x.dtype not in DROPOUT_DTYPES:
        raise ValueError(f"threefry dropout kernel takes bf16 or f32 CUDA tensors, got {x.dtype} "
                         f"on {x.device}")
    lay = layout(x.shape, global_shape, offset)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty_like(x)
    fn = getattr(_lib(), f"threefry_dropout_{DROPOUT_DTYPES[x.dtype]}")
    _check(fn(*_key_words(key), x.data_ptr(), out.data_ptr(), *_dropout_consts(rate, x.dtype),
              *lay, _stream(x.device)), "dropout")
    if backward:
        dropout_bwd_launches += 1
    else:
        dropout_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _dropout_consts(rate: float, dtype: torch.dtype):
    """(p, c): the keep threshold f32(1 - rate) and the divisor, 1 - rate
    rounded to x's dtype."""
    return float(np.float32(1.0 - rate)), torch.tensor(1.0 - rate, dtype=dtype).float().item()


class ThreefryDropout(torch.autograd.Function):
    """Differentiable `dropout(key, x, rate, global_shape, offset)`. Saves the
    key and the block's layout only: dropout is linear, so the backward is
    the same draw on the gradient (one more launch), and no mask is kept."""

    @staticmethod
    def forward(ctx, x, key, rate: float, global_shape, offset):
        ctx.key, ctx.rate, ctx.global_shape, ctx.offset = key, rate, global_shape, offset
        return dropout(key, x, rate, global_shape, offset)

    @staticmethod
    def backward(ctx, g):
        return (dropout(ctx.key, g, ctx.rate, ctx.global_shape, ctx.offset, backward=True),
                None, None, None, None)
