"""Gated-residual AdaLN forward (K2): wrapper, plain version, launch count.

Port of f5e_tts_tpu/ops/pallas_norm.py: _gated_adaln_fwd_impl. The kernel is
`csrc/gated_adaln.cu` (its header says what bounds it and how it is built);
this module checks the operands, launches it on PyTorch's current stream and
counts the launches in `launches`.

    new_x = x + gate * y
    out   = LayerNorm(new_x; eps 1e-6, no affine) * (1 + scale) + shift

x, y (B, N, D); gate/scale/shift (B, D); fp32 math; both outputs in x's
dtype, with `out` computed from the fp32 new_x.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from f5e_tts_tpu_torch.kernels import _build

EPS = 1e-6
launches = 0  # kernel launches since the caller last set it to 0


def gated_adaln_plain(x, y, gate, scale, shift) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch (fp32 math, one rounding per output)."""
    new_x = x.float() + gate.float()[:, None, :] * y.float()
    mean = new_x.mean(dim=-1, keepdim=True)
    var = (new_x - mean).square().mean(dim=-1, keepdim=True)
    norm = (new_x - mean) * torch.rsqrt(var + EPS)
    out = norm * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return new_x.to(x.dtype), out.to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("gated_adaln")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gated_adaln_fwd.argtypes = [p, p, p, p, p, ll, ll, ll, p, p, i, i, i, ctypes.c_float, p]
    lib.gated_adaln_fwd.restype = ctypes.c_int
    return lib


def _row_operand(t: torch.Tensor) -> torch.Tensor:
    """A (B, D) modulation row read through its row stride when aligned."""
    ok = t.stride(1) == 1 and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0
    return t if ok else t.contiguous()


def gated_adaln(x, y, gate, scale, shift) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new_x, out) of the gated residual + AdaLN. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16, D % 8 == 0, D <= 4096) or
    raise."""
    global launches
    if x.device.type == "cpu":
        return gated_adaln_plain(x, y, gate, scale, shift)
    if not x.is_cuda:
        raise ValueError(f"gated_adaln: unsupported device {x.device}")
    b, n, d = x.shape
    if y.shape != x.shape or any(t.shape != (b, d) for t in (gate, scale, shift)):
        raise ValueError(f"gated_adaln: shapes x{tuple(x.shape)} y{tuple(y.shape)} "
                         f"gate{tuple(gate.shape)} scale{tuple(scale.shape)} "
                         f"shift{tuple(shift.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (x, y, gate, scale, shift)):
        raise ValueError("gated_adaln kernel takes bf16 operands")
    if d % 8 or d > 4096:
        raise ValueError(f"gated_adaln kernel takes D % 8 == 0 and D <= 4096, got {d}")
    if any(t.device != x.device for t in (y, gate, scale, shift)):
        raise ValueError("gated_adaln: operands on different devices")
    x, y = x.contiguous(), y.contiguous()
    gate, scale, shift = (_row_operand(t) for t in (gate, scale, shift))
    new_x = torch.empty_like(x)
    out = torch.empty_like(x)
    err = _lib().gated_adaln_fwd(
        x.data_ptr(), y.data_ptr(), gate.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        gate.stride(0), scale.stride(0), shift.stride(0), new_x.data_ptr(), out.data_ptr(),
        b * n, n, d, EPS, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gated_adaln kernel launch failed: CUDA error {err}")
    launches += 1
    return new_x, out
