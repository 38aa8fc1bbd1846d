"""Gated-residual AdaLN forward (K2) and backward (K5): wrappers, plain
versions, launch counts, and the autograd Function that joins them.

Ports of f5e_tts_tpu/ops/pallas_norm.py: _gated_adaln_fwd_impl (K2) and
_gated_adaln_bwd_impl (K5). The kernels are in `csrc/gated_adaln.cu` (its
header says what bounds them and how they are built); this module checks
the operands, launches them on PyTorch's current stream and counts the
launches in `launches` (K2) and `bwd_launches` (K5) for bf16 operands, and in
`fp32_launches` and `fp32_bwd_launches` for fp32 ones (a model run with
compute_dtype float32; the TPU kernels take any element type).

    new_x = x + gate * y
    out   = LayerNorm(new_x; eps 1e-6, no affine) * (1 + scale) + shift

x, y (B, N, D); gate/scale/shift (B, D); fp32 math; both outputs in x's
dtype, with `out` computed from the fp32 new_x. Widths: D % 8 == 0 and
D <= 4096 in bf16, D % 4 == 0 and D <= 2048 in fp32 (a lane holds at most
16 vectors of 16 bytes). `GatedAdaLN.apply` is the
differentiable form the DiT block calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from f5e_tts_tpu_torch.kernels import _build

EPS = 1e-6
launches = 0  # K2 kernel launches on bf16 operands since the caller last set it to 0
bwd_launches = 0  # K5 kernel launches on bf16 operands since the caller last set it to 0
fp32_launches = 0  # K2 launches on fp32 operands
fp32_bwd_launches = 0  # K5 launches on fp32 operands
# the dtypes the kernels take: (entry-point suffix, largest D)
KERNEL_DTYPES = {torch.bfloat16: ("", 4096), torch.float32: ("_f32", 2048)}


def _math_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (so gradcheck sees exact arithmetic)."""
    return torch.promote_types(t.dtype, torch.float32)


def gated_adaln_plain(x, y, gate, scale, shift) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch (fp32 math, one rounding per output)."""
    ct = _math_dtype(x)
    new_x = x.to(ct) + gate.to(ct)[:, None, :] * y.to(ct)
    mean = new_x.mean(dim=-1, keepdim=True)
    var = (new_x - mean).square().mean(dim=-1, keepdim=True)
    norm = (new_x - mean) * torch.rsqrt(var + EPS)
    out = norm * (1.0 + scale.to(ct)[:, None, :]) + shift.to(ct)[:, None, :]
    return new_x.to(x.dtype), out.to(x.dtype)


def gated_adaln_bwd_plain(x, y, gate, scale, g_newx, g_out):
    """K5's function in plain PyTorch, as the TPU kernel computes it: row
    statistics recomputed from x, y and gate; (dx, dy) in x's and y's dtype;
    (dgate, dscale, dshift) summed over N in fp32 and returned in gate's and
    scale's dtype."""
    ct = _math_dtype(x)
    g = gate.to(ct)[:, None, :]
    yf = y.to(ct)
    new_x = x.to(ct) + g * yf
    mean = new_x.mean(dim=-1, keepdim=True)
    var = (new_x - mean).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + EPS)
    xhat = (new_x - mean) * r
    gout = g_out.to(ct)
    dxh = gout * (1.0 + scale.to(ct)[:, None, :])
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    dnx = r * (dxh - m1 - xhat * m2) + g_newx.to(ct)
    return (dnx.to(x.dtype), (dnx * g).to(y.dtype), (dnx * yf).sum(dim=1).to(gate.dtype),
            (gout * xhat).sum(dim=1).to(scale.dtype), gout.sum(dim=1).to(scale.dtype))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("gated_adaln")
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    for suffix, _ in KERNEL_DTYPES.values():
        fwd, bwd = getattr(lib, f"gated_adaln_fwd{suffix}"), getattr(lib, f"gated_adaln_bwd{suffix}")
        groups = getattr(lib, f"gated_adaln_bwd_groups{suffix}")
        fwd.argtypes = [p, p, p, p, p, ll, ll, ll, p, p, i, i, i, f, p]
        bwd.argtypes = [p, p, p, p, ll, ll, p, p, p, p, p, i, p, p, p, i, i, i, f, p]
        groups.argtypes = [i, i, i]
        fwd.restype = bwd.restype = groups.restype = i
    return lib


def _row_operand(t: torch.Tensor) -> torch.Tensor:
    """A (B, D) modulation row read through its row stride when aligned."""
    ok = (t.stride(1) == 1 and t.stride(0) * t.element_size() % 16 == 0
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _check(name: str, big, rows) -> None:
    """Device, shape, dtype and width checks shared by K2 and K5."""
    x = big[0]
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    b, n, d = x.shape
    if any(t.shape != x.shape for t in big) or any(t.shape != (b, d) for t in rows):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in (*big, *rows)]} do not match "
                         f"(B, N, D) = {tuple(x.shape)} and (B, D)")
    if x.dtype not in KERNEL_DTYPES or any(t.dtype != x.dtype for t in (*big, *rows)):
        raise ValueError(f"{name} kernel takes bf16 or fp32 operands of one dtype, got "
                         f"{[t.dtype for t in (*big, *rows)]}")
    vec, widest = 16 // x.element_size(), KERNEL_DTYPES[x.dtype][1]
    if d % vec or d > widest:
        raise ValueError(f"{name} kernel takes D % {vec} == 0 and D <= {widest} in {x.dtype}, "
                         f"got {d}")
    if b > 65535:
        raise ValueError(f"{name} kernel takes B <= 65535 (its grid's second axis), got {b}")
    if any(t.device != x.device for t in (*big, *rows)):
        raise ValueError(f"{name}: operands on different devices")


def gated_adaln(x, y, gate, scale, shift) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new_x, out) of the gated residual + AdaLN (K2). CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16 or fp32, the widths
    of the module's docstring, B <= 65535) or raise. Not differentiable: see
    `GatedAdaLN`."""
    global launches, fp32_launches
    if x.device.type == "cpu":
        return gated_adaln_plain(x, y, gate, scale, shift)
    _check("gated_adaln", (x, y), (gate, scale, shift))
    b, n, d = x.shape
    x, y = x.contiguous(), y.contiguous()
    gate, scale, shift = (_row_operand(t) for t in (gate, scale, shift))
    new_x = torch.empty_like(x)
    out = torch.empty_like(x)
    suffix = KERNEL_DTYPES[x.dtype][0]
    err = getattr(_lib(), f"gated_adaln_fwd{suffix}")(
        x.data_ptr(), y.data_ptr(), gate.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        gate.stride(0), scale.stride(0), shift.stride(0), new_x.data_ptr(), out.data_ptr(),
        b * n, n, d, EPS, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gated_adaln kernel launch failed: CUDA error {err}")
    if suffix:
        fp32_launches += 1
    else:
        launches += 1
    return new_x, out


def gated_adaln_bwd(x, y, gate, scale, g_newx, g_out):
    """(dx, dy, dgate, dscale, dshift) of the gated residual + AdaLN (K5).
    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16
    or fp32, the widths of the module's docstring) or raise."""
    global bwd_launches, fp32_bwd_launches
    if x.device.type == "cpu":
        return gated_adaln_bwd_plain(x, y, gate, scale, g_newx, g_out)
    _check("gated_adaln_bwd", (x, y, g_newx, g_out), (gate, scale))
    b, n, d = x.shape
    x, y, g_newx, g_out = (t.contiguous() for t in (x, y, g_newx, g_out))
    gate, scale = _row_operand(gate), _row_operand(scale)
    lib, suffix = _lib(), KERNEL_DTYPES[x.dtype][0]
    # blocks a sample: from the card's SM count
    groups = getattr(lib, f"gated_adaln_bwd_groups{suffix}")(b, n, d)
    if groups <= 0:
        raise RuntimeError(f"gated_adaln_bwd: planning the launch failed: CUDA error {-groups}")
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    # fp32 partial column sums of each block of rows, added in order by pass 2
    partial = torch.empty((b, groups, 3, d), dtype=torch.float32, device=x.device)
    dgate, dscale, dshift = (torch.empty((b, d), dtype=x.dtype, device=x.device)
                             for _ in range(3))
    err = getattr(lib, f"gated_adaln_bwd{suffix}")(
        x.data_ptr(), y.data_ptr(), gate.data_ptr(), scale.data_ptr(), gate.stride(0),
        scale.stride(0), g_newx.data_ptr(), g_out.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        partial.data_ptr(), groups, dgate.data_ptr(), dscale.data_ptr(), dshift.data_ptr(), b, n,
        d, EPS, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gated_adaln_bwd kernel launch failed: CUDA error {err}")
    if suffix:
        fp32_bwd_launches += 1
    else:
        bwd_launches += 1
    return dx, dy, dgate, dscale, dshift


class GatedAdaLN(torch.autograd.Function):
    """Differentiable (new_x, out): K2 forward, K5 backward (their plain
    versions for CPU tensors). Saves x, y, gate and scale, as the TPU
    custom_vjp saves its inputs."""

    @staticmethod
    def forward(ctx, x, y, gate, scale, shift):
        ctx.save_for_backward(x, y, gate, scale)
        return gated_adaln(x, y, gate, scale, shift)

    @staticmethod
    def backward(ctx, g_newx, g_out):
        x, y, gate, scale = ctx.saved_tensors
        g_newx = torch.zeros_like(x) if g_newx is None else g_newx
        g_out = torch.zeros_like(x) if g_out is None else g_out
        return gated_adaln_bwd(x, y, gate, scale, g_newx, g_out)
