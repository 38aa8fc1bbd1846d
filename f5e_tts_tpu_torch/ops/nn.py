"""Core NN primitives over parameter dicts (counterpart of
`f5e_tts_tpu/ops/nn.py`).

Conventions, kept from the JAX package so its parameter trees load as plain
copies:
- activations are channels-last: (B, N, D);
- linear params {"w": (in, out), "b": (out,)};
- conv1d params {"w": (k, in/groups, out), "b": (out,)};
- matmuls run in the caller's compute dtype with fp32 accumulation, and the
  bias is added before the one rounding to the compute dtype;
- norms and activations compute in fp32 and round back to the input dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.ops.quant import int8_linear


def _uniform(shape, bound: float, generator, device) -> torch.Tensor:
    return (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) * bound


def linear_init(d_in: int, d_out: int, generator: torch.Generator, device="cpu",
                zero: bool = False, bias: bool = True) -> dict:
    """fp32 linear params: torch's default rule U(+-1/sqrt(fan_in)) for the
    weight and the bias (none without `bias`), or zeros (AdaLN-zero), as the
    JAX init."""
    if zero:
        return {"w": torch.zeros(d_in, d_out, device=device),
                "b": torch.zeros(d_out, device=device)}
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform((d_in, d_out), bound, generator, device)}
    if bias:
        p["b"] = _uniform((d_out,), bound, generator, device)
    return p


def conv1d_init(d_in: int, d_out: int, kernel: int, groups: int, generator: torch.Generator,
                device="cpu") -> dict:
    bound = 1.0 / math.sqrt(d_in // groups * kernel)
    return {"w": _uniform((kernel, d_in // groups, d_out), bound, generator, device),
            "b": _uniform((d_out,), bound, generator, device)}


def linear(p, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w + b with fp32 accumulation and one rounding after the bias.

    A plain bf16 `x @ w + b` would round the product before the bias add.
    On the card `addmm` hands the bias to cuBLASLt's epilogue, which adds it
    in the fp32 accumulator; on the CPU the product is formed in fp32.
    Params quantized by `ops/quant.py` ({"w_q", "w_scale"}) take its W8A8
    product (f5e_tts_tpu/ops/nn.py: linear dispatches the same way).
    """
    if "w_q" in p:
        return int8_linear(p, x, compute_dtype)
    dtype = compute_dtype or x.dtype
    w = p["w"].to(dtype)
    b = p.get("b")
    lead = x.shape[:-1]
    x2 = x.to(dtype).reshape(-1, x.shape[-1])
    if dtype == torch.float32 or x2.is_cuda:
        y = x2 @ w if b is None else torch.addmm(b.to(dtype), x2, w)
    else:
        y = x2.float() @ w.float()
        if b is not None:
            y = y + b.float()
        y = y.to(dtype)
    return y.reshape(*lead, w.shape[1])


def embedding(p, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p["w"])


def conv1d(p, x: torch.Tensor, groups: int = 1, padding="SAME", dilation: int = 1,
           stride: int = 1, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Channels-last 1-D conv: (B, N, D_in) -> (B, N_out, D_out).

    padding: "SAME" (odd k), an int, or (lo, hi). The weight is stored
    (k, in/groups, out) and viewed as torch's (out, in/groups, k).
    """
    dtype = compute_dtype or x.dtype
    w = p["w"].to(dtype)
    k = w.shape[0]
    if isinstance(padding, str):
        if padding != "SAME" or k % 2 == 0:
            raise ValueError(f"padding {padding!r} needs an odd kernel, got k={k}")
        lo = hi = dilation * (k - 1) // 2
    elif isinstance(padding, int):
        lo = hi = padding
    else:
        lo, hi = padding
    xt = F.pad(x.to(dtype).transpose(1, 2), (lo, hi))
    wt = w.permute(2, 1, 0)
    b = p.get("b")
    if dtype == torch.float32 or xt.is_cuda:
        y = F.conv1d(xt, wt, None if b is None else b.to(dtype), stride, 0, dilation, groups)
    else:
        y = F.conv1d(xt.float(), wt.float(), None if b is None else b.float(),
                     stride, 0, dilation, groups).to(dtype)
    return y.transpose(1, 2)


def layernorm(p: Optional[dict], x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in fp32 with var = mean((x - mean)^2); p=None: no affine."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["g"].float() + p["b"].float()
    return y.to(x.dtype)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with an fp32 variance (modules.py:275-294)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["g"].float()).to(x.dtype)


def batchnorm_init(dim: int, device="cpu"):
    """BatchNorm1d (params, running state): gain 1, bias 0; mean 0, var 1 and
    the update count (torch's defaults, as the JAX init)."""
    return ({"g": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device)},
            {"mean": torch.zeros(dim, device=device), "var": torch.ones(dim, device=device),
             "count": torch.zeros((), dtype=torch.int32, device=device)})


def batchnorm(p, state, x: torch.Tensor, training: bool, momentum: float = 0.1,
              eps: float = 1e-5):
    """BatchNorm over the features of (B, N, D), the statistics pooled over
    (B, N), padding included: torch.nn.BatchNorm1d on (B, D, N). Returns (y,
    new_state). Training normalises with the batch's biased variance and moves
    the running variance with the unbiased one; eval normalises with the
    running statistics and returns `state` itself. fp32 inside, y in x's
    dtype; the running statistics stay fp32 and carry no gradient
    (f5e_tts_tpu ops/nn.py:239-262)."""
    xf = x.float()
    if training:
        mean = xf.mean(dim=(0, 1))
        var = (xf - mean).square().mean(dim=(0, 1))
        n = x.shape[0] * x.shape[1]
        unbiased = var.detach() * n / max(n - 1, 1)
        new_state = {"mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
                     "var": (1 - momentum) * state["var"] + momentum * unbiased,
                     "count": state["count"] + 1}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (xf - mean) * torch.rsqrt(var + eps) * p["g"] + p["b"]
    return y.to(x.dtype), new_state


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """where(keep, x / (1 - rate), 0) with keep ~ Bernoulli(1 - rate) drawn
    from `generator` (uniform < 1 - rate, as jax.random.bernoulli), or the
    given boolean `keep` mask."""
    if not training or rate == 0.0:
        return x
    if keep is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def mish(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.tanh(F.softplus(xf))).to(x.dtype)


def gelu(x: torch.Tensor, approximate: str = "none") -> torch.Tensor:
    """GELU: "none" = exact erf, "tanh" = the tanh approximation."""
    return F.gelu(x.float(), approximate=approximate).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def sinus_time_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """(B,) -> (B, dim) = [sin | cos] (reference: modules.py:149-161)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1))
    args = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0,
                         theta_rescale_factor: float = 1.0) -> np.ndarray:
    """Absolute sinusoidal table (end, dim) = [cos | sin], float64 math,
    float32 out (reference: modules.py:196-207)."""
    theta = theta * theta_rescale_factor ** (dim / (dim - 2))
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    angles = np.outer(np.arange(end, dtype=np.float64), freqs)
    return np.concatenate([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def get_pos_embed_indices(start: torch.Tensor, length: int, max_pos: int,
                          scale=1.0) -> torch.Tensor:
    """(B,) start + arange(length) * scale, each product cast to start's
    dtype (truncated toward zero for integer starts), clipped to max_pos - 1;
    (B, length) in start's dtype (reference: src/f5_tts/model/modules.py:210-219)."""
    scale = scale * torch.ones_like(start, dtype=torch.float32)
    steps = torch.arange(length, dtype=torch.float32, device=start.device)[None, :]
    pos = start[:, None] + (steps * scale[:, None]).to(start.dtype)
    return torch.clamp(pos, max=max_pos - 1)
