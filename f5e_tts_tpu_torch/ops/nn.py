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

from f5e_tts_tpu_torch.kernels import threefry as fthreefry
from f5e_tts_tpu_torch.ops import prng
from f5e_tts_tpu_torch.ops.quant import int8_linear
from f5e_tts_tpu_torch.parallel import mesh as pmesh


def _uniform(shape, bound: float, key, device) -> torch.Tensor:
    """U[-bound, bound) f32: `jax.random.uniform(key, shape, minval=-bound,
    maxval=bound)` for a threefry key (on the card through the kernel), or
    torch's draw from a `torch.Generator` (the nets whose seeded init is not
    on JAX's threefry yet: the PPG front end and the nets beside it)."""
    if isinstance(key, torch.Generator):
        return (torch.rand(shape, generator=key, device=device) * 2.0 - 1.0) * bound
    return fthreefry.uniform(key, shape, device, -bound, bound)


def _split2(key):
    """(weight key, bias key) as JAX's initialisers split them; a generator
    serves both draws in turn."""
    if isinstance(key, torch.Generator):
        return key, key
    kw, kb = prng.split(key)
    return kw, kb


def linear_init(d_in: int, d_out: int, key, device="cpu", zero: bool = False,
                bias: bool = True) -> dict:
    """fp32 linear params: torch's default rule U(+-1/sqrt(fan_in)) for the
    weight and the bias (none without `bias`), or zeros (AdaLN-zero), as the
    JAX init (ops/nn.py: linear_init, linear_zero_init): `key` split into the
    weight's and the bias's."""
    if zero:
        return {"w": torch.zeros(d_in, d_out, device=device),
                "b": torch.zeros(d_out, device=device)}
    bound = 1.0 / math.sqrt(d_in)
    kw, kb = _split2(key)
    p = {"w": _uniform((d_in, d_out), bound, kw, device)}
    if bias:
        p["b"] = _uniform((d_out,), bound, kb, device)
    return p


def embedding_init(num: int, dim: int, key, device="cpu") -> dict:
    """torch.nn.Embedding's default N(0, 1) (JAX ops/nn.py: embedding_init)."""
    return {"w": fthreefry.normal(key, (num, dim), device)}


def conv1d_init(d_in: int, d_out: int, kernel: int, groups: int, key, device="cpu",
                bias: bool = True) -> dict:
    """torch.nn.Conv1d's default rule U(+-1/sqrt(in/groups * k)) for the
    weight (k, in/groups, out) and the bias (none without `bias`)."""
    bound = 1.0 / math.sqrt(d_in // groups * kernel)
    kw, kb = _split2(key)
    p = {"w": _uniform((kernel, d_in // groups, d_out), bound, kw, device)}
    if bias:
        p["b"] = _uniform((d_out,), bound, kb, device)
    return p


def conv_transpose1d_init(d_in: int, d_out: int, kernel: int, key, device="cpu") -> dict:
    """A transposed conv's params in the pre-flipped (k, in, out) layout of
    `conv_transpose1d`, drawn by torch.nn.ConvTranspose1d's default rule:
    its fan-in is out_channels * k, so U(+-1/sqrt(out * k)) for the weight
    and the bias (f5e_tts_tpu ops/nn.py:222-230)."""
    bound = 1.0 / math.sqrt(d_out * kernel)
    kw, kb = _split2(key)
    return {"w": _uniform((kernel, d_in, d_out), bound, kw, device),
            "b": _uniform((d_out,), bound, kb, device)}


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


def conv_transpose1d(p, x: torch.Tensor, stride: int, padding: int = 0,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Channels-last transposed conv: (B, N, C_in) -> (B, (N - 1) * stride -
    2 * padding + k, C_out).

    p["w"] is stored pre-flipped as (k, C_in, C_out), as the JAX package
    keeps it (its loader flips torch's (in, out, k) ConvTranspose1d kernel),
    where the JAX op zero-stuffs and runs a tap conv with k - 1 - padding on
    each side. This is torch's transposed conv of the unflipped kernel
    `w.flip(0).permute(1, 2, 0)`, which gives the same output length
    (f5e_tts_tpu ops/nn.py:197-219)."""
    dtype = compute_dtype or x.dtype
    w = p["w"].to(dtype).flip(0).permute(1, 2, 0)
    b = p.get("b")
    xt = x.to(dtype).transpose(1, 2)
    if dtype == torch.float32 or xt.is_cuda:
        y = F.conv_transpose1d(xt, w, None if b is None else b.to(dtype), stride, padding)
    else:
        y = F.conv_transpose1d(xt.float(), w.float(), None if b is None else b.float(), stride,
                               padding).to(dtype)
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
    (f5e_tts_tpu ops/nn.py:239-262).

    Under a batch mesh (parallel/mesh.py: batch_mesh) the statistics are the
    global batch's, as the JAX function's under pjit: the per-feature sums
    (of x, then of the centred squares) are all-reduced over the batch axes
    and divided by the global count, and their backward sums the gradients
    over the ranks (SyncBatchNorm's rule: every shard's loss reads them).
    The running statistics are then the same on every rank."""
    xf = x.float()
    if training:
        bm = pmesh.batch_mesh()
        if bm is None:
            mean = xf.mean(dim=(0, 1))
            var = (xf - mean).square().mean(dim=(0, 1))
            n = x.shape[0] * x.shape[1]
        else:
            n = x.shape[0] * x.shape[1] * bm.size(pmesh.BATCH_AXES)
            pooled = lambda t: pmesh.AllReduceBoth.apply(  # noqa: E731
                t.sum(dim=(0, 1)), bm, pmesh.BATCH_AXES) / n
            mean = pooled(xf)
            var = pooled((xf - mean).square())
        unbiased = var.detach() * n / max(n - 1, 1)
        new_state = {"mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
                     "var": (1 - momentum) * state["var"] + momentum * unbiased,
                     "count": state["count"] + 1}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (xf - mean) * torch.rsqrt(var + eps) * p["g"] + p["b"]
    return y.to(x.dtype), new_state


def dropout(key, x: torch.Tensor, rate: float, training: bool,
            global_shape=None, offset=None, keep: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """The JAX package's dropout (ops/nn.py:264-268): where(keep, x / c, 0)
    with keep ~ bernoulli(key, 1 - rate, x.shape) and c = 1 - rate rounded to
    x's dtype (see `prng.dropout`), through the threefry kernel on the card
    (`ThreefryDropout`: its backward draws the same mask again). `x` may be
    the block of a larger array at `offset` of `global_shape` (a rank's part
    of a sharded activation), and then draws its part of the larger
    array's mask. A given boolean `keep` mask replaces the draw."""
    if not training or rate == 0.0:
        return x
    if keep is not None:
        return prng.scaled_where(keep.to(x.device), x, rate)
    return fthreefry.ThreefryDropout.apply(x, key, rate, global_shape, offset)


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
