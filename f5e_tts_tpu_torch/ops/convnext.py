"""ConvNeXt blocks (counterpart of `f5e_tts_tpu/ops/convnext.py`): V2 with GRN
for the DiT text embedding, V1 with layer scale for the Vocos backbone.

reference: src/f5_tts/model/modules.py:225-269.
"""

from __future__ import annotations

import torch

from f5e_tts_tpu_torch.ops import nn as fnn


def grn(p, x: torch.Tensor) -> torch.Tensor:
    """Global Response Normalization over (B, N, D): the L2 norm runs over the
    SEQUENCE axis, then is normalised by its mean over D."""
    xf = x.float()
    gx = torch.sqrt(torch.sum(xf.square(), dim=1, keepdim=True))  # (B, 1, D)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return (p["gamma"].float() * (xf * nx) + p["beta"].float() + xf).to(x.dtype)


def convnext_v2(p, x: torch.Tensor, dilation: int = 1,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """dwconv k7 -> LN -> pw1 -> exact GELU -> GRN -> pw2, plus the residual."""
    pad = (dilation * (7 - 1)) // 2
    h = fnn.conv1d(p["dwconv"], x, groups=x.shape[-1], padding=pad, dilation=dilation,
                   compute_dtype=compute_dtype)
    h = fnn.layernorm(p["norm"], h, eps=1e-6)
    h = fnn.linear(p["pwconv1"], h, compute_dtype)
    h = fnn.gelu(h, approximate="none")
    h = grn(p["grn"], h)
    h = fnn.linear(p["pwconv2"], h, compute_dtype)
    return (x + h).to(x.dtype)


def convnext_v1(p, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """dwconv k7 -> LN -> pw1 -> exact GELU -> pw2 -> * gamma, plus the residual."""
    h = fnn.conv1d(p["dwconv"], x, groups=x.shape[-1], padding=3, compute_dtype=compute_dtype)
    h = fnn.layernorm(p["norm"], h, eps=1e-6)
    h = fnn.linear(p["pwconv1"], h, compute_dtype)
    h = fnn.gelu(h, approximate="none")
    h = fnn.linear(p["pwconv2"], h, compute_dtype)
    h = h * p["gamma"].to(h.dtype)
    return (x + h).to(x.dtype)
