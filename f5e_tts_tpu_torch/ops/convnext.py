"""ConvNeXt blocks (counterpart of `f5e_tts_tpu/ops/convnext.py`): V2 with GRN
for the DiT text embedding, V1 with layer scale for the Vocos backbone.

reference: src/f5_tts/model/modules.py:225-269.
"""

from __future__ import annotations

import torch

from f5e_tts_tpu_torch.ops import attention as fattn
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.parallel import mesh as pmesh
from f5e_tts_tpu_torch.parallel.mesh import AllReduceBoth


def grn(p, x: torch.Tensor, channels=None) -> torch.Tensor:
    """Global Response Normalization over (B, N, D): the L2 norm runs over the
    SEQUENCE axis, then is normalised by its mean over D. `channels`
    (mesh, axis): x holds this rank's slice of D split over the axis, and
    the mean's sum is all-reduced over it."""
    xf = x.float()
    gx = torch.sqrt(torch.sum(xf.square(), dim=1, keepdim=True))  # (B, 1, D)
    if channels is None:
        mean = gx.mean(dim=-1, keepdim=True)
    else:
        mesh, axis = channels
        total = AllReduceBoth.apply(gx.sum(dim=-1, keepdim=True), mesh, axis)
        mean = total / (gx.shape[-1] * mesh.size(axis))
    nx = gx / (mean + 1e-6)
    return (p["gamma"].float() * (xf * nx) + p["beta"].float() + xf).to(x.dtype)


def convnext_v2(p, x: torch.Tensor, dilation: int = 1,
                compute_dtype: torch.dtype = torch.bfloat16,
                sharded: bool = False) -> torch.Tensor:
    """dwconv k7 -> LN -> pw1 -> exact GELU -> GRN -> pw2, plus the residual.
    `sharded`: p holds this rank's slices under the active mesh (pwconv1
    column-parallel, GRN on its channels, pwconv2 row-parallel; parallel/
    mesh.py: dit_param_spec), x is replicated."""
    tp = sharded and fattn._tp_shards() > 1
    pad = (dilation * (7 - 1)) // 2
    h = fnn.conv1d(p["dwconv"], x, groups=x.shape[-1], padding=pad, dilation=dilation,
                   compute_dtype=compute_dtype)
    h = fnn.layernorm(p["norm"], h, eps=1e-6)
    h = fnn.linear(p["pwconv1"], fattn.tp_copy(h) if tp else h, compute_dtype)
    h = fnn.gelu(h, approximate="none")
    h = grn(p["grn"], h, (pmesh.current().mesh, "model") if tp else None)
    h = fattn.row_parallel_linear(p["pwconv2"], h, compute_dtype) if tp else \
        fnn.linear(p["pwconv2"], h, compute_dtype)
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
