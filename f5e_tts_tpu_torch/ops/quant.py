"""Int8 W8A8 serving quantization (counterpart of `f5e_tts_tpu/ops/quant.py`).

The four large matmuls of each trunk block (the fused qkv projection, the
attention output, the two FF layers; the MMDiT's per-stream q/k/v, out and
FF pairs; the UNetT's q/k/v, out, FF and skip projection) run as int8 x int8
products with int32 sums. Embeddings, AdaLN modulation, norms, proj_out,
attention itself and the vocoder stay in the compute dtype.

Scheme, as the JAX package's:
- weights symmetric per output channel: scale = max|w| / 127 over the
  contraction axis (at least 1e-12), codes round(w / scale) clipped to
  [-127, 127] (round half to even: `torch.round` is `np.rint`), made once
  when the params are quantized;
- activations symmetric per token, made on the fly the same way over the
  last axis;
- the int32 product, then y * s_x * w_scale + b in fp32, rounded once to
  the compute dtype.

On the card the product is `torch._int_mm` (cuBLASLt s8 x s8 -> s32). It
takes more than 16 rows and inner and outer widths that are multiples of 8,
and it is fastest with the weight operand in column-major order, so `w_q` is
stored as the (d_in, d_out) transpose of a contiguous (d_out, d_in) tensor,
and a call with 16 rows or fewer is padded with zero rows. The JAX package
leaves this product to XLA (`lax.dot_general`) outside any Pallas kernel,
so no hand-written kernel stands behind it. EXPERIMENTAL and opt-in
(`F5TTS(quantize="int8")`): quality on released weights is unmeasured.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

INT_MM_MIN_ROWS = 17  # torch._int_mm on the card takes more than 16 rows


@functools.cache
def _int8_max(device: torch.device) -> torch.Tensor:
    """127 as an fp32 tensor on `device`, made once (a graph capture reads
    it by address)."""
    return torch.full((), 127.0, device=device)


def _symmetric_int8(v: torch.Tensor, dim: int):
    """(int8 codes, fp32 scale) of fp32 `v`, symmetric over `dim`: scale =
    max|v| / 127 (at least 1e-12), codes round(v / scale) in [-127, 127].
    The 127 is a tensor on v's device: divided by a Python number, PyTorch's
    CUDA kernel multiplies by its reciprocal, an ulp off numpy's quotient,
    which would move the odd code away from the JAX package's."""
    amax = v.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax / _int8_max(v.device), min=1e-12)
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8), scale


def quantize_linear_params(p: dict) -> dict:
    """{"w": (d_in, d_out), ["b"]} -> {"w_q" int8 (d_in, d_out), stored
    column-major, "w_scale" fp32 (d_out,), ["b" fp32]}."""
    codes, scale = _symmetric_int8(p["w"].detach().float(), -2)
    out = {"w_q": codes.t().contiguous().t(), "w_scale": scale.squeeze(-2)}
    if "b" in p:
        out["b"] = p["b"].detach().float()
    return out


def _int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, padding M up to the
    card's minimum with zero rows."""
    m = x_q.shape[0]
    if x_q.is_cuda:
        if x_q.shape[1] % 8 or w_q.shape[1] % 8:
            raise ValueError(f"int8 linear on the card takes widths that are multiples of 8, "
                             f"got ({x_q.shape[1]}, {w_q.shape[1]})")
        if m < INT_MM_MIN_ROWS:
            return torch._int_mm(F.pad(x_q, (0, 0, 0, INT_MM_MIN_ROWS - m)), w_q)[:m]
    return torch._int_mm(x_q.contiguous(), w_q)


def int8_linear(p: dict, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """W8A8 x @ w + b: per-token int8 activations, an int32 product, the
    scales and bias applied in fp32, one rounding to the compute dtype (x's
    dtype when none is given)."""
    out_dtype = compute_dtype or x.dtype
    lead = x.shape[:-1]
    x_q, s_x = _symmetric_int8(x.float().reshape(-1, x.shape[-1]), -1)
    y = _int_mm(x_q, p["w_q"]).float() * s_x * p["w_scale"].float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(out_dtype).reshape(*lead, y.shape[-1])


def _quantize_keys(d: dict, names) -> dict:
    return {k: quantize_linear_params(v) if k in names else v for k, v in d.items()}


def quantize_dit_params(params: dict) -> dict:
    """The DiT trunk's to_qkv (fused first, as `dit.fuse_qkv`), to_out, ff1
    and ff2 of every block in int8; everything else as it is."""
    from f5e_tts_tpu_torch.models import dit as fdit

    if "blocks" not in params or not params["blocks"] or "attn" not in params["blocks"][0]:
        raise ValueError("quantize_dit_params takes DiT params")
    params = fdit.fuse_qkv(params)
    blocks = [{**_quantize_keys(blk, ("ff1", "ff2")),
               "attn": _quantize_keys(blk["attn"], ("to_qkv", "to_out"))}
              for blk in params["blocks"]]
    return {**params, "blocks": blocks}


_MMDIT_ATTN = ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c", "to_out", "to_out_c")
_MMDIT_FF = ("ff1_x", "ff2_x", "ff1_c", "ff2_c")


def quantize_mmdit_params(params: dict) -> dict:
    """The MMDiT's joint-attention projections of both streams (unfused, as
    its attention reads them) and its per-stream FF pairs in int8, in every
    block and the final one."""
    def block(blk: dict) -> dict:
        return {**_quantize_keys(blk, _MMDIT_FF), "attn": _quantize_keys(blk["attn"], _MMDIT_ATTN)}

    return {**params, "blocks": [block(b) for b in params["blocks"]],
            "final_block": block(params["final_block"])}


def quantize_unett_params(params: dict) -> dict:
    """The UNetT's attention projections (fused to_qkv or to_q/k/v: a column
    of the fused weight has the scale of its own projection's column, so
    both give the same codes and products), to_out, the FF pair and the
    skip projection of every layer in int8."""
    def layer(lay: dict) -> dict:
        return {**_quantize_keys(lay, ("ff1", "ff2", "skip_proj")),
                "attn": _quantize_keys(lay["attn"], ("to_qkv", "to_q", "to_k", "to_v", "to_out"))}

    return {**params, "first_half": [layer(x) for x in params["first_half"]],
            "second_half": [layer(x) for x in params["second_half"]]}


def quantize_backbone_params(params: dict, backbone: str) -> dict:
    """Dispatch on the model config's backbone name ("DiT", "MMDiT",
    "UNetT")."""
    if backbone == "DiT":
        return quantize_dit_params(params)
    if backbone == "MMDiT":
        return quantize_mmdit_params(params)
    if backbone == "UNetT":
        return quantize_unett_params(params)
    raise ValueError(f"int8 quantization: unknown backbone {backbone!r}")
