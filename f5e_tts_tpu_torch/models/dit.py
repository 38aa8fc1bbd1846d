"""DiT backbone (counterpart of `f5e_tts_tpu/models/dit.py`): the sampler's
forward with a precomputed text embedding, and the training forward
(`dit_forward`, with dropout), both differentiable through the kernels'
autograd Functions.

Parameters are nested dicts of tensors with the JAX package's names and
layouts, except that the per-block tensors are a list of `depth` dicts
instead of arrays stacked for `lax.scan`; the loop over blocks is a Python
loop. q/k features are in the half-split RoPE order (see ops/rope.py).

reference semantics: src/f5_tts/model/backbones/dit.py:183-472 and
src/f5_tts/model/modules.py:610-641 (DiTBlock).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.kernels.gated_adaln import GatedAdaLN
from f5e_tts_tpu_torch.ops import convnext as fcnx
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops.attention import attention
from f5e_tts_tpu_torch.ops.rope import rotary_cos_sin_half


# ---------------------------------------------------------------------------
# init: torch's default rules (U(+-1/sqrt(fan_in)), N(0, 1) embeddings) and
# AdaLN-zero (modulation linears and proj_out zero), as the JAX init.
# ---------------------------------------------------------------------------


_linear_init = fnn.linear_init
_conv_init = fnn.conv1d_init


def _convnext_v2_init(dim, inter, gen, device):
    return {
        "dwconv": _conv_init(dim, dim, 7, dim, gen, device),
        "norm": {"g": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device)},
        "pwconv1": _linear_init(dim, inter, gen, device),
        "grn": {"gamma": torch.zeros(inter, device=device),
                "beta": torch.zeros(inter, device=device)},
        "pwconv2": _linear_init(inter, dim, gen, device),
    }


def init_dit(cfg: DiTConfig, vocab_size: int, generator: torch.Generator,
             device="cpu") -> dict:
    """fp32 parameters of the given shapes from `generator` (on `device`)."""
    if cfg.ppg.use_ppg or cfg.codebook.use_codebook:
        raise NotImplementedError("PPG and codebook DiTs are not ported yet "
                                  "(ROADMAP queue 1 item 6)")
    text_dim = cfg.text_dim if cfg.text_dim is not None else cfg.mel_dim
    g, dev = generator, device
    inner = cfg.heads * cfg.dim_head
    ff = int(cfg.dim * cfg.ff_mult)
    params = {
        "time_embed": {"mlp1": _linear_init(256, cfg.dim, g, dev),
                       "mlp2": _linear_init(cfg.dim, cfg.dim, g, dev)},
        "text_embed": {
            "embed": {"w": torch.randn(vocab_size + 1, text_dim, generator=g, device=dev)},
            "blocks": [_convnext_v2_init(text_dim, text_dim * 2, g, dev)
                       for _ in range(cfg.conv_layers)],
        },
        "input_embed": {
            "proj": _linear_init(cfg.mel_dim * 2 + text_dim, cfg.dim, g, dev),
            "conv1": _conv_init(cfg.dim, cfg.dim, 31, 16, g, dev),
            "conv2": _conv_init(cfg.dim, cfg.dim, 31, 16, g, dev),
        },
        "blocks": [
            {
                "attn_norm": _linear_init(cfg.dim, cfg.dim * 6, g, dev, zero=True),
                "attn": {name: _linear_init(cfg.dim, inner, g, dev)
                         for name in ("to_q", "to_k", "to_v")}
                | {"to_out": _linear_init(inner, cfg.dim, g, dev)},
                "ff1": _linear_init(cfg.dim, ff, g, dev),
                "ff2": _linear_init(ff, cfg.dim, g, dev),
            }
            for _ in range(cfg.depth)
        ],
    }
    if cfg.long_skip_connection:
        params["long_skip"] = _linear_init(cfg.dim * 2, cfg.dim, g, dev, bias=False)
    params["norm_out"] = _linear_init(cfg.dim, cfg.dim * 2, g, dev, zero=True)
    params["proj_out"] = _linear_init(cfg.dim, cfg.mel_dim, g, dev, zero=True)
    return params


def fuse_qkv(params: dict, compute_dtype: Optional[torch.dtype] = None) -> dict:
    """Params whose blocks hold one fused [q|k|v] projection (`to_qkv`) in
    place of to_q/to_k/to_v, so the trunk runs one (dim, 3*inner) GEMM per
    block. Done once at load; `dit_trunk` fuses per call when it is not."""
    blocks = [{**blk, "attn": _fused_attn(blk["attn"], compute_dtype)} for blk in params["blocks"]]
    return {**params, "blocks": blocks}


def _fused_attn(attn: dict, compute_dtype: Optional[torch.dtype]) -> dict:
    if "to_qkv" in attn:
        return attn
    parts = [attn[name] for name in ("to_q", "to_k", "to_v")]
    qkv = {"w": torch.cat([p["w"] for p in parts], dim=-1)}
    if "b" in parts[0]:
        qkv["b"] = torch.cat([p["b"] for p in parts], dim=-1)
    if compute_dtype is not None:
        qkv = {k: v.to(compute_dtype) for k, v in qkv.items()}
    rest = {k: v for k, v in attn.items() if k not in ("to_q", "to_k", "to_v")}
    return {**rest, "to_qkv": qkv}


# ---------------------------------------------------------------------------
# embeddings (time-independent parts are computed once per request)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _abs_pos_table(dim: int, max_pos: int) -> torch.Tensor:
    """(max_pos, dim) fp32 table on the CPU; callers slice and copy it."""
    return torch.from_numpy(fnn.precompute_freqs_cis(dim, max_pos))


@functools.lru_cache(maxsize=16)
def _rope_tables(dim_head: int, seq_len: int, device: torch.device):
    cos, sin = rotary_cos_sin_half(dim_head, seq_len)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def time_embed(params, time: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B,) -> (B, dim): sinus(256) -> Linear -> SiLU -> Linear (modules.py:721-731)."""
    h = fnn.sinus_time_embedding(time, 256)
    h = fnn.linear(params["time_embed"]["mlp1"], h.to(compute_dtype), compute_dtype)
    return fnn.linear(params["time_embed"]["mlp2"], fnn.silu(h), compute_dtype)


def text_embed_fn(params, cfg: DiTConfig, text_ids: Optional[torch.Tensor], batch: int,
                  seq_len: int, drop_text: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Text ids (B, NT), pad -1 -> (B, N, text_dim) (dit.py:37-87).

    Ids shift by +1 (0 = filler) and are curtailed or padded to N; the padding
    mask is taken BEFORE the CFG text drop; the absolute position table and
    the ConvNeXtV2 blocks apply only when conv_layers > 0.
    """
    device = params["text_embed"]["embed"]["w"].device
    text_dim = cfg.text_dim if cfg.text_dim is not None else cfg.mel_dim
    if text_ids is None:
        ids = torch.zeros((batch, seq_len), dtype=torch.long, device=device)
        text_mask = None
    else:
        ids = text_ids.to(device=device, dtype=torch.long) + 1
        nt = ids.shape[1]
        ids = ids[:, :seq_len] if nt >= seq_len else F.pad(ids, (0, seq_len - nt))
        text_mask = ids == 0 if cfg.text_mask_padding else None
        ids = ids.masked_fill(drop_text.to(device)[:, None], 0)

    emb = fnn.embedding(params["text_embed"]["embed"], ids).to(compute_dtype)
    if cfg.conv_layers > 0:
        table = _abs_pos_table(text_dim, cfg.max_pos)[:seq_len]
        emb = emb + table.to(device=device, dtype=compute_dtype)[None]
        if text_mask is not None:
            emb = emb.masked_fill(text_mask[:, :, None], 0.0)
        for blk in params["text_embed"]["blocks"]:
            emb = fcnx.convnext_v2(blk, emb, compute_dtype=compute_dtype)
            if text_mask is not None:
                emb = emb.masked_fill(text_mask[:, :, None], 0.0)
    return emb


def input_embed_fn(params, cfg: DiTConfig, x: torch.Tensor, cond: torch.Tensor,
                   text_embed: torch.Tensor, drop_audio_cond: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Concat-project + conv position embedding: 2x (grouped conv k31, groups
    16, padding 15) + Mish, plus the residual (dit.py:159-177)."""
    ie = params["input_embed"]
    cond = cond.masked_fill(drop_audio_cond[:, None, None], 0.0).to(compute_dtype)
    h = fnn.linear(ie["proj"], torch.cat([x.to(compute_dtype), cond,
                                          text_embed.to(compute_dtype)], dim=-1), compute_dtype)
    c = fnn.mish(fnn.conv1d(ie["conv1"], h, groups=16, padding=15, compute_dtype=compute_dtype))
    c = fnn.mish(fnn.conv1d(ie["conv2"], c, groups=16, padding=15, compute_dtype=compute_dtype))
    return (c + h).to(compute_dtype)


# ---------------------------------------------------------------------------
# transformer trunk
# ---------------------------------------------------------------------------


def _dit_block(blk, x, t_emb, mask, rope_cos, rope_sin, cfg: DiTConfig,
               compute_dtype=torch.bfloat16, training: bool = False,
               generator: Optional[torch.Generator] = None):
    """One DiT block (modules.py:610-641), with K2/K5 after the attention.
    In training, dropout (cfg.dropout, drawn from `generator`) acts on the
    attention output and on the FF hidden, as in the JAX block."""
    mod = fnn.linear(blk["attn_norm"], fnn.silu(t_emb), compute_dtype)  # (B, 6D)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)

    norm = fnn.layernorm(None, x, eps=1e-6).to(compute_dtype)
    norm = norm * (1 + scale_msa[:, None, :]) + shift_msa[:, None, :]
    attn_out = attention(blk["attn"], norm, cfg.heads, mask=mask, rope_cos=rope_cos,
                         rope_sin=rope_sin, pe_attn_head=cfg.pe_attn_head, qk_norm=cfg.qk_norm,
                         compute_dtype=compute_dtype)
    attn_out = fnn.dropout(attn_out, cfg.dropout, training, generator)
    # x += gate * attn_out; LN; * (1 + scale) + shift, in one pass (K2, K5)
    x, norm = GatedAdaLN.apply(x, attn_out, gate_msa, scale_mlp, shift_mlp)
    h = fnn.linear(blk["ff1"], norm.to(compute_dtype), compute_dtype)
    h = fnn.dropout(fnn.gelu(h, approximate="tanh"), cfg.dropout, training, generator)
    h = fnn.linear(blk["ff2"], h, compute_dtype)
    return (x + gate_mlp[:, None, :] * h).to(compute_dtype)


def dit_trunk(params, cfg: DiTConfig, x, t_emb, mask, seq_len, compute_dtype=torch.bfloat16,
              training: bool = False, generator: Optional[torch.Generator] = None):
    """The blocks, the long skip when configured (the trunk's input
    concatenated to its output and projected back to dim), then the final
    AdaLN and projection; fp32 out (dit.py:459-472). Blocks without a fused
    `to_qkv` get it concatenated per call (training keeps to_q/to_k/to_v as
    the fp32 master weights)."""
    rope_cos, rope_sin = _rope_tables(cfg.dim_head, seq_len, x.device)
    residual = x
    for blk in params["blocks"]:
        if "to_qkv" not in blk["attn"]:
            blk = {**blk, "attn": _fused_attn(blk["attn"], compute_dtype)}
        x = _dit_block(blk, x, t_emb, mask, rope_cos, rope_sin, cfg, compute_dtype, training,
                       generator)
    if cfg.long_skip_connection:
        x = fnn.linear(params["long_skip"], torch.cat([x, residual], dim=-1), compute_dtype)

    # final AdaLN (modules.py:322-336): chunk order is (scale, shift)
    scale, shift = fnn.linear(params["norm_out"], fnn.silu(t_emb), compute_dtype).chunk(2, dim=-1)
    x = fnn.layernorm(None, x, eps=1e-6).to(compute_dtype)
    x = x * (1 + scale[:, None, :]) + shift[:, None, :]
    return fnn.linear(params["proj_out"], x, compute_dtype).float()


def dit_sample_step(params, cfg: DiTConfig, *, x, cond, text_embed, time, drop_audio_cond,
                    mask=None, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Inference forward with a precomputed text embedding (dit.py:417-472):
    time embedding, input embedding, trunk. (B, N, mel) fp32 out."""
    t_emb = time_embed(params, time, compute_dtype)
    h = input_embed_fn(params, cfg, x, cond, text_embed, drop_audio_cond, compute_dtype)
    return dit_trunk(params, cfg, h, t_emb, mask, x.shape[1], compute_dtype)


def dit_forward(params, cfg: DiTConfig, *, x, cond, text_ids, time, drop_audio_cond, drop_text,
                mask=None, training: bool = False, generator: Optional[torch.Generator] = None,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Training forward (dit.py:450-533, the non-PPG, non-codebook branch):
    time, text (recomputed every call) and input embeddings, then the trunk
    with dropout when `training`. (B, N, mel) fp32 out."""
    if cfg.ppg.use_ppg or cfg.codebook.use_codebook:
        raise NotImplementedError("PPG and codebook training are not ported yet "
                                  "(ROADMAP queue 1 item 6)")
    b, n, _ = x.shape
    t_emb = time_embed(params, time, compute_dtype)
    te = text_embed_fn(params, cfg, text_ids, b, n, drop_text, compute_dtype)
    h = input_embed_fn(params, cfg, x, cond, te, drop_audio_cond, compute_dtype)
    return dit_trunk(params, cfg, h, t_emb, mask, n, compute_dtype, training, generator)
