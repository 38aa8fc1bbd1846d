"""UNetT backbone, the E2-TTS flat UNet transformer (counterpart of
`f5e_tts_tpu/models/unett.py`).

- The time embedding is packed as sequence row 0, so attention runs on N+1
  rows, the mask gains one True in front and the RoPE tables are N+1 long:
  audio frame i rotates at position i+1.
- Pre-norm blocks with x_transformers' RMSNorm (eps 1e-12):
  x = attn(norm(x)) + x; x = ff(norm(x)) + x.
- UNet skips: each layer of the first half pushes its input; each layer of
  the second half pops one (LIFO) and merges it by concat + `skip_proj`, by
  add, or not at all (`skip_connect_type`).
- No AdaLN and no dropout: the JAX forward takes no `training`/`rng`.

Parameters are nested dicts with the JAX package's names and layouts, except
that each half is a list of per-layer dicts (`first_half`, `second_half`)
instead of arrays stacked for `lax.scan`.

reference semantics: src/f5_tts/model/backbones/unett.py:106-250.
"""

from __future__ import annotations

from typing import Optional

import torch

from f5e_tts_tpu_torch.config import DiTConfig, UNetTConfig
from f5e_tts_tpu_torch.models import dit as fdit
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops.attention import attention

RMS_EPS = 1e-12  # x_transformers' RMSNorm


def init_unett(cfg: UNetTConfig, vocab_size: int, generator: torch.Generator,
               device="cpu") -> dict:
    """fp32 parameters of the given shapes from `generator` (on `device`):
    torch's default rules, RMSNorm gains of one, as the JAX init."""
    if cfg.depth % 2:
        raise ValueError(f"UNetT depth must be even, got {cfg.depth}")
    text_dim = cfg.text_dim if cfg.text_dim is not None else cfg.mel_dim
    g, dev = generator, device
    inner = cfg.heads * cfg.dim_head
    ff = int(cfg.dim * cfg.ff_mult)
    lin, ones = fnn.linear_init, lambda d: {"g": torch.ones(d, device=dev)}

    def layer(with_skip_proj: bool) -> dict:
        attn = {name: lin(cfg.dim, inner, g, dev) for name in ("to_q", "to_k", "to_v")}
        attn["to_out"] = lin(inner, cfg.dim, g, dev)
        if cfg.qk_norm == "rms_norm":
            attn["q_norm"], attn["k_norm"] = ones(cfg.dim_head), ones(cfg.dim_head)
        p = {"attn_norm": ones(cfg.dim), "attn": attn, "ff_norm": ones(cfg.dim),
             "ff1": lin(cfg.dim, ff, g, dev), "ff2": lin(ff, cfg.dim, g, dev)}
        if with_skip_proj:
            p["skip_proj"] = lin(cfg.dim * 2, cfg.dim, g, dev, bias=False)
        return p

    half = cfg.depth // 2
    return {
        "time_embed": {"mlp1": lin(256, cfg.dim, g, dev), "mlp2": lin(cfg.dim, cfg.dim, g, dev)},
        "text_embed": {
            "embed": {"w": torch.randn(vocab_size + 1, text_dim, generator=g, device=dev)},
            "blocks": [fdit._convnext_v2_init(text_dim, text_dim * 2, g, dev)
                       for _ in range(cfg.conv_layers)],
        },
        "input_embed": {
            "proj": lin(cfg.mel_dim * 2 + text_dim, cfg.dim, g, dev),
            "conv1": fnn.conv1d_init(cfg.dim, cfg.dim, 31, 16, g, dev),
            "conv2": fnn.conv1d_init(cfg.dim, cfg.dim, 31, 16, g, dev),
        },
        "first_half": [layer(False) for _ in range(half)],
        "second_half": [layer(cfg.skip_connect_type == "concat") for _ in range(half)],
        "norm_out": ones(cfg.dim),
        "proj_out": lin(cfg.dim, cfg.mel_dim, g, dev),
    }


def fuse_qkv(params: dict) -> dict:
    """Params whose layers hold one fused [q|k|v] projection (`to_qkv`), as
    `dit.fuse_qkv` does for the DiT's blocks; unfused layers are fused per
    call."""
    def fused(layers):
        return [{**layer, "attn": fdit._fused_attn(layer["attn"], None)} for layer in layers]

    return {**params, "first_half": fused(params["first_half"]),
            "second_half": fused(params["second_half"])}


def attention_rows(n: int) -> int:
    """The rows attention runs on for n frames: the time token is row 0."""
    return n + 1


def _dit_shim(cfg: UNetTConfig) -> DiTConfig:
    return DiTConfig(text_dim=cfg.text_dim if cfg.text_dim is not None else cfg.mel_dim,
                     mel_dim=cfg.mel_dim, conv_layers=cfg.conv_layers,
                     text_mask_padding=cfg.text_mask_padding, max_pos=cfg.max_pos)


def text_embed_fn(params, cfg: UNetTConfig, text_ids: Optional[torch.Tensor], batch: int,
                  seq_len: int, drop_text: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The DiT's text embedding (unett.py:35-82), (B, N, text_dim)."""
    return fdit.text_embed_fn(params, _dit_shim(cfg), text_ids, batch, seq_len, drop_text,
                              compute_dtype)


def _unett_layer(layer, x, mask, rope_cos, rope_sin, cfg: UNetTConfig, compute_dtype):
    if "to_qkv" not in layer["attn"]:
        layer = {**layer, "attn": fdit._fused_attn(layer["attn"], compute_dtype)}
    h = fnn.rmsnorm(layer["attn_norm"], x, eps=RMS_EPS)
    h = attention(layer["attn"], h.to(compute_dtype), cfg.heads, mask=mask, rope_cos=rope_cos,
                  rope_sin=rope_sin, pe_attn_head=cfg.pe_attn_head, qk_norm=cfg.qk_norm,
                  compute_dtype=compute_dtype)
    x = x + h
    h = fnn.rmsnorm(layer["ff_norm"], x, eps=RMS_EPS)
    h = fnn.linear(layer["ff1"], h.to(compute_dtype), compute_dtype)
    h = fnn.linear(layer["ff2"], fnn.gelu(h, approximate="tanh"), compute_dtype)
    return (x + h).to(compute_dtype)


def unett_forward(params, cfg: UNetTConfig, *, x, cond, text_ids, time, drop_audio_cond,
                  drop_text, mask=None, text_embed=None,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Forward (unett.py:184-250): (B, N, mel) fp32 out. `text_embed` is the
    precomputed text embedding (the sampler's cache), else it is computed
    from `text_ids` and `drop_text`."""
    b, n, _ = x.shape
    t_emb = fdit.time_embed(params, time, compute_dtype)
    if text_embed is None:
        text_embed = text_embed_fn(params, cfg, text_ids, b, n, drop_text, compute_dtype)
    h = fdit.input_embed_fn(params, cfg, x, cond, text_embed, drop_audio_cond, compute_dtype)

    # the time token at row 0 (unett.py:215-217)
    h = torch.cat([t_emb[:, None, :].to(compute_dtype), h], dim=1)
    if mask is not None:
        mask = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=mask.device), mask], dim=1)
    rope_cos, rope_sin = fdit._rope_tables(cfg.dim_head, attention_rows(n), h.device)

    skips = []
    for layer in params["first_half"]:
        skips.append(h)
        h = _unett_layer(layer, h, mask, rope_cos, rope_sin, cfg, compute_dtype)
    for layer in params["second_half"]:
        skip = skips.pop()
        if cfg.skip_connect_type == "concat":
            h = fnn.linear(layer["skip_proj"], torch.cat([h, skip], dim=-1), compute_dtype)
        elif cfg.skip_connect_type == "add":
            h = h + skip
        h = _unett_layer(layer, h, mask, rope_cos, rope_sin, cfg, compute_dtype)

    h = fnn.rmsnorm(params["norm_out"], h, eps=RMS_EPS)[:, 1:, :]  # drop the time token
    return fnn.linear(params["proj_out"], h.to(compute_dtype), compute_dtype).float()
