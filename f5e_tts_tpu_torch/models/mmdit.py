"""MMDiT backbone (counterpart of `f5e_tts_tpu/models/mmdit.py`): an
SD3-style dual-stream transformer whose blocks attend jointly over the keys
[audio | text].

The text stream keeps its own length (it is not padded to the mel length);
the last block is `context_pre_only`: a 2-way modulation of the text stream,
no text output projection and no text feed-forward. Parameters are nested
dicts of tensors with the JAX package's names and layouts, except that the
first depth-1 blocks are a list of per-block dicts (`blocks`) instead of
arrays stacked for `lax.scan`; the loop over them is a Python loop, and
`final_block` runs after it. q/k features of both streams are in the
half-split RoPE order (see ops/rope.py). The forward applies no dropout,
as the JAX forward applies none.

reference: src/f5_tts/model/backbones/mmdit.py:84-188 and
src/f5_tts/model/modules.py:647-715 (MMDiTBlock).
"""

from __future__ import annotations

from typing import Optional

import torch

from f5e_tts_tpu_torch.config import MMDiTConfig
from f5e_tts_tpu_torch.models.dit import _abs_pos_table, _rope_tables, time_embed
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops import prng
from f5e_tts_tpu_torch.ops.attention import joint_attention, joint_attention_init

TEXT_MAX_POS = 1024  # rows of the text stream's absolute position table (mmdit.py:29-37)


def init_mmdit(cfg: MMDiTConfig, vocab_size: int, key: torch.Tensor, device="cpu") -> dict:
    """fp32 parameters of the given shapes from the threefry `key` (on
    `device`): torch's default rules and AdaLN-zero under the JAX init's key
    chain (models/mmdit.py:23-59: `key` split in 8 + 2 depth and consumed in
    order; a block's key serves its joint attention, and its FF linears
    take fold_in(key, 1..4))."""
    keys, dev = iter(prng.split(key, 8 + 2 * cfg.depth)), device
    ff = int(cfg.dim * cfg.ff_mult)
    lin = fnn.linear_init

    def block(k, context_pre_only: bool) -> dict:
        blk = {
            "attn_norm_x": lin(cfg.dim, cfg.dim * 6, None, dev, zero=True),
            "attn_norm_c": lin(cfg.dim, cfg.dim * (2 if context_pre_only else 6), None, dev,
                               zero=True),
            "attn": joint_attention_init(cfg.dim, cfg.dim, cfg.heads, cfg.dim_head, k, dev,
                                         context_pre_only=context_pre_only,
                                         qk_norm=cfg.qk_norm),
            "ff1_x": lin(cfg.dim, ff, prng.fold_in(k, 1), dev),
            "ff2_x": lin(ff, cfg.dim, prng.fold_in(k, 2), dev),
        }
        if not context_pre_only:
            blk["ff1_c"] = lin(cfg.dim, ff, prng.fold_in(k, 3), dev)
            blk["ff2_c"] = lin(ff, cfg.dim, prng.fold_in(k, 4), dev)
        return blk

    params = {
        "time_embed": {"mlp1": lin(256, cfg.dim, next(keys), dev),
                       "mlp2": lin(cfg.dim, cfg.dim, next(keys), dev)},
        "text_embed": {"embed": fnn.embedding_init(vocab_size + 1, cfg.dim, next(keys), dev)},
        "audio_embed": {
            "proj": lin(cfg.mel_dim * 2, cfg.dim, next(keys), dev),
            "conv1": fnn.conv1d_init(cfg.dim, cfg.dim, 31, 16, next(keys), dev),
            "conv2": fnn.conv1d_init(cfg.dim, cfg.dim, 31, 16, next(keys), dev),
        },
    }
    params["blocks"] = [block(next(keys), False) for _ in range(cfg.depth - 1)]
    params["final_block"] = block(next(keys), True)
    params["norm_out"] = lin(cfg.dim, cfg.dim * 2, None, dev, zero=True)
    params["proj_out"] = lin(cfg.dim, cfg.mel_dim, None, dev, zero=True)
    return params


def text_embed_fn(params, cfg: MMDiTConfig, text_ids: torch.Tensor, drop_text: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Text ids (B, Nt), pad -1 -> (B, Nt, dim), at the text's own length
    (mmdit.py:39-60). Ids shift by +1 (0 = filler); the padding mask is taken
    before the CFG text drop, which zeroes the ids and keeps the length."""
    device = params["text_embed"]["embed"]["w"].device
    ids = text_ids.to(device=device, dtype=torch.long) + 1
    text_mask = ids == 0
    ids = ids.masked_fill(drop_text.to(device)[:, None], 0)
    emb = fnn.embedding(params["text_embed"]["embed"], ids).to(compute_dtype)
    table = _abs_pos_table(cfg.dim, TEXT_MAX_POS)[: ids.shape[1]]
    emb = emb + table.to(device=device, dtype=compute_dtype)[None]
    return emb.masked_fill(text_mask[:, :, None], 0.0)


def audio_embed_fn(params, x: torch.Tensor, cond: torch.Tensor, drop_audio_cond: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Concat-project noised mel and cond, then the conv position embedding
    (2x grouped conv k31 + Mish) with its residual (mmdit.py:66-78)."""
    ae = params["audio_embed"]
    cond = cond.masked_fill(drop_audio_cond[:, None, None], 0.0).to(compute_dtype)
    h = fnn.linear(ae["proj"], torch.cat([x.to(compute_dtype), cond], dim=-1), compute_dtype)
    c = fnn.mish(fnn.conv1d(ae["conv1"], h, groups=16, padding=15, compute_dtype=compute_dtype))
    c = fnn.mish(fnn.conv1d(ae["conv2"], c, groups=16, padding=15, compute_dtype=compute_dtype))
    return (c + h).to(compute_dtype)


def _modulated_norm(x, scale, shift, compute_dtype):
    norm = fnn.layernorm(None, x, eps=1e-6).to(compute_dtype)
    return norm * (1 + scale[:, None, :]) + shift[:, None, :]


def _feed_forward(blk, suffix: str, x, compute_dtype):
    h = fnn.gelu(fnn.linear(blk[f"ff1_{suffix}"], x, compute_dtype), approximate="tanh")
    return fnn.linear(blk[f"ff2_{suffix}"], h, compute_dtype)


def _mmdit_block(blk, x, c, t_emb, mask, rope, c_rope, cfg: MMDiTConfig, context_pre_only: bool,
                 compute_dtype=torch.bfloat16):
    """One MMDiT block (modules.py:687-715): returns (x, c); c is None after
    the `context_pre_only` block."""
    act = fnn.silu(t_emb)
    mod_c = fnn.linear(blk["attn_norm_c"], act, compute_dtype)
    if context_pre_only:
        scale_c, shift_c = mod_c.chunk(2, dim=-1)
    else:
        shift_c, scale_c, gate_c, shift_mlp_c, scale_mlp_c, gate_mlp_c = mod_c.chunk(6, dim=-1)
    shift_x, scale_x, gate_x, shift_mlp_x, scale_mlp_x, gate_mlp_x = fnn.linear(
        blk["attn_norm_x"], act, compute_dtype).chunk(6, dim=-1)

    x_attn, c_attn = joint_attention(
        blk["attn"], _modulated_norm(x, scale_x, shift_x, compute_dtype),
        _modulated_norm(c, scale_c, shift_c, compute_dtype), cfg.heads, mask=mask,
        rope_cos=rope[0], rope_sin=rope[1], c_rope_cos=c_rope[0], c_rope_sin=c_rope[1],
        context_pre_only=context_pre_only, qk_norm=cfg.qk_norm, compute_dtype=compute_dtype)

    if context_pre_only:
        c = None
    else:
        c = c + gate_c[:, None, :] * c_attn
        norm_c = _modulated_norm(c, scale_mlp_c, shift_mlp_c, compute_dtype)
        c = (c + gate_mlp_c[:, None, :] * _feed_forward(blk, "c", norm_c, compute_dtype)
             ).to(compute_dtype)

    x = x + gate_x[:, None, :] * x_attn
    norm_x = _modulated_norm(x, scale_mlp_x, shift_mlp_x, compute_dtype)
    x = x + gate_mlp_x[:, None, :] * _feed_forward(blk, "x", norm_x, compute_dtype)
    return x.to(compute_dtype), c


def mmdit_forward(params, cfg: MMDiTConfig, *, x, cond, text_ids: Optional[torch.Tensor], time,
                  drop_audio_cond, drop_text, mask: Optional[torch.Tensor] = None,
                  text_embed: Optional[torch.Tensor] = None,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The MMDiT forward (mmdit.py:147-188), (B, N, mel) fp32 out. The text
    embedding is `text_embed` (B, Nt, dim) when given (the sampler computes it
    once), else computed from `text_ids` and `drop_text`. With a padding
    `mask` (B, N) the blocks run the joint-mask attention kernel; without one
    (training) every key is valid."""
    n = x.shape[1]
    t_emb = time_embed(params, time, compute_dtype)
    if text_embed is None:
        text_embed = text_embed_fn(params, cfg, text_ids, drop_text, compute_dtype)
    c = text_embed
    h = audio_embed_fn(params, x, cond, drop_audio_cond, compute_dtype)
    rope = _rope_tables(cfg.dim_head, n, x.device)
    c_rope = _rope_tables(cfg.dim_head, c.shape[1], x.device)

    for blk in params["blocks"]:
        h, c = _mmdit_block(blk, h, c, t_emb, mask, rope, c_rope, cfg, False, compute_dtype)
    h, _ = _mmdit_block(params["final_block"], h, c, t_emb, mask, rope, c_rope, cfg, True,
                        compute_dtype)

    scale, shift = fnn.linear(params["norm_out"], fnn.silu(t_emb), compute_dtype).chunk(2, dim=-1)
    h = _modulated_norm(h, scale, shift, compute_dtype)
    return fnn.linear(params["proj_out"], h, compute_dtype).float()
