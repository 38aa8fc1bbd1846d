"""Backbone dispatch for the CFM layer (counterpart of
`f5e_tts_tpu/models/backbone.py`): init, the sampler's step and the
training forward, over the DiT, the UNetT and the MMDiT."""

from __future__ import annotations

import torch

from f5e_tts_tpu_torch.config import DiTConfig, MMDiTConfig, UNetTConfig
from f5e_tts_tpu_torch.models import dit as fdit
from f5e_tts_tpu_torch.models import mmdit as fmmdit
from f5e_tts_tpu_torch.models import unett as funett


def backbone_kind(arch) -> str:
    """"dit", "unett" or "mmdit"."""
    if isinstance(arch, DiTConfig):
        return "dit"
    if isinstance(arch, UNetTConfig):
        return "unett"
    if isinstance(arch, MMDiTConfig):
        return "mmdit"
    raise TypeError(f"unknown arch config {type(arch)}")


def init_backbone(arch, vocab_size: int, key: torch.Tensor, device="cpu"):
    """fp32 parameters of the backbone from the threefry `key` (ops/prng.py),
    the JAX package's weights for the same key (backbone.py:28-34);
    (params, state) for a PPG DiT, whose state is its BatchNorms' running
    statistics (see `split_state`)."""
    kind = backbone_kind(arch)
    if kind == "dit":
        return fdit.init_dit(arch, vocab_size, key, device)
    if kind == "unett":
        return funett.init_unett(arch, vocab_size, key, device)
    return fmmdit.init_mmdit(arch, vocab_size, key, device)


def fuse_qkv(params, arch) -> dict:
    """Params whose self-attention layers hold one fused `to_qkv` projection
    (the DiT's and the UNetT's; the MMDiT's are returned as they are)."""
    kind = backbone_kind(arch)
    if kind == "dit":
        return fdit.fuse_qkv(params)
    if kind == "unett":
        return funett.fuse_qkv(params)
    return params


def attention_rows(arch, n: int) -> int:
    """The rows attention runs on for n frames, the length of the RoPE
    tables the backbone reads (`unett.attention_rows` for the UNetT)."""
    return funett.attention_rows(n) if backbone_kind(arch) == "unett" else n


def uses_ppg(arch) -> bool:
    return isinstance(arch, DiTConfig) and arch.ppg.use_ppg


def split_state(arch, made) -> tuple:
    """(params, state) of what `init_backbone` or a reference loader made for
    `arch`: a PPG DiT's pair as it is, the params of any other backbone with
    an empty state."""
    return made if uses_ppg(arch) else (made, {})


def precompute_ppg_embed(params, state, arch, ppg, batch: int, seq_len: int, drop_ppg,
                         compute_dtype=torch.bfloat16):
    """Time-independent PPG embedding of a PPG DiT in eval mode (the
    BatchNorms' running statistics), (B, N, text_dim); None for any other
    backbone."""
    if not uses_ppg(arch):
        return None
    return fdit.ppg_embed_fn(params, state, arch, ppg, batch, seq_len, drop_ppg,
                             compute_dtype=compute_dtype)[0]


def precompute_text_embed(params, arch, text_ids, batch: int, seq_len: int, drop_text,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Time-independent text embedding (the reference's per-ODE text cache):
    (B, N, text_dim) for the DiT, (B, Nt, dim) at the text's own length for
    the MMDiT."""
    kind = backbone_kind(arch)
    if kind == "dit":
        return fdit.text_embed_fn(params, arch, text_ids, batch, seq_len, drop_text,
                                  compute_dtype)
    if kind == "unett":
        return funett.text_embed_fn(params, arch, text_ids, batch, seq_len, drop_text,
                                    compute_dtype)
    return fmmdit.text_embed_fn(params, arch, text_ids, drop_text, compute_dtype)


def sample_step(params, arch, *, x, cond, text_embed, time, drop_audio_cond, mask=None,
                compute_dtype=torch.bfloat16, ppg_embed=None) -> torch.Tensor:
    """One time-dependent forward with precomputed conditioning (a PPG
    DiT's `ppg_embed` too)."""
    kind = backbone_kind(arch)
    if kind == "dit":
        return fdit.dit_sample_step(params, arch, x=x, cond=cond, text_embed=text_embed,
                                    time=time, drop_audio_cond=drop_audio_cond, mask=mask,
                                    compute_dtype=compute_dtype, ppg_embed=ppg_embed)
    if kind == "unett":
        return funett.unett_forward(params, arch, x=x, cond=cond, text_ids=None, time=time,
                                    drop_audio_cond=drop_audio_cond, drop_text=None, mask=mask,
                                    text_embed=text_embed, compute_dtype=compute_dtype)
    return fmmdit.mmdit_forward(params, arch, x=x, cond=cond, text_ids=None, time=time,
                                drop_audio_cond=drop_audio_cond, drop_text=None, mask=mask,
                                text_embed=text_embed, compute_dtype=compute_dtype)


def forward_train(params, arch, *, x, cond, text_ids, time, drop_audio_cond, drop_text,
                  mask=None, training: bool = False, rng=None,
                  compute_dtype=torch.bfloat16, return_extras: bool = False, state=None,
                  **dit_kw):
    """Full training forward (backbone.py:69-90): the predicted flow, or
    with `return_extras` (pred, DiTExtras). The UNetT and MMDiT forwards
    have no dropout, state or extra losses, so `training`, the key `rng`,
    `state` and the DiT's PPG / codebook keywords (`dit_kw`: ppg, drop_ppg,
    text_len, ppg_len, vq_temperature, draws) reach only the DiT; the
    others' extras are zero losses and `state` as given."""
    kind = backbone_kind(arch)
    if kind == "dit":
        return fdit.dit_forward(params, arch, x=x, cond=cond, text_ids=text_ids, time=time,
                                drop_audio_cond=drop_audio_cond, drop_text=drop_text, mask=mask,
                                training=training, rng=rng,
                                compute_dtype=compute_dtype, state=state,
                                return_extras=return_extras, **dit_kw)
    if kind == "unett":
        pred = funett.unett_forward(params, arch, x=x, cond=cond, text_ids=text_ids, time=time,
                                    drop_audio_cond=drop_audio_cond, drop_text=drop_text,
                                    mask=mask, compute_dtype=compute_dtype)
    else:
        pred = fmmdit.mmdit_forward(params, arch, x=x, cond=cond, text_ids=text_ids, time=time,
                                    drop_audio_cond=drop_audio_cond, drop_text=drop_text,
                                    mask=mask, compute_dtype=compute_dtype)
    if not return_extras:
        return pred
    zero = torch.zeros((), device=pred.device)
    return pred, fdit.DiTExtras(extra_loss=zero, new_state=state or {}, align_loss=zero,
                                perplex_loss=zero)
