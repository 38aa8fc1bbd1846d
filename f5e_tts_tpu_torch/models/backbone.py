"""Backbone dispatch for the CFM layer (counterpart of
`f5e_tts_tpu/models/backbone.py`): init, the sampler's step and the
training forward, over the DiT and the MMDiT. The UNetT is not ported
yet and raises."""

from __future__ import annotations

import torch

from f5e_tts_tpu_torch.config import DiTConfig, MMDiTConfig, UNetTConfig
from f5e_tts_tpu_torch.models import dit as fdit
from f5e_tts_tpu_torch.models import mmdit as fmmdit


def backbone_kind(arch) -> str:
    """"dit" or "mmdit"; the UNetT is known but not ported."""
    if isinstance(arch, DiTConfig):
        return "dit"
    if isinstance(arch, MMDiTConfig):
        return "mmdit"
    if isinstance(arch, UNetTConfig):
        raise NotImplementedError("the UNetT backbone is not ported yet")
    raise TypeError(f"unknown arch config {type(arch)}")


def init_backbone(arch, vocab_size: int, generator: torch.Generator, device="cpu") -> dict:
    """fp32 parameters of the backbone from `generator` (backbone.py:28-34)."""
    if backbone_kind(arch) == "dit":
        return fdit.init_dit(arch, vocab_size, generator, device)
    return fmmdit.init_mmdit(arch, vocab_size, generator, device)


def uses_ppg(arch) -> bool:
    return isinstance(arch, DiTConfig) and arch.ppg.use_ppg


def precompute_text_embed(params, arch, text_ids, batch: int, seq_len: int, drop_text,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Time-independent text embedding (the reference's per-ODE text cache):
    (B, N, text_dim) for the DiT, (B, Nt, dim) at the text's own length for
    the MMDiT."""
    if backbone_kind(arch) == "dit":
        return fdit.text_embed_fn(params, arch, text_ids, batch, seq_len, drop_text,
                                  compute_dtype)
    return fmmdit.text_embed_fn(params, arch, text_ids, drop_text, compute_dtype)


def sample_step(params, arch, *, x, cond, text_embed, time, drop_audio_cond, mask=None,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One time-dependent forward with precomputed conditioning."""
    if backbone_kind(arch) == "dit":
        return fdit.dit_sample_step(params, arch, x=x, cond=cond, text_embed=text_embed,
                                    time=time, drop_audio_cond=drop_audio_cond, mask=mask,
                                    compute_dtype=compute_dtype)
    return fmmdit.mmdit_forward(params, arch, x=x, cond=cond, text_ids=None, time=time,
                                drop_audio_cond=drop_audio_cond, drop_text=None, mask=mask,
                                text_embed=text_embed, compute_dtype=compute_dtype)


def forward_train(params, arch, *, x, cond, text_ids, time, drop_audio_cond, drop_text,
                  mask=None, training: bool = False, generator=None,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Full training forward (backbone.py:69-90): the predicted flow. The
    MMDiT forward has no dropout, so `training` and `generator` reach only
    the DiT."""
    if backbone_kind(arch) == "dit":
        return fdit.dit_forward(params, arch, x=x, cond=cond, text_ids=text_ids, time=time,
                                drop_audio_cond=drop_audio_cond, drop_text=drop_text, mask=mask,
                                training=training, generator=generator,
                                compute_dtype=compute_dtype)
    return fmmdit.mmdit_forward(params, arch, x=x, cond=cond, text_ids=text_ids, time=time,
                                drop_audio_cond=drop_audio_cond, drop_text=drop_text, mask=mask,
                                compute_dtype=compute_dtype)
