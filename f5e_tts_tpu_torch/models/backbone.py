"""Backbone dispatch for the CFM layer (counterpart of
`f5e_tts_tpu/models/backbone.py`): init, the sampler's step and the
training forward. Only the DiT is ported; UNetT and MMDiT raise until their
slice lands."""

from __future__ import annotations

import torch

from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.models import dit as fdit


def _require_dit(arch) -> None:
    if not isinstance(arch, DiTConfig):
        raise NotImplementedError(f"backbone {type(arch).__name__} is not ported yet")


def init_backbone(arch, vocab_size: int, generator: torch.Generator, device="cpu") -> dict:
    """fp32 parameters of the backbone from `generator` (backbone.py:28-34)."""
    _require_dit(arch)
    return fdit.init_dit(arch, vocab_size, generator, device)


def uses_ppg(arch) -> bool:
    return isinstance(arch, DiTConfig) and arch.ppg.use_ppg


def precompute_text_embed(params, arch, text_ids, batch: int, seq_len: int, drop_text,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Time-independent text embedding (the reference's per-ODE text cache)."""
    _require_dit(arch)
    return fdit.text_embed_fn(params, arch, text_ids, batch, seq_len, drop_text, compute_dtype)


def sample_step(params, arch, *, x, cond, text_embed, time, drop_audio_cond, mask=None,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One time-dependent forward with precomputed conditioning."""
    _require_dit(arch)
    return fdit.dit_sample_step(params, arch, x=x, cond=cond, text_embed=text_embed, time=time,
                                drop_audio_cond=drop_audio_cond, mask=mask,
                                compute_dtype=compute_dtype)


def forward_train(params, arch, *, x, cond, text_ids, time, drop_audio_cond, drop_text,
                  mask=None, training: bool = False, generator=None,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Full training forward (backbone.py:69-79), DiT only: the predicted flow."""
    _require_dit(arch)
    return fdit.dit_forward(params, arch, x=x, cond=cond, text_ids=text_ids, time=time,
                            drop_audio_cond=drop_audio_cond, drop_text=drop_text, mask=mask,
                            training=training, generator=generator, compute_dtype=compute_dtype)
