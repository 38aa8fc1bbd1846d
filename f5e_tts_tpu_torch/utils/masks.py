"""Mask helpers (counterpart of `f5e_tts_tpu/utils/masks.py`)."""

from __future__ import annotations

from typing import Optional

import torch


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """(B,) lengths -> (B, length) bool mask, True where position < length.

    reference: src/f5_tts/model/utils.py:41-46.
    """
    seq = torch.arange(length, device=lens.device)
    return seq[None, :] < lens[:, None]


def mask_from_start_end_indices(start: torch.Tensor, end: torch.Tensor,
                                length: int) -> torch.Tensor:
    """(B,) start/end -> (B, length) bool mask of [start, end).

    reference: src/f5_tts/model/utils.py:49-54.
    """
    seq = torch.arange(length, device=start.device)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])


def mask_from_frac_lengths(seq_len: torch.Tensor, frac_lengths: torch.Tensor, length: int,
                           generator: Optional[torch.Generator] = None,
                           rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A random contiguous span covering `frac` of each sequence: span length
    floor(frac * len), start floor(U * (len - span)) with U uniform in [0, 1),
    taken from `rand` (B,) when given, else drawn from `generator`.

    reference: src/f5_tts/model/utils.py:57-65.
    """
    lengths = (frac_lengths.float() * seq_len.float()).to(torch.int32)
    max_start = seq_len.to(torch.int32) - lengths
    if rand is None:
        rand = torch.rand(seq_len.shape, generator=generator, device=seq_len.device)
    start = (max_start.float() * rand.to(seq_len.device).float()).to(torch.int32).clamp_min(0)
    return mask_from_start_end_indices(start, start + lengths, length)
