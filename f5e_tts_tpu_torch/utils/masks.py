"""Mask helpers (counterpart of `f5e_tts_tpu/utils/masks.py`)."""

from __future__ import annotations

import torch


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """(B,) lengths -> (B, length) bool mask, True where position < length.

    reference: src/f5_tts/model/utils.py:41-46.
    """
    seq = torch.arange(length, device=lens.device)
    return seq[None, :] < lens[:, None]
