"""Determinism helpers (counterpart of `f5e_tts_tpu/utils/seed.py`;
reference: src/f5_tts/model/utils.py:17-24)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 0) -> None:
    """Seed Python's, numpy's and torch's global generators (torch's on every
    CUDA device too). The port's own draws take explicit keys (the
    sampler's noise, JAX's threefry: ops/prng.py), `torch.Generator`s
    (training) or seeds, as the JAX package takes keys; this covers library
    code that draws from the globals."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
