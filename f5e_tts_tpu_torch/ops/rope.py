"""Rotary position embeddings in the half-split (NeoX) order (counterpart of
the half-split half of `f5e_tts_tpu/ops/rope.py`).

The reference (x_transformers) rotates interleaved pairs (2j, 2j+1). The port,
like the JAX package, keeps q/k features per head permuted so pair j sits at
(j, j + dh/2): attention scores are unchanged (q.k is invariant under a
shared permutation) and rotate-half is one contiguous split. The weight
loaders apply `permute_qk_*` at ingest; `unpermute_qk_*` reverse it.
"""

from __future__ import annotations

import numpy as np
import torch


def half_split_perm(dim_head: int) -> np.ndarray:
    """perm[j] = 2j for j < d/2 else 2(j - d/2) + 1; new[j] = old[perm[j]]."""
    return np.concatenate([np.arange(0, dim_head, 2), np.arange(1, dim_head, 2)])


def permute_qk_weight(w: np.ndarray, heads: int) -> np.ndarray:
    """Permute the per-head output features of an (in, heads*dh) q/k weight."""
    d_in, inner = w.shape
    perm = half_split_perm(inner // heads)
    return np.ascontiguousarray(w.reshape(d_in, heads, -1)[:, :, perm].reshape(d_in, inner))


def permute_qk_bias(b: np.ndarray, heads: int) -> np.ndarray:
    inner = b.shape[-1]
    perm = half_split_perm(inner // heads)
    return np.ascontiguousarray(b.reshape(heads, -1)[:, perm].reshape(inner))


def unpermute_qk_weight(w: np.ndarray, heads: int) -> np.ndarray:
    d_in, inner = w.shape
    inv = np.argsort(half_split_perm(inner // heads))
    return np.ascontiguousarray(w.reshape(d_in, heads, -1)[:, :, inv].reshape(d_in, inner))


def unpermute_qk_bias(b: np.ndarray, heads: int) -> np.ndarray:
    inner = b.shape[-1]
    inv = np.argsort(half_split_perm(inner // heads))
    return np.ascontiguousarray(b.reshape(heads, -1)[:, inv].reshape(inner))


def rotary_cos_sin_half(dim_head: int, max_pos: int, theta: float = 10000.0):
    """Half-split tables (max_pos, dim_head) = [c | c], [s | s], float32."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim_head, 2).astype(np.float64) / dim_head))
    freqs = np.outer(np.arange(max_pos, dtype=np.float64), inv_freq)
    freqs = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def rot_half(x: torch.Tensor) -> torch.Tensor:
    """concat(-x[d/2:], x[:d/2]) over the last axis."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x * cos + rot_half(x) * sin in fp32, rounded back to x's dtype."""
    xf = x.float()
    return (xf * cos + rot_half(xf) * sin).to(x.dtype)
