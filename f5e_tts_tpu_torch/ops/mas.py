"""Monotonic alignment search (counterpart of `f5e_tts_tpu/ops/mas.py`;
reference: src/f5_tts/durpred/monotonic_align/core.py:14-46).

The reference runs a numba DP on the host. Here, as in the JAX package, the
DP and its backtrack run on the tensor's device, each a loop over the T_y
rows vectorised over the batch and the T_x columns: 2 * T_y small steps,
bound by the host's launch rate on a card.

`value` is (B, T_y, T_x) with y = dim 1 (PPG frames) and x = dim 2 (text
tokens); `t_ys` / `t_xs` are each sample's valid lengths. The path is (B,
T_y, T_x), one-hot in every valid row, monotonic non-decreasing in x, ending
at (t_y - 1, t_x - 1).
"""

from __future__ import annotations

import math

import torch

_NEG = -1e9


@torch.no_grad()
def maximum_path(value: torch.Tensor, t_ys: torch.Tensor, t_xs: torch.Tensor) -> torch.Tensor:
    """The monotonic maximum path, fp32 {0, 1} (B, T_y, T_x).

    Forward DP (core.py:26-39), row y over the band max(0, t_x + y - t_y) <= x
    <= min(t_x - 1, y): value[y, x] += max(value[y-1, x-1] (0 at y = x = 0,
    -inf at x = 0 otherwise), value[y-1, x] (-inf at x = y)). Backtrack
    (core.py:41-46) from x = t_x - 1 down the rows: mark (y, x), then step
    to x - 1 when x != 0 and (x == y or cum[y-1, x] < cum[y-1, x-1]); rows
    at or past t_y are zero.
    """
    b, t_y, t_x = value.shape
    dev = value.device
    value = value.float()
    t_ys, t_xs = t_ys.to(dev, torch.long), t_xs.to(dev, torch.long)
    xs = torch.arange(t_x, device=dev)[None, :]

    cum = torch.empty((b, t_y, t_x), device=dev)
    prev = torch.full((b, t_x), _NEG, device=dev)
    lo = t_xs[:, None] - t_ys[:, None]  # + y: the band's lower edge
    for y in range(t_y):
        v_cur = prev.masked_fill(xs == y, _NEG)
        v_prev = torch.roll(prev, 1, dims=-1)
        v_prev[:, 0] = 0.0 if y == 0 else _NEG
        in_band = (xs >= (lo + y).clamp(min=0)) & (xs < t_xs[:, None].clamp(max=y + 1))
        row = value[:, y]
        prev = torch.where(in_band, row + torch.maximum(v_prev, v_cur), row)
        cum[:, y] = prev

    path = torch.zeros((b, t_y, t_x), device=dev)
    index = t_xs - 1
    rows = torch.arange(b, device=dev)
    for y in range(t_y - 1, -1, -1):
        valid = y < t_ys
        path[rows, y, index.clamp(min=0)] = torch.where(valid & (index >= 0), 1.0, 0.0)
        prev_row = cum[:, max(y - 1, 0)] if y > 0 else torch.zeros_like(cum[:, 0])
        at_idx = prev_row.gather(1, index.clamp(min=0)[:, None])[:, 0]
        at_idx_m1 = prev_row.gather(1, (index - 1).clamp(min=0)[:, None])[:, 0]
        dec = (index != 0) & ((index == y) | (at_idx < at_idx_m1))
        index = torch.where(valid & dec, index - 1, index)
    return path


def neg_cent_grid(text_embed: torch.Tensor, ppg_embed: torch.Tensor) -> torch.Tensor:
    """The unit-variance gaussian log-likelihood grid (B, T_ppg, T_text)
    (reference: dit.py:319-325): sum_d [-0.5 log(2 pi) - 0.5 ppg^2 + ppg.text
    - 0.5 text^2], in fp32."""
    d = text_embed.shape[-1]
    tf, pf = text_embed.float(), ppg_embed.float()
    n1 = -0.5 * math.log(2 * math.pi) * d
    n2 = (-0.5 * pf.square()).sum(dim=-1)[:, :, None]
    n3 = torch.einsum("btd,bsd->bts", pf, tf)
    n4 = (-0.5 * tf.square()).sum(dim=-1)[:, None, :]
    return n1 + n2 + n3 + n4
