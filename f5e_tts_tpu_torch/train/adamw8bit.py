"""8-bit AdamW: block-wise int8 optimizer moments (counterpart of
`f5e_tts_tpu/train/adamw8bit.py`).

reference: src/f5_tts/model/trainer.py:134-137 (`bnb.optim.AdamW8bit` behind
`bnb_optimizer`). Not bitsandbytes: the JAX package's own quantisation,
which this port reproduces code for code. Both moments are kept as int8
codes with one fp32 scale per 256-element block, about 2.03 bytes a
parameter against AdamW's 8:
- m (signed): per-block absmax linear int8 in [-127, 127];
- v (non-negative): the same code on sqrt(v), which keeps relative precision
  where the update divides by it;
- tensors under `min_quantize_size` elements (biases, norms) keep fp32
  moments, as bitsandbytes' min_8bit_size does.
Each update decodes a tensor's moments to fp32, updates them, computes the
step from the fp32 values, and encodes them again. torch.round, like
jnp.round, rounds half to even, and the scale is floored at 1e-20 as in JAX.
Differences from the fp32 optax.adamw that the JAX package keeps: the
schedule is read at the post-increment count, and weight decay multiplies
the learning rate (`-lr * (step + wd * p)`).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from f5e_tts_tpu_torch.train.step import AdamW, AdamWState, tree_leaves


def _encode(x: torch.Tensor, block_size: int, signed: bool) -> dict:
    """{"codes": (blocks, block_size) int8, "scale": (blocks, 1) fp32}."""
    flat = x.reshape(-1).float()
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block_size)).reshape(-1,
                                                                                      block_size)
    if not signed:
        blocks = torch.sqrt(blocks)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    codes = torch.round(blocks / torch.clamp(scale, min=1e-20)).clamp(-127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale}


def _decode(q: dict, shape, signed: bool) -> torch.Tensor:
    blocks = q["codes"].float() * q["scale"]
    if not signed:
        blocks = blocks.square()
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


class AdamW8bit(AdamW):
    """The clip / accumulate chain of `train/step.py: AdamW` around the
    block-wise 8-bit AdamW (decoupled weight decay); its state's `mu` and
    `nu` hold, per parameter, a {"codes", "scale"} dict or an fp32 tensor."""

    def __init__(self, schedule: Callable[[int], float], max_grad_norm: float,
                 grad_accum: int = 1, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, block_size: int = 256,
                 min_quantize_size: int = 4096):
        super().__init__(schedule, max_grad_norm, grad_accum, b1, b2, eps)
        self.weight_decay, self.block_size = weight_decay, block_size
        self.min_quantize_size = min_quantize_size

    def _encode_or_keep(self, x: torch.Tensor, p: torch.Tensor, signed: bool):
        return _encode(x, self.block_size, signed) if p.numel() >= self.min_quantize_size else x

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        def zeros(signed):
            return [self._encode_or_keep(torch.zeros_like(p, dtype=torch.float32), p, signed)
                    for p in params]

        return AdamWState(mu=zeros(True), nu=zeros(False),
                          acc=[torch.zeros_like(p, dtype=torch.float32) for p in params]
                          if self.grad_accum > 1 else None)

    @torch.no_grad()
    def _adam_(self, state: AdamWState, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> None:
        state.count += 1
        c = state.count
        lr = self.schedule(c)  # the JAX update reads the schedule after the increment
        b1, b2 = self.b1, self.b2
        mu_hat, nu_hat = 1.0 / (1.0 - b1 ** c), 1.0 / (1.0 - b2 ** c)
        for i, (p, g) in enumerate(zip(params, grads)):
            qm, qv = state.mu[i], state.nu[i]
            m = _decode(qm, p.shape, True) if isinstance(qm, dict) else qm
            v = _decode(qv, p.shape, False) if isinstance(qv, dict) else qv
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g.square()
            step = (m * mu_hat) / (torch.sqrt(v * nu_hat) + self.eps)
            p.add_((-lr * (step + self.weight_decay * p.float())).to(p.dtype))
            state.mu[i] = self._encode_or_keep(m, p, True)
            state.nu[i] = self._encode_or_keep(v, p, False)


def state_bytes(opt_state) -> int:
    """The optimizer state's bytes: every tensor of the moments (and the
    accumulator, when there is one) and the update count, an int32 as in JAX."""
    trees = [opt_state.mu, opt_state.nu] + ([opt_state.acc] if opt_state.acc is not None else [])
    return 4 + sum(t.numel() * t.element_size() for t in tree_leaves(trees))
