"""Gumbel-softmax vector quantizer (counterpart of `f5e_tts_tpu/ops/vq.py`;
reference: src/f5_tts/model/modules.py:744-950, GumbelVectorQuantizer).

The codebook is `vars` (1, groups * num_vars, var_dim); the logits come from
the `weight_proj` linears (GELU between them when there are several);
training takes a hard straight-through gumbel-softmax, eval the argmax; the
code and prob perplexities are computed over the B * T pool.

The reference Trainer never calls `set_num_updates`, so the temperature stays
at `temp_start`; `decayed_temperature` is the schedule it would follow.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.config import CodebookConfig
from f5e_tts_tpu_torch.ops import nn as fnn


class VQResult(NamedTuple):
    x: torch.Tensor  # (B, T, D) quantized
    code_perplexity: torch.Tensor  # () of the argmax codes
    prob_perplexity: torch.Tensor  # () of the mean softmax, differentiable
    num_vars: int  # num_vars * groups


def gumbel_vq_init(cfg: CodebookConfig, dim: int, generator: torch.Generator,
                   device="cpu") -> dict:
    """fp32 parameters for input and output width `dim` (reference
    dit.py:296-307): `vars` ~ U(0, 1); one `weight_proj` layer N(0, 1) with a
    zero bias, or weight_proj_depth torch-default linears."""
    groups = 1 if cfg.combine_groups else cfg.groups
    params = {"vars": torch.rand((1, groups * cfg.num_vars, dim // cfg.groups),
                                 generator=generator, device=device)}
    out = cfg.groups * cfg.num_vars
    if cfg.weight_proj_depth > 1:
        inner = dim * cfg.weight_proj_factor
        sizes = [dim] + [inner] * (cfg.weight_proj_depth - 1) + [out]
        params["weight_proj"] = {f"layer_{i}": fnn.linear_init(a, b, generator, device)
                                 for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    else:
        params["weight_proj"] = {"layer_0": {
            "w": torch.randn((dim, out), generator=generator, device=device),
            "b": torch.zeros(out, device=device)}}
    return params


def _weight_proj(params, x: torch.Tensor) -> torch.Tensor:
    layers = sorted(params["weight_proj"], key=lambda s: int(s.split("_")[1]))
    for i, name in enumerate(layers):
        x = fnn.linear(params["weight_proj"][name], x)
        if i < len(layers) - 1:
            x = fnn.gelu(x, approximate="none")
    return x


def _perplexity(probs: torch.Tensor) -> torch.Tensor:
    """(groups, num_vars) mean distribution -> sum over groups of exp(entropy)."""
    return torch.exp(-(probs * torch.log(probs + 1e-7)).sum(dim=-1)).sum()


def gumbel_uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[1e-10, 1) draws for the gumbel noise (jax.random.uniform(minval=1e-10))."""
    return 1e-10 + (1.0 - 1e-10) * torch.rand(shape, generator=generator, device=device)


def gumbel_vq_apply(params, cfg: CodebookConfig, x: torch.Tensor, *, training: bool,
                    temperature, generator: Optional[torch.Generator] = None,
                    uniform: Optional[torch.Tensor] = None) -> VQResult:
    """Quantize (B, T, D) -> (B, T, D) in fp32 (reference: modules.py:881-950).

    Training adds gumbel noise -log(-log(u)) to the logits, u = `uniform`
    ((B * T * groups, num_vars) in [1e-10, 1)) or drawn from `generator`,
    and takes the hard one-hot of softmax((logits + noise) / temperature)
    with the soft one's gradient; eval takes the argmax one-hot.
    """
    b, t, _ = x.shape
    g, v = cfg.groups, cfg.num_vars
    logits = _weight_proj(params, x.float()).reshape(b * t * g, v)

    hard = F.one_hot(logits.argmax(dim=-1), v).float()
    code_ppl = _perplexity(hard.reshape(b * t, g, v).mean(dim=0))
    prob_ppl = _perplexity(torch.softmax(logits.reshape(b * t, g, v), dim=-1).mean(dim=0))

    if training:
        if uniform is None:
            uniform = gumbel_uniform(logits.shape, generator, logits.device)
        gumbels = -torch.log(-torch.log(uniform.to(logits.device).float()))
        y_soft = torch.softmax((logits + gumbels) / temperature, dim=-1)
        y_hard = F.one_hot(y_soft.argmax(dim=-1), v).float()
        onehot = y_hard + y_soft - y_soft.detach()
    else:
        onehot = hard

    codebook = params["vars"]
    if cfg.combine_groups:
        codebook = codebook.repeat(1, g, 1)
    # each group's one-hot rows times its codes: a (B*T, V) x (V, var_dim)
    # product a group. The reference's broadcast (onehot[:, :, None] * vars,
    # summed over the codes) would hold B*T x G*V x var_dim floats, 3.8 GB
    # for 8 x 2304 frames at 2 x 100 codes of 256.
    xq = torch.einsum("ngv,gvd->ngd", onehot.reshape(b * t, g, v), codebook.reshape(g, v, -1))
    return VQResult(x=xq.reshape(b, t, -1), code_perplexity=code_ppl,
                    prob_perplexity=prob_ppl, num_vars=v * g)


def decayed_temperature(cfg: CodebookConfig, num_updates: int) -> float:
    """max(temp_start * temp_decay ** updates, temp_stop) (reference:
    modules.py:825-828)."""
    return max(cfg.temp_start * cfg.temp_decay ** num_updates, cfg.temp_stop)
