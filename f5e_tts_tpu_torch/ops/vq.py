"""Gumbel-softmax vector quantizer (counterpart of `f5e_tts_tpu/ops/vq.py`;
reference: src/f5_tts/model/modules.py:744-950, GumbelVectorQuantizer).

The codebook is `vars` (1, groups * num_vars, var_dim); the logits come from
the `weight_proj` linears (GELU between them when there are several);
training takes a hard straight-through gumbel-softmax, eval the argmax; the
code and prob perplexities are computed over the B * T pool, which under a
batch mesh (parallel/mesh.py: batch_mesh) is the global batch's, as the
JAX function's under pjit.

The reference Trainer never calls `set_num_updates`, so the temperature stays
at `temp_start`; `decayed_temperature` is the schedule it would follow.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.config import CodebookConfig
from f5e_tts_tpu_torch.kernels import threefry as fthreefry
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops import prng
from f5e_tts_tpu_torch.parallel import mesh as pmesh


class VQResult(NamedTuple):
    x: torch.Tensor  # (B, T, D) quantized
    code_perplexity: torch.Tensor  # () of the argmax codes
    prob_perplexity: torch.Tensor  # () of the mean softmax, differentiable
    num_vars: int  # num_vars * groups


def gumbel_vq_init(cfg: CodebookConfig, dim: int, key, device="cpu") -> dict:
    """fp32 parameters for input and output width `dim` (reference
    dit.py:296-307), from `key` split in two as the JAX init (ops/vq.py:33-52):
    `vars` ~ U(0, 1) from the first; from the second, one `weight_proj`
    layer N(0, 1) with a zero bias, or weight_proj_depth torch-default
    linears, one key each."""
    k1, k2 = prng.split(key)
    groups = 1 if cfg.combine_groups else cfg.groups
    params = {"vars": fthreefry.uniform(k1, (1, groups * cfg.num_vars, dim // cfg.groups),
                                        device)}
    out = cfg.groups * cfg.num_vars
    if cfg.weight_proj_depth > 1:
        inner = dim * cfg.weight_proj_factor
        sizes = [dim] + [inner] * (cfg.weight_proj_depth - 1) + [out]
        kk = prng.split(k2, cfg.weight_proj_depth)
        params["weight_proj"] = {f"layer_{i}": fnn.linear_init(a, b, kk[i], device)
                                 for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    else:
        params["weight_proj"] = {"layer_0": {"w": fthreefry.normal(k2, (dim, out), device),
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


def _pool_mean(rows: torch.Tensor) -> torch.Tensor:
    """(rows, groups, num_vars) -> their mean over the rows, the global
    batch's under a batch mesh (`global_mean`: each shard's gradient is its
    own rows' part, so the summed gradients are the global mean's)."""
    bm = pmesh.batch_mesh()
    if bm is None:
        return rows.mean(dim=0)
    return pmesh.global_mean(rows.sum(dim=0), rows.shape[0], bm)


def gumbel_uniform(key, shape, device) -> torch.Tensor:
    """The gumbel noise's U[1e-10, 1) draw (jax.random.uniform(minval=1e-10))
    of (rows, num_vars), through the threefry kernel on the card. Under a
    batch mesh the rows are this rank's equal share of the global batch's
    (batch-major), and it draws its rows of the global draw."""
    global_shape, offset = prng.slab(shape, rows=pmesh.batch_rows(shape[0]))
    return fthreefry.uniform(key, shape, device, 1e-10, 1.0, global_shape, offset)


def gumbel_vq_apply(params, cfg: CodebookConfig, x: torch.Tensor, *, training: bool,
                    temperature, rng: Optional[torch.Tensor] = None,
                    uniform: Optional[torch.Tensor] = None) -> VQResult:
    """Quantize (B, T, D) -> (B, T, D) in fp32 (reference: modules.py:881-950).

    Training adds gumbel noise -log(-log(u)) to the logits, u = `uniform`
    ((B * T * groups, num_vars) in [1e-10, 1)) or drawn from the key `rng`,
    and takes the hard one-hot of softmax((logits + noise) / temperature)
    with the soft one's gradient; eval takes the argmax one-hot.
    """
    b, t, _ = x.shape
    g, v = cfg.groups, cfg.num_vars
    logits = _weight_proj(params, x.float()).reshape(b * t * g, v)

    hard = F.one_hot(logits.argmax(dim=-1), v).float()
    code_ppl = _perplexity(_pool_mean(hard.reshape(b * t, g, v)))
    prob_ppl = _perplexity(_pool_mean(torch.softmax(logits.reshape(b * t, g, v), dim=-1)))

    if training:
        if uniform is None:
            uniform = gumbel_uniform(rng, logits.shape, logits.device)
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
