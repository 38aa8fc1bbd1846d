"""DiT backbone (counterpart of `f5e_tts_tpu/models/dit.py`): the sampler's
forward with precomputed text (and PPG) embeddings, and the training forward
(`dit_forward`, with dropout), both differentiable through the kernels'
autograd Functions. The F5E model's DiT adds a PPG embedding with
BatchNorm state and, in training, the shared Gumbel-VQ codebook's losses
(alignment by MAS, perplexity, cross masking); `checkpoint_activations`
recomputes each block in the backward under the config's `remat_policy`.

Parameters are nested dicts of tensors with the JAX package's names and
layouts, except that the per-block tensors are a list of `depth` dicts
instead of arrays stacked for `lax.scan`; the loop over blocks is a Python
loop. q/k features are in the half-split RoPE order (see ops/rope.py).

Under the active mesh (parallel/mesh.py: active, entered by the training
step) the params are this rank's slices of `dit_param_spec`: with a
"model" axis > 1 the blocks and the text embedding's ConvNeXt run
Megatron's column / row split over it; with fsdp > 1 each block's split
matrices are all-gathered at use (`FSDPGather`); with pipe > 1 the trunk
runs its stage's blocks through `gpipe_scan` (models/dit.py:356-394 of the
JAX package).

reference semantics: src/f5_tts/model/backbones/dit.py:183-472 and
src/f5_tts/model/modules.py:610-641 (DiTBlock).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from f5e_tts_tpu_torch.config import DiTConfig
from f5e_tts_tpu_torch.kernels.gated_adaln import GatedAdaLN
from f5e_tts_tpu_torch.ops import attention as fattn
from f5e_tts_tpu_torch.ops import convnext as fcnx
from f5e_tts_tpu_torch.ops import mas as fmas
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops import vq as fvq
from f5e_tts_tpu_torch.ops.attention import attention
from f5e_tts_tpu_torch.ops.rope import rotary_cos_sin_half
from f5e_tts_tpu_torch.parallel import mesh as pmesh
from f5e_tts_tpu_torch.parallel import pipeline as ppipe
from f5e_tts_tpu_torch.utils.masks import lens_to_mask


# ---------------------------------------------------------------------------
# init: torch's default rules (U(+-1/sqrt(fan_in)), N(0, 1) embeddings) and
# AdaLN-zero (modulation linears and proj_out zero), as the JAX init.
# ---------------------------------------------------------------------------


_linear_init = fnn.linear_init
_conv_init = fnn.conv1d_init


def _convnext_v2_init(dim, inter, gen, device):
    return {
        "dwconv": _conv_init(dim, dim, 7, dim, gen, device),
        "norm": {"g": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device)},
        "pwconv1": _linear_init(dim, inter, gen, device),
        "grn": {"gamma": torch.zeros(inter, device=device),
                "beta": torch.zeros(inter, device=device)},
        "pwconv2": _linear_init(inter, dim, gen, device),
    }


def init_dit(cfg: DiTConfig, vocab_size: int, generator: torch.Generator,
             device="cpu"):
    """fp32 parameters of the given shapes from `generator` (on `device`).

    A PPG DiT (`cfg.ppg.use_ppg`) also has state, the running statistics of
    its PPG embedding's BatchNorms, and `init_dit` returns (params, state)
    for it; for every other config the params alone. The PPG embedding is
    the reference's conv projector (dit.py:93-153): a linear, 3 x (conv k5 +
    BatchNorm), a linear to text_dim; the input projection then takes
    2 * mel + 2 * text_dim features. A codebook adds the shared Gumbel-VQ
    `quantizer` (dit.py:296-307).
    """
    text_dim = cfg.text_dim if cfg.text_dim is not None else cfg.mel_dim
    g, dev = generator, device
    inner = cfg.heads * cfg.dim_head
    ff = int(cfg.dim * cfg.ff_mult)
    params = {
        "time_embed": {"mlp1": _linear_init(256, cfg.dim, g, dev),
                       "mlp2": _linear_init(cfg.dim, cfg.dim, g, dev)},
        "text_embed": {
            "embed": {"w": torch.randn(vocab_size + 1, text_dim, generator=g, device=dev)},
            "blocks": [_convnext_v2_init(text_dim, text_dim * 2, g, dev)
                       for _ in range(cfg.conv_layers)],
        },
    }
    state = {}
    if cfg.ppg.use_ppg:
        pd = cfg.ppg.ppg_dim
        convs = [_conv_init(pd, pd, 5, 1, g, dev) for _ in range(3)]
        bns = [fnn.batchnorm_init(pd, dev) for _ in range(3)]
        params["ppg_embed"] = {"pre": _linear_init(pd, pd, g, dev), "convs": convs,
                               "bns": [p for p, _ in bns],
                               "post": _linear_init(pd, text_dim, g, dev)}
        state["ppg_bn"] = [s for _, s in bns]
    params["input_embed"] = {
        "proj": _linear_init(cfg.mel_dim * 2 + text_dim * (2 if cfg.ppg.use_ppg else 1),
                             cfg.dim, g, dev),
        "conv1": _conv_init(cfg.dim, cfg.dim, 31, 16, g, dev),
        "conv2": _conv_init(cfg.dim, cfg.dim, 31, 16, g, dev),
    }
    params["blocks"] = [
        {
            "attn_norm": _linear_init(cfg.dim, cfg.dim * 6, g, dev, zero=True),
            "attn": {name: _linear_init(cfg.dim, inner, g, dev)
                     for name in ("to_q", "to_k", "to_v")}
            | {"to_out": _linear_init(inner, cfg.dim, g, dev)},
            "ff1": _linear_init(cfg.dim, ff, g, dev),
            "ff2": _linear_init(ff, cfg.dim, g, dev),
        }
        for _ in range(cfg.depth)
    ]
    if cfg.long_skip_connection:
        params["long_skip"] = _linear_init(cfg.dim * 2, cfg.dim, g, dev, bias=False)
    params["norm_out"] = _linear_init(cfg.dim, cfg.dim * 2, g, dev, zero=True)
    params["proj_out"] = _linear_init(cfg.dim, cfg.mel_dim, g, dev, zero=True)
    if cfg.codebook.use_codebook:
        params["quantizer"] = fvq.gumbel_vq_init(cfg.codebook, text_dim, g, dev)
    return (params, state) if cfg.ppg.use_ppg else params


def fuse_qkv(params: dict, compute_dtype: Optional[torch.dtype] = None) -> dict:
    """Params whose blocks hold one fused [q|k|v] projection (`to_qkv`) in
    place of to_q/to_k/to_v, so the trunk runs one (dim, 3*inner) GEMM per
    block. Done once at load; `dit_trunk` fuses per call when it is not."""
    blocks = [{**blk, "attn": _fused_attn(blk["attn"], compute_dtype)} for blk in params["blocks"]]
    return {**params, "blocks": blocks}


def _fused_attn(attn: dict, compute_dtype: Optional[torch.dtype]) -> dict:
    if "to_qkv" in attn:
        return attn
    parts = [attn[name] for name in ("to_q", "to_k", "to_v")]
    qkv = {"w": torch.cat([p["w"] for p in parts], dim=-1)}
    if "b" in parts[0]:
        qkv["b"] = torch.cat([p["b"] for p in parts], dim=-1)
    if compute_dtype is not None:
        qkv = {k: v.to(compute_dtype) for k, v in qkv.items()}
    rest = {k: v for k, v in attn.items() if k not in ("to_q", "to_k", "to_v")}
    return {**rest, "to_qkv": qkv}


# ---------------------------------------------------------------------------
# embeddings (time-independent parts are computed once per request)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _abs_pos_table(dim: int, max_pos: int) -> torch.Tensor:
    """(max_pos, dim) fp32 table on the CPU; callers slice and copy it.
    Built outside inference mode, as the other cached tables: the cache
    outlives the call, and a later training step cannot save an inference
    tensor for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(fnn.precompute_freqs_cis(dim, max_pos))


@functools.lru_cache(maxsize=16)
def _rope_tables(dim_head: int, seq_len: int, device: torch.device):
    with torch.inference_mode(False):  # cached: see _abs_pos_table
        cos, sin = rotary_cos_sin_half(dim_head, seq_len)
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def time_embed(params, time: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B,) -> (B, dim): sinus(256) -> Linear -> SiLU -> Linear (modules.py:721-731)."""
    h = fnn.sinus_time_embedding(time, 256)
    h = fnn.linear(params["time_embed"]["mlp1"], h.to(compute_dtype), compute_dtype)
    return fnn.linear(params["time_embed"]["mlp2"], fnn.silu(h), compute_dtype)


def text_embed_fn(params, cfg: DiTConfig, text_ids: Optional[torch.Tensor], batch: int,
                  seq_len: int, drop_text: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Text ids (B, NT), pad -1 -> (B, N, text_dim) (dit.py:37-87).

    Ids shift by +1 (0 = filler) and are curtailed or padded to N; the padding
    mask is taken BEFORE the CFG text drop; the absolute position table and
    the ConvNeXtV2 blocks apply only when conv_layers > 0.
    """
    device = params["text_embed"]["embed"]["w"].device
    text_dim = cfg.text_dim if cfg.text_dim is not None else cfg.mel_dim
    if text_ids is None:
        ids = torch.zeros((batch, seq_len), dtype=torch.long, device=device)
        text_mask = None
    else:
        ids = text_ids.to(device=device, dtype=torch.long) + 1
        nt = ids.shape[1]
        ids = ids[:, :seq_len] if nt >= seq_len else F.pad(ids, (0, seq_len - nt))
        text_mask = ids == 0 if cfg.text_mask_padding else None
        ids = ids.masked_fill(drop_text.to(device)[:, None], 0)

    emb = fnn.embedding(params["text_embed"]["embed"], ids).to(compute_dtype)
    if cfg.conv_layers > 0:
        table = _abs_pos_table(text_dim, cfg.max_pos)[:seq_len]
        emb = emb + table.to(device=device, dtype=compute_dtype)[None]
        if text_mask is not None:
            emb = emb.masked_fill(text_mask[:, :, None], 0.0)
        for blk in params["text_embed"]["blocks"]:
            emb = fcnx.convnext_v2(blk, emb, compute_dtype=compute_dtype, sharded=True)
            if text_mask is not None:
                emb = emb.masked_fill(text_mask[:, :, None], 0.0)
    return emb


def ppg_embed_fn(params, state, cfg: DiTConfig, ppg: Optional[torch.Tensor], batch: int,
                 seq_len: int, drop_ppg: torch.Tensor, training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 keep: Optional[Sequence[torch.Tensor]] = None, compute_dtype=torch.bfloat16):
    """PPG (B, NP, ppg_dim) -> ((B, N, text_dim), new state): the conv
    projector (dit.py:93-153), linear -> 3 x (conv k5 + BatchNorm + ReLU +
    dropout 0.5) -> linear. The PPG is truncated or zero-padded to the N mel
    frames as it is, with no resampling (a 20 ms PPG covers about half of a
    ~10.7 ms mel grid; the JAX package pads it so too), and the rows of
    `drop_ppg` are zeroed; None is all zeros. The BatchNorms pool (B, N),
    padding included, and update the state in training. Dropout acts only
    in training and only with a `generator` or the 3 boolean `keep` masks
    (B, N, ppg_dim) (the JAX function's rule: training and an rng)."""
    pd = cfg.ppg.ppg_dim
    pp = params["ppg_embed"]
    device = pp["pre"]["w"].device
    if ppg is None:
        x = torch.zeros((batch, seq_len, pd), dtype=compute_dtype, device=device)
    else:
        ppg = ppg.to(device)
        npg = ppg.shape[1]
        x = ppg[:, :seq_len] if npg >= seq_len else F.pad(ppg, (0, 0, 0, seq_len - npg))
        x = x.masked_fill(drop_ppg.to(device)[:, None, None], 0.0).to(compute_dtype)
    dropping = training and (generator is not None or keep is not None)
    h = fnn.linear(pp["pre"], x, compute_dtype)
    new_bns = []
    for i in range(3):
        h = fnn.conv1d(pp["convs"][i], h, padding=2, compute_dtype=compute_dtype)
        h, ns = fnn.batchnorm(pp["bns"][i], state["ppg_bn"][i], h, training=training)
        new_bns.append(ns)
        h = torch.relu(h)
        if dropping:
            h = fnn.dropout(h, 0.5, True, generator, None if keep is None else keep[i])
    return fnn.linear(pp["post"], h, compute_dtype), {"ppg_bn": new_bns}


def input_embed_fn(params, cfg: DiTConfig, x: torch.Tensor, cond: torch.Tensor,
                   text_embed: torch.Tensor, drop_audio_cond: torch.Tensor,
                   compute_dtype=torch.bfloat16,
                   ppg_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concat [x | cond | text (| ppg)] -> project, plus the conv position
    embedding: 2x (grouped conv k31, groups 16, padding 15) + Mish and the
    residual (dit.py:159-177)."""
    ie = params["input_embed"]
    cond = cond.masked_fill(drop_audio_cond[:, None, None], 0.0).to(compute_dtype)
    parts = [x.to(compute_dtype), cond, text_embed.to(compute_dtype)]
    if ppg_embed is not None:
        parts.append(ppg_embed.to(compute_dtype))
    h = fnn.linear(ie["proj"], torch.cat(parts, dim=-1), compute_dtype)
    c = fnn.mish(fnn.conv1d(ie["conv1"], h, groups=16, padding=15, compute_dtype=compute_dtype))
    c = fnn.mish(fnn.conv1d(ie["conv2"], c, groups=16, padding=15, compute_dtype=compute_dtype))
    return (c + h).to(compute_dtype)


# ---------------------------------------------------------------------------
# transformer trunk
# ---------------------------------------------------------------------------


class _KeptLinear(torch.autograd.Function):
    """`fnn.linear` whose output is computed once and kept: the remat
    recompute of a block under `save_attn_ff` takes the FF hidden (ff1's
    output, before the GELU) from `kept` instead of running the GEMM again.
    The backward is the linear's own (the gradients autograd forms for
    `fnn.linear`, the same products in the same dtypes), which needs the
    input and the weight, not the output."""

    @staticmethod
    def forward(ctx, x, w, b, kept: dict, compute_dtype):
        if "ff_hidden" not in kept:
            kept["ff_hidden"] = fnn.linear({"w": w, "b": b}, x, compute_dtype).detach()
        ctx.save_for_backward(x, w, b)
        ctx.dtype = compute_dtype
        return kept["ff_hidden"].detach()

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dtype = ctx.dtype
        x2 = x.to(dtype).reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        wd = w.to(dtype)
        if dtype == torch.float32 or x2.is_cuda:  # addmm in dtype (fnn.linear)
            gx, gw, gb = g2.mm(wd.t()), x2.t().mm(g2), g2.sum(0)
        else:  # the CPU's fp32 product, rounded once
            gf = g2.float()
            gx, gw, gb = gf.mm(wd.float().t()).to(dtype), x2.float().t().mm(gf).to(dtype), gf.sum(0)
        return (gx.reshape(x.shape).to(x.dtype), gw.to(w.dtype), gb.to(b.dtype), None, None)


def _dit_block(blk, x, t_emb, mask, rope_cos, rope_sin, cfg: DiTConfig,
               compute_dtype=torch.bfloat16, training: bool = False,
               generator: Optional[torch.Generator] = None, kept: Optional[dict] = None):
    """One DiT block (modules.py:610-641), with K2/K5 after the attention.
    In training, dropout (cfg.dropout, drawn from `generator`) acts on the
    attention output and on the FF hidden, as in the JAX block. `kept`
    (remat, see `_checkpointed_block`) holds what the policy keeps from the
    block's first forward: the attention output and, under save_attn_ff,
    the FF hidden."""
    policy_ff = kept is not None and cfg.remat_policy == "save_attn_ff"
    mod = fnn.linear(blk["attn_norm"], fnn.silu(t_emb), compute_dtype)  # (B, 6D)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)

    norm = fnn.layernorm(None, x, eps=1e-6).to(compute_dtype)
    norm = norm * (1 + scale_msa[:, None, :]) + shift_msa[:, None, :]
    attn_out = attention(blk["attn"], norm, cfg.heads, mask=mask, rope_cos=rope_cos,
                         rope_sin=rope_sin, pe_attn_head=cfg.pe_attn_head, qk_norm=cfg.qk_norm,
                         compute_dtype=compute_dtype, kept=kept, sharded_heads=True)
    attn_out = fnn.dropout(attn_out, cfg.dropout, training, generator)
    # x += gate * attn_out; LN; * (1 + scale) + shift, in one pass (K2, K5)
    x, norm = GatedAdaLN.apply(x, attn_out, gate_msa, scale_mlp, shift_mlp)
    norm = fattn.tp_copy(norm.to(compute_dtype))  # ff1 is column-parallel under TP
    if policy_ff:
        h = _KeptLinear.apply(norm, blk["ff1"]["w"], blk["ff1"]["b"], kept, compute_dtype)
    else:
        h = fnn.linear(blk["ff1"], norm, compute_dtype)
    h = _ff_dropout(fnn.gelu(h, approximate="tanh"), cfg.dropout, training, generator)
    h = fattn.row_parallel_linear(blk["ff2"], h, compute_dtype)
    return (x + gate_mlp[:, None, :] * h).to(compute_dtype)


def _ff_dropout(h, rate: float, training: bool, generator):
    """Dropout on the FF hidden. Under TP, h is this rank's columns: the keep
    mask is drawn at the full width, as every rank of the model axis draws
    it from the same generator state, and sliced, so the masks are those of
    the unsharded block."""
    tp = fattn._tp_shards()
    if tp == 1 or not training or rate == 0.0:
        return fnn.dropout(h, rate, training, generator)
    full = h.shape[:-1] + (h.shape[-1] * tp,)
    keep = torch.rand(full, generator=generator, device=h.device) < 1.0 - rate
    r = pmesh.current().mesh.index("model")
    return fnn.dropout(h, rate, training, keep=keep[..., r * h.shape[-1]:(r + 1) * h.shape[-1]])


REMAT_POLICIES = ("block", "save_attn", "save_attn_ff")


def _checkpointed_block(blk, x, t_emb, mask, rope_cos, rope_sin, cfg: DiTConfig,
                        compute_dtype, training: bool, generator: Optional[torch.Generator]):
    """`_dit_block` under torch.utils.checkpoint (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward (dit.py:329-354). `block` recomputes everything, K3 and K2
    included; `save_attn` keeps the attention output (K3's output and row
    statistics), so the recompute rebuilds q/k/v by GEMMs and skips K3;
    `save_attn_ff` keeps the FF hidden as well. K2 runs again under every
    policy: the FF's weight gradient needs its output.

    Dropout draws from an explicit generator, which the checkpoint does not
    stash (it stashes the global RNGs only). So the block draws from a
    private generator set to `generator`'s state at its start, in the
    forward and again in the recompute, and `generator` is then moved past
    the block's draws: the masks are those of the unchecked block."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one of {REMAT_POLICIES}")
    kept = None if cfg.remat_policy == "block" else {}
    start = generator.get_state() if generator is not None else None
    end = {}

    def run(x, t_emb):
        g = None
        if start is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(start)
        y = _dit_block(blk, x, t_emb, mask, rope_cos, rope_sin, cfg, compute_dtype, training,
                       g, kept)
        if g is not None:
            end.setdefault("state", g.get_state())
        return y

    y = checkpoint(run, x, t_emb, use_reentrant=False, preserve_rng_state=generator is None)
    if start is not None:
        generator.set_state(end["state"])
    return y


def dit_trunk(params, cfg: DiTConfig, x, t_emb, mask, seq_len, compute_dtype=torch.bfloat16,
              training: bool = False, generator: Optional[torch.Generator] = None):
    """The blocks, the long skip when configured (the trunk's input
    concatenated to its output and projected back to dim), then the final
    AdaLN and projection; fp32 out (dit.py:459-472). Blocks without a fused
    `to_qkv` get it concatenated per call (training keeps to_q/to_k/to_v as
    the fp32 master weights). With `checkpoint_activations`, and while
    autograd records, each block is checkpointed (`_checkpointed_block`)."""
    rope_cos, rope_sin = _rope_tables(cfg.dim_head, seq_len, x.device)
    remat = cfg.checkpoint_activations and torch.is_grad_enabled()
    residual = x
    fsdp = _fsdp_gather(cfg)

    def block(h, blk, t_e, mk, cos, sin, gen):
        blk = fsdp(blk)
        if "to_qkv" not in blk["attn"]:
            blk = {**blk, "attn": _fused_attn(blk["attn"], compute_dtype)}
        if remat:
            return _checkpointed_block(blk, h, t_e, mk, cos, sin, cfg, compute_dtype, training,
                                       gen)
        return _dit_block(blk, h, t_e, mk, cos, sin, cfg, compute_dtype, training, gen)

    if ppipe.pp_shards() > 1:
        x = _pipelined_trunk(block, params["blocks"], x, t_emb, mask, rope_cos, rope_sin, cfg,
                             training, generator)
    else:
        for blk in params["blocks"]:
            x = block(x, blk, t_emb, mask, rope_cos, rope_sin, generator)
    if cfg.long_skip_connection:
        x = fnn.linear(params["long_skip"], torch.cat([x, residual], dim=-1), compute_dtype)

    # final AdaLN (modules.py:322-336): chunk order is (scale, shift)
    scale, shift = fnn.linear(params["norm_out"], fnn.silu(t_emb), compute_dtype).chunk(2, dim=-1)
    x = fnn.layernorm(None, x, eps=1e-6).to(compute_dtype)
    x = x * (1 + scale[:, None, :]) + shift[:, None, :]
    return fnn.linear(params["proj_out"], x, compute_dtype).float()


def _fsdp_gather(cfg: DiTConfig):
    """blk -> blk with its fsdp-split matrices all-gathered for use (their
    gradients reduce-scattered back), or the identity without fsdp."""
    mesh = pmesh.current().over("fsdp")
    if mesh is None:
        return lambda blk: blk
    spec = pmesh.block_spec(cfg, fsdp=True)

    def gather(t, s):
        if "fsdp" not in tuple(s):
            return t
        return pmesh.FSDPGather.apply(t, mesh, "fsdp", tuple(s).index("fsdp"))

    return lambda blk: pmesh.tree_map_with_spec(gather, blk, spec)


def _pipelined_trunk(block, blocks, x, t_emb, mask, rope_cos, rope_sin, cfg: DiTConfig,
                     training: bool, generator):
    """The blocks of this rank's pipeline stage through `gpipe_scan`. With
    dropout in training each layer gets a seed, drawn alike on every stage
    from `generator`, and each microbatch folds its index into the seeds
    (`fold_scanned`): microbatches and stages draw independent masks."""
    mesh, axis, n_micro = ppipe.pp_context()
    seeds = [None] * len(blocks)
    if training and cfg.dropout > 0.0 and generator is not None:
        drawn = torch.randint(0, 2 ** 62, (len(blocks) * mesh.size(axis),), generator=generator,
                              device=generator.device).tolist()
        s = mesh.index(axis)
        seeds = drawn[s * len(blocks):(s + 1) * len(blocks)]

    def fold(items, m):
        return [(blk, None if seed is None else (seed * 1_000_003 + m + 1) % (2 ** 63))
                for blk, seed in items]

    def body(h, item, t_e, mk, cos, sin):
        blk, seed = item
        gen = None if seed is None else torch.Generator(device=h.device).manual_seed(seed)
        return block(h, blk, t_e, mk, cos, sin, gen)

    return ppipe.gpipe_scan(body, x, list(zip(blocks, seeds)), mesh, axis=axis, n_micro=n_micro,
                            batched=(t_emb, mask), const=(rope_cos, rope_sin), fold_scanned=fold)


def dit_sample_step(params, cfg: DiTConfig, *, x, cond, text_embed, time, drop_audio_cond,
                    mask=None, compute_dtype=torch.bfloat16,
                    ppg_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference forward with precomputed text (and PPG) embeddings
    (dit.py:417-472): time embedding, input embedding, trunk. (B, N, mel)
    fp32 out."""
    t_emb = time_embed(params, time, compute_dtype)
    h = input_embed_fn(params, cfg, x, cond, text_embed, drop_audio_cond, compute_dtype,
                       ppg_embed=ppg_embed)
    return dit_trunk(params, cfg, h, t_emb, mask, x.shape[1], compute_dtype)


class DiTExtras(NamedTuple):
    extra_loss: torch.Tensor  # () align_loss + perplex_loss
    new_state: dict  # the BatchNorm state after this forward ({} without PPG)
    align_loss: torch.Tensor  # ()
    perplex_loss: torch.Tensor  # ()


class DiTDraws(NamedTuple):
    """The random draws of the PPG embedding and of the codebook branch in
    one `dit_forward`. Fields left None are drawn from the call's generator
    (in this order, each only where the config uses it); tests hand over
    draws made from a JAX key."""

    ppg_keep: Optional[Sequence[torch.Tensor]] = None  # 3 x (B, N, ppg_dim) bool dropout keeps
    gumbel_text: Optional[torch.Tensor] = None  # (B * N * groups, num_vars) U[1e-10, 1)
    gumbel_ppg: Optional[torch.Tensor] = None  # the same for the PPG embedding
    perm_text: Optional[torch.Tensor] = None  # (N,) permutation: its first k frames quantized
    perm_ppg: Optional[torch.Tensor] = None
    cross_apply: Optional[torch.Tensor] = None  # () U[0, 1): cross mask when < cross_mask_prob
    cross_ratio: Optional[torch.Tensor] = None  # (B,) U[0, 1): masked share 0.3 + 0.4 u
    cross_start: Optional[torch.Tensor] = None  # (B,) U[0, 1): where the span starts


def dit_forward(params, cfg: DiTConfig, *, x, cond, text_ids, time, drop_audio_cond, drop_text,
                mask=None, training: bool = False, generator: Optional[torch.Generator] = None,
                compute_dtype=torch.bfloat16, state: Optional[dict] = None,
                ppg: Optional[torch.Tensor] = None, drop_ppg: Optional[torch.Tensor] = None,
                text_len: Optional[torch.Tensor] = None, ppg_len: Optional[torch.Tensor] = None,
                vq_temperature: float = 2.0, draws: Optional[DiTDraws] = None,
                return_extras: bool = False):
    """Training forward (dit.py:474-549): time, text (recomputed every call)
    and, for a PPG DiT, PPG embeddings (with `state`, the BatchNorm state),
    the codebook branch in training, the input embedding, then the trunk
    with dropout when `training`. (B, N, mel) fp32 out, or with
    `return_extras` (pred, DiTExtras).

    The codebook branch (a codebook DiT with PPG, in training; needs
    `text_len` and `ppg_len`) follows dit.py:502-524: the align loss (MAS
    between the text and PPG embeddings, NaN-guarded), the perplexity loss
    (a `perplex_loss_prob` share of the frames quantized, one permutation a
    modality for the whole batch) and the cross mask. The align loss and the
    cross mask act only when no sample drops its text or its PPG; MAS runs
    only when one of them is configured (it is off for the F5E config).
    Random draws come from `draws` where given, else from `generator`."""
    b, n, _ = x.shape
    d = draws or DiTDraws()
    t_emb = time_embed(params, time, compute_dtype)
    te = text_embed_fn(params, cfg, text_ids, b, n, drop_text, compute_dtype)
    zero = torch.zeros((), device=x.device)
    new_state, pe, align_loss, perplex_loss = state or {}, None, zero, zero
    if cfg.ppg.use_ppg:
        if drop_ppg is None:
            drop_ppg = torch.zeros(b, dtype=torch.bool, device=x.device)
        pe, new_state = ppg_embed_fn(params, state, cfg, ppg, b, n, drop_ppg, training,
                                     generator, d.ppg_keep, compute_dtype)
        if cfg.codebook.use_codebook and training:
            te, pe, align_loss, perplex_loss = _codebook_branch(
                params, cfg, te, pe, drop_text, drop_ppg, text_len, ppg_len, vq_temperature,
                generator, d)
    h = input_embed_fn(params, cfg, x, cond, te, drop_audio_cond, compute_dtype, ppg_embed=pe)
    pred = dit_trunk(params, cfg, h, t_emb, mask, n, compute_dtype, training, generator)
    if not return_extras:
        return pred
    return pred, DiTExtras(extra_loss=align_loss + perplex_loss, new_state=new_state,
                           align_loss=align_loss, perplex_loss=perplex_loss)


# ---------------------------------------------------------------------------
# codebook internals (reference: dit.py:296-415)
# ---------------------------------------------------------------------------


def _codebook_branch(params, cfg: DiTConfig, te, pe, drop_text, drop_ppg, text_len, ppg_len,
                     temperature, generator, d: DiTDraws):
    """(text embed, PPG embed, align loss, perplexity loss) after the
    codebook branch of `dit_forward`."""
    if text_len is None or ppg_len is None:
        raise ValueError("the codebook branch needs text_len and ppg_len")
    cb, dev = cfg.codebook, te.device
    b, n, _ = te.shape
    zero = torch.zeros((), device=dev)
    align_loss, perplex_loss = zero, zero
    # the per-batch "use both modalities" of the reference, over per-sample drops
    use_both = ~(drop_text.to(dev).any() | drop_ppg.to(dev).any())

    def draw(value, make):
        return make() if value is None else value.to(dev)

    if cb.use_align_loss or cb.use_perplex_loss:
        shape = (b * n * cb.groups, cb.num_vars)
        gt = draw(d.gumbel_text, lambda: fvq.gumbel_uniform(shape, generator, dev))
        gp = draw(d.gumbel_ppg, lambda: fvq.gumbel_uniform(shape, generator, dev))
    attn = None
    if cb.use_align_loss or cfg.ppg.use_cross_mask:
        attn = _align_text_ppg(te, text_len.to(dev), pe, ppg_len.to(dev))
    if cb.use_align_loss:
        al = _calc_align_loss(params, cb, attn, te, text_len.to(dev), pe, temperature, gt, gp)
        align_loss = torch.where(use_both & ~torch.isnan(al), al, zero)  # NaN guard (:511-514)
    if cb.use_perplex_loss:
        perm_t = draw(d.perm_text, lambda: torch.randperm(n, generator=generator, device=dev))
        perm_p = draw(d.perm_ppg, lambda: torch.randperm(n, generator=generator, device=dev))
        te, pe, perplex_loss = _perplex_loss(params, cb, te, pe, drop_text, drop_ppg,
                                             temperature, gt, gp, perm_t, perm_p)
    if cfg.ppg.use_cross_mask:
        u_apply = draw(d.cross_apply, lambda: torch.rand((), generator=generator, device=dev))
        u_ratio = draw(d.cross_ratio, lambda: torch.rand(b, generator=generator, device=dev))
        u_start = draw(d.cross_start, lambda: torch.rand(b, generator=generator, device=dev))
        apply_cm = use_both & (u_apply < cfg.ppg.cross_mask_prob)
        mt, mp = _cross_mask(attn, te, text_len.to(dev), pe, ppg_len.to(dev), u_ratio, u_start)
        te, pe = torch.where(apply_cm, mt, te), torch.where(apply_cm, mp, pe)
    return te, pe, align_loss, perplex_loss


def _align_text_ppg(text_embed, text_len, ppg_embed, ppg_len) -> torch.Tensor:
    """MAS between the text and PPG embeddings -> (B, NT, NP) 0/1, no gradient
    (dit.py:310-331: the grid is (B, NP, NT) with y = PPG, x = text)."""
    grid = fmas.neg_cent_grid(text_embed.detach(), ppg_embed.detach())
    return fmas.maximum_path(grid, ppg_len, text_len).transpose(1, 2)


def _calc_align_loss(params, cb, attn, text_embed, text_len, ppg_embed, temperature, gt, gp):
    """The MSE between each text token's straight-through quantized embedding
    and the attn-averaged quantized PPG embeddings over it, over the valid
    text tokens, times align_loss_weight (dit.py:333-360)."""
    te, pe = text_embed.float(), ppg_embed.float()
    tq = fvq.gumbel_vq_apply(params["quantizer"], cb, te, training=True, temperature=temperature,
                             uniform=gt).x
    pq = fvq.gumbel_vq_apply(params["quantizer"], cb, pe, training=True, temperature=temperature,
                             uniform=gp).x
    tq = te + (tq - te).detach()
    pq = pe + (pq - pe).detach()
    avg_ppg = torch.einsum("btp,bpd->btd", attn, pq) / attn.sum(dim=2).clamp(min=1e-8)[:, :, None]
    loss = (tq - avg_ppg).square().mean(dim=2)
    m = lens_to_mask(text_len, text_embed.shape[1]).float()
    return (loss * m).sum() / (m.sum() + 1e-8) * cb.align_loss_weight


def _perplex_loss(params, cb, text_embed, ppg_embed, drop_text, drop_ppg, temperature, gt, gp,
                  perm_t, perm_p):
    """Quantize the frames perm[:k], k = int(N * perplex_loss_prob), of each
    modality (one permutation for the whole batch) and add the diversity
    loss (num_vars - prob_perplexity) / num_vars of each modality no sample
    drops, times perplex_loss_weight (dit.py:364-384)."""
    def mix(embed, uniform, perm):
        res = fvq.gumbel_vq_apply(params["quantizer"], cb, embed.float(), training=True,
                                  temperature=temperature, uniform=uniform)
        t = embed.shape[1]
        w = torch.zeros(t, device=embed.device).index_fill(0, perm[: int(t * cb.perplex_loss_prob)],
                                                           1.0)[None, :, None]
        mixed = w * res.x + (1 - w) * embed.float()
        return mixed.to(embed.dtype), (res.num_vars - res.prob_perplexity) / res.num_vars

    zero = torch.zeros((), device=text_embed.device)
    mixed_t, pl_t = mix(text_embed, gt, perm_t)
    keep_t = ~drop_text.to(text_embed.device).any()
    mixed_p, pl_p = mix(ppg_embed, gp, perm_p)
    keep_p = ~drop_ppg.to(text_embed.device).any()
    loss = torch.where(keep_t, pl_t, zero) + torch.where(keep_p, pl_p, zero)
    return (torch.where(keep_t, mixed_t, text_embed), torch.where(keep_p, mixed_p, ppg_embed),
            loss * cb.perplex_loss_weight)


def _cross_mask(attn, text_embed, text_len, ppg_embed, ppg_len, u_ratio, u_start):
    """Zero a random span of 30-70 % of each sample's text tokens and the
    complementary PPG frames, mapped to tokens by the MAS path's argmax
    (dit.py:386-415)."""
    nt, npg = text_embed.shape[1], ppg_embed.shape[1]
    mask_len = torch.clamp((0.3 + 0.4 * u_ratio) * text_len.float(), min=1.0).to(torch.int32)
    start = ((text_len.to(torch.int32) - mask_len).float() * u_start).to(torch.int32)
    idx = torch.arange(nt, device=text_embed.device)[None, :]
    text_keep = ((idx < start[:, None]) | (idx >= (start + mask_len)[:, None]))
    text_keep = text_keep & lens_to_mask(text_len, nt)
    ppg_keep = torch.gather(text_keep, 1, attn.argmax(dim=1))
    ppg_keep = ~ppg_keep & lens_to_mask(ppg_len, npg)
    return (text_embed.masked_fill(~text_keep[:, :, None], 0.0),
            ppg_embed.masked_fill(~ppg_keep[:, :, None], 0.0))
