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
from f5e_tts_tpu_torch.kernels import threefry as fthreefry
from f5e_tts_tpu_torch.kernels.gated_adaln import GatedAdaLN
from f5e_tts_tpu_torch.ops import attention as fattn
from f5e_tts_tpu_torch.ops import convnext as fcnx
from f5e_tts_tpu_torch.ops import mas as fmas
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.ops import prng
from f5e_tts_tpu_torch.ops import vq as fvq
from f5e_tts_tpu_torch.ops.attention import attention
from f5e_tts_tpu_torch.ops.rope import rotary_cos_sin_half
from f5e_tts_tpu_torch.parallel import mesh as pmesh
from f5e_tts_tpu_torch.parallel import pipeline as ppipe
from f5e_tts_tpu_torch.utils.masks import lens_to_mask


# ---------------------------------------------------------------------------
# init: torch's default rules (U(+-1/sqrt(fan_in)), N(0, 1) embeddings) and
# AdaLN-zero (modulation linears and proj_out zero), from a threefry key split
# as the JAX init splits it, so a seed gives the JAX package's weights.
# ---------------------------------------------------------------------------


def init_dit(cfg: DiTConfig, vocab_size: int, key: torch.Tensor, device="cpu"):
    """fp32 parameters of the given shapes from the threefry `key` (ops/prng.py)
    on `device`: the JAX init's key chain (models/dit.py:38-108), `key` split
    in 64 + 2 depth and consumed in order, each block's own key split in 4.

    A PPG DiT (`cfg.ppg.use_ppg`) also has state, the running statistics of
    its PPG embedding's BatchNorms, and `init_dit` returns (params, state)
    for it; for every other config the params alone. The PPG embedding is
    the reference's conv projector (dit.py:93-153): a linear, 3 x (conv k5 +
    BatchNorm), a linear to text_dim; the input projection then takes
    2 * mel + 2 * text_dim features. A codebook adds the shared Gumbel-VQ
    `quantizer` (dit.py:296-307).
    """
    text_dim = cfg.text_dim if cfg.text_dim is not None else cfg.mel_dim
    keys, dev = iter(prng.split(key, 64 + 2 * cfg.depth)), device
    lin = fnn.linear_init
    params = {
        "time_embed": {"mlp1": lin(256, cfg.dim, next(keys), dev),
                       "mlp2": lin(cfg.dim, cfg.dim, next(keys), dev)},
        "text_embed": {
            "embed": fnn.embedding_init(vocab_size + 1, text_dim, next(keys), dev),
            "blocks": [fcnx.convnext_v2_init(text_dim, text_dim * 2, next(keys), dev)
                       for _ in range(cfg.conv_layers)],
        },
    }
    state = {}
    if cfg.ppg.use_ppg:
        pd = cfg.ppg.ppg_dim
        convs = [fnn.conv1d_init(pd, pd, 5, 1, next(keys), dev) for _ in range(3)]
        bns = [fnn.batchnorm_init(pd, dev) for _ in range(3)]
        params["ppg_embed"] = {"pre": lin(pd, pd, next(keys), dev), "convs": convs,
                               "bns": [p for p, _ in bns],
                               "post": lin(pd, text_dim, next(keys), dev)}
        state["ppg_bn"] = [s for _, s in bns]
    params["input_embed"] = {
        "proj": lin(cfg.mel_dim * 2 + text_dim * (2 if cfg.ppg.use_ppg else 1), cfg.dim,
                    next(keys), dev),
        "conv1": fnn.conv1d_init(cfg.dim, cfg.dim, 31, 16, next(keys), dev),
        "conv2": fnn.conv1d_init(cfg.dim, cfg.dim, 31, 16, next(keys), dev),
    }
    params["blocks"] = [init_block(cfg, next(keys), dev) for _ in range(cfg.depth)]
    if cfg.long_skip_connection:
        params["long_skip"] = lin(cfg.dim * 2, cfg.dim, next(keys), dev, bias=False)
    params["norm_out"] = lin(cfg.dim, cfg.dim * 2, None, dev, zero=True)
    params["proj_out"] = lin(cfg.dim, cfg.mel_dim, None, dev, zero=True)
    if cfg.codebook.use_codebook:
        params["quantizer"] = fvq.gumbel_vq_init(cfg.codebook, text_dim, next(keys), dev)
    return (params, state) if cfg.ppg.use_ppg else params


def init_block(cfg: DiTConfig, key: torch.Tensor, device="cpu") -> dict:
    """One block's fp32 parameters from its key, split in 4 as the JAX
    init's (models/dit.py:91): the attention from the first, the FF linears
    from the third and fourth; the AdaLN modulation zero."""
    k1, _, k3, k4 = prng.split(key, 4)
    ff = int(cfg.dim * cfg.ff_mult)
    return {"attn_norm": fnn.linear_init(cfg.dim, cfg.dim * 6, None, device, zero=True),
            "attn": fattn.attention_init(cfg.dim, cfg.heads, cfg.dim_head, k1, device,
                                         cfg.qk_norm),
            "ff1": fnn.linear_init(cfg.dim, ff, k3, device),
            "ff2": fnn.linear_init(ff, cfg.dim, k4, device)}


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
                 rng: Optional[torch.Tensor] = None,
                 keep: Optional[Sequence[torch.Tensor]] = None, compute_dtype=torch.bfloat16):
    """PPG (B, NP, ppg_dim) -> ((B, N, text_dim), new state): the conv
    projector (dit.py:93-153), linear -> 3 x (conv k5 + BatchNorm + ReLU +
    dropout 0.5) -> linear. The PPG is truncated or zero-padded to the N mel
    frames as it is, with no resampling (a 20 ms PPG covers about half of a
    ~10.7 ms mel grid; the JAX package pads it so too), and the rows of
    `drop_ppg` are zeroed; None is all zeros. The BatchNorms pool (B, N),
    padding included, and update the state in training. Dropout acts only
    in training and only with a key `rng`, split before each of the three
    (the JAX function's chain), or the 3 boolean `keep` masks (B, N,
    ppg_dim); under a batch mesh each rank draws its rows of the global
    batch's masks."""
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
    dropping = training and (rng is not None or keep is not None)
    h = fnn.linear(pp["pre"], x, compute_dtype)
    new_bns = []
    for i in range(3):
        h = fnn.conv1d(pp["convs"][i], h, padding=2, compute_dtype=compute_dtype)
        h, ns = fnn.batchnorm(pp["bns"][i], state["ppg_bn"][i], h, training=training)
        new_bns.append(ns)
        h = torch.relu(h)
        if dropping:
            sub = None
            if keep is None:
                rng, sub = prng.split(rng)
            h = fnn.dropout(sub, h, 0.5, True, *prng.slab(h.shape, pmesh.batch_rows(h.shape[0])),
                            keep=None if keep is None else keep[i])
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
               rng: Optional[torch.Tensor] = None, rows=None, kept: Optional[dict] = None):
    """One DiT block (modules.py:610-641), with K2/K5 after the attention.
    In training with a key `rng`, dropout (cfg.dropout) acts on the
    attention output and on the FF hidden, each under its own split of the
    key, as in the JAX block (models/dit.py:268, 282). `rows` (global rows,
    first row) places x's rows in the batch whose masks are drawn (a rank's
    share of the global batch; None: x is the whole batch). `kept` (remat,
    see `_checkpointed_block`) holds what the policy keeps from the block's
    first forward: the attention output and, under save_attn_ff, the FF
    hidden."""
    policy_ff = kept is not None and cfg.remat_policy == "save_attn_ff"
    dropping = training and rng is not None and cfg.dropout > 0
    mod = fnn.linear(blk["attn_norm"], fnn.silu(t_emb), compute_dtype)  # (B, 6D)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)

    norm = fnn.layernorm(None, x, eps=1e-6).to(compute_dtype)
    norm = norm * (1 + scale_msa[:, None, :]) + shift_msa[:, None, :]
    attn_out = attention(blk["attn"], norm, cfg.heads, mask=mask, rope_cos=rope_cos,
                         rope_sin=rope_sin, pe_attn_head=cfg.pe_attn_head, qk_norm=cfg.qk_norm,
                         compute_dtype=compute_dtype, kept=kept, sharded_heads=True)
    if dropping:
        rng, sub = prng.split(rng)
        attn_out = fnn.dropout(sub, attn_out, cfg.dropout, True,
                               *prng.slab(attn_out.shape, rows))
    # x += gate * attn_out; LN; * (1 + scale) + shift, in one pass (K2, K5)
    x, norm = GatedAdaLN.apply(x, attn_out, gate_msa, scale_mlp, shift_mlp)
    norm = fattn.tp_copy(norm.to(compute_dtype))  # ff1 is column-parallel under TP
    if policy_ff:
        h = _KeptLinear.apply(norm, blk["ff1"]["w"], blk["ff1"]["b"], kept, compute_dtype)
    else:
        h = fnn.linear(blk["ff1"], norm, compute_dtype)
    h = fnn.gelu(h, approximate="tanh")
    if dropping:
        rng, sub = prng.split(rng)
        h = fnn.dropout(sub, h, cfg.dropout, True, *prng.slab(h.shape, rows, _ff_cols(h)))
    h = fattn.row_parallel_linear(blk["ff2"], h, compute_dtype)
    return (x + gate_mlp[:, None, :] * h).to(compute_dtype)


def _ff_cols(h: torch.Tensor):
    """(global columns, first column) of the FF hidden `h` under TP, where
    h holds this rank's columns: its masks are then its columns of the
    unsharded block's. None without TP."""
    tp = fattn._tp_shards()
    if tp == 1:
        return None
    return h.shape[-1] * tp, h.shape[-1] * pmesh.current().mesh.index("model")


REMAT_POLICIES = ("block", "save_attn", "save_attn_ff")


def _checkpointed_block(blk, x, t_emb, mask, rope_cos, rope_sin, cfg: DiTConfig,
                        compute_dtype, training: bool, rng: Optional[torch.Tensor], rows):
    """`_dit_block` under torch.utils.checkpoint (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward (dit.py:329-354). `block` recomputes everything, K3 and K2
    included; `save_attn` keeps the attention output (K3's output and row
    statistics), so the recompute rebuilds q/k/v by GEMMs and skips K3;
    `save_attn_ff` keeps the FF hidden as well. K2 runs again under every
    policy: the FF's weight gradient needs its output. The recompute draws
    its dropout masks from the same key, so they are the forward's."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one of {REMAT_POLICIES}")
    kept = None if cfg.remat_policy == "block" else {}

    def run(x, t_emb):
        return _dit_block(blk, x, t_emb, mask, rope_cos, rope_sin, cfg, compute_dtype, training,
                          rng, rows, kept)

    return checkpoint(run, x, t_emb, use_reentrant=False, preserve_rng_state=False)


def dit_trunk(params, cfg: DiTConfig, x, t_emb, mask, seq_len, compute_dtype=torch.bfloat16,
              training: bool = False, rng: Optional[torch.Tensor] = None):
    """The blocks, the long skip when configured (the trunk's input
    concatenated to its output and projected back to dim), then the final
    AdaLN and projection; fp32 out (dit.py:459-472). Blocks without a fused
    `to_qkv` get it concatenated per call (training keeps to_q/to_k/to_v as
    the fp32 master weights). With `checkpoint_activations`, and while
    autograd records, each block is checkpointed (`_checkpointed_block`).
    In training with a key `rng`, block i draws its dropout under
    split(rng, depth)[i] (models/dit.py:303)."""
    rope_cos, rope_sin = _rope_tables(cfg.dim_head, seq_len, x.device)
    remat = cfg.checkpoint_activations and torch.is_grad_enabled()
    residual = x
    fsdp = _fsdp_gather(cfg)
    layer_keys = ([None] * cfg.depth if not training or rng is None
                  else list(prng.split(rng, cfg.depth)))

    def block(h, blk, t_e, mk, cos, sin, key, rows):
        blk = fsdp(blk)
        if "to_qkv" not in blk["attn"]:
            blk = {**blk, "attn": _fused_attn(blk["attn"], compute_dtype)}
        if remat:
            return _checkpointed_block(blk, h, t_e, mk, cos, sin, cfg, compute_dtype, training,
                                       key, rows)
        return _dit_block(blk, h, t_e, mk, cos, sin, cfg, compute_dtype, training, key, rows)

    if ppipe.pp_shards() > 1:
        x = _pipelined_trunk(block, params["blocks"], x, t_emb, mask, rope_cos, rope_sin,
                             layer_keys)
    else:
        rows = pmesh.batch_rows(x.shape[0])
        for blk, key in zip(params["blocks"], layer_keys):
            x = block(x, blk, t_emb, mask, rope_cos, rope_sin, key, rows)
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


def _pipelined_trunk(block, blocks, x, t_emb, mask, rope_cos, rope_sin, layer_keys):
    """The blocks of this rank's pipeline stage through `gpipe_scan`, each
    with its layer's key of the whole trunk (the stage's slice of
    `layer_keys`), into which each microbatch folds its index (JAX's
    `fold_scanned`, models/dit.py:388): microbatches and stages draw
    independent masks. As in the JAX package, where the pipeline runs in a
    shard_map over the stage's local microbatch, a block draws its masks at
    the microbatch's own shape."""
    mesh, axis, n_micro = ppipe.pp_context()
    s = mesh.index(axis)
    keys = layer_keys[s * len(blocks):(s + 1) * len(blocks)]

    def fold(items, m):
        return [(blk, None if key is None else prng.fold_in(key, m)) for blk, key in items]

    def body(h, item, t_e, mk, cos, sin):
        blk, key = item
        return block(h, blk, t_e, mk, cos, sin, key, None)

    return ppipe.gpipe_scan(body, x, list(zip(blocks, keys)), mesh, axis=axis, n_micro=n_micro,
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
    one `dit_forward`. Fields left None are drawn from the call's key, as
    the JAX forward draws them; tests plant specific draws here."""

    ppg_keep: Optional[Sequence[torch.Tensor]] = None  # 3 x (B, N, ppg_dim) bool dropout keeps
    gumbel_text: Optional[torch.Tensor] = None  # (B * N * groups, num_vars) U[1e-10, 1)
    gumbel_ppg: Optional[torch.Tensor] = None  # the same for the PPG embedding
    perm_text: Optional[torch.Tensor] = None  # (N,) permutation: its first k frames quantized
    perm_ppg: Optional[torch.Tensor] = None
    cross_apply: Optional[torch.Tensor] = None  # () U[0, 1): cross mask when < cross_mask_prob
    cross_ratio: Optional[torch.Tensor] = None  # (B,) U[0, 1): masked share 0.3 + 0.4 u
    cross_start: Optional[torch.Tensor] = None  # (B,) U[0, 1): where the span starts


def dit_forward(params, cfg: DiTConfig, *, x, cond, text_ids, time, drop_audio_cond, drop_text,
                mask=None, training: bool = False, rng: Optional[torch.Tensor] = None,
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

    The threefry key `rng` (PRNGKey(0) when None, as JAX) is split in 7 as
    the JAX forward splits it (models/dit.py:479): the gumbel noise of each
    modality, the two permutations, the cross mask, the PPG dropout and the
    trunk; fields of `draws` replace the draws they name."""
    b, n, _ = x.shape
    d = draws or DiTDraws()
    rng = prng.prng_key(0) if rng is None else rng
    r_vq_t, r_vq_p, r_perm_t, r_perm_p, r_cross, r_ppgdrop, r_trunk = prng.split(rng, 7)
    t_emb = time_embed(params, time, compute_dtype)
    te = text_embed_fn(params, cfg, text_ids, b, n, drop_text, compute_dtype)
    zero = torch.zeros((), device=x.device)
    new_state, pe, align_loss, perplex_loss = state or {}, None, zero, zero
    if cfg.ppg.use_ppg:
        if drop_ppg is None:
            drop_ppg = torch.zeros(b, dtype=torch.bool, device=x.device)
        pe, new_state = ppg_embed_fn(params, state, cfg, ppg, b, n, drop_ppg, training,
                                     r_ppgdrop, d.ppg_keep, compute_dtype)
        if cfg.codebook.use_codebook and training:
            te, pe, align_loss, perplex_loss = _codebook_branch(
                params, cfg, te, pe, drop_text, drop_ppg, text_len, ppg_len, vq_temperature,
                (r_vq_t, r_vq_p, r_perm_t, r_perm_p, r_cross), d)
    h = input_embed_fn(params, cfg, x, cond, te, drop_audio_cond, compute_dtype, ppg_embed=pe)
    pred = dit_trunk(params, cfg, h, t_emb, mask, n, compute_dtype, training, r_trunk)
    if not return_extras:
        return pred
    return pred, DiTExtras(extra_loss=align_loss + perplex_loss, new_state=new_state,
                           align_loss=align_loss, perplex_loss=perplex_loss)


# ---------------------------------------------------------------------------
# codebook internals (reference: dit.py:296-415)
# ---------------------------------------------------------------------------


def _codebook_branch(params, cfg: DiTConfig, te, pe, drop_text, drop_ppg, text_len, ppg_len,
                     temperature, keys, d: DiTDraws):
    """(text embed, PPG embed, align loss, perplexity loss) after the
    codebook branch of `dit_forward`; `keys` = its gumbel, permutation and
    cross-mask keys. Under a batch mesh the per-row draws (gumbel noise,
    the cross mask's spans) are this rank's rows of the global batch's, the
    permutations and the cross mask's coin the batch's own."""
    if text_len is None or ppg_len is None:
        raise ValueError("the codebook branch needs text_len and ppg_len")
    r_vq_t, r_vq_p, r_perm_t, r_perm_p, r_cross = keys
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
        gt = draw(d.gumbel_text, lambda: fvq.gumbel_uniform(r_vq_t, shape, dev))
        gp = draw(d.gumbel_ppg, lambda: fvq.gumbel_uniform(r_vq_p, shape, dev))
    attn = None
    if cb.use_align_loss or cfg.ppg.use_cross_mask:
        attn = _align_text_ppg(te, text_len.to(dev), pe, ppg_len.to(dev))
    if cb.use_align_loss:
        al = _calc_align_loss(params, cb, attn, te, text_len.to(dev), pe, temperature, gt, gp)
        align_loss = torch.where(use_both & ~torch.isnan(al), al, zero)  # NaN guard (:511-514)
    if cb.use_perplex_loss:
        perm_t = draw(d.perm_text, lambda: prng.permutation(r_perm_t, n).to(dev))
        perm_p = draw(d.perm_ppg, lambda: prng.permutation(r_perm_p, n).to(dev))
        te, pe, perplex_loss = _perplex_loss(params, cb, te, pe, drop_text, drop_ppg,
                                             temperature, gt, gp, perm_t, perm_p)
    if cfg.ppg.use_cross_mask:
        r_apply, r_mask = prng.split(r_cross)
        r_ratio, r_start = prng.split(r_mask)
        rows = prng.slab((b,), pmesh.batch_rows(b))
        u_apply = draw(d.cross_apply, lambda: fthreefry.uniform(r_apply, (), dev))
        u_ratio = draw(d.cross_ratio, lambda: fthreefry.uniform(r_ratio, (b,), dev, 0.0, 1.0, *rows))
        u_start = draw(d.cross_start, lambda: fthreefry.uniform(r_start, (b,), dev, 0.0, 1.0, *rows))
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
    text tokens, times align_loss_weight (dit.py:333-360); under a batch mesh
    the mean over the global batch's valid tokens (`global_mean`)."""
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
    return pmesh.global_mean((loss * m).sum(), m.sum(), pmesh.batch_mesh(),
                             eps=1e-8) * cb.align_loss_weight


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
