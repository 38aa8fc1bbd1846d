"""The WeNet attention decoder: the (Bi)Transformer decoder, label
smoothing, and the greedy searches (counterpart of
`f5e_tts_tpu/models/wenet_decoder.py`).

reference: src/f5_tts/ppg/wenet/transformer/decoder.py:1-295,
decoder_layer.py:1-147, attention.py:24-135 (MultiHeadedAttention),
positionwise_feed_forward.py, embedding.py:20-83 (PositionalEncoding, xscale
sqrt(d)), label_smoothing_loss.py, utils/common.py:42-135 (add_sos_eos,
reverse_pad_list, th_accuracy), utils/mask.py (subsequent_mask).

The decoder completes the CTC-attention hybrid of asr_model.py: the
attention loss is the label-smoothing loss over the left (and optionally the
right-to-left) decoder. Functions over parameter dicts with the JAX tree's
names and layouts; attention is plain einsum and softmax in fp32 (no Pallas
kernel in the JAX package either). Target preparation and the searches'
bookkeeping run on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.utils.convert import to_tensors
from f5e_tts_tpu_torch.utils.masks import lens_to_mask


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 5000
    dim: int = 256  # attention_dim == the encoder's output_size
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    r_num_blocks: int = 0  # > 0: BiTransformerDecoder
    normalize_before: bool = True
    max_pos: int = 5000


IGNORE_ID = -1
_ATTN = ("linear_q", "linear_k", "linear_v", "linear_out")


# ---------------------------------------------------------------------------
# targets (utils/common.py)
# ---------------------------------------------------------------------------


def add_sos_eos(ys_pad: np.ndarray, sos: int, eos: int,
                ignore_id: int = IGNORE_ID) -> Tuple[np.ndarray, np.ndarray]:
    """(B, L) padded targets -> (ys_in (B, L + 1) led by <sos>, padded with
    <eos>; ys_out (B, L + 1) ended by <eos>, padded with ignore_id)
    (common.py:42-85)."""
    b, length = ys_pad.shape
    lens = (ys_pad != ignore_id).sum(axis=1)
    ys_in = np.full((b, length + 1), eos, dtype=ys_pad.dtype)
    ys_out = np.full((b, length + 1), ignore_id, dtype=ys_pad.dtype)
    ys_in[:, 0] = sos
    for i in range(b):
        n = int(lens[i])
        ys_in[i, 1: n + 1] = ys_pad[i, :n]
        ys_out[i, :n] = ys_pad[i, :n]
        ys_out[i, n] = eos
    return ys_in, ys_out


def reverse_pad_list(ys_pad: np.ndarray, ys_lens: np.ndarray,
                     pad_value: int = IGNORE_ID) -> np.ndarray:
    """Each row's valid prefix reversed (common.py:88-113)."""
    out = np.full_like(ys_pad, pad_value)
    for i, n in enumerate(ys_lens):
        out[i, : int(n)] = ys_pad[i, : int(n)][::-1]
    return out


def th_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                ignore_label: int = IGNORE_ID) -> torch.Tensor:
    """The token accuracy over the targets that are not ignore_label
    (common.py:116-135)."""
    mask = targets != ignore_label
    correct = ((logits.argmax(dim=-1) == targets) & mask).sum()
    return correct / mask.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# parameters: seeded init, the JAX tree, the wenet checkpoint layout
# ---------------------------------------------------------------------------


def _init_one_decoder(cfg: DecoderConfig, num_blocks: int, g: torch.Generator, dev) -> dict:
    d, lu = cfg.dim, cfg.linear_units

    def lin(i, o):
        return fnn.linear_init(i, o, g, dev)

    def ln():
        return {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev)}

    layers = [{"self_attn": {n: lin(d, d) for n in _ATTN},
               "src_attn": {n: lin(d, d) for n in _ATTN},
               "ff": {"w1": lin(d, lu), "w2": lin(lu, d)},
               "norm1": ln(), "norm2": ln(), "norm3": ln()} for _ in range(num_blocks)]
    return {"embed": {"w": torch.randn((cfg.vocab_size, d), generator=g, device=dev)},
            "layers": layers, "after_norm": ln(), "output_layer": lin(d, cfg.vocab_size)}


def init_decoder(cfg: DecoderConfig, generator: torch.Generator, device="cpu") -> dict:
    """Seeded fp32 parameters: torch-default linears, an N(0, 1) embedding,
    unit LayerNorms (the JAX init's rules); "right" with r_num_blocks > 0."""
    params = {"left": _init_one_decoder(cfg, cfg.num_blocks, generator, device)}
    if cfg.r_num_blocks > 0:
        params["right"] = _init_one_decoder(cfg, cfg.r_num_blocks, generator, device)
    return params


def decoder_from_jax(params_np) -> dict:
    """The JAX `init_decoder` / `decoder_from_torch` tree (nested dicts of
    numpy arrays) -> port params: the same names and layouts, as tensors."""
    return to_tensors(params_np)


def _one_decoder_from_torch(sd: Dict[str, np.ndarray], prefix: str, num_blocks: int) -> dict:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def lin(k):
        p = {"w": t(sd[f"{k}.weight"].T)}
        if f"{k}.bias" in sd:
            p["b"] = t(sd[f"{k}.bias"])
        return p

    def ln(k):
        return {"g": t(sd[f"{k}.weight"]), "b": t(sd[f"{k}.bias"])}

    layers = []
    for i in range(num_blocks):
        k = f"{prefix}decoders.{i}"
        layers.append({
            "self_attn": {n: lin(f"{k}.self_attn.{n}") for n in _ATTN},
            "src_attn": {n: lin(f"{k}.src_attn.{n}") for n in _ATTN},
            "ff": {"w1": lin(f"{k}.feed_forward.w_1"), "w2": lin(f"{k}.feed_forward.w_2")},
            "norm1": ln(f"{k}.norm1"), "norm2": ln(f"{k}.norm2"), "norm3": ln(f"{k}.norm3"),
        })
    return {"embed": {"w": t(sd[f"{prefix}embed.0.weight"])}, "layers": layers,
            "after_norm": ln(f"{prefix}after_norm"), "output_layer": lin(f"{prefix}output_layer")}


def decoder_from_torch(sd: Dict, cfg: DecoderConfig, prefix: str = "decoder.") -> dict:
    """A wenet ASR checkpoint's decoder (numpy arrays or tensors) -> port
    params: the TransformerDecoder keys (decoder.decoders.*) or the
    BiTransformerDecoder's (decoder.left_decoder.*, decoder.right_decoder.*)."""
    sd = {k: v.detach().float().cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32)
          for k, v in sd.items()}
    if f"{prefix}left_decoder.embed.0.weight" in sd:
        params = {"left": _one_decoder_from_torch(sd, f"{prefix}left_decoder.", cfg.num_blocks)}
        if cfg.r_num_blocks > 0:
            params["right"] = _one_decoder_from_torch(sd, f"{prefix}right_decoder.",
                                                      cfg.r_num_blocks)
        return params
    return {"left": _one_decoder_from_torch(sd, prefix, cfg.num_blocks)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _mha(p, q_in, k_in, v_in, mask, heads: int, compute_dtype):
    """Multi-head attention, mask True = keep (attention.py:66-135: -inf
    where masked, softmax, then zero where masked); mask (B, Tq, Ts) or
    (B, 1, Ts)."""
    b, tq, d = q_in.shape
    dk = d // heads

    def proj(pp, y):
        return fnn.linear(pp, y, compute_dtype).reshape(b, -1, heads, dk).float()

    q, k, v = proj(p["linear_q"], q_in), proj(p["linear_k"], k_in), proj(p["linear_v"], v_in)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dk)
    if mask is None:
        attn = torch.softmax(scores, dim=-1)
    else:
        m = mask[:, None]
        attn = torch.softmax(scores.masked_fill(~m, -math.inf), dim=-1).masked_fill(~m, 0.0)
    out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, tq, d).to(compute_dtype)
    return fnn.linear(p["linear_out"], out, compute_dtype)


def _decoder_layer(p, x, tgt_mask, memory, memory_mask, heads, normalize_before, compute_dtype):
    """decoder_layer.py:57-147 (concat_after False, eval)."""
    def pre(name, y):
        return fnn.layernorm(p[name], y, eps=1e-5) if normalize_before else y

    def post(name, y):
        return y if normalize_before else fnn.layernorm(p[name], y, eps=1e-5).to(compute_dtype)

    h = pre("norm1", x)
    x = post("norm1", x + _mha(p["self_attn"], h, h, h, tgt_mask, heads, compute_dtype))
    h = pre("norm2", x)
    x = post("norm2", x + _mha(p["src_attn"], h, memory, memory, memory_mask, heads,
                                compute_dtype))
    h = torch.relu(fnn.linear(p["ff"]["w1"], pre("norm3", x), compute_dtype))
    x = post("norm3", x + fnn.linear(p["ff"]["w2"], h, compute_dtype))
    return x.to(compute_dtype)


def _abs_pos_table(d: int, max_len: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((max_len, d), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


def _one_decoder_forward(params, cfg: DecoderConfig, num_blocks: int, memory, memory_mask,
                         ys_in, ys_in_lens, compute_dtype=torch.float32):
    u = ys_in.shape[1]
    dev = memory.device
    pad_mask = lens_to_mask(ys_in_lens.to(dev), u)  # (B, U)
    causal = torch.tril(torch.ones((u, u), dtype=torch.bool, device=dev))
    tgt_mask = pad_mask[:, None, :] & causal[None]  # decoder.py:115-122
    ids = ys_in.to(dev).long().clamp_min(0)  # padding rows are masked out anyway
    pos = torch.from_numpy(_abs_pos_table(cfg.dim, u)).to(dev)
    x = (fnn.embedding(params["embed"], ids).float() * math.sqrt(cfg.dim) + pos[None]).to(
        compute_dtype)
    for i in range(num_blocks):
        x = _decoder_layer(params["layers"][i], x, tgt_mask, memory, memory_mask,
                           cfg.attention_heads, cfg.normalize_before, compute_dtype)
    if cfg.normalize_before:
        x = fnn.layernorm(params["after_norm"], x, eps=1e-5).to(compute_dtype)
    logits = fnn.linear(params["output_layer"], x, compute_dtype)
    return logits.float(), pad_mask.sum(-1)


def decoder_forward(params, cfg: DecoderConfig, memory: torch.Tensor, memory_lens: torch.Tensor,
                    ys_in: torch.Tensor, ys_in_lens: torch.Tensor,
                    r_ys_in: Optional[torch.Tensor] = None, reverse_weight: float = 0.0,
                    compute_dtype=torch.float32):
    """(logits of the left decoder (B, U, V), the right decoder's or 0, the
    valid lengths) for <sos>-led targets over the (B, T, D) encoder output
    (decoder.py:87-138, BiTransformerDecoder :240-272)."""
    memory_mask = lens_to_mask(memory_lens.to(memory.device), memory.shape[1])[:, None, :]
    mem = memory.to(compute_dtype)
    lx, olens = _one_decoder_forward(params["left"], cfg, cfg.num_blocks, mem, memory_mask,
                                     ys_in, ys_in_lens, compute_dtype)
    rx = torch.zeros((), device=memory.device)
    if reverse_weight > 0.0 and "right" in params:
        if r_ys_in is None:
            raise ValueError("reverse_weight > 0 needs r_ys_in")
        rx, _ = _one_decoder_forward(params["right"], cfg, cfg.r_num_blocks, mem, memory_mask,
                                     r_ys_in, ys_in_lens, compute_dtype)
    return lx, rx, olens


# ---------------------------------------------------------------------------
# losses (label_smoothing_loss.py) and the attention loss (asr_model.py)
# ---------------------------------------------------------------------------


def label_smoothing_loss(logits: torch.Tensor, target: torch.Tensor, *, smoothing: float = 0.1,
                         padding_idx: int = IGNORE_ID,
                         normalize_length: bool = False) -> torch.Tensor:
    """KL(smoothed one-hot || softmax(logits)) over the targets that are not
    padding: smoothing / (V - 1) everywhere and 1 - smoothing at the target,
    summed and divided by the batch size (or the target count with
    normalize_length) (label_smoothing_loss.py:58-85)."""
    b, u, v = logits.shape
    x = logits.reshape(-1, v).float()
    t = target.reshape(-1).long().to(x.device)
    ignore = t == padding_idx
    true_dist = torch.full((b * u, v), smoothing / (v - 1), device=x.device)
    true_dist.scatter_(1, torch.where(ignore, 0, t)[:, None], 1.0 - smoothing)
    kl = true_dist * (torch.log(true_dist.clamp_min(1e-20)) - torch.log_softmax(x, dim=-1))
    kl = kl.masked_fill(ignore[:, None], 0.0)
    denom = (~ignore).sum().clamp_min(1) if normalize_length else b
    return kl.sum() / denom


def attention_loss(params, cfg: DecoderConfig, memory: torch.Tensor, memory_lens: torch.Tensor,
                   ys_pad: np.ndarray, sos: int, eos: int, *, smoothing: float = 0.1,
                   reverse_weight: float = 0.0, compute_dtype=torch.float32):
    """ASRModel._calc_att_loss: add_sos_eos, the forward, label smoothing,
    (1 - rw) * left + rw * right, th_accuracy -> (loss, accuracy). ys_pad
    (B, L) host targets padded with IGNORE_ID."""
    ys_pad = np.asarray(ys_pad)
    ys_in, ys_out = add_sos_eos(ys_pad, sos, eos)
    ys_in_lens = (ys_pad != IGNORE_ID).sum(axis=1) + 1
    dev = memory.device
    r_ys_in = r_ys_out = None
    if reverse_weight > 0.0:
        r_ys_in, r_ys_out = add_sos_eos(reverse_pad_list(ys_pad, ys_in_lens - 1), sos, eos)
        r_ys_in = torch.from_numpy(r_ys_in).to(dev)
    lx, rx, _ = decoder_forward(params, cfg, memory, memory_lens, torch.from_numpy(ys_in).to(dev),
                                torch.from_numpy(ys_in_lens).to(dev), r_ys_in=r_ys_in,
                                reverse_weight=reverse_weight, compute_dtype=compute_dtype)
    ys_out_t = torch.from_numpy(ys_out).to(dev)
    loss = label_smoothing_loss(lx, ys_out_t, smoothing=smoothing)
    if reverse_weight > 0.0:
        r_loss = label_smoothing_loss(rx, torch.from_numpy(r_ys_out).to(dev), smoothing=smoothing)
        loss = loss * (1 - reverse_weight) + r_loss * reverse_weight
    return loss, th_accuracy(lx, ys_out_t)


# ---------------------------------------------------------------------------
# greedy searches
# ---------------------------------------------------------------------------


def ctc_greedy_search(ctc_logits, lens, blank: int = 0) -> List[List[int]]:
    """Argmax, repeats collapsed, blanks dropped (asr_model.py
    ctc_greedy_search) -> a token-id list per row."""
    if torch.is_tensor(ctc_logits):
        ctc_logits = ctc_logits.detach().cpu().numpy()
    if torch.is_tensor(lens):
        lens = lens.cpu().numpy()
    hyps = []
    for row, n in zip(np.argmax(np.asarray(ctc_logits), axis=-1), np.asarray(lens)):
        prev, hyp = blank, []
        for t in row[: int(n)]:
            if t != blank and t != prev:
                hyp.append(int(t))
            prev = t
        hyps.append(hyp)
    return hyps


def attention_greedy_decode(params, cfg: DecoderConfig, memory: torch.Tensor,
                            memory_lens: torch.Tensor, sos: int, eos: int,
                            max_len: int = 100) -> List[List[int]]:
    """Greedy attention decoding of a batch (recognize --mode attention at
    beam 1): each step re-runs the decoder over the whole prefix and takes
    the last position's argmax; a tool, not a serving loop. Returns the
    token-id lists without <sos> / <eos>."""
    b = memory.shape[0]
    ys = np.full((b, 1), sos, np.int32)
    finished = np.zeros((b,), bool)
    for _ in range(max_len):
        lens = torch.full((b,), ys.shape[1], dtype=torch.long)
        logits, _, _ = decoder_forward(params, cfg, memory, memory_lens,
                                       torch.from_numpy(ys).to(memory.device), lens)
        nxt = logits[:, -1].argmax(dim=-1).cpu().numpy().astype(np.int32)
        nxt = np.where(finished, eos, nxt)
        ys = np.concatenate([ys, nxt[:, None]], axis=1)
        finished |= nxt == eos
        if finished.all():
            break
    out = []
    for row in ys[:, 1:]:
        hyp = []
        for t in row:
            if int(t) == eos:
                break
            hyp.append(int(t))
        out.append(hyp)
    return out
