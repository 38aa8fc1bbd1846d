"""Training the PPG ASR model (the Conformer): the CE + CTC hybrid loss, the
gradient-reversal speaker branch, the center loss, a train step, and CTC
forced alignment (counterpart of `f5e_tts_tpu/models/conformer_train.py`).

reference: src/f5_tts/ppg/asr_model.py (the loss combination :200-221, the
SoftmaxLoss CE head, the CTC head ctc.py:1-70, the speaker branch :92-104,
154-159), wenet/utils/grl.py, wenet/transformer/etc.py,
wenet/bin/alignment.py.

The encoder runs `conformer_encode`, whose conv module normalises with the
BatchNorm's running statistics, as the JAX package trains it (wenet would use
batch statistics). The CTC loss is `F.ctc_loss` on the rows whose labels fit
their frames; a row that cannot fit (fewer frames than labels plus repeats)
takes optax.ctc_loss's value, the large finite cost of its log(0) floor
(`_ctc_loss_floored`), so the two packages agree on every row.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from f5e_tts_tpu_torch.models.conformer import ConformerConfig, conformer_encode
from f5e_tts_tpu_torch.ops import nn as fnn
from f5e_tts_tpu_torch.train.step import tree_leaves
from f5e_tts_tpu_torch.utils.masks import lens_to_mask

CTC_LOG_EPSILON = -1e5  # optax.ctc_loss's log(0)


def init_asr_heads(cfg: ConformerConfig, vocab_size: int, generator: torch.Generator,
                   device="cpu") -> dict:
    """The frame-level CE head (vocab + 1 phones, over the content linear's
    output) and the CTC head (vocab, over the encoder output); asr_model.py:77-90."""
    d = cfg.output_size
    return {"ce": fnn.linear_init(d, vocab_size + 1, generator, device),
            "ctc": fnn.linear_init(d, vocab_size, generator, device)}


class ASRLossOut(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    ctc_loss: torch.Tensor
    acc: torch.Tensor
    sv_loss: Optional[torch.Tensor] = None
    sv_acc: Optional[torch.Tensor] = None


def _ctc_loss_floored(logprobs: torch.Tensor, lens: torch.Tensor, labels: torch.Tensor,
                      label_lens: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """(B,) CTC loss by optax.ctc_loss's recursion (blank and label alphas,
    log(0) as CTC_LOG_EPSILON), a loop over the frames: the value optax
    gives a row whose labels cannot fit its frames."""
    b, t, _ = logprobs.shape
    u = labels.shape[1]
    dev = logprobs.device
    labels = labels.long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    lp_phi = logprobs[:, :, blank]  # (B, T)
    lp_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(b, t, u))  # (B, T, U)
    pad = 1.0 - lens_to_mask(lens, t).float()
    phi = torch.full((b, u + 1), CTC_LOG_EPSILON, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, u), CTC_LOG_EPSILON, device=dev)

    def add_to_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=-1)

    for i in range(t):
        prev_phi_orig = phi
        prev_phi = add_to_phi(phi, emit + CTC_LOG_EPSILON * repeat)
        e = lp_emit[:, i]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, emit + e)
        next_phi = prev_phi + lp_phi[:, i:i + 1]
        next_phi = add_to_phi(next_phi, emit + lp_phi[:, i:i + 1]
                              + CTC_LOG_EPSILON * (1.0 - repeat))
        pd = pad[:, i:i + 1]
        emit = pd * emit + (1.0 - pd) * next_emit
        phi = pd * prev_phi_orig + (1.0 - pd) * next_phi
    phi = add_to_phi(phi, emit)
    return -phi.gather(1, label_lens.long()[:, None])[:, 0]


def ctc_loss(logprobs: torch.Tensor, lens: torch.Tensor, labels: torch.Tensor,
             label_lens: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """(B,) CTC loss of (B, T, V) log-probs with (B,) frame lengths against
    (B, U) labels with (B,) lengths: optax.ctc_loss's value on every row.
    Rows that fit their frames go through F.ctc_loss; the others, which
    F.ctc_loss calls infinite, take `_ctc_loss_floored` (computed only when
    some row needs it: deciding that reads one flag on the host)."""
    labels = labels.long()
    u = labels.shape[1]
    valid = lens_to_mask(label_lens, u)
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid[:, 1:]).sum(dim=1)
    infeasible = label_lens.long() + repeats > lens.long()
    out = F.ctc_loss(logprobs.transpose(0, 1), labels, lens.long(), label_lens.long(),
                     blank=blank, reduction="none", zero_infinity=True)
    if bool(infeasible.any()):
        out = torch.where(infeasible, _ctc_loss_floored(logprobs, lens, labels, label_lens,
                                                        blank), out)
    return out


def asr_loss(encoder_params, heads, cfg: ConformerConfig, feats: torch.Tensor,
             feat_lens: torch.Tensor, frame_labels: Optional[torch.Tensor] = None,
             ctc_labels: Optional[torch.Tensor] = None,
             ctc_label_lens: Optional[torch.Tensor] = None, ppg_weight: float = 0.5,
             compute_dtype=torch.float32, sv_params: Optional[dict] = None,
             spk_label: Optional[torch.Tensor] = None, sv_weight: float = 0.0,
             sv_loss_kind: str = "softmax", grl_coeff: float = 1.0,
             chunk_mask=None) -> ASRLossOut:
    """loss = ppg_weight * CE + (1 - ppg_weight) * CTC (either alone when
    only its labels are given), + sv_weight * SV with the speaker branch
    (asr_model.py:204-221). frame_labels (B, T') per-frame phone ids, -1
    padding; ctc_labels (B, U), 0 padding; chunk_mask (T', T') the
    dynamic-chunk mask of `sample_train_chunk_mask`."""
    enc, enc_lens = conformer_encode(encoder_params, cfg, feats, feat_lens, compute_dtype,
                                     chunk_mask=chunk_mask)
    content = fnn.linear(encoder_params["content_linear"], enc, compute_dtype)
    zero = torch.zeros((), device=enc.device)

    ce, acc = zero, zero
    if frame_labels is not None:
        logits = fnn.linear(heads["ce"], content, compute_dtype).float()
        tlen = min(logits.shape[1], frame_labels.shape[1])
        logits, labels = logits[:, :tlen], frame_labels[:, :tlen].long()
        valid = (labels >= 0) & lens_to_mask(enc_lens, tlen)
        safe = labels.clamp_min(0)
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
        denom = valid.sum().clamp_min(1)
        ce = torch.where(valid, nll, 0.0).sum() / denom
        acc = (valid & (logits.argmax(-1) == safe)).sum() / denom

    ctc = zero
    if ctc_labels is not None:
        logits = fnn.linear(heads["ctc"], enc, compute_dtype).float()
        ctc = ctc_loss(torch.log_softmax(logits, dim=-1), enc_lens, ctc_labels,
                       ctc_label_lens).mean()

    sv = sv_acc = None
    if frame_labels is not None and ctc_labels is not None:
        loss = ppg_weight * ce + (1.0 - ppg_weight) * ctc
    elif frame_labels is not None:
        loss = ce
    else:
        loss = ctc
    if sv_params is not None and spk_label is not None:
        sv, sv_acc = sv_loss_fn(sv_params, content, enc_lens, spk_label, sv_loss=sv_loss_kind,
                                grl_coeff=grl_coeff)
        loss = loss + sv_weight * sv  # asr_model.py:207-221
    return ASRLossOut(loss=loss, ce_loss=ce, ctc_loss=ctc, acc=acc,
                      sv_loss=zero if sv is None else sv, sv_acc=zero if sv_acc is None else sv_acc)


def make_asr_train_step(cfg: ConformerConfig, optimizer, ppg_weight: float = 0.5,
                        compute_dtype=torch.float32):
    """step(params, heads, opt_state, batch) -> (params, heads, opt_state,
    ASRLossOut): one update of the encoder params and the heads together by
    `optimizer` (train/step.py: AdamW, the counterpart of the optax
    optimiser the JAX step is handed; its state from
    `optimizer.init(tree_leaves([params, heads]))`), in place. batch: feats,
    feat_lens and any of frame_labels, ctc_labels, ctc_label_lens, chunk_mask."""

    def step(params, heads, opt_state, batch):
        leaves = tree_leaves([params, heads])
        for p in leaves:
            p.requires_grad_(True)
        out = asr_loss(params, heads, cfg, batch["feats"], batch["feat_lens"],
                       batch.get("frame_labels"), batch.get("ctc_labels"),
                       batch.get("ctc_label_lens"), ppg_weight, compute_dtype,
                       chunk_mask=batch.get("chunk_mask"))
        grads = torch.autograd.grad(out.loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        optimizer.update_(opt_state, leaves, grads)
        return params, heads, opt_state, ASRLossOut(*(v.detach() for v in out))

    return step


# ---------------------------------------------------------------------------
# the speaker-verification branch with gradient reversal (asr_model.py:92-104,
# 154-159; wenet/utils/grl.py; wenet/transformer/etc.py)
# ---------------------------------------------------------------------------


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeff):
        ctx.coeff = coeff
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.coeff * g, None


def grad_reverse(x: torch.Tensor, coeff: float = 1.0) -> torch.Tensor:
    """The identity forward, -coeff * grad backward (grl.py:8-27)."""
    return _GradReverse.apply(x, coeff)


def stats_pool(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(B, T, D) and lengths -> (B, 2D) mean || unbiased std over the
    prefix of the shortest length (asr_model.py:155-157 truncates to
    enc_lens.min(), then StatsPool, etc.py:40-45), as masked sums."""
    t = x.shape[1]
    w = (torch.arange(t, device=x.device)[None, :] < lens.min()).float()
    denom = w.sum(dim=1, keepdim=True).clamp_min(1.0)
    xf = x.float()
    mean = (xf * w[:, :, None]).sum(dim=1) / denom
    var = ((xf - mean[:, None, :]).square() * w[:, :, None]).sum(dim=1) / denom
    n = (denom - 1.0).clamp_min(1.0)
    return torch.cat([mean, torch.sqrt(var * denom / n + 1e-12)], dim=-1)


def init_sv_branch(cfg: ConformerConfig, spk_num: int, generator: torch.Generator,
                   spk_dim: int = 128, sv_loss: str = "softmax", device="cpu") -> dict:
    """sv_linear (2D -> spk_dim) and the classifier: a linear for softmax,
    an xavier-uniform (spk_num, spk_dim) weight for the margin products
    (asr_model.py:98-103)."""
    params = {"sv_linear": fnn.linear_init(2 * cfg.output_size, spk_dim, generator, device)}
    if sv_loss == "softmax":
        params["sv_fc"] = fnn.linear_init(spk_dim, spk_num, generator, device)
    elif sv_loss in ("arc_margin", "add_margin"):
        lim = (6.0 / (spk_num + spk_dim)) ** 0.5
        params["margin_w"] = (torch.rand((spk_num, spk_dim), generator=generator, device=device)
                              * 2.0 - 1.0) * lim
    else:
        raise NotImplementedError(f"sv loss {sv_loss!r} (softmax | arc_margin | add_margin)")
    return params


def _xent(logits, label):
    nll = -torch.log_softmax(logits.float(), dim=-1).gather(-1, label.long()[:, None])[:, 0]
    return nll.mean(), (logits.argmax(-1) == label).float().mean()


def _cosine(w, x):
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    wn = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min(1e-12)
    return xn @ wn.T


def arc_margin_logits(w, x, label, m: float = 0.50, s: float = 30.0,
                      easy_margin: bool = False) -> torch.Tensor:
    """cos(theta + m) margin logits (etc.py:220-270, ArcMarginProduct)."""
    cosine = _cosine(w, x)
    sine = torch.sqrt(torch.clamp(1.0 - cosine.square(), 0.0, 1.0))
    phi = cosine * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine > math.cos(math.pi - m), phi,
                          cosine - math.sin(math.pi - m) * m)
    onehot = F.one_hot(label.long(), w.shape[0]).float()
    return (onehot * phi + (1 - onehot) * cosine) * s


def add_margin_logits(w, x, label, m: float = 0.40, s: float = 30.0) -> torch.Tensor:
    """cos(theta) - m margin logits (etc.py, AddMarginProduct)."""
    cosine = _cosine(w, x)
    onehot = F.one_hot(label.long(), w.shape[0]).float()
    return (onehot * (cosine - m) + (1 - onehot) * cosine) * s


def sv_loss_fn(sv_params, content: torch.Tensor, enc_lens: torch.Tensor,
               spk_label: torch.Tensor, *, sv_loss: str = "softmax", grl_coeff: float = 1.0):
    """Pool -> sv_linear -> GRL -> classifier: (loss, accuracy). The GRL
    makes the encoder remove speaker information (asr_model.py:154-159)."""
    emb = fnn.linear(sv_params["sv_linear"], stats_pool(content, enc_lens), torch.float32)
    emb = grad_reverse(emb, grl_coeff)
    if sv_loss == "softmax":
        logits = fnn.linear(sv_params["sv_fc"], emb, torch.float32)
    elif sv_loss == "arc_margin":
        logits = arc_margin_logits(sv_params["margin_w"], emb, spk_label)
    else:
        logits = add_margin_logits(sv_params["margin_w"], emb, spk_label)
    return _xent(logits, spk_label)


def init_center_loss(num_classes: int, feat_dim: int, generator: torch.Generator,
                     device="cpu") -> dict:
    """Per-class centres (wenet center_loss.py, CenterLoss2)."""
    return {"centers": torch.randn((num_classes, feat_dim), generator=generator, device=device)}


def center_loss_fn(params, feats: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Half the mean squared distance of the features to their class
    centres, padding labels (< 0) left out."""
    f = feats.reshape(-1, feats.shape[-1]).float()
    y = labels.reshape(-1).long()
    valid = y >= 0
    d2 = (f - params["centers"][y.clamp_min(0)]).square().sum(dim=-1)
    return torch.where(valid, d2, 0.0).sum() / valid.sum().clamp_min(1) / 2.0


# ---------------------------------------------------------------------------
# CTC forced alignment (wenet/bin/alignment.py), on the host
# ---------------------------------------------------------------------------


def ctc_forced_align(logprobs, label, blank: int = 0, return_states: bool = False):
    """The Viterbi path through the CTC topology of one utterance.

    logprobs: (T, V) log-softmax frame posteriors (valid frames only);
    label: (U,) token ids. Returns the (T,) state-token sequence (blank or a
    label token per frame), and with return_states also the (T,) CTC state
    indices (odd s = label token (s - 1) // 2, which keeps repeated tokens
    apart). Float64 on the host; each state's predecessors are ranked
    [stay, s - 1, s - 2] and a tie goes to the first, as the JAX loop's
    np.argmax does; each frame is one vectorised step over the states."""
    logprobs = np.asarray(logprobs, np.float64)
    label = [int(t) for t in label]
    t_len = logprobs.shape[0]
    states = np.asarray([blank] + [x for tok in label for x in (tok, blank)], np.int64)
    s_len = len(states)
    idx = np.arange(s_len)
    # skipping a blank is allowed between two different tokens
    skip = np.zeros(s_len, bool)
    skip[2:] = (states[2:] != blank) & (states[2:] != states[:-2])
    lp = logprobs[:, states]
    dp = np.full((t_len, s_len), -1e30)
    bp = np.zeros((t_len, s_len), np.int32)
    dp[0, 0] = lp[0, 0]
    if s_len > 1:
        dp[0, 1] = lp[0, 1]
    cands = np.full((3, s_len), -np.inf)
    for t in range(1, t_len):
        prev = dp[t - 1]
        cands[0] = prev
        cands[1, 1:] = prev[:-1]
        cands[2, 2:] = np.where(skip[2:], prev[:-2], -np.inf)
        j = np.argmax(cands, axis=0)
        dp[t] = cands[j, idx] + lp[t]
        bp[t] = idx - j
    ends = [s_len - 1] + ([s_len - 2] if s_len > 1 else [])
    s = max(ends, key=lambda e: dp[t_len - 1, e])
    path: List[int] = [0] * t_len
    spath: List[int] = [0] * t_len
    for t in range(t_len - 1, -1, -1):
        path[t] = int(states[s])
        spath[t] = int(s)
        s = bp[t, s]
    if return_states:
        return path, spath
    return path
