"""CFG distillation: train a student whose single forward matches the
teacher's guidance-combined flow (counterpart of
`f5e_tts_tpu/train/distill.py`; arXiv 2504.20334, "Towards Flow-Matching-
based TTS without Classifier-Free Guidance").

At inference the sampler runs two backbone branches a step, cond and
uncond, combined as (1 + w) v_cond - w v_uncond (reference cfm.py:439-448;
`models/cfm.py: cfg_branches`). A student distilled on that combination
serves with cfg_strength=0: one branch a step, half the sampler's rows at
the same NFE.

- The teacher's two branches run as one folded 2B-batch forward, in eval
  mode and under `torch.no_grad()`; the student runs one drop-free pass in
  training mode (its dropout active).
- The span, time and noise draws are those of `cfm_loss`, in its order
  (frac, span, x0, time), so the student sees the infilling task it will
  serve. Tests hand over draws made from a JAX key through `draws=`.
- `init_distill` copies the teacher: the optimizer updates the student in
  place, so a student that shared the teacher's storage would move it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from f5e_tts_tpu_torch.config import CFMConfig, MelConfig
from f5e_tts_tpu_torch.models import backbone as fbb
from f5e_tts_tpu_torch.models import cfm as fcfm
from f5e_tts_tpu_torch.ops import prng
from f5e_tts_tpu_torch.parallel import mesh as pmesh
from f5e_tts_tpu_torch.train import step as fstep


class DistillLossOut(NamedTuple):
    loss: torch.Tensor  # fp32 scalar
    teacher_flow: torch.Tensor  # (B, N, mel) fp32, the CFG-combined target
    student_pred: torch.Tensor  # (B, N, mel)


def cfg_distill_loss(student_params, teacher_params, arch, cfm: CFMConfig, *,
                     mel: torch.Tensor, mel_lens: torch.Tensor,
                     text_ids: Optional[torch.Tensor],
                     rng: Optional[torch.Tensor] = None,
                     draws: Optional[fcfm.LossDraws] = None, cfg_strength: float = 2.0,
                     training: bool = True, compute_dtype=torch.bfloat16,
                     state: Optional[dict] = None) -> DistillLossOut:
    """Masked-span MSE between the student's single pass and the teacher's
    CFG-combined flow at the same (phi, t, cond): sum(se * w) / max(sum(w) *
    mel_dim, 1) over the span (reference: f5e_tts_tpu distill.py:41-116).

    The teacher's rows are [cond | uncond]: drop_audio_cond = drop_text =
    [False..., True...] and the PPG dropped in both; its flow is (1 + w)
    v_cond - w v_uncond in fp32, with no gradient. The student drops
    nothing but the PPG and runs in training mode when `training`. The
    threefry key `rng` (PRNGKey(0) when None) is split in 5 as the JAX loss
    splits it (distill.py:66): frac, span, time, noise (`cfm.row_draws`;
    fields of `draws` replace them) and the student's dropout. A PPG DiT
    reads its BatchNorm `state`."""
    b, n, _ = mel.shape
    dev = mel.device
    d = draws or fcfm.LossDraws()
    bm = pmesh.batch_mesh()  # a batch mesh: the global run's draws and loss, as cfm_loss
    rng = prng.prng_key(0) if rng is None else rng
    r_frac, r_span, r_time, r_noise, r_model = prng.split(rng, 5)
    span, x0, time = fcfm.row_draws(d, b, n, mel.shape[-1], mel_lens, cfm,
                                    (r_frac, r_span, r_noise, r_time), dev)
    x1 = mel.float()
    x0 = x0.float()
    t = time[:, None, None]
    phi = (1 - t) * x0 + t * x1
    cond = x1.masked_fill(span[:, :, None], 0.0)

    ones = torch.ones(b, dtype=torch.bool, device=dev)
    zeros = torch.zeros(b, dtype=torch.bool, device=dev)
    ppg = fbb.uses_ppg(arch)

    with torch.no_grad():
        branch = torch.cat([zeros, ones])
        pred2 = fbb.forward_train(
            teacher_params, arch, x=torch.cat([phi, phi]).to(compute_dtype),
            cond=torch.cat([cond, cond]).to(compute_dtype),
            text_ids=None if text_ids is None else torch.cat([text_ids, text_ids]),
            time=torch.cat([time, time]), drop_audio_cond=branch, drop_text=branch,
            mask=None, training=False, compute_dtype=compute_dtype, state=state,
            **(dict(drop_ppg=torch.cat([ones, ones])) if ppg else {}))
        v_cond, v_uncond = pred2[:b].float(), pred2[b:].float()
        teacher_flow = (1.0 + cfg_strength) * v_cond - cfg_strength * v_uncond

    student_pred = fbb.forward_train(
        student_params, arch, x=phi.to(compute_dtype), cond=cond.to(compute_dtype),
        text_ids=text_ids, time=time, drop_audio_cond=zeros, drop_text=zeros, mask=None,
        training=training, rng=r_model, compute_dtype=compute_dtype, state=state,
        **(dict(drop_ppg=ones) if ppg else {}))

    se = (student_pred.float() - teacher_flow).square()
    w = span[:, :, None].float()
    loss = pmesh.global_mean((se * w).sum(), w.sum() * se.shape[-1], bm, min_den=1.0)
    return DistillLossOut(loss=loss, teacher_flow=teacher_flow, student_pred=student_pred)


def distill_loss_with_device_mel(student_params, teacher_params, arch, cfm: CFMConfig,
                                 mel_cfg: MelConfig, batch: dict,
                                 rng: Optional[torch.Tensor] = None,
                                 draws: Optional[fcfm.LossDraws] = None,
                                 compute_dtype=torch.bfloat16, cfg_strength: float = 2.0,
                                 state: Optional[dict] = None) -> fcfm.CFMLossOut:
    """The Trainer's loss in distillation mode: a batch of audio or mel ->
    `cfg_distill_loss` in training mode, as a CFMLossOut (cond = the
    teacher's flow, pred = the student's; no extra loss and no new model
    state), so the trainer's step, EMA, accumulation and checkpoints run
    unchanged (reference: f5e_tts_tpu distill.py:118-143)."""
    from f5e_tts_tpu_torch.ops.mel import mel_spectrogram

    if "mel" in batch:
        mel = batch["mel"]
    else:
        n = batch["audio"].shape[1] // mel_cfg.hop_length
        mel = mel_spectrogram(batch["audio"], mel_cfg)[:, :n, :]
    out = cfg_distill_loss(student_params, teacher_params, arch, cfm, mel=mel,
                           mel_lens=batch["mel_lens"], text_ids=batch.get("text_ids"),
                           rng=rng, draws=draws, cfg_strength=cfg_strength,
                           training=True, compute_dtype=compute_dtype, state=state)
    zero = torch.zeros((), device=mel.device)
    return fcfm.CFMLossOut(loss=out.loss, flow_loss=out.loss, cond=out.teacher_flow,
                           pred=out.student_pred, extra_loss=zero, new_state=None,
                           align_loss=zero, perplex_loss=zero)


# The JAX DistillState (params, opt_state, step) is the port's TrainState:
# `make_distill_step` runs the Trainer's own update (`step.backward_and_apply`),
# so the distillation has one update path.
DistillState = fstep.TrainState


def init_distill(teacher_params: dict, optimizer) -> DistillState:
    """A student initialised from the teacher (guidance distillation: it
    learns only the guidance offset), copied: the optimizer updates it in
    place, and the teacher must stay as it is."""
    return fstep.init_train_state(
        fstep.tree_map(lambda t: t.detach().float().clone(), teacher_params), optimizer)


def make_distill_step(teacher_params, arch, cfm: CFMConfig, optimizer,
                      cfg_strength: float = 2.0, compute_dtype=torch.bfloat16):
    """step(ds, mel, mel_lens, text_ids, rng=None, draws=None) -> (ds,
    StepMetrics): one distillation update of the student in place with
    `optimizer` (`train.step.AdamW` or `AdamW8bit`: init(list) and
    update_(state, params, grads)), through the Trainer's update
    (reference: f5e_tts_tpu distill.py:146-179)."""

    def step(ds: DistillState, mel, mel_lens, text_ids, rng=None, draws=None):
        batch = {"mel": mel, "mel_lens": mel_lens, "text_ids": text_ids}
        return fstep.backward_and_apply(
            ds, lambda params: distill_loss_with_device_mel(
                params, teacher_params, arch, cfm, None, batch, rng, draws,
                compute_dtype, cfg_strength=cfg_strength, state=ds.model_state),
            optimizer=optimizer, ema=fstep.EMASettings())

    return step
