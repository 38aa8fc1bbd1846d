"""Training loop on one device: data -> step -> EMA -> checkpoints -> logs
(counterpart of `f5e_tts_tpu/train/trainer.py`, without the mesh).

reference: src/f5_tts/model/trainer.py:25-494.

- the log-mel frontend runs on the card inside the step, from the raw audio
  the loader carries (`loss_with_device_mel`); a PPG model's PPG comes from
  the batch or, when it has none, from `ppg_extractor` over the batch's 16 kHz
  audio, on the card (JAX trainer.py:432-443),
- EMA, grad clip and the NaN skip live in the step (train/step.py),
- checkpoints: the full train state with torch.save as `model_last.pt` or
  `model_{update}.pt`, a `.meta.json` beside it, and the EMA weights in the
  reference layout under `ema_model.` in the same file (the reference's .pt
  dict {ema_model_state_dict, update}, trainer.py:150-163), so
  `utils/convert.py: load_state_dict` reads the port's checkpoints as it
  reads the reference's (a PPG model's BatchNorm statistics among them,
  from the model state: the EMA covers the params only). Rotation keeps the last N numbered checkpoints and
  never deletes pretrained_* (trainer.py:166-183); resume prefers model_last
  (trainer.py:185-263); `init_state(pretrained_path=)` starts from the EMA
  weights of a reference-layout checkpoint,
- a SIGTERM saves model_last at the next step boundary,
- `sample_fn` (`make_sample_logger`) writes a sample every
  log_samples_per_updates updates (trainer.py:434-490).
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from f5e_tts_tpu_torch.config import MelConfig, ModelConfig, TrainConfig
from f5e_tts_tpu_torch.models import backbone as fbb
from f5e_tts_tpu_torch.models import cfm as fcfm
from f5e_tts_tpu_torch.ops.mel import mel_spectrogram
from f5e_tts_tpu_torch.train import step as fstep
from f5e_tts_tpu_torch.utils.convert import backbone_to_reference_state_dict
from f5e_tts_tpu_torch.utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_sample_logger(model_cfg: ModelConfig, vocab, tokenizer: str, save_dir: str,
                       sample_text: str, ref_mel: np.ndarray, ref_text: str,
                       vocoder_decode=None, nfe: int = 32, device="cuda"):
    """The periodic sample hook (reference trainer.py:434-490):
    sample_fn(ema_params, update, state) synthesises `sample_text` after the
    (ref_frames, mel) prompt `ref_mel` at twice its length with the EMA
    weights (fp32, on `device`), saves the generated mel as
    update_{N}_gen_mel.npy beside the checkpoints and, with a vocoder,
    update_{N}_gen.wav."""
    from f5e_tts_tpu_torch.infer.audio import write_wav
    from f5e_tts_tpu_torch.infer.pipeline import TTSEngine

    def sample_fn(ema_params, update: int, state: Optional[dict] = None):
        engine = TTSEngine(params=ema_params, state=state or {}, arch=model_cfg.arch,
                           vocab=vocab, mel=model_cfg.mel, cfm=model_cfg.cfm,
                           infer_cfg=model_cfg.infer, tokenizer=tokenizer,
                           vocoder_decode=vocoder_decode, compute_dtype=torch.float32,
                           device=device)
        with torch.no_grad():
            mel_gen = engine.synthesize_chunk(ref_mel[None], ref_text + " " + sample_text,
                                              ref_mel.shape[0] * 2, seed=update, nfe_steps=nfe)
        if vocoder_decode is not None:
            wav = np.asarray(vocoder_decode(torch.as_tensor(mel_gen[None])))[0]
            write_wav(os.path.join(save_dir, f"update_{update}_gen.wav"), wav,
                      model_cfg.mel.target_sample_rate)
        np.save(os.path.join(save_dir, f"update_{update}_gen_mel.npy"), mel_gen)

    return sample_fn


def loss_with_device_mel(params, arch, cfm, mel_cfg: MelConfig, batch: dict,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[fcfm.LossDraws] = None,
                         compute_dtype=torch.bfloat16, training: bool = True,
                         state: Optional[dict] = None) -> fcfm.CFMLossOut:
    """cfm_loss, computing the log-mel on the batch's device when the batch
    carries raw audio (B, T) instead of a mel; a PPG DiT reads its `state`
    and the batch's text_lens, ppg and ppg_lens. The Gumbel temperature is
    cfm_loss's default 2.0 whatever the codebook's temp_start, as the JAX
    trainer passes none (f5e_tts_tpu/train/trainer.py: loss_with_device_mel)."""
    if "mel" in batch:
        mel = batch["mel"]
    else:
        n = batch["audio"].shape[1] // mel_cfg.hop_length
        mel = mel_spectrogram(batch["audio"], mel_cfg)[:, :n, :]
    kw = {}
    if fbb.uses_ppg(arch):
        kw = dict(state=state, text_lens=batch.get("text_lens"), ppg=batch.get("ppg"),
                  ppg_lens=batch.get("ppg_lens"))
    return fcfm.cfm_loss(params, arch, cfm, mel=mel, mel_lens=batch["mel_lens"],
                         text_ids=batch.get("text_ids"), generator=generator, draws=draws,
                         training=training, compute_dtype=compute_dtype, **kw)


@dataclass
class Trainer:
    model_cfg: ModelConfig
    train_cfg: TrainConfig
    vocab_size: int
    tokenize: Callable
    log_fn: Optional[Callable[[dict, int], None]] = None
    device: object = "cuda"
    ppg_extractor: object = None  # a frozen PPGExtractor (models/conformer.py) for PPG models
    # sample_fn(ema_params, update, model_state) every log_samples_per_updates
    # updates (`make_sample_logger`)
    sample_fn: Optional[Callable] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.arch = self.model_cfg.arch
        fbb.backbone_kind(self.arch)  # raises for an unknown config
        self.cfm = self.model_cfg.cfm
        if self.train_cfg.param_dtype != "float32":
            raise NotImplementedError("the port keeps fp32 master weights (param_dtype float32)")
        self.compute_dtype = _DTYPES[self.train_cfg.compute_dtype]
        self._init_ts = None
        os.makedirs(self.train_cfg.save_dir, exist_ok=True)

    # ------------------------------------------------------------------
    # state setup
    # ------------------------------------------------------------------

    def init_state(self, total_updates: int, rng_seed: int = 0,
                   pretrained_path: Optional[str] = None) -> fstep.TrainState:
        """Seeded fp32 params, or with `pretrained_path` the EMA weights (and a
        PPG DiT's BatchNorm statistics) of a reference-layout checkpoint
        (.pt or .safetensors, as `load_state_dict(use_ema=True)` reads it);
        the optimizer state and the EMA. `train` consumes a state armed here
        instead of re-initing."""
        if pretrained_path:
            from f5e_tts_tpu_torch.utils.convert import (backbone_from_reference_state_dict,
                                                         load_state_dict)

            made = backbone_from_reference_state_dict(
                load_state_dict(pretrained_path, use_ema=True), self.arch)
            made = fstep.tree_map(lambda t: t.to(self.device), made)
        else:
            gen = torch.Generator(device=self.device).manual_seed(rng_seed)
            made = fbb.init_backbone(self.arch, self.vocab_size, gen, self.device)
        params, model_state = fbb.split_state(self.arch, made)
        self.optimizer = fstep.make_optimizer(self.train_cfg, total_updates)
        ts = fstep.init_train_state(params, self.optimizer, model_state)
        self._init_ts = ts
        return ts

    def make_step(self):
        """step(ts, batch, generator) -> (ts, StepMetrics) for a batch of
        device tensors carrying audio or mel."""
        mel_cfg, arch, cfm, dtype = self.model_cfg.mel, self.arch, self.cfm, self.compute_dtype
        optimizer = self.optimizer
        ema = fstep.EMASettings.from_train_cfg(self.train_cfg)

        def step(ts, batch, generator, draws=None):
            def loss_fn(params):
                return loss_with_device_mel(params, arch, cfm, mel_cfg, batch, generator, draws,
                                            dtype, state=ts.model_state)

            return fstep.backward_and_apply(ts, loss_fn, optimizer=optimizer, ema=ema)

        return step

    def step_generator(self, ts: fstep.TrainState) -> torch.Generator:
        """The draws of micro-step micro + skipped: a generator seeded from
        (seed, consumed batches), so a resumed run repeats them (the JAX step
        folds the same count into its key)."""
        seed = self.train_cfg.seed * 1_000_003 + ts.micro + ts.skipped
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    # checkpointing (reference semantics: trainer.py:150-263)
    # ------------------------------------------------------------------

    def _ckpt_path(self, name: str) -> str:
        return os.path.join(self.train_cfg.save_dir, name)

    def save_checkpoint(self, ts: fstep.TrainState, last: bool = False):
        name = "model_last" if last else f"model_{ts.update}"
        cpu = lambda t: t.detach().cpu()  # noqa: E731
        ema_sd = backbone_to_reference_state_dict(ts.ema_params, self.arch,
                                                  state=ts.model_state)
        state = {
            "ema_model_state_dict": {f"ema_model.{k}": v for k, v in ema_sd.items()},
            "update": ts.update,
            "train_state": {
                "params": fstep.tree_map(cpu, ts.params),
                "ema_params": fstep.tree_map(cpu, ts.ema_params),
                "opt_state": fstep.tree_map(cpu, ts.opt_state.state_dict()),
                "model_state": fstep.tree_map(cpu, ts.model_state),
                "update": ts.update, "micro": ts.micro, "skipped": ts.skipped,
            },
        }
        tmp = self._ckpt_path(f"{name}.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, self._ckpt_path(f"{name}.pt"))
        with open(self._ckpt_path(f"{name}.meta.json"), "w") as f:
            json.dump({"update": ts.update}, f)
        if not last:
            self._rotate()

    def _rotate(self):
        keep = self.train_cfg.keep_last_n_checkpoints
        if keep < 0:
            return
        pat = re.compile(r"model_(\d+)\.pt$")
        ckpts = sorted((int(m.group(1)), name) for name in os.listdir(self.train_cfg.save_dir)
                       if (m := pat.match(name)))
        while len(ckpts) > keep:
            upd, name = ckpts.pop(0)
            for path in (name, f"model_{upd}.meta.json"):
                if os.path.exists(self._ckpt_path(path)):
                    os.remove(self._ckpt_path(path))

    def load_checkpoint(self, ts: fstep.TrainState) -> fstep.TrainState:
        """Resume: model_last > the highest numbered (trainer.py:185-205);
        `ts` unchanged when there is none."""
        d = self.train_cfg.save_dir
        if os.path.exists(os.path.join(d, "model_last.pt")):
            name = "model_last.pt"
        else:
            pat = re.compile(r"model_(\d+)\.pt$")
            nums = sorted((int(m.group(1)), n) for n in os.listdir(d) if (m := pat.match(n)))
            if not nums:
                return ts
            name = nums[-1][1]
        st = torch.load(os.path.join(d, name), map_location="cpu", weights_only=True)["train_state"]
        dev = lambda t: t.to(self.device)  # noqa: E731
        opt = st["opt_state"]
        return fstep.TrainState(
            params=fstep.tree_map(lambda t: dev(t).requires_grad_(True), st["params"]),
            ema_params=fstep.tree_map(dev, st["ema_params"]),
            # the 8-bit moments are {"codes", "scale"} dicts, AdamW's tensors
            opt_state=fstep.AdamWState(
                mu=fstep.tree_map(dev, opt["mu"]), nu=fstep.tree_map(dev, opt["nu"]),
                count=opt["count"], mini_step=opt["mini_step"],
                acc=None if opt["acc"] is None else [dev(t) for t in opt["acc"]]),
            update=st["update"], micro=st["micro"], skipped=st["skipped"],
            model_state=fstep.tree_map(dev, st.get("model_state", {})))

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------

    def device_batch(self, batch: dict) -> dict:
        """The batch's arrays on the device; a PPG model's batch with no
        `ppg` gets one from `ppg_extractor` over its `audio_16k` (the dataset's
        `with_16k_audio`)."""
        out = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        if fbb.uses_ppg(self.arch) and "ppg" not in out and self.ppg_extractor is not None:
            if "audio_16k" not in out:
                raise ValueError("PPG training needs 16 kHz audio in the batch (build the "
                                 "dataset with with_16k_audio=True) or a precomputed ppg")
            out["ppg"], out["ppg_lens"] = self.ppg_extractor.audio_to_ppg(
                out["audio_16k"], out["audio_16k_lens"])
        return out

    def train(self, loader, epochs: Optional[int] = None, resume: bool = True,
              max_updates: Optional[int] = None):
        tc = self.train_cfg
        epochs = epochs if epochs is not None else tc.epochs
        # schedule horizon in OPTIMIZER updates (reference trainer.py:334)
        total_updates = max_updates or (math.ceil(len(loader) / tc.grad_accumulation_steps)
                                        * epochs)
        ts = self._init_ts if self._init_ts is not None else self.init_state(
            total_updates, rng_seed=tc.seed)
        self._init_ts = None
        if resume:
            ts = self.load_checkpoint(ts)
        step = self.make_step()

        # preemption: a SIGTERM requests a final model_last save at the next
        # step boundary, so the job resumes exactly where it stopped
        preempted = {"flag": False}

        def _on_sigterm(signum, frame):
            preempted["flag"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not on the main thread
            prev_handler = None

        start_update = ts.update
        t0 = time.time()
        done = False
        # dataloader fast-forward on resume (reference trainer.py:347-352):
        # skip the batches already consumed (micro-steps incl. NaN skips)
        consumed = ts.micro + ts.skipped
        skip_epochs, skip_batches = divmod(consumed, max(len(loader), 1))
        try:
            for epoch in range(skip_epochs, epochs):
                if done:
                    break
                loader.sampler.set_epoch(epoch)
                batch_iter = iter(loader)
                for _ in range(skip_batches if epoch == skip_epochs else 0):
                    if next(batch_iter, None) is None:
                        break
                for batch in batch_iter:
                    t_step = time.time()
                    prev_update = ts.update
                    ts, metrics = step(ts, self.device_batch(batch), self.step_generator(ts))
                    if self.log_fn is not None:
                        self.log_fn({"loss": metrics.loss, "grad_norm": metrics.grad_norm,
                                     "flow_loss": metrics.flow_loss,
                                     "extra_loss": metrics.extra_loss,
                                     "align_loss": metrics.align_loss,
                                     "perplex_loss": metrics.perplex_loss,
                                     "step_seconds": time.time() - t_step}, ts.update)
                    # cadenced actions fire once per optimizer update
                    advanced = ts.update != prev_update
                    if advanced and ts.update % tc.last_per_updates == 0:
                        self.save_checkpoint(ts, last=True)
                    if advanced and ts.update % tc.save_per_updates == 0:
                        self.save_checkpoint(ts)
                    if (self.sample_fn is not None and advanced
                            and ts.update % tc.log_samples_per_updates == 0):
                        self.sample_fn(ts.ema_params, ts.update, ts.model_state)
                    if preempted["flag"]:
                        print("SIGTERM received — checkpointing and exiting")
                        done = True
                        break
                    if max_updates and ts.update >= max_updates:
                        done = True
                        break
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        self.save_checkpoint(ts, last=True)
        return ts, {"updates": ts.update - start_update, "seconds": time.time() - t0,
                    "preempted": preempted["flag"]}
