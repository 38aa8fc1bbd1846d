"""Quality-proxy runner: train a tiny CFM on toyspeech, distil it, score the
serving levers (counterpart of `scripts/quality_proxy.py`).

One device: the card unless --device cpu (the proxy's numbers do not depend
on the hardware beyond summation order; the card is faster).

    python -m f5e_tts_tpu_torch.eval.quality_proxy_cli train   --dir qp [--steps 4000]
    python -m f5e_tts_tpu_torch.eval.quality_proxy_cli distill --dir qp [--distill-steps 1500]
    python -m f5e_tts_tpu_torch.eval.quality_proxy_cli eval    --dir qp [--report qp.json]
    python -m f5e_tts_tpu_torch.eval.quality_proxy_cli all     --dir qp [--device cpu]

The eval scores one row per serving lever, every lever from the same
per-utterance noise (the differences isolate the lever):

    teacher_nfe32_cfg2   fp32, NFE 32, cfg 2, sway -1: the reference configuration
    nfe16                NFE 16
    epss16of32/8of32     EPSS pruned grids (arXiv 2505.19931) keeping 16/8 of 32 steps
    cfg0_base            cfg 0 on the base model: the no-guidance ablation
    int8_w8a8            W8A8 trunk quantization (unless --no-int8)
    cfg0_distill[_nfe16] cfg 0 on the distilled student (after `distill`)

Columns: TER (token error rate by the language's own decoder, the WER
proxy), mel MSE / MCD dB / LSD against the ground-truth mel, and MCD against
the teacher's own output (drift). Checkpoints are the port trainer's
`model_last.pt` under {dir}/teacher and {dir}/student.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch


def _configs(args):
    from f5e_tts_tpu_torch.config import CFMConfig, DiTConfig, ModelConfig, TrainConfig
    from f5e_tts_tpu_torch.eval import proxy_quality as pq

    arch = DiTConfig(dim=args.dim, depth=args.depth, heads=4, dim_head=args.dim // 4,
                     ff_mult=2, mel_dim=pq.MEL.n_mel_channels, text_dim=64,
                     conv_layers=2, dropout=0.0)
    model_cfg = ModelConfig(name="toyspeech", backbone="DiT", arch=arch, mel=pq.MEL,
                            cfm=CFMConfig())
    train_cfg = TrainConfig(
        learning_rate=2e-4, num_warmup_updates=200,
        save_per_updates=10 ** 9, last_per_updates=500,
        save_dir=os.path.join(args.dir, "teacher"),
        compute_dtype="float32", seed=0)
    return model_cfg, train_cfg


def _loader(args, n_utts: int, seed: int):
    from f5e_tts_tpu_torch.data import dataset as fdata
    from f5e_tts_tpu_torch.eval import proxy_quality as pq

    rows = pq.make_dataset(n_utts, seed=seed)
    ds = fdata.ArrowSpeechDataset(rows, durations=[r["duration"] for r in rows], mel=pq.MEL)
    # fixed-count batches and one length bucket (14 tokens = 168 frames):
    # every batch is (batch_utts, 168, 24)
    return fdata.build_loader(ds, pq.tokenize, frames_threshold=10 ** 9,
                              max_samples=args.batch_utts,
                              len_multiple=14 * pq.FRAMES_PER_TOKEN, seed=666,
                              batch_size_type="sample")


def _trainer(args, train_cfg, log_fn=None):
    from f5e_tts_tpu_torch.eval import proxy_quality as pq
    from f5e_tts_tpu_torch.train.trainer import Trainer

    model_cfg, _ = _configs(args)
    return Trainer(model_cfg, train_cfg, vocab_size=len(pq.VOCAB), tokenize=pq.tokenize,
                   log_fn=log_fn, device=args.device)


def cmd_train(args) -> dict:
    _, train_cfg = _configs(args)
    losses = []

    def log_fn(m, u):
        losses.append(m["loss"])
        if u % 200 == 0 or u <= 3:
            recent = sum(losses[-100:]) / len(losses[-100:])
            print(f"update {u}: loss {m['loss']:.4f} (avg100 {recent:.4f}) "
                  f"{m['step_seconds']:.3f}s/step", flush=True)

    trainer = _trainer(args, train_cfg, log_fn)
    _, info = trainer.train(_loader(args, args.train_utts, seed=1), epochs=10 ** 6,
                            resume=args.resume, max_updates=args.steps)
    out = {"phase": "train", "updates": info["updates"], "seconds": round(info["seconds"], 1),
           "first_loss": losses[0] if losses else None,
           "final_loss_avg100": round(sum(losses[-100:]) / max(len(losses[-100:]), 1), 4)}
    print(json.dumps(out))
    return out


def cmd_distill(args) -> dict:
    """CFG-distil a cfg-0 student from the trained teacher's EMA weights; the
    student starts from them (guidance distillation)."""
    _, train_cfg = _configs(args)
    teacher = os.path.join(args.dir, "teacher", "model_last.pt")
    if not os.path.exists(teacher):
        raise FileNotFoundError(f"no trained teacher at {teacher}: run `train` first")
    train_cfg = dataclasses.replace(train_cfg, save_dir=os.path.join(args.dir, "student"),
                                    learning_rate=1e-4, num_warmup_updates=100)
    losses = []

    def log_fn(m, u):
        losses.append(m["loss"])
        if u % 200 == 0 or u <= 3:
            print(f"distill update {u}: loss {m['loss']:.5f}", flush=True)

    trainer = _trainer(args, train_cfg, log_fn)
    trainer.set_teacher(teacher, cfg_strength=args.distill_cfg)
    trainer.init_state(args.steps, rng_seed=0, pretrained_path=teacher)
    _, info = trainer.train(_loader(args, args.train_utts, seed=1), epochs=10 ** 6,
                            resume=args.resume, max_updates=args.steps)
    out = {"phase": "distill", "updates": info["updates"], "seconds": round(info["seconds"], 1),
           "first_loss": losses[0] if losses else None,
           "final_loss": losses[-1] if losses else None}
    print(json.dumps(out))
    return out


def _load_ema(args, save_dir: str) -> dict:
    """The EMA params of the trainer checkpoint under `save_dir`, on the device."""
    _, train_cfg = _configs(args)
    trainer = _trainer(args, dataclasses.replace(train_cfg, save_dir=save_dir))
    ts = trainer.load_checkpoint(trainer.init_state(total_updates=1, rng_seed=0))
    if ts.update <= 0:
        raise FileNotFoundError(f"no trained checkpoint under {save_dir}")
    return ts.ema_params


def eval_inputs(eval_utts: int, prompt_tokens: int, device="cuda"):
    """The held-out utterances (a seed disjoint from training's) as sampler
    inputs: (inputs, texts, n_toks, gt_mels); every utterance padded into
    the 192-frame bucket, its first `prompt_tokens` tokens the prompt."""
    from f5e_tts_tpu_torch.eval import proxy_quality as pq
    from f5e_tts_tpu_torch.models import cfm as fcfm

    rng = np.random.default_rng(12345)
    utts = [pq.make_utterance(rng) for _ in range(eval_utts)]
    frames = pq.FRAMES_PER_TOKEN
    bucket = 16 * frames  # at most 14 tokens, 168 frames, padded to 192
    gt_mels, texts, n_toks = [], [], []
    for text, _, wav in utts:
        gt_mels.append(pq._mel(wav)[: len(text) * frames])
        texts.append(text)
        n_toks.append(len(text))
    b = len(utts)
    cond = np.zeros((b, bucket, pq.MEL.n_mel_channels), np.float32)
    for i, m in enumerate(gt_mels):
        cond[i, : prompt_tokens * frames] = m[: prompt_tokens * frames]
    lens = np.full((b,), prompt_tokens * frames, np.int32)
    duration = np.asarray([n * frames for n in n_toks], np.int32)
    text_ids = pq.tokenize(texts)
    text_pad = np.full((b, 16), -1, np.int32)
    text_pad[:, : text_ids.shape[1]] = text_ids
    dev = torch.device(device)
    inputs = fcfm.prepare_inputs(torch.from_numpy(cond).to(dev), torch.from_numpy(lens).to(dev),
                                 torch.from_numpy(duration).to(dev), bucket,
                                 text_ids=torch.from_numpy(text_pad).to(dev))
    return inputs, texts, n_toks, gt_mels


def make_levers(params: dict, student: Optional[dict], int8: bool = True) -> dict:
    """{name: {p, steps, cfg, ts}} of the lever table, the teacher first."""
    from f5e_tts_tpu_torch.models.cfm import pruned_sway_timesteps

    levers = {
        "teacher_nfe32_cfg2": dict(p=params, steps=32, cfg=2.0, ts=None),
        "nfe16": dict(p=params, steps=16, cfg=2.0, ts=None),
        "epss16of32": dict(p=params, steps=32, cfg=2.0,
                           ts=pruned_sway_timesteps(tuple(range(0, 33, 2)))),
        "epss8of32": dict(p=params, steps=32, cfg=2.0,
                          ts=pruned_sway_timesteps((0, 1, 2, 3, 4, 6, 10, 18, 32))),
        "cfg0_base": dict(p=params, steps=32, cfg=0.0, ts=None),
    }
    if int8:
        from f5e_tts_tpu_torch.ops.quant import quantize_backbone_params

        levers["int8_w8a8"] = dict(p=quantize_backbone_params(params, "DiT"), steps=32,
                                   cfg=2.0, ts=None)
    if student is not None:
        levers["cfg0_distill"] = dict(p=student, steps=32, cfg=0.0, ts=None)
        levers["cfg0_distill_nfe16"] = dict(p=student, steps=16, cfg=0.0, ts=None)
    return levers


def score_levers(levers: dict, arch, cfm, inputs, texts, n_toks, gt_mels, prompt_tokens: int,
                 *, seeds, device="cuda", log=print) -> dict:
    """Sample every lever (fp32, sway -1, the key mask on) from the same noise
    and score it: {name: {ter_pct, mel_mse, mcd_db, lsd, mcd_vs_teacher_db}}
    over the generated frames, the first lever being the teacher. The noise
    is drawn per utterance from `seeds` (B,), the JAX script's for the same
    seeds and the same for every lever (scripts/quality_proxy.py:226-253)."""
    from f5e_tts_tpu_torch.eval import proxy_quality as pq
    from f5e_tts_tpu_torch.models import cfm as fcfm

    frames = pq.FRAMES_PER_TOKEN
    results, teacher_out = {}, None
    for name, lv in levers.items():
        with torch.no_grad():
            out, _ = fcfm.sample(lv["p"], arch, cfm, inputs, steps=lv["steps"],
                                 cfg_strength=lv["cfg"], sway_coef=-1.0, use_mask=True,
                                 seeds=seeds, timesteps=lv["ts"], compute_dtype=torch.float32,
                                 device=device)
        out = out.float().cpu().numpy()
        if teacher_out is None:
            teacher_out = out
        ters, metrics, drift = [], [], []
        for i, n in enumerate(n_toks):
            gen = slice(prompt_tokens * frames, n * frames)
            hyp = pq.decode_mel(out[i, : n * frames], n, start_token=prompt_tokens)
            ters.append(pq.token_error_rate(hyp, texts[i][prompt_tokens:]))
            metrics.append(pq.mel_metrics(out[i, gen], gt_mels[i][gen]))
            drift.append(pq.mel_metrics(out[i, gen], teacher_out[i, gen])["mcd_db"])
        row = {
            "ter_pct": round(100 * float(np.mean(ters)), 2),
            "mel_mse": round(float(np.mean([m["mel_mse"] for m in metrics])), 4),
            "mcd_db": round(float(np.mean([m["mcd_db"] for m in metrics])), 3),
            "lsd": round(float(np.mean([m["lsd"] for m in metrics])), 4),
            "mcd_vs_teacher_db": round(float(np.mean(drift)), 3),
        }
        results[name] = row
        log(f"[{name:22s}] TER {row['ter_pct']:6.2f}%  MCD {row['mcd_db']:6.3f} dB  "
            f"LSD {row['lsd']:.4f}  drift-MCD {row['mcd_vs_teacher_db']:6.3f} dB")
    return results


def gt_decoder_ter_pct(texts, n_toks, gt_mels, prompt_tokens: int) -> float:
    """The decoder's TER on the ground-truth mel, in percent: ~0 for a sound
    decoder."""
    from f5e_tts_tpu_torch.eval import proxy_quality as pq

    return round(100 * float(np.mean([
        pq.token_error_rate(pq.decode_mel(gt_mels[i], n, start_token=prompt_tokens),
                            texts[i][prompt_tokens:]) for i, n in enumerate(n_toks)])), 3)


def cmd_eval(args) -> dict:
    model_cfg, _ = _configs(args)
    params = _load_ema(args, os.path.join(args.dir, "teacher"))
    sdir = os.path.join(args.dir, "student")
    student = (_load_ema(args, sdir) if os.path.exists(os.path.join(sdir, "model_last.pt"))
               else None)
    prompt = args.prompt_tokens
    inputs, texts, n_toks, gt_mels = eval_inputs(args.eval_utts, prompt, args.device)
    seeds = list(range(7000, 7000 + len(texts)))
    results = score_levers(make_levers(params, student, int8=not args.no_int8),
                           model_cfg.arch, model_cfg.cfm, inputs, texts, n_toks, gt_mels,
                           prompt, seeds=seeds, device=args.device,
                           log=lambda m: print(m, flush=True))
    results["_gt_decoder_ter_pct"] = gt_decoder_ter_pct(texts, n_toks, gt_mels, prompt)
    print(f"[gt decoder sanity    ] TER {results['_gt_decoder_ter_pct']:.3f}% (must be ~0)")

    report = {"arch": {"dim": args.dim, "depth": args.depth}, "eval_utts": len(texts),
              "prompt_tokens": prompt, "device": str(args.device), "levers": results}
    path = args.report or os.path.join(args.dir, "quality_proxy.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"phase": "eval", "report": path}))
    print("\n| lever | TER % | mel MSE | MCD dB | LSD | MCD vs teacher dB |")
    print("|---|---|---|---|---|---|")
    for name, r in results.items():
        if not name.startswith("_"):
            print(f"| {name} | {r['ter_pct']} | {r['mel_mse']} | {r['mcd_db']} | "
                  f"{r['lsd']} | {r['mcd_vs_teacher_db']} |")
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=["train", "distill", "eval", "all"])
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), "quality_proxy"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--distill-steps", type=int, default=1500)
    ap.add_argument("--distill-cfg", type=float, default=2.0)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--train-utts", type=int, default=2048)
    ap.add_argument("--eval-utts", type=int, default=64)
    ap.add_argument("--prompt-tokens", type=int, default=3)
    ap.add_argument("--batch-utts", type=int, default=16)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-int8", action="store_true")
    ap.add_argument("--report", default=None)
    return ap


def main(argv=None) -> dict:
    """Runs the subcommand; returns {phase: its summary} (the eval's report)."""
    from f5e_tts_tpu_torch.utils.device import resolve_device

    args = parser().parse_args(argv)
    args.device = resolve_device(args.device)
    os.makedirs(args.dir, exist_ok=True)
    done = {}
    if args.cmd in ("train", "all"):
        done["train"] = cmd_train(args)
    if args.cmd in ("distill", "all"):
        a = argparse.Namespace(**vars(args))
        a.steps = args.distill_steps
        done["distill"] = cmd_distill(a)
    if args.cmd in ("eval", "all"):
        done["eval"] = cmd_eval(args)
    return done


if __name__ == "__main__":
    main()
