"""CFG-distillation entry point: a teacher checkpoint -> a cfg-free student
(counterpart of `f5e_tts_tpu/train/distill_cli.py`).

The Trainer (EMA, checkpoint rotation, preemption, resume) runs with the
distillation loss (train/distill.py, arXiv 2504.20334): the student's single
forward learns the teacher's guidance-combined flow, so its exported
checkpoint serves with ``cfg_strength=0``, one branch a sampler step in
place of two. One device: the card unless --device cpu.

    python -m f5e_tts_tpu_torch.train.distill_cli --config configs/example.yaml \\
        --teacher ckpts/model_last.pt [--cfg_strength 2.0] [--data_dir data] \\
        [--max_updates N] [--device cpu]

The student starts from the teacher (it learns only the guidance offset)
unless --student names another checkpoint.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    import yaml

    from f5e_tts_tpu_torch.config import load_train_yaml, load_yaml
    from f5e_tts_tpu_torch.data.dataset import build_loader, load_speech_dataset
    from f5e_tts_tpu_torch.train.train import make_tokenize
    from f5e_tts_tpu_torch.train.trainer import Trainer
    from f5e_tts_tpu_torch.utils import text as ftext

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="training yaml (example.yaml layout)")
    p.add_argument("--teacher", required=True, help="teacher checkpoint (.pt/.safetensors)")
    p.add_argument("--student", default=None, help="student init checkpoint; default: the teacher")
    p.add_argument("--cfg_strength", type=float, default=2.0,
                   help="the guidance strength the student distills (the teacher's serving one)")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--dataset_name", default=None)
    p.add_argument("--max_updates", type=int, default=None)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    model_cfg = load_yaml(args.config)
    train_cfg = load_train_yaml(args.config)
    with open(args.config, "r", encoding="utf-8") as f:
        datasets = yaml.safe_load(f).get("datasets", {})
    dataset_name = args.dataset_name or datasets.get("name", "Emilia_ZH_EN")
    vocab, vocab_size = ftext.get_tokenizer(model_cfg.tokenizer_path or dataset_name,
                                            model_cfg.tokenizer, data_dir=args.data_dir)
    tokenize = make_tokenize(model_cfg, vocab)
    dataset = load_speech_dataset(dataset_name, model_cfg.tokenizer,
                                  dataset_type=datasets.get("dataset_type", "CustomDataset"),
                                  data_root=args.data_dir, mel=model_cfg.mel)
    loader = build_loader(dataset, tokenize, frames_threshold=train_cfg.batch_size_per_device,
                          max_samples=train_cfg.max_samples, seed=train_cfg.seed)

    def log_fn(metrics, update):
        if update % 10 == 0:
            print(f"update {update}: distill_loss={metrics['loss']:.5f} "
                  f"grad_norm={metrics['grad_norm']:.3f}")

    trainer = Trainer(model_cfg, train_cfg, vocab_size=vocab_size, tokenize=tokenize,
                      log_fn=log_fn, device=args.device, distill_cfg_strength=args.cfg_strength)
    trainer.set_teacher(args.teacher)
    trainer.init_state(len(loader) * train_cfg.epochs,
                       pretrained_path=args.student or args.teacher)
    ts, info = trainer.train(loader, resume=not args.no_resume, max_updates=args.max_updates)
    print(f"distilled: {info['updates']} updates in {info['seconds']:.0f}s; "
          f"serve the exported checkpoint with cfg_strength=0")
    return ts


if __name__ == "__main__":
    main()
