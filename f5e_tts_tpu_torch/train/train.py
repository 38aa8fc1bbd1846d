"""The training entry point: YAML config -> backbone -> Trainer -> dataset ->
train (counterpart of `f5e_tts_tpu/train/train.py`).

reference: src/f5_tts/train/train.py:18-105 (Hydra main); here plain YAML
and argparse, the schema of configs/example.yaml. One device: the card
unless --device cpu.

As in the JAX CLI, the Trainer gets no PPG extractor and the dataset no PPG,
so a `use_ppg` model trains on zero PPG (`ppg_embed_fn` of no PPG); the
pinyin and g2p-mix tokenizers raise (pypinyin and g2p_mix are absent).

    python -m f5e_tts_tpu_torch.train.train --config configs/example.yaml \\
        [--data_dir data] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def make_tokenize(model_cfg, vocab):
    """The training side's texts -> (B, NT) ids of a model config (the
    reference's in-dataset tokenization, model/dataset.py:128-181): bytes,
    or the characters of a char/custom vocab, interspersed when the align
    loss or the cross mask reads them (cfm.py:509-510)."""
    from f5e_tts_tpu_torch.utils import text as ftext

    def tokenize(texts):
        if model_cfg.tokenizer in ("pinyin", "char-level-pinyin", "phone-level-pinyin", "g2p-mix"):
            raise NotImplementedError(f"tokenizer {model_cfg.tokenizer!r} needs pypinyin / "
                                      "g2p_mix, which the port does not have")
        if model_cfg.tokenizer == "byte":
            return ftext.list_str_to_bytes(list(texts))
        toks = [list(t) for t in texts]
        arch = model_cfg.arch
        if getattr(arch, "codebook", None) and (arch.codebook.use_align_loss
                                                or arch.ppg.use_cross_mask):
            toks = ftext.intersperse(toks)
        return ftext.list_str_to_idx(toks, vocab)

    return tokenize


def main(argv=None):
    import yaml

    from f5e_tts_tpu_torch.config import load_train_yaml, load_yaml
    from f5e_tts_tpu_torch.data.dataset import ArrowSpeechDataset, build_loader
    from f5e_tts_tpu_torch.train.trainer import Trainer
    from f5e_tts_tpu_torch.utils import text as ftext

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="training yaml (example.yaml layout)")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--dataset_name", default=None)
    p.add_argument("--pretrained", default=None, help="reference-layout checkpoint to start from")
    p.add_argument("--max_updates", type=int, default=None)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    model_cfg = load_yaml(args.config)
    train_cfg = load_train_yaml(args.config)
    with open(args.config, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    datasets = raw.get("datasets", {})
    dataset_name = args.dataset_name or datasets.get("name", "Emilia_ZH_EN")
    vocab, vocab_size = ftext.get_tokenizer(model_cfg.tokenizer_path or dataset_name,
                                            model_cfg.tokenizer, data_dir=args.data_dir)
    tokenize = make_tokenize(model_cfg, vocab)

    dataset_type = datasets.get("dataset_type", "CustomDataset")
    if dataset_type != "CustomDataset":
        raise NotImplementedError(f"dataset_type {dataset_type!r}: the port reads "
                                  "CustomDataset directories only")
    dataset = ArrowSpeechDataset.from_dir(
        os.path.join(args.data_dir, f"{dataset_name}_{model_cfg.tokenizer}"), mel=model_cfg.mel)
    loader = build_loader(dataset, tokenize, frames_threshold=train_cfg.batch_size_per_device,
                          max_samples=train_cfg.max_samples, seed=train_cfg.seed)

    logs = []

    def log_fn(metrics, update):
        logs.append((update, metrics))
        if update % 10 == 0:
            print(f"update {update}: loss={metrics['loss']:.4f} "
                  f"grad_norm={metrics['grad_norm']:.3f}")
        if train_cfg.logger == "tensorboard":
            _tb_log(train_cfg.save_dir, metrics, update)
        elif train_cfg.logger == "wandb":
            _wandb_log(metrics, update)

    trainer = Trainer(model_cfg, train_cfg, vocab_size=vocab_size, tokenize=tokenize,
                      log_fn=log_fn, device=args.device)
    if args.pretrained:
        trainer.init_state(len(loader) * train_cfg.epochs, pretrained_path=args.pretrained)
    ts, info = trainer.train(loader, resume=not args.no_resume, max_updates=args.max_updates)
    print(f"done: {info['updates']} updates in {info['seconds']:.0f}s "
          f"({info['updates'] / max(info['seconds'], 1e-9):.2f} updates/s)")
    return ts


_wandb_started = {"init": False}


def _wandb_log(metrics, update):
    """wandb logging (reference trainer.py:59-99), when the package is there."""
    try:
        import wandb
    except ImportError:
        return
    if not _wandb_started["init"]:
        wandb.init(project="f5e-tts-tpu", resume="allow")
        _wandb_started["init"] = True
    wandb.log(metrics, step=update)


_tb_writers = {}


def _tb_log(save_dir, metrics, update):
    """TensorBoard scalars under {save_dir}/tb, when the package is there."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return
    w = _tb_writers.setdefault(save_dir, SummaryWriter(os.path.join(save_dir, "tb")))
    for k, v in metrics.items():
        w.add_scalar(k, v, update)


if __name__ == "__main__":
    main()
