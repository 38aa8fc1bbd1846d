"""Finetune CLI: argparse over the architecture presets (counterpart of
`f5e_tts_tpu/train/finetune_cli.py`; reference: src/f5_tts/train/
finetune_cli.py).

The presets are F5TTS_v1_Base, F5TTS_Base, F5TTS_Small and E2TTS_Base. With
--finetune the pretrained checkpoint (a local path: nothing is downloaded) is
copied into ckpts/<dataset_name>/ as pretrained_<name>, which rotation never
deletes, and training starts from its EMA weights. The run directory is
relative to the working directory. The card unless --device cpu; launched
once per rank under torchrun, the ranks train data-parallel (each on
cuda:<LOCAL_RANK>, its rows of every batch; --transport as train/train.py).
Texts become ids as in the JAX CLI (`finetune_tokenize`): "pinyin" (the
default; it needs jieba and pypinyin) and "char-level-pinyin" through
`convert_char_to_pinyin`, "byte" as UTF-8, any other name as characters.

    python -m f5e_tts_tpu_torch.train.finetune_cli --dataset_name my_set \\
        --tokenizer char --finetune --pretrain model_1250000.pt [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="f5e-tts-tpu-torch_finetune-cli")
    p.add_argument("--exp_name", default="F5TTS_v1_Base",
                   choices=["F5TTS_v1_Base", "F5TTS_Base", "F5TTS_Small", "E2TTS_Base"])
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--data_dir", default="data")
    p.add_argument("--pretrain", default=None, help="local pretrained checkpoint path")
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--tokenizer", default="pinyin")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--batch_size_per_gpu", type=int, default=3200)
    p.add_argument("--batch_size_type", default="frame", choices=["frame", "sample"])
    p.add_argument("--max_samples", type=int, default=64)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num_warmup_updates", type=int, default=20000)
    p.add_argument("--save_per_updates", type=int, default=50000)
    p.add_argument("--keep_last_n_checkpoints", type=int, default=-1)
    p.add_argument("--last_per_updates", type=int, default=5000)
    p.add_argument("--max_updates", type=int, default=None)
    p.add_argument("--bnb_optimizer", action="store_true",
                   help="8-bit AdamW moments (reference finetune_cli.py:70; here "
                        "train/adamw8bit.py)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--transport", default=None, choices=["nccl", "gloo", "gloo-host"],
                   help="the ranks' collectives (default: nccl on the card, gloo on the CPU)")
    return p.parse_args(argv)


def finetune_tokenize(tokenizer: str, vocab):
    """This CLI's texts -> (B, NT) ids, the JAX CLI's closure
    (finetune_cli.py:82-92): TONE3 pinyin for "pinyin" and
    "char-level-pinyin", UTF-8 bytes for "byte", the characters for every
    other name ("phone-level-pinyin" and "g2p-mix" included, as there; the
    YAML CLI's `train.make_tokenize` phonemizes those two)."""
    from f5e_tts_tpu_torch.utils import text as ftext

    def tokenize(texts):
        if tokenizer in ("pinyin", "char-level-pinyin"):
            toks = ftext.convert_char_to_pinyin(list(texts))
        elif tokenizer == "byte":
            return ftext.list_str_to_bytes(list(texts))
        else:
            toks = [list(t) for t in texts]
        return ftext.list_str_to_idx(toks, vocab)

    return tokenize


def main(argv=None):
    import dataclasses

    from f5e_tts_tpu_torch.config import TrainConfig, preset
    from f5e_tts_tpu_torch.data.dataset import ArrowSpeechDataset, build_loader
    from f5e_tts_tpu_torch.parallel import multihost
    from f5e_tts_tpu_torch.parallel.mesh import ShardedLoader
    from f5e_tts_tpu_torch.train.trainer import Trainer
    from f5e_tts_tpu_torch.utils import text as ftext

    args = parse_args(argv)
    multihost.initialize()  # a rank of torchrun's world; nothing for one process
    device = multihost.local_device(args.device)
    main_rank = multihost.process_index() == 0
    model_cfg = dataclasses.replace(preset(args.exp_name), tokenizer=args.tokenizer,
                                    tokenizer_path=args.tokenizer_path)

    ckpt_dir = os.path.join("ckpts", args.dataset_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    pretrain_path = None
    if args.finetune:
        if not args.pretrain:
            raise SystemExit("--finetune needs --pretrain <local checkpoint> (nothing is "
                             "downloaded)")
        # copied as pretrained_* into the run directory (finetune_cli.py:141-151)
        pretrain_path = os.path.join(ckpt_dir, f"pretrained_{os.path.basename(args.pretrain)}")
        if main_rank and not os.path.exists(pretrain_path):
            shutil.copy2(args.pretrain, pretrain_path)
        multihost.barrier()

    train_cfg = TrainConfig(
        epochs=args.epochs, learning_rate=args.learning_rate,
        num_warmup_updates=args.num_warmup_updates,
        grad_accumulation_steps=args.grad_accumulation_steps, max_grad_norm=args.max_grad_norm,
        batch_size_per_device=args.batch_size_per_gpu, batch_size_type=args.batch_size_type,
        max_samples=args.max_samples, save_per_updates=args.save_per_updates,
        keep_last_n_checkpoints=args.keep_last_n_checkpoints,
        last_per_updates=args.last_per_updates, save_dir=ckpt_dir,
        bnb_optimizer=args.bnb_optimizer)

    vocab, vocab_size = ftext.get_tokenizer(args.tokenizer_path or args.dataset_name,
                                            args.tokenizer, data_dir=args.data_dir)
    tokenize = finetune_tokenize(args.tokenizer, vocab)
    dataset = ArrowSpeechDataset.from_dir(
        os.path.join(args.data_dir, f"{args.dataset_name}_{args.tokenizer}"), mel=model_cfg.mel)
    loader = build_loader(dataset, tokenize, frames_threshold=args.batch_size_per_gpu,
                          max_samples=args.max_samples, seed=train_cfg.seed)

    trainer = Trainer(model_cfg, train_cfg, vocab_size=vocab_size, tokenize=tokenize,
                      device=device,
                      transport=args.transport,
                      log_fn=lambda m, u: main_rank and u % 50 == 0 and print(
                          f"update {u}: {m['loss']:.4f}"))
    loader = ShardedLoader(loader, trainer.mesh)  # this rank's rows of each batch
    if pretrain_path:
        trainer.init_state(len(loader) * args.epochs, pretrained_path=pretrain_path)
    ts, _ = trainer.train(loader, max_updates=args.max_updates)
    return ts


if __name__ == "__main__":
    main()
