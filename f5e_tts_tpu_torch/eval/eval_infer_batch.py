"""Batch evaluation CLI: generate a whole test set and report the wall clock
and RTF (counterpart of `f5e_tts_tpu/eval/eval_infer_batch.py`).

reference: src/f5_tts/eval/eval_infer_batch.py (+ its _tts and _vc variants)
and eval_infer_batch.sh; --mode picks the sampler. One device: the card
unless --device cpu. Without --ckpt the model has seeded random weights.

    python -m f5e_tts_tpu_torch.eval.eval_infer_batch -t seedtts --metalst meta.lst \\
        --ckpt model.pt --vocab vocab.txt -n exp1 -nfe 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    from f5e_tts_tpu_torch.api import F5TTS
    from f5e_tts_tpu_torch.eval import harness as fh

    p = argparse.ArgumentParser()
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-n", "--expname", default="F5TTS_v1_Base")
    p.add_argument("-c", "--ckptstep", type=int, default=1250000)
    p.add_argument("--ckpt", default="", help="checkpoint path")
    p.add_argument("--vocab", default="", help="vocab.txt path")
    p.add_argument("--model_cfg", default=None)
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("-nfe", "--nfestep", type=int, default=32)
    p.add_argument("-o", "--odemethod", default="euler")
    p.add_argument("-ss", "--swaysampling", type=float, default=-1)
    p.add_argument("--cfg_strength", type=float, default=2.0)
    p.add_argument("--mode", default="cfg", choices=["cfg", "tts", "vc"])
    p.add_argument("--alpha_spk", type=float, default=1.0)
    p.add_argument("--alpha_txt", type=float, default=1.0)
    p.add_argument("--alpha_ppg", type=float, default=1.0)
    p.add_argument("-t", "--testset", default="seedtts", choices=["seedtts", "ls_pc_test_clean"])
    p.add_argument("--metalst", required=True)
    p.add_argument("--librispeech_path", default="")
    p.add_argument("--infer_batch_size", type=int, default=1)
    p.add_argument("--output_dir", default="results")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    tts = F5TTS(model=args.expname, ckpt_file=args.ckpt, vocab_file=args.vocab,
                config_file=args.model_cfg, vocoder_local_path=args.vocoder_local_path,
                ode_method=args.odemethod, device=args.device)
    engine = tts.engine
    if args.testset == "seedtts":
        metainfo = fh.get_seedtts_metainfo(args.metalst)
    else:
        metainfo = fh.get_librispeech_metainfo(args.metalst, args.librispeech_path)
    batches = fh.shard_for_host(fh.get_inference_prompts(
        metainfo, engine.tokenize, engine.mel, infer_batch_size=args.infer_batch_size))

    out_dir = os.path.join(
        args.output_dir,
        f"{args.expname}_{args.ckptstep}_{args.testset}_{args.nfestep}nfe_{args.odemethod}"
        f"_ss{args.swaysampling}_cfg{args.cfg_strength}_seed{args.seed}")
    stats = fh.run_batch_inference(
        engine, batches, out_dir, nfe_steps=args.nfestep, cfg_strength=args.cfg_strength,
        sway=args.swaysampling, seed=args.seed or 0, mode=args.mode, alpha_spk=args.alpha_spk,
        alpha_txt=args.alpha_txt, alpha_ppg=args.alpha_ppg)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
