"""Scoring CLI: WER / SIM / UTMOS over a directory of generated wavs
(counterpart of `f5e_tts_tpu/eval/score_cli.py`).

reference: src/f5_tts/eval/eval_seedtts_testset.py +
eval_librispeech_test_clean.py + eval_utmos.py. The scoring models load from
local paths (scorers.py raises without them); results go to
_{metric}_results.jsonl with a mean line (eval_seedtts_testset.py:76-85).
The models run on the card unless --device cpu.

    python -m f5e_tts_tpu_torch.eval.score_cli wer --gen_dir results/... --metalst meta.lst \\
        --lang en --asr_model /path/whisper-large-v3
    python -m f5e_tts_tpu_torch.eval.score_cli sim --gen_dir ... --metalst ... --embedder ...
    python -m f5e_tts_tpu_torch.eval.score_cli utmos --gen_dir ... --utmos /path/utmos.pt
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os


def _pairs_from_meta(metalst: str, gen_dir: str, field: str):
    """(utt, gt_text, gen_wav) for "wer", else (utt, gen_wav, prompt_wav), for
    each utterance of the meta list whose wav is in `gen_dir`."""
    from f5e_tts_tpu_torch.eval.harness import get_seedtts_metainfo

    pairs = []
    for utt, _prompt_text, prompt_wav, gt_text, _gt_wav in get_seedtts_metainfo(metalst):
        gen_wav = os.path.join(gen_dir, f"{utt}.wav")
        if not os.path.exists(gen_wav):
            continue
        pairs.append((utt, gt_text, gen_wav) if field == "wer" else (utt, gen_wav, prompt_wav))
    return pairs


def main(argv=None):
    from f5e_tts_tpu_torch.eval import scorers as fs

    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="metric", required=True)
    pw = sub.add_parser("wer")
    pw.add_argument("--gen_dir", required=True)
    pw.add_argument("--metalst", required=True)
    pw.add_argument("--lang", default="en", choices=["en", "zh"])
    pw.add_argument("--asr_model", default="",
                    help="local ASR weights dir (paraformer-zh parent for zh, whisper dir/size "
                         "for en)")
    pw.add_argument("--backend", default=None,
                    choices=[None, "funasr", "faster_whisper", "hf_whisper"],
                    help="default: funasr for zh, faster_whisper for en (utils_eval.py:472-488)")
    pw.add_argument("--mode", default="whisper_v3", choices=["seedtts", "whisper_v3"],
                    help="normalisation: run_asr_wer vs run_asr_wer_whisper_large_v3")
    pw.add_argument("--workers", type=int, default=1,
                    help="parallel scoring workers, one ASR model each "
                         "(eval_seedtts_testset.py:60-67)")
    ps = sub.add_parser("sim")
    ps.add_argument("--gen_dir", required=True)
    ps.add_argument("--metalst", required=True)
    ps.add_argument("--embedder", required=True, help="local speaker-embedder weights")
    pu = sub.add_parser("utmos")
    pu.add_argument("--gen_dir", required=True)
    pu.add_argument("--utmos", required=True, help="local UTMOS checkpoint")
    for sp in (pw, ps, pu):
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.metric == "wer":
        # (gen_wav, prompt_wav, truth) triplets, the reference's test-set layout
        test_set = [(gen_wav, "", text)
                    for _utt, text, gen_wav in _pairs_from_meta(args.metalst, args.gen_dir, "wer")]
        make = functools.partial(_make_transcriber, backend=args.backend,
                                 ckpt_dir=args.asr_model, device=args.device)
        rows = fs.run_asr_wer_parallel(test_set, make, lang=args.lang, mode=args.mode,
                                       n_jobs=args.workers)
        mean = fs.write_results_jsonl(rows, "wer",
                                      os.path.join(args.gen_dir, "_wer_results.jsonl"))
        out = {"wer": mean, "n": len(rows)}
    elif args.metric == "sim":
        embed = _load_speaker_embedder(args.embedder, device=args.device)
        out = fs.score_sim(_pairs_from_meta(args.metalst, args.gen_dir, "sim"), embed_fn=embed,
                           results_path=os.path.join(args.gen_dir, "_sim_results.jsonl"))
    else:
        utmos = fs.load_utmos(args.utmos, device=args.device)
        wavs = sorted(glob.glob(os.path.join(args.gen_dir, "*.wav")))
        out = fs.score_utmos(wavs, utmos,
                             results_path=os.path.join(args.gen_dir, "_utmos_results.jsonl"))
    print(json.dumps(out))
    return out


def _make_transcriber(rank: int, lang: str, *, backend=None, ckpt_dir="", device="cuda"):
    """One worker's ASR model (picklable for an mp.Pool worker, as the
    reference loads one model a GPU, eval_seedtts_testset.py:60-67)."""
    from f5e_tts_tpu_torch.eval import scorers as fs

    return fs.load_asr_backend(lang, backend=backend, ckpt_dir=ckpt_dir, device=device)


def _load_speaker_embedder(path: str, device="cuda"):
    """The WavLM-large + ECAPA speaker embedder as a torchscript export
    (reference: eval/ecapa_tdnn.py + utils_eval.py:714-719), on `device`;
    raises without the file."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"speaker embedder not found at {path} (export the WavLM-ECAPA model to "
            "torchscript and pass its path; nothing is downloaded)")
    import numpy as np
    import torch

    from f5e_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = torch.jit.load(path, map_location=dev).eval()

    def embed(wav_path: str) -> np.ndarray:
        from f5e_tts_tpu_torch.infer.audio import read_wav, resample

        wav, sr = read_wav(wav_path)
        wav = resample(wav, sr, 16_000)
        with torch.no_grad():
            return model(torch.from_numpy(wav[None]).to(dev)).cpu().numpy().reshape(-1)

    return embed


if __name__ == "__main__":
    main()
