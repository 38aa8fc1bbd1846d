"""Small utility CLIs (counterpart of `f5e_tts_tpu/scripts.py`; reference:
src/f5_tts/scripts/).

  python -m f5e_tts_tpu_torch.scripts count_params [--model F5TTS_v1_Base] [--seconds 20] \
      [--device cpu]
  python -m f5e_tts_tpu_torch.scripts count_max_epoch --total_hours 95282 ...
  python -m f5e_tts_tpu_torch.scripts edit --ref ref.wav --orig "..." --target "..." \
      --spans 1.0:2.5 ... [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def count_params(argv):
    """reference: scripts/count_params_gflops.py:26-40 (thop counter)."""
    from f5e_tts_tpu_torch.config import preset
    from f5e_tts_tpu_torch.utils.profiling import report_model_stats

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--vocab_size", type=int, default=2545)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = preset(args.model).arch
    stats = report_model_stats(cfg, args.vocab_size, args.seconds, device=args.device)
    print(json.dumps(stats))
    return stats


def count_max_epoch(argv):
    """reference: scripts/count_max_epoch.py: epochs reachable in a budget of
    updates, given the dataset's hours and the frames of a global batch."""
    p = argparse.ArgumentParser()
    p.add_argument("--total_hours", type=float, required=True, help="dataset audio hours")
    p.add_argument("--mel_hop", type=int, default=256)
    p.add_argument("--mel_sr", type=int, default=24000)
    p.add_argument("--frames_per_batch", type=int, default=307200, help="global batch frames")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--wanted_updates", type=int, default=1_000_000)
    args = p.parse_args(argv)
    frames_total = args.total_hours * 3600 * args.mel_sr / args.mel_hop
    updates_per_epoch = frames_total / (args.frames_per_batch * args.grad_accum)
    out = {"updates_per_epoch": int(updates_per_epoch),
           "epochs_for_wanted_updates": round(args.wanted_updates / updates_per_epoch, 1)}
    print(json.dumps(out))
    return out


def edit(argv):
    """Speech edit CLI (reference: infer/speech_edit.py __main__ flow), on the
    card unless --device cpu."""
    from f5e_tts_tpu_torch.api import F5TTS
    from f5e_tts_tpu_torch.infer.audio import read_wav, write_wav
    from f5e_tts_tpu_torch.infer.speech_edit import edit_speech

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--ref", required=True, help="wav to edit")
    p.add_argument("--orig", required=True, help="original transcript")
    p.add_argument("--target", required=True, help="edited transcript")
    p.add_argument("--spans", required=True, nargs="+",
                   help="edit spans start:end in seconds, e.g. 1.0:2.5")
    p.add_argument("--fix_durations", nargs="*", type=float, default=None)
    p.add_argument("--nfe", type=int, default=32)
    p.add_argument("--out", default="edited.wav")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    spans = [tuple(map(float, s.split(":"))) for s in args.spans]
    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                vocoder_local_path=args.vocoder_local_path, device=args.device)
    wav, sr = read_wav(args.ref)
    out, out_sr = edit_speech(tts.engine, wav, sr, args.orig, args.target, spans,
                              fix_durations=args.fix_durations, nfe_steps=args.nfe)
    write_wav(args.out, out, out_sr)
    print(f"wrote {args.out}")
    return out, out_sr


COMMANDS = {"count_params": count_params, "count_max_epoch": count_max_epoch, "edit": edit}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m f5e_tts_tpu_torch.scripts {{{'|'.join(COMMANDS)}}} ...")
        raise SystemExit(2)
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
